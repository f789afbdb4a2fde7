"""The D 192 gradient of the port's ``flash_attention`` (MLA), on the CPU.

deepseek-v2-lite's training attention has q/k heads of 128 + 64 and v
zero-padded to 192 (``lm._mla_attend``), causal, Hq = Hkv = 16. Its
backward runs on entries of its own (``flash_attention_bwd_{prep,dkdv,
dq}_bf16_d192_sm90`` in ``csrc/flash_attention_bwd_sm90.cu``: ``dkdv`` on
two warpgroups a block, one accumulator each), which run only on a card;
``chip_smoke.py`` holds them against the plain version there. Here, with
inputs made from a seed with numpy (v and dO zero past column 128, as the
MLA path gives them):

- the plain version ``ref.attention_bwd`` at D 192 against ``jax.grad``
  of ``repro.kernels.ref.attention`` (float32 2e-5, bf16 relative norm
  3e-2), the padded columns' dv exactly 0;
- the entries' arithmetic, emulated by tests/test_torch_flash_bwd_tc.py's
  ``emulate`` (its tiles read from the source; warpgroup 1 of ``dkdv``
  reads warpgroup 0's float32 P^T, so dK's arithmetic is the one-
  warpgroup kernel's), within 3.7e-3 of the float32-upcast gradient
  (chip_smoke's ``FLASH_BWD_UPCAST_RNORM``) at deepseek's heads and at
  ragged lengths;
- the route rule and the wrapper on stand-in libraries: bf16 D 192 takes
  the D 192 entries with the forward's saved lse; float32 D 192 and the
  CUDA-core route refuse it; the source's D 192 entries and their layout.
"""
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_flash_bwd_tc as tc_test
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ref
from test_torch_flash_bwd_tc import stand_ins  # noqa: F401  (a fixture)

# one intra-op thread, as in the other port tests run by parallel workers
torch.set_num_threads(1)

F32_TOL, BF16_RNORM, UPCAST_RNORM = 2e-5, tc_test.BF16_RNORM, tc_test.UPCAST_RNORM
D, V_D = 192, 128   # MLA's q/k head (128 + 64) and its value head


def _inputs(shape, dtype, seed):
    """(B, Sq, Skv, Hq, Hkv) -> q, k, v, dO at D 192 in ``dtype``; v and dO
    zero past column V_D."""
    b, sq, skv, hq, hkv = shape
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((b, sq, hq, D)).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, skv, hkv, D)).astype(np.float32))
            for _ in range(2))
    v[..., V_D:] = 0
    do[..., V_D:] = 0
    return [t.to(dtype) for t in (q, k, v, do)]


def _jax_grads(q, k, v, do, causal=True):
    dt = jnp.bfloat16 if q.dtype == torch.bfloat16 else jnp.float32
    args = [jnp.asarray(t.float().numpy(), dt) for t in (q, k, v, do)]
    _, vjp = jax.vjp(lambda a, b, c: jref.attention(a, b, c, causal=causal), *args[:3])
    return [np.asarray(g, np.float32) for g in vjp(args[3])]


def _rnorm(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# (B, Sq, Skv, Hq, Hkv): MLA's heads (Hq = Hkv) at a few tiles, ragged,
# Sq != Skv, and GQA
PLAIN_SHAPES = [(1, 130, 130, 4, 4), (2, 33, 70, 2, 2), (2, 70, 33, 4, 2)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", PLAIN_SHAPES)
def test_plain_backward_matches_jax_grad(shape, causal):
    """float32 within 2e-5 (padded dv columns exactly 0); bf16 relative
    norm within 3e-2."""
    q, k, v, do = _inputs(shape, torch.float32, 0)
    got = ref.attention_bwd(q, k, v, ref.attention(q, k, v, causal=causal), do, causal=causal)
    for g, t, w in zip(got, (q, k, v), _jax_grads(q, k, v, do, causal)):
        assert g.shape == t.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, atol=F32_TOL, rtol=F32_TOL)
    assert torch.count_nonzero(got[2][..., V_D:]) == 0
    qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
    got = ref.attention_bwd(qb, kb, vb, ref.attention(qb, kb, vb, causal=causal), dob,
                            causal=causal)
    for g, w in zip(got, _jax_grads(qb, kb, vb, dob, causal)):
        assert g.dtype == torch.bfloat16 and _rnorm(g.float(), w) < BF16_RNORM


# deepseek's 16 heads at 256 tokens (its layout, cut in length), ragged
# (phase 2's (2, 200, 4, 192)), Sq < Skv, Sq > Skv, GQA, one query
EMULATED = [((1, 256, 256, 16, 16), True), ((2, 200, 200, 4, 4), True),
            ((2, 130, 260, 4, 4), True), ((2, 260, 130, 2, 2), True),
            ((2, 200, 200, 6, 2), True), ((2, 200, 77, 4, 4), False), ((1, 1, 100, 2, 2), False)]


@pytest.mark.parametrize("shape,causal", EMULATED)
def test_emulated_d192_backward(shape, causal):
    """Each of dq, dk, dv within UPCAST_RNORM (relative norm) of the
    float32 gradient of the inputs upcast, within BF16_RNORM of the plain
    version and of ``jax.grad`` in bf16; dv's padded columns exactly 0."""
    q, k, v, do = _inputs(shape, torch.bfloat16, 1)
    o = ref.attention(q, k, v, causal=causal)
    assert torch.count_nonzero(o[..., V_D:]) == 0
    got = tc_test.emulate(q, k, v, o, do, causal=causal)
    exact = ref.attention_bwd(*(t.float() for t in (q, k, v, o)), do.float(), causal=causal)
    want = ref.attention_bwd(q, k, v, o, do, causal=causal)
    for g, x, w, j in zip(got, exact, want, _jax_grads(q, k, v, do, causal)):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert _rnorm(g.float(), x) < UPCAST_RNORM
        assert _rnorm(g.float(), w.float()) < BF16_RNORM
        assert _rnorm(g.float(), j) < BF16_RNORM
    assert torch.count_nonzero(got[2][..., V_D:]) == 0


def test_mla_attention_gradient_through_the_padding():
    """``lm._mla_attend``'s training call, ``attention(q, k, pad(v))[...,
    :128]``, on the CPU: the padded v columns get a zero gradient (the
    slice's), and v's gradient is that of the unpadded value head."""
    q, k, v, _ = _inputs((1, 40, 40, 2, 2), torch.float32, 2)
    v = v[..., :V_D].clone().requires_grad_()
    dy = torch.randn((1, 40, 2, V_D), generator=torch.Generator().manual_seed(3))
    out = ref.attention(q, k, torch.nn.functional.pad(v, (0, D - V_D)), causal=True)[..., :V_D]
    (gv,) = torch.autograd.grad(out, v, dy)
    full = ref.attention_bwd(q, k, torch.nn.functional.pad(v.detach(), (0, D - V_D)), None,
                             torch.nn.functional.pad(dy, (0, D - V_D)), causal=True)[2]
    assert torch.count_nonzero(full[..., V_D:]) == 0
    torch.testing.assert_close(gv, full[..., :V_D], atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# the route rule, the refusals and the wrapper on stand-in libraries
# ---------------------------------------------------------------------------

def test_d192_takes_the_tensor_core_route_in_bf16_only():
    assert flash.choose_bwd_route(torch.bfloat16, D) == flash.TENSOR_CORE
    assert flash.choose_bwd_route(torch.float32, D) == flash.CUDA_CORE
    assert flash.bwd_tc_symbols(D) == flash.BWD_TC_D192_SYMBOLS
    assert all(flash.bwd_tc_symbols(d) == flash.BWD_TC_SYMBOLS for d in (64, 80, 128))
    flash.check_backward((1, 16, 16, D), (1, 16, 16, D), torch.bfloat16)
    with pytest.raises(ValueError, match="D <= 128"):
        flash.check_backward((1, 16, 16, D), (1, 16, 16, D), torch.float32)
    with pytest.raises(ValueError, match="D <= 128"):
        flash.check_backward((1, 16, 16, D), (1, 16, 16, D), torch.bfloat16,
                             route=flash.CUDA_CORE)


@pytest.mark.parametrize("causal", [True, False])
def test_d192_launches_its_own_entries_with_the_saved_lse(stand_ins, causal):
    """bf16 D 192, Hq = Hkv = 16 (MLA): the Function's forward writes the
    lse (D 192 on the forward's tensor-core entry), the backward launches
    the D 192 prep, dkdv and dq in order with (b, sq, skv, 16, 16, 192,
    causal, stride, 1/sqrt(192)) and that lse, and no entry of D 64 to
    128; dk and dv come back in k's and v's shape."""
    b, sq, skv, h = 1, 70, 70, 16
    q = tc_test._bf16((b, sq, h, D), grad=True)
    k, v = (tc_test._bf16((b, skv, h, D), grad=True) for _ in range(2))
    out = flash.flash_attention(q, k, v, causal=causal)
    (sym, fwd), = stand_ins
    stride = flash.lse_stride(sq)
    assert sym == "flash_attention_bf16_sm90" and fwd[4] is not None
    assert fwd[5:13] == (b, sq, skv, h, h, D, int(causal), stride)
    lse = out.grad_fn.saved_tensors[4]
    assert lse.shape == (b, h, stride) and lse.data_ptr() == fwd[4]
    dq, dk, dv = torch.autograd.grad(out.float().sum(), (q, k, v))
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    assert [s for s, _ in stand_ins[1:]] == list(flash.BWD_TC_D192_SYMBOLS.values())
    prep, dkdv, dqa = (a for _, a in stand_ins[1:])
    assert prep[3:-1] == (b, sq, h, D, stride)
    for args in (dkdv, dqa):
        assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
        assert args[4:6] == (lse.data_ptr(), prep[2])
        assert args[-10:-1] == (b, sq, skv, h, h, D, int(causal), stride, 1 / math.sqrt(D))
    assert dkdv[6:8] == (dk.data_ptr(), dv.data_ptr()) and dqa[6] == dq.data_ptr()
    assert flash.BWD_TC_KERNEL.launches == 3 and flash.BWD_KERNEL.launches == 0
    assert all(flash.BWD_TC_KERNEL.symbol_launches[s] == 0 for s in flash.BWD_TC_SYMBOLS.values())


def test_d192_refusals_come_before_any_launch(stand_ins):
    """Where no kernel takes the gradient, ``flash_attention`` raises
    before its forward launches: float32 D 192, bf16 D 192 forced onto the
    CUDA cores, bf16 D 256; bf16 D 192 forced onto the tensor cores runs."""
    for dtype, d, route in ((torch.float32, D, None), (torch.bfloat16, D, flash.CUDA_CORE),
                            (torch.bfloat16, 256, None)):
        q, k, v = (torch.zeros((1, 8, 2, d), dtype=dtype, requires_grad=True) for _ in range(3))
        with pytest.raises(ValueError, match="backward takes D <="):
            flash.flash_attention(q, k, v, causal=True, route=route)
    assert not stand_ins
    q, k, v = (tc_test._bf16((1, 8, 2, D), grad=True) for _ in range(3))
    flash.flash_attention(q, k, v, causal=True, route=flash.TENSOR_CORE)
    assert [s for s, _ in stand_ins] == ["flash_attention_bf16_sm90"]


def test_source_holds_the_d192_entries():
    """The D 192 entries are in the source, refuse other head dims, run
    dkdv on two warpgroups (the named barrier of both, 256 threads, one
    block an SM) and dq at D 192 on the one-warpgroup kernel."""
    src = tc_test.SOURCE
    for sym in flash.BWD_TC_D192_SYMBOLS.values():
        assert f'extern "C" int {sym}(' in src
    assert set(flash.BWD_TC_KERNEL.symbols) == (set(flash.BWD_TC_SYMBOLS.values())
                                               | set(flash.BWD_TC_D192_SYMBOLS.values()))
    assert "(d192 ? d != 192 : (d != 64 && d != 80 && d != 128))" in src
    assert "launch_dkdv_wg2<192>(" in src and "launch_dq<192>(" in src
    assert "__launch_bounds__(2 * kBwdThreads, 1)" in src
    assert "kernel<<<grid, 2 * kBwdThreads, bytes, stream>>>" in src
    assert "bar.arrive 1, 256" in src and "bar.sync 1, 256" in src
    assert re.search(r"min_blocks\(\) \{ return D <= 64 \? 3 : D <= 128 \? 2 : 1; \}", src)
