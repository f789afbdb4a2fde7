"""The causal GQA gradient of the port's ``flash_attention``, on the CPU.

The LMs' attention is causal with fewer kv heads than query heads
(phi4-mini-3.8b 24 / 8, qwen3-8b 32 / 8). Here, with inputs made from a
seed with numpy:

- the plain version ``ref.attention_bwd(..., causal=True)`` on GQA heads
  against ``jax.grad`` of ``repro.kernels.ref.attention`` (float32 2e-5,
  bf16 relative norm 3e-2), Sq = Skv, Sq < Skv and Sq > Skv, and a kv
  head's gradient as the sum over its query heads';
- both backward routes' arithmetic, emulated by
  tests/test_torch_flash_bwd_route.py's (CUDA cores) and
  tests/test_torch_flash_bwd_tc.py's (tensor cores) ``emulate`` with
  ``causal`` and GQA: the CUDA-core route against the plain version at
  float32's 2e-5; the tensor-core route within 3.7e-3 (relative norm,
  chip_smoke's ``FLASH_BWD_UPCAST_RNORM``) of the float32-upcast
  gradient and 3e-2 of the plain version and of ``jax.grad`` in bf16, at
  Sq = Skv = 200 and 256, Hq / Hkv = 4 / 2 and 6 / 2, D 64, 80 and 128,
  and at Sq != Skv;
- the wrapper on stand-in libraries: the causal forward writes and saves
  the lse, each entry gets ``causal``, Hq and Hkv, the gradients take
  k's and v's shapes; ``check_backward`` refuses what no route takes
  (D 192 but in bf16, and D > 192); the sources launch the longest causal
  blocks first.
"""
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_flash_bwd_route as route_test
import test_torch_flash_bwd_tc as tc_test
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ref
from test_torch_flash_bwd_tc import stand_ins  # noqa: F401  (a fixture)

# one intra-op thread, as in the other port tests run by parallel workers
torch.set_num_threads(1)

F32_TOL, BF16_RNORM, UPCAST_RNORM = route_test.F32_TOL, tc_test.BF16_RNORM, tc_test.UPCAST_RNORM


def _inputs(shape, dtype, seed):
    """(B, Sq, Skv, Hq, Hkv, D) -> q, k, v, dO in ``dtype``."""
    b, sq, skv, hq, hkv, d = shape
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((b, sq, hq, d)).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, skv, hkv, d)).astype(np.float32))
            for _ in range(2))
    return [t.to(dtype) for t in (q, k, v, do)]


def _jax_grads(q, k, v, do, causal=True):
    """``jax.grad`` of the reference's oracle, in the inputs' dtype."""
    dt = jnp.bfloat16 if q.dtype == torch.bfloat16 else jnp.float32
    args = [jnp.asarray(t.float().numpy(), dt) for t in (q, k, v, do)]
    _, vjp = jax.vjp(lambda a, b, c: jref.attention(a, b, c, causal=causal), *args[:3])
    return [np.asarray(g, np.float32) for g in vjp(args[3])]


def _rnorm(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# (B, Sq, Skv, Hq, Hkv, D)
PLAIN_SHAPES = [(2, 33, 33, 4, 2, 16), (2, 20, 45, 6, 2, 16), (2, 45, 20, 4, 1, 32)]


@pytest.mark.parametrize("shape", PLAIN_SHAPES)
def test_plain_backward_matches_jax_grad(shape):
    """float32: within 2e-5; bf16: relative norm within 3e-2."""
    q, k, v, do = _inputs(shape, torch.float32, 0)
    o = ref.attention(q, k, v, causal=True)
    got = ref.attention_bwd(q, k, v, o, do, causal=True)
    for g, t, w in zip(got, (q, k, v), _jax_grads(q, k, v, do)):
        assert g.shape == t.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, atol=F32_TOL, rtol=F32_TOL)
    qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
    got = ref.attention_bwd(qb, kb, vb, ref.attention(qb, kb, vb, causal=True), dob, causal=True)
    for g, w in zip(got, _jax_grads(qb, kb, vb, dob)):
        assert g.dtype == torch.bfloat16 and _rnorm(g.float(), w) < BF16_RNORM


def test_plain_gqa_gradient_sums_the_query_heads():
    """A kv head's dk and dv are the sums of its query heads' shares: the
    gradient with k and v repeated to Hq heads, summed in groups."""
    q, k, v, do = _inputs((2, 24, 24, 6, 2, 16), torch.float32, 1)
    rep = 3
    dq, dk, dv = ref.attention_bwd(q, k, v, None, do, causal=True)
    ke, ve = (t.repeat_interleave(rep, 2) for t in (k, v))
    dq_e, dk_e, dv_e = ref.attention_bwd(q, ke, ve, None, do, causal=True)
    torch.testing.assert_close(dq, dq_e, atol=1e-6, rtol=1e-6)
    for g, ge in ((dk, dk_e), (dv, dv_e)):
        torch.testing.assert_close(g, ge.reshape(2, 24, 2, rep, 16).sum(3), atol=1e-6, rtol=1e-6)


def test_causal_rows_ignore_later_keys():
    """Under the mask a query row reads keys 0..row only: the first query's
    dO moves dv of key 0 (its weight there is 1) and no gradient of a
    later key."""
    q, k, v, do = _inputs((1, 8, 8, 2, 1, 16), torch.float32, 2)
    base = ref.attention_bwd(q, k, v, None, do, causal=True)
    do2 = do.clone()
    do2[:, 0] += 1.0
    moved = ref.attention_bwd(q, k, v, None, do2, causal=True)
    assert torch.equal(base[1][:, 1:], moved[1][:, 1:]) and torch.equal(base[2][:, 1:],
                                                                           moved[2][:, 1:])
    assert not torch.equal(base[2][:, 0], moved[2][:, 0])


# the CUDA-core route (float32 and other bf16 head dims); the last, 5
# queries, in float32 only: with so few causal rows dk is mostly
# cancellation (row 0's dS is 0 in exact arithmetic), and Delta taken from
# the bf16 output moves it by 4.2e-3 of its norm, a measure of the bf16
# rounding of o rather than of the kernel's arithmetic
CUDA_CORE_SHAPES = [(2, 200, 200, 6, 2, 64), (2, 197, 197, 6, 2, 80), (2, 130, 260, 4, 2, 128),
                    (2, 260, 130, 4, 2, 128), (1, 5, 100, 4, 1, 16)]


@pytest.mark.parametrize("shape", CUDA_CORE_SHAPES)
def test_emulated_cuda_core_backward_causal_gqa(shape):
    """float32 within 2e-5 of the plain version and of ``jax.grad``; bf16
    within 3e-2 (relative norm) of the plain version and within one bf16
    rounding (2^-8) of the float32 gradient of the same inputs."""
    q, k, v, do = _inputs(shape, torch.float32, 3)
    o = ref.attention(q, k, v, causal=True)
    got = route_test.emulate(q, k, v, o, do, causal=True)
    want = ref.attention_bwd(q, k, v, o, do, causal=True)
    for g, w, j in zip(got, want, _jax_grads(q, k, v, do)):
        assert g.shape == w.shape and g.dtype == torch.float32
        torch.testing.assert_close(g, w, atol=F32_TOL, rtol=F32_TOL)
        np.testing.assert_allclose(g.numpy(), j, atol=F32_TOL, rtol=F32_TOL)
    if shape[1] < 8:
        return
    q, k, v, do = (t.bfloat16() for t in (q, k, v, do))
    o = ref.attention(q, k, v, causal=True)
    got = route_test.emulate(q, k, v, o, do, causal=True)
    want = ref.attention_bwd(q, k, v, o, do, causal=True)
    exact = ref.attention_bwd(*(t.float() for t in (q, k, v, o)), do.float(), causal=True)
    for g, w, x in zip(got, want, exact):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert _rnorm(g.float(), w.float()) < BF16_RNORM
        assert _rnorm(g.float(), x) < 2.0 ** -8


# the tensor-core route: Sq = Skv = 200 and 256, Hq / Hkv 4 / 2 and 6 / 2,
# D 64, 80, 128; then Sq != Skv
TENSOR_CORE_SHAPES = [(2, s, s, hq, 2, d) for s in (200, 256) for hq in (4, 6)
                      for d in (64, 80, 128)] + [(2, 130, 260, 4, 2, 128),
                                                 (2, 260, 130, 4, 2, 128)]


@pytest.mark.parametrize("shape", TENSOR_CORE_SHAPES)
def test_emulated_tensor_core_backward_causal_gqa(shape):
    """Each of dq, dk, dv within UPCAST_RNORM (relative norm) of the
    float32 gradient of the inputs upcast, and within BF16_RNORM of the
    plain version and of ``jax.grad`` in bf16."""
    q, k, v, do = _inputs(shape, torch.bfloat16, 4)
    o = ref.attention(q, k, v, causal=True)
    got = tc_test.emulate(q, k, v, o, do, causal=True)
    exact = ref.attention_bwd(*(t.float() for t in (q, k, v, o)), do.float(), causal=True)
    want = ref.attention_bwd(q, k, v, o, do, causal=True)
    for g, x, w, j in zip(got, exact, want, _jax_grads(q, k, v, do)):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert _rnorm(g.float(), x) < UPCAST_RNORM
        assert _rnorm(g.float(), w.float()) < BF16_RNORM
        assert _rnorm(g.float(), j) < BF16_RNORM


@pytest.mark.parametrize("shape", [(2, 70, 150, 6, 2, 80), (1, 150, 70, 4, 1, 64)])
def test_forward_lse_is_the_masked_log_sum_exp(shape):
    """The forward kernel's lse under the mask (emulated) is each row's
    log-sum-exp over its keys 0..row, in log2 units."""
    q, k, _, _ = _inputs(shape, torch.bfloat16, 5)
    b, sq, skv, hq, hkv, d = shape
    s = (q.float().transpose(1, 2)
         @ k.float().transpose(1, 2).repeat_interleave(hq // hkv, 1).transpose(-1, -2)).double()
    s = s.masked_fill(torch.arange(skv)[None, :] > torch.arange(sq)[:, None], -torch.inf)
    want = torch.logsumexp(s / math.sqrt(d), -1) * tc_test.LOG2E
    torch.testing.assert_close(tc_test.forward_lse(q, k, causal=True).double(), want,
                               atol=2e-5, rtol=0)


# ---------------------------------------------------------------------------
# the wrapper, on stand-in libraries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_launches_carry_causal_and_both_head_counts(stand_ins, causal):
    """bf16 D 64 with Hq 6, Hkv 2: the Function's forward writes the lse
    with the causal flag, the backward's dkdv and dq get (b, sq, skv, 6,
    2, 64, causal, stride) and the saved lse, prep the query heads, and
    dk and dv come back in k's and v's shape."""
    b, sq, skv, hq, hkv, d = 2, 70, 70, 6, 2, 64
    q = tc_test._bf16((b, sq, hq, d), grad=True)
    k, v = (tc_test._bf16((b, skv, hkv, d), grad=True) for _ in range(2))
    out = flash.flash_attention(q, k, v, causal=causal)
    (sym, fwd), = stand_ins
    stride = flash.lse_stride(sq)
    assert sym == "flash_attention_bf16_sm90" and fwd[4] is not None
    assert fwd[5:13] == (b, sq, skv, hq, hkv, d, int(causal), stride)
    lse = out.grad_fn.saved_tensors[4]
    assert lse.shape == (b, hq, stride) and lse.data_ptr() == fwd[4]
    dq, dk, dv = torch.autograd.grad(out.float().sum(), (q, k, v))
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    prep, dkdv, dqa = (a for _, a in stand_ins[1:])
    assert [s for s, _ in stand_ins[1:]] == list(flash.BWD_TC_SYMBOLS.values())
    assert prep[3:-1] == (b, sq, hq, d, stride)
    for args in (dkdv, dqa):
        assert args[4] == lse.data_ptr()
        assert args[-10:-1] == (b, sq, skv, hq, hkv, d, int(causal), stride, 1 / math.sqrt(d))
    assert dkdv[6:8] == (dk.data_ptr(), dv.data_ptr()) and dqa[6] == dq.data_ptr()


@pytest.mark.parametrize("d", [64, 128])
def test_cuda_core_launches_carry_causal_and_both_head_counts(stand_ins, d):
    """float32 (the reduced card-vs-CPU step's route) with Hq 4, Hkv 2,
    causal: the forward's entry gets causal 1, each backward entry (b, sq,
    skv, 4, 2, d, 1)."""
    b, sq, skv, hq, hkv = 2, 33, 33, 4, 2
    q = torch.zeros((b, sq, hq, d), requires_grad=True)
    k, v = (torch.zeros((b, skv, hkv, d), requires_grad=True) for _ in range(2))
    out = flash.flash_attention(q, k, v, causal=True)
    dq, dk, dv = torch.autograd.grad(out.sum(), (q, k, v))
    assert dk.shape == k.shape and dv.shape == v.shape
    assert [s for s, _ in stand_ins] == ["flash_attention_f32"] + [
        f"flash_attention_bwd_{e}_f32" for e in flash.BWD_ENTRIES]
    assert stand_ins[0][1][4:11] == (b, sq, skv, hq, hkv, d, 1)
    for _, args in stand_ins[1:]:
        assert args[-9:-2] == (b, sq, skv, hq, hkv, d, 1)


def test_forced_route_keeps_the_mask(stand_ins):
    """bf16 causal GQA forced onto the CUDA-core entries (phase 2 times
    them so): each gets causal 1 and both head counts, and reads no lse."""
    q, o, do = (tc_test._bf16((1, 8, 4, 128)) for _ in range(3))
    k, v = (tc_test._bf16((1, 8, 1, 128)) for _ in range(2))
    flash.flash_attention_bwd(q, k, v, o, do, causal=True, route="cuda_core")
    assert [s for s, _ in stand_ins] == [f"flash_attention_bwd_{e}_bf16"
                                         for e in flash.BWD_ENTRIES]
    assert all(a[-9:-2] == (1, 8, 8, 4, 1, 128, 1) for _, a in stand_ins)


@pytest.mark.parametrize("d", [16, 64, 80, 96, 128, 192, 256])
def test_check_backward_refuses_d192_only(d):
    """Causal and GQA pass at every head dim up to 128 in float32 and
    bf16; D 192 (MLA's q/k heads) passes in bf16 only (the tensor-core
    entries of D 192) and is refused in float32 and on the CUDA-core route
    forced; above 192 every dtype is refused."""
    for hq, hkv in ((4, 4), (8, 2)):
        q_shape, k_shape = (1, 16, hq, d), (1, 16, hkv, d)
        for dtype in (torch.float32, torch.bfloat16):
            takes = d <= 128 or (d == 192 and dtype == torch.bfloat16)
            if takes:
                flash.check_backward(q_shape, k_shape, dtype)
            else:
                with pytest.raises(ValueError, match="D <= (128|192)"):
                    flash.check_backward(q_shape, k_shape, dtype)
        if d > 128:
            with pytest.raises(ValueError, match="D <= 128"):
                flash.check_backward(q_shape, k_shape, torch.bfloat16, route=flash.CUDA_CORE)
        if d > flash.MAX_BWD_D:
            with pytest.raises(ValueError, match="D <= 192"):
                flash.check_backward(q_shape, k_shape, torch.bfloat16, route=flash.TENSOR_CORE)


def test_sources_launch_the_longest_causal_blocks_first():
    """The grids as the sources write them: causal (a template parameter
    of the tensor-core kernels), the tensor-core dkdv
    over (Hkv, B, key blocks) from the first keys, dq over (Hq, B, query
    blocks) from the last rows; without the mask (tiles, heads, B), a
    head's blocks adjacent, as before the mask was taken; the CUDA-core
    prep and dq from the last rows; each skips the tiles the mask leaves
    empty."""
    tc = flash.BWD_TC_KERNEL.source.read_text()
    cc = flash.BWD_KERNEL.source.read_text()
    assert "grid = causal ? dim3(hkv, b, tiles) : dim3(tiles, hkv, b);" in tc
    assert "grid = causal ? dim3(hq, b, tiles) : dim3(tiles, hq, b);" in tc
    assert "k0 = (kCausal ? blockIdx.z : blockIdx.x) * kBwdRows" in tc
    assert "q0 = (kCausal ? gridDim.z - 1 - blockIdx.z : blockIdx.x) * kBwdRows;" in tc
    assert "t_first = kCausal ? min(k0 / kBwdTile, n_tiles) : 0" in tc
    assert "kv_end = kCausal ? min(skv, q0 + kBwdRows) : skv" in tc
    for kern in ("dkdv", "dq"):   # the mask a template parameter, both instantiated
        assert f"causal ? bwd_{kern}_tc_kernel<D, true> : bwd_{kern}_tc_kernel<D, false>" in tc
    assert len(re.findall(r"\(gridDim\.x - 1 - blockIdx\.x\) \* kBQ", cc)) == 2
    assert "q_first = causal ? k0 / kBQ * kBQ : 0" in cc
    assert len(re.findall(r"kv_end = causal \? min\(skv, q0 \+ kBQ\) : skv", cc)) == 2
