"""The gradient of the port's ``flash_attention``, on the CPU.

The backward kernel (``csrc/flash_attention_bwd.cu``: ``prep``,
``dkdv``, ``dq``) runs only on a card; ``chip_smoke.py`` holds it
against the plain version there. Here: a plain emulation of its tiled
arithmetic (each query row's log-sum-exp recomputed over key tiles with
a running max and sum, Delta = rowsum(dO * O); per key tile dV += P^T dO
and dK += dS^T (q * sm_scale) over every query tile; per query tile dQ
+= dS K over every key tile, scaled once; the last tiles masked; float32
sums, one rounding to the inputs' type) held against ``ref.attention_bwd``
(``torch.autograd.grad`` of the plain version) and against ``jax.grad``
of ``repro.kernels.ref.attention``, at ViT-L/16's 197 tokens (D 64),
ViT-H/14's 257 (D 80, read as 80 columns), the UNet's 77 context keys
and 64-query mid block, and one query, in float32 and bf16 (the causal
GQA shapes of the LMs are tests/test_torch_flash_bwd_causal.py's, through
the same emulation). The tile sizes are read from the source. Also: the
limit the wrapper raises for (D > 128) before any launch, the wrapper's refusal of
CPU tensors, the entries and their counts, and a CPU ``ops.attention``
under autograd (the plain version's gradient). Inputs are made from a
seed with numpy.
"""
import dataclasses
import math
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ops, ref

# one intra-op thread, as in the other port tests run by parallel workers
torch.set_num_threads(1)

SOURCE = flash.BWD_KERNEL.source.read_text()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


BQ, BK = _constant("kBQ"), _constant("kBK")
# float32: the kernel's contract (chip_smoke.py's FLASH_BWD_F32_TOL);
# bf16: relative norm of each gradient against the plain version in
# bf16, which rounds the scaled q, the weights and their gradient to bf16
# where the kernel keeps float32 (chip_smoke.py's FLASH_BWD_BF16_RNORM)
F32_TOL, BF16_RNORM = 2e-5, 3e-2


def emulate(q, k, v, o, do, causal=False):
    """The three entries' arithmetic on q, o, do (B, Sq, Hq, D) and k, v
    (B, Skv, Hkv, D) -> (dq, dk, dv) in q's dtype. Tiles of BQ queries and
    BK keys padded with zeros as the kernel's shared memory is; keys past
    Skv, queries past Sq and, with ``causal``, keys past the query's index
    get P = 0; query head h reads kv head h // (Hq / Hkv), and a kv head's
    dK and dV sum its query heads' shares head by head."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    scale = torch.tensor(1 / math.sqrt(d), dtype=torch.float32)
    nq, nk = -(-sq // BQ) * BQ, -(-skv // BK) * BK

    def heads(t, n):   # (B, S, H, D) -> (B, H, n, D) float32, zero rows past S
        t = t.float().transpose(1, 2)
        return torch.nn.functional.pad(t, (0, 0, 0, n - t.shape[2]))
    qs, dof, of = heads(q, nq) * scale, heads(do, nq), heads(o, nq)
    kf, vf = (heads(t, nk).repeat_interleave(rep, 1) for t in (k, v))   # a query head's
    q_in = (torch.arange(nq) < sq)[:, None]   # (queries, 1)
    k_in = (torch.arange(nk) < skv)[None, :]  # (1, keys)
    if causal:
        k_in = k_in & (torch.arange(nk)[None, :] <= torch.arange(nq)[:, None])

    # prep: lse over key tiles (running max and sum), Delta
    delta = (dof * of).sum(-1)
    lse = torch.empty((b, h, nq))
    for q0 in range(0, nq, BQ):
        m = torch.full((b, h, BQ), -1e30)
        l = torch.zeros((b, h, BQ))
        for k0 in range(0, nk, BK):
            s = qs[:, :, q0:q0 + BQ] @ kf[:, :, k0:k0 + BK].transpose(-1, -2)
            valid = k_in[q0:q0 + BQ, k0:k0 + BK] if causal else k_in[:, k0:k0 + BK]
            mx = torch.maximum(m, s.masked_fill(~valid, -torch.inf).amax(-1))
            l = l * torch.exp(m - mx) + torch.where(valid, torch.exp(s - mx[..., None]),
                                                    0.0).sum(-1)
            m = mx
        lse[:, :, q0:q0 + BQ] = m + torch.log(l)
    lse = torch.where(q_in[:, 0], lse, 0.0)
    delta = torch.where(q_in[:, 0], delta, 0.0)

    def p_ds(q0, k0):
        qt, kt = slice(q0, q0 + BQ), slice(k0, k0 + BK)
        s = qs[:, :, qt] @ kf[:, :, kt].transpose(-1, -2)
        keys = k_in[qt, kt] if causal else k_in[:, kt]
        p = torch.where(q_in[qt] & keys, torch.exp(s - lse[:, :, qt, None]), 0.0)
        dp = dof[:, :, qt] @ vf[:, :, kt].transpose(-1, -2)
        return p, p * (dp - delta[:, :, qt, None])

    # dkdv: a key tile over every query tile of each of its kv head's
    # query heads j (heads j, rep + j, ... of the query side), head by head
    dk, dv = torch.empty((b, hkv, nk, d)), torch.empty((b, hkv, nk, d))
    for k0 in range(0, nk, BK):
        dka = torch.zeros((b, hkv, BK, d))
        dva = torch.zeros((b, hkv, BK, d))
        for j in range(rep):
            for q0 in range(0, nq, BQ):
                p, ds = (t[:, j::rep] for t in p_ds(q0, k0))
                dva += p.transpose(-1, -2) @ dof[:, j::rep, q0:q0 + BQ]
                dka += ds.transpose(-1, -2) @ qs[:, j::rep, q0:q0 + BQ]
        dk[:, :, k0:k0 + BK], dv[:, :, k0:k0 + BK] = dka, dva
    # dq: a query tile over every key tile, scaled once
    dq = torch.empty_like(qs)
    for q0 in range(0, nq, BQ):
        dqa = torch.zeros((b, h, BQ, d))
        for k0 in range(0, nk, BK):
            dqa += p_ds(q0, k0)[1] @ kf[:, :, k0:k0 + BK]
        dq[:, :, q0:q0 + BQ] = dqa * scale
    out = (dq[:, :, :sq], dk[:, :, :skv], dv[:, :, :skv])
    return tuple(t.transpose(1, 2).to(q.dtype).contiguous() for t in out)


# (B, Sq, Skv, H, D): ViT-L/16's 197 tokens; ViT-H/14's 257 at D 80; the
# UNet's cross-attention to 77 context keys and its 64-query mid block;
# one query
SHAPES = [(2, 197, 197, 4, 64), (2, 257, 257, 4, 80), (2, 200, 77, 4, 64),
          (2, 64, 64, 4, 64), (2, 1, 77, 4, 64)]


def _inputs(shape, dtype, seed):
    b, sq, skv, h, d = shape
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((b, sq, h, d)).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, skv, h, d)).astype(np.float32))
            for _ in range(2))
    return [t.to(dtype) for t in (q, k, v, do)]


def _rnorm(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_grads(q, k, v, do):
    """``jax.grad`` of the reference's oracle, in the inputs' dtype."""
    dt = jnp.bfloat16 if q.dtype == torch.bfloat16 else jnp.float32
    args = [jnp.asarray(t.float().numpy(), dt) for t in (q, k, v, do)]
    _, vjp = jax.vjp(lambda a, b, c: jref.attention(a, b, c, causal=False), *args[:3])
    return [np.asarray(g, np.float32) for g in vjp(args[3])]


@pytest.mark.parametrize("shape", SHAPES)
def test_emulated_backward_matches_the_plain_version_in_float32(shape):
    q, k, v, do = _inputs(shape, torch.float32, 0)
    o = ref.attention(q, k, v)
    got = emulate(q, k, v, o, do)
    want = ref.attention_bwd(q, k, v, o, do)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        torch.testing.assert_close(g, w, atol=F32_TOL, rtol=F32_TOL)
    for g, w in zip(got, _jax_grads(q, k, v, do)):
        np.testing.assert_allclose(g.numpy(), w, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_emulated_backward_matches_the_plain_version_in_bf16(shape):
    """Relative norm of each gradient within BF16_RNORM of the plain
    version and of ``jax.grad`` in bf16, and within one bf16 rounding
    (relative norm 2^-8) of the float32 gradient of the same inputs: the
    kernel's sums are float32, only its outputs round."""
    q, k, v, do = _inputs(shape, torch.bfloat16, 1)
    o = ref.attention(q, k, v)
    got = emulate(q, k, v, o, do)
    want = ref.attention_bwd(q, k, v, o, do)
    exact = ref.attention_bwd(*(t.float() for t in (q, k, v, o)), do.float())
    for g, w, j, x in zip(got, want, _jax_grads(q, k, v, do), exact):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert _rnorm(g.float(), w.float()) < BF16_RNORM
        assert _rnorm(g.float(), j) < BF16_RNORM
        assert _rnorm(g.float(), x) < 2.0 ** -8


def test_tiles_come_from_the_source():
    assert (BQ, BK) == (64, 64)
    assert _constant("kThreads") == 256


# ---------------------------------------------------------------------------
# the wrapper, here without nvcc or a card
# ---------------------------------------------------------------------------

def _requiring_grad(shape_q, shape_k):
    q = torch.zeros(shape_q, requires_grad=True)
    k, v = (torch.zeros(shape_k) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("causal,shape_k,match", [
    (True, (1, 8, 2, 192), "D <= 128"),
    (False, (1, 8, 1, 192), "D <= 128"),
])
def test_backward_limits_raise_before_any_launch(causal, shape_k, match):
    """D > 128 (MLA's 192), causal or not, GQA or not, raises a ValueError
    naming the limit where an input requires a gradient (the check comes
    before the device's), and no library is loaded; at D 128 the causal
    mask and GQA pass it and reach the device check."""
    q, k, v = _requiring_grad((1, 8, 2, 192), shape_k)
    with pytest.raises(ValueError, match=match):
        flash.flash_attention(q, k, v, causal=causal)
    with pytest.raises(ValueError, match=match):
        flash.flash_attention_bwd(q, k, v, q, q, causal=causal)
    q, k, v = _requiring_grad((1, 8, 2, 128), shape_k[:3] + (128,))
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention(q, k, v, causal=causal)
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention_bwd(q, k, v, q.detach(), q.detach(), causal=causal)
    assert flash.KERNEL._lib is None and flash.BWD_KERNEL._lib is None
    assert flash.KERNEL.launches == 0 and flash.BWD_KERNEL.launches == 0


def test_backward_limits_head_dim():
    q, k, v = _requiring_grad((1, 8, 2, 192), (1, 8, 2, 192))
    with pytest.raises(ValueError, match="D <= 128"):
        flash.flash_attention(q, k, v)
    flash.check_backward((1, 8, 2, 128), (1, 8, 2, 128))
    flash.check_backward((1, 8, 4, 128), (1, 8, 2, 128))   # GQA


@pytest.mark.parametrize("grad", [False, True])
def test_wrappers_refuse_cpu_tensors(grad):
    """Within the limits, a CPU tensor reaches the device check: the
    wrappers launch their kernels or raise."""
    q, k, v = (torch.zeros(1, 8, 2, 16, requires_grad=grad) for _ in range(3))
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention_bwd(q, k, v, q.detach(), q.detach())


def test_no_gradient_takes_the_forward_alone(monkeypatch):
    """Under ``torch.no_grad``, or with no input requiring a gradient,
    ``flash_attention`` is the forward call as it was: no autograd
    Function, nothing saved."""
    calls = []
    monkeypatch.setattr(flash, "_forward", lambda *a: calls.append(a) or a[0])
    monkeypatch.setattr(flash._FlashAttention, "apply", lambda *a: pytest.fail("applied"))
    q = torch.zeros(1, 8, 2, 16, requires_grad=True)
    with torch.no_grad():
        flash.flash_attention(q, q, q)
    flash.flash_attention(*(torch.zeros(1, 8, 2, 16) for _ in range(3)), causal=True)
    assert len(calls) == 2 and calls[1][3] is True


def test_the_autograd_function_saves_and_calls_the_backward(monkeypatch):
    """The Function's forward is the forward call (made contiguous); its
    backward hands q, k, v, the output and the output's gradient to
    ``flash_attention_bwd`` and returns its (dq, dk, dv). float32 takes
    the CUDA-core route, which reads no log-sum-exp of the forward."""
    seen = {}

    def fake_bwd(q, k, v, o, dout, lse=None, causal=False, route=None):
        seen.update(q=q, k=k, v=v, o=o, dout=dout, lse=lse, causal=causal, route=route)
        return 2 * q, 3 * k, 4 * v
    monkeypatch.setattr(flash, "_forward", lambda q, k, v, causal, route: q + v)
    monkeypatch.setattr(flash, "flash_attention_bwd", fake_bwd)
    q, k, v = (torch.full((1, 8, 2, 16), float(i + 1), requires_grad=True) for i in range(3))
    out = flash.flash_attention(q, k, v)
    assert torch.equal(out, q.detach() + v.detach())
    dq, dk, dv = torch.autograd.grad(out.sum(), (q, k, v))
    assert torch.equal(seen["o"], out.detach()) and torch.equal(seen["dout"], torch.ones_like(q))
    assert seen["lse"] is None and seen["route"] == "cuda_core" and seen["causal"] is False
    assert torch.equal(dq, 2 * q) and torch.equal(dk, 3 * k) and torch.equal(dv, 4 * v)


def test_backward_entries_and_counts():
    assert flash.BWD_KERNEL.source.name == "flash_attention_bwd.cu"
    assert flash.BWD_KERNEL in ops.KERNELS and flash.KERNEL in ops.KERNELS
    assert set(flash.BWD_KERNEL.symbols) == {
        f"flash_attention_bwd_{e}_{t}" for e in ("prep", "dkdv", "dq") for t in ("f32", "bf16")}
    for (entry, _), sym in flash.BWD_SYMBOLS.items():
        assert f'extern "C" int {sym}(' in SOURCE
        n_ptr = {"prep": 6, "dkdv": 8, "dq": 7}[entry]
        # b, sq, skv, hq, hkv, d, causal; sm_scale and the stream
        assert len(flash.BWD_KERNEL.symbols[sym]) == n_ptr + 7 + 2


def test_backward_launches_three_entries_in_order(monkeypatch):
    """A stand-in library (the entry points return 0, cudaSuccess) and
    tensors that pass for CUDA ones: one launch of each entry, in order,
    each counted (bf16 D 80 forced onto the CUDA-core route; the
    tensor-core route's launches are tests/test_torch_flash_bwd_tc.py's)."""
    kernel = flash.BWD_KERNEL
    order = []
    kernel._lib = SimpleNamespace(**{s: (lambda s: lambda *a: order.append((s, a)) or 0)(s)
                                     for s in kernel.symbols})
    monkeypatch.setattr(flash, "_check_inputs", lambda q, k, v: None)

    class Stream:
        cuda_stream = 0
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    try:
        kernel.reset()
        q, k, v, o, do = (torch.zeros(2, 5, 3, 80, dtype=torch.bfloat16) for _ in range(5))
        flash.flash_attention_bwd(q, k, v, o, do, route="cuda_core")
        assert [s for s, _ in order] == [f"flash_attention_bwd_{e}_bf16"
                                         for e in ("prep", "dkdv", "dq")]
        assert all(a[-9:-2] == (2, 5, 5, 3, 3, 80, 0) and a[-2] == 1 / math.sqrt(80)
                   for _, a in order)
        assert kernel.launches == 3
        assert {s: n for s, n in kernel.symbol_launches.items() if n} == {
            s: 1 for s, _ in order}
    finally:
        kernel._lib = None
        kernel.reset()


def test_cpu_attention_under_autograd_is_the_plain_versions_gradient():
    q, k, v, do = _inputs((2, 33, 20, 3, 16), torch.float32, 3)
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    out = ops.attention(qq, kk, vv)
    assert torch.equal(out.detach(), ref.attention(q, k, v))
    got = torch.autograd.grad(out, (qq, kk, vv), do)
    for g, w in zip(got, ref.attention_bwd(q, k, v, out.detach(), do)):
        assert torch.equal(g, w)
    assert flash.BWD_KERNEL.launches == 0 and flash.KERNEL.launches == 0


def test_the_autograd_function_under_remat(monkeypatch):
    """Inside a rematerialized block (``layers.remat``, as the training
    forwards wrap theirs) the Function's forward runs twice, once in the
    forward and once in the backward's recompute, its backward once, and
    the gradients equal those without remat: the forward and backward
    replaced by the plain versions, so it runs here."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import layers as L
    calls = {"forward": 0, "backward": 0}

    def fwd(q, k, v, causal, route):
        calls["forward"] += 1
        return ref.attention(q, k, v, causal=causal)

    def bwd(q, k, v, o, dout, lse=None, causal=False, route=None):
        calls["backward"] += 1
        return ref.attention_bwd(q, k, v, o, dout, causal=causal)
    monkeypatch.setattr(flash, "_forward", fwd)
    monkeypatch.setattr(flash, "flash_attention_bwd", bwd)
    rng = np.random.default_rng(4)
    x, w = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((2, 20, 48), (48, 144)))

    def block(w, x):
        q, k, v = (t.reshape(2, 20, 3, 16).contiguous() for t in (x @ w).chunk(3, dim=-1))
        return torch.tanh(flash.flash_attention(q, k, v)).sum()
    grads = {}
    for remat in ("none", "dots_saveable"):
        cfg = dataclasses.replace(reduced(get_config("vit-l16")), remat=remat)
        calls.update(forward=0, backward=0)
        ww, xx = w.clone().requires_grad_(), x.clone().requires_grad_()
        grads[remat] = torch.autograd.grad(L.remat(block, cfg, True)(ww, xx), (ww, xx))
        assert calls == {"forward": 1 if remat == "none" else 2, "backward": 1}
    for a, b in zip(grads["none"], grads["dots_saveable"]):
        assert torch.equal(a, b)
