"""The tensor-core route of ``flash_attention``'s gradient, on the CPU.

The kernels (``csrc/flash_attention_bwd_sm90.cu``: ``prep``, ``dkdv``,
``dq`` on wgmma) run only on a card; ``chip_smoke.py`` holds them against
the plain version there. Here: a plain emulation of their arithmetic
(each row's log-sum-exp as the forward's tensor-core kernel leaves it, a
running max and sum over its key tiles in log2 units; Delta = rowsum(dO *
O); per query tile dV += bf16(P)^T dO and dK += bf16(dS)^T q, per key
tile dQ += bf16(dS) K, float32 sums, dK and dQ scaled once, one rounding
of each output) held against the float32 gradient of the inputs upcast
(relative norm ``chip_smoke.FLASH_BWD_UPCAST_RNORM``), against
``ref.attention_bwd`` and against ``jax.grad`` of
``repro.kernels.ref.attention`` in bf16 (``FLASH_BWD_BF16_RNORM``), at
ViT-L/16's 197 tokens, ViT-H/14's D 80, the UNet's 77 context keys, its
16-query mid block, one query and a ragged D 128; the tile sizes are read
from the sources. Also: the route rule, a forced route, the launches on
stand-in libraries (the Function's forward writes the log-sum-exp and its
backward reads it; D 80 read in place; a call without a gradient passes a
null lse). Inputs are made from a seed with numpy.
"""
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
from repro_torch.kernels import ref

# one intra-op thread, as in the other port tests run by parallel workers
torch.set_num_threads(1)

SOURCE = flash.BWD_TC_KERNEL.source.read_text()
FWD_SOURCE = flash.KERNEL.source.read_text()


def _constant(name: str, text: str = SOURCE) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


ROWS, TILE = _constant("kBwdRows"), _constant("kBwdTile")
FWD_BK = int(re.search(r"#define FLASH_TC_BK (\d+)", FWD_SOURCE).group(1))
LOG2E = 1.4426950408889634
# chip_smoke.py's FLASH_BWD_UPCAST_RNORM and FLASH_BWD_BF16_RNORM
UPCAST_RNORM, BF16_RNORM = 3.7e-3, 3e-2


def forward_lse(q, k, causal=False):
    """The forward kernel's log-sum-exp of each query row, (B, Hq, Sq), in
    log2 units: x = (q . k) * (sm_scale * log2(e)) in float32 (-1e30 at a
    key past the query's index with ``causal``; query head h reads kv head
    h // (Hq / Hkv)), the running max m and sum l over key tiles of
    ``FWD_BK`` (l rescaled by exp2(m_prev - m_new)), lse = m + log2(l)."""
    d = q.shape[-1]
    rep = q.shape[2] // k.shape[2]
    qf, kf = q.float().transpose(1, 2), k.float().transpose(1, 2).repeat_interleave(rep, 1)
    c = torch.tensor(1 / math.sqrt(d), dtype=torch.float32) * torch.tensor(LOG2E)
    m = torch.full(qf.shape[:3], -1e30)
    l = torch.zeros(qf.shape[:3])
    rows = torch.arange(qf.shape[2])[:, None]
    for k0 in range(0, kf.shape[2], FWD_BK):
        x = (qf @ kf[:, :, k0:k0 + FWD_BK].transpose(-1, -2)) * c
        if causal:
            keys = torch.arange(k0, min(k0 + FWD_BK, kf.shape[2]))[None, :]
            x = torch.where(keys <= rows, x, -1e30)
        mx = torch.maximum(m, x.amax(-1))
        l = l * torch.exp2(m - mx) + torch.exp2(x - mx[..., None]).sum(-1)
        m = mx
    return m + torch.log2(l)


def emulate(q, k, v, o, do, causal=False):
    """The three tensor-core entries' arithmetic on bf16 q, o, do (B, Sq,
    Hq, D) and k, v (B, Skv, Hkv, D) -> bf16 (dq, dk, dv); with ``causal``
    P = dS = 0 at a key past the query's index (the lse the forward's
    masked one); a kv head's dK and dV sum its query heads' shares head by
    head, each over the query tiles in order (dkdv's walk)."""
    d = q.shape[-1]
    rep = q.shape[2] // k.shape[2]
    scale = torch.tensor(1 / math.sqrt(d), dtype=torch.float32)
    c = scale * torch.tensor(LOG2E)
    lse = forward_lse(q, k, causal)
    qf, of, dof = (t.float().transpose(1, 2) for t in (q, o, do))
    kf, vf = (t.float().transpose(1, 2) for t in (k, v))
    delta = (dof * of).sum(-1)
    qpos, kpos = torch.arange(qf.shape[2]), torch.arange(kf.shape[2])
    everything = torch.tensor(True)

    def p_ds(s, dp, lse_, delta_, keep):
        p = torch.where(keep, torch.exp2(s * c - lse_), 0.0)
        return p, p * (dp - delta_)

    # dkdv: each block of ROWS keys over every query tile of each query head
    # j of its kv head (heads j, rep + j, ...), head by head (the key rows
    # are independent, so all blocks at once)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for j in range(rep):
        for q0 in range(0, qf.shape[2], TILE):
            qt, dot = qf[:, j::rep, q0:q0 + TILE], dof[:, j::rep, q0:q0 + TILE]
            keep = kpos[:, None] <= qpos[None, q0:q0 + TILE] if causal else everything
            p, ds = p_ds(kf @ qt.transpose(-1, -2), vf @ dot.transpose(-1, -2),
                         lse[:, j::rep, None, q0:q0 + TILE], delta[:, j::rep, None, q0:q0 + TILE],
                         keep)
            dv += p.bfloat16().float() @ dot
            dk += ds.bfloat16().float() @ qt
    # dq: each block of ROWS queries over every key tile of its kv head
    dq = torch.zeros_like(qf)
    ke, ve = kf.repeat_interleave(rep, 1), vf.repeat_interleave(rep, 1)
    for k0 in range(0, kf.shape[2], TILE):
        kt, vt = ke[:, :, k0:k0 + TILE], ve[:, :, k0:k0 + TILE]
        keep = kpos[None, k0:k0 + TILE] <= qpos[:, None] if causal else everything
        _, ds = p_ds(qf @ kt.transpose(-1, -2), dof @ vt.transpose(-1, -2),
                     lse[..., None], delta[..., None], keep)
        dq += ds.bfloat16().float() @ kt
    out = (dq * scale, dk * scale, dv)
    return tuple(t.bfloat16().transpose(1, 2).contiguous() for t in out)


# (B, Sq, Skv, H, D): ViT-L/16's 197 tokens; ViT-H/14's 257 at D 80; the
# UNet's 77 context keys; its 16-query mid block; one query; ragged D 128
SHAPES = [(2, 197, 197, 4, 64), (2, 257, 257, 4, 80), (2, 200, 77, 4, 64),
          (2, 16, 16, 4, 64), (2, 1, 77, 4, 64), (2, 100, 130, 2, 128)]


def _inputs(shape, seed):
    b, sq, skv, h, d = shape
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((b, sq, h, d)).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, skv, h, d)).astype(np.float32))
            for _ in range(2))
    return [t.bfloat16() for t in (q, k, v, do)]


def _rnorm(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_grads(q, k, v, do):
    """``jax.grad`` of the reference's oracle in bf16."""
    args = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v, do)]
    _, vjp = jax.vjp(lambda a, b, c: jref.attention(a, b, c, causal=False), *args[:3])
    return [np.asarray(g, np.float32) for g in vjp(args[3])]


def test_forward_lse_is_the_log_sum_exp():
    q, k, _, _ = _inputs((2, 70, 150, 3, 80), 5)
    d = q.shape[-1]
    s = (q.float().transpose(1, 2) @ k.float().transpose(1, 2).transpose(-1, -2)).double()
    want = torch.logsumexp(s / math.sqrt(d), -1) * LOG2E
    torch.testing.assert_close(forward_lse(q, k).double(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_emulated_tensor_core_backward(shape):
    """Each of dq, dk, dv within UPCAST_RNORM (relative norm) of the
    float32 gradient of the inputs upcast, and within BF16_RNORM of the
    plain version and of ``jax.grad`` in bf16."""
    q, k, v, do = _inputs(shape, 1)
    o = ref.attention(q, k, v)
    got = emulate(q, k, v, o, do)
    exact = ref.attention_bwd(*(t.float() for t in (q, k, v, o)), do.float())
    want = ref.attention_bwd(q, k, v, o, do)
    for g, x, w, j in zip(got, exact, want, _jax_grads(q, k, v, do)):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert _rnorm(g.float(), x) < UPCAST_RNORM
        assert _rnorm(g.float(), w.float()) < BF16_RNORM
        assert _rnorm(g.float(), j) < BF16_RNORM


def test_tiles_come_from_the_sources():
    assert (ROWS, TILE, FWD_BK) == (64, 64, 64)
    assert _constant("kBwdThreads") == 128 and _constant("kBwdStages") == 2
    assert flash.LSE_ROW_PAD == TILE   # a tile's lse and Delta are one bulk copy
    assert [flash.lse_stride(n) for n in (1, 64, 65, 197, 257)] == [64, 64, 128, 256, 320]


# ---------------------------------------------------------------------------
# the route rule and the wrapper, here without nvcc or a card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "tensor_core"), (torch.bfloat16, 80, "tensor_core"),
    (torch.bfloat16, 128, "tensor_core"), (torch.bfloat16, 96, "cuda_core"),
    (torch.bfloat16, 16, "cuda_core"), (torch.bfloat16, 192, "tensor_core"),
    (torch.bfloat16, 256, "cuda_core"), (torch.float32, 192, "cuda_core"),
    (torch.float32, 64, "cuda_core"), (torch.float32, 80, "cuda_core"),
    (torch.float32, 128, "cuda_core"),
])
def test_choose_bwd_route(dtype, d, route):
    assert flash.choose_bwd_route(dtype, d) == route
    assert flash.TENSOR_CORE_BWD_D == (64, 80, 128, 192)


def test_tensor_core_entries():
    assert flash.BWD_TC_KERNEL.source.name == "flash_attention_bwd_sm90.cu"
    assert list(flash.BWD_TC_SYMBOLS) == list(flash.BWD_ENTRIES)
    assert list(flash.BWD_TC_D192_SYMBOLS) == list(flash.BWD_ENTRIES)
    for sym in (*flash.BWD_TC_SYMBOLS.values(), *flash.BWD_TC_D192_SYMBOLS.values()):
        assert f'extern "C" int {sym}(' in SOURCE
    assert set(flash.BWD_TC_KERNEL.symbols) == (set(flash.BWD_TC_SYMBOLS.values())
                                               | set(flash.BWD_TC_D192_SYMBOLS.values()))
    # the forward's tensor-core entry takes the lse pointer and its stride
    assert len(flash.KERNEL.symbols["flash_attention_bf16_sm90"]) == 15
    assert "void* lse, int b" in FWD_SOURCE and "int causal, int lse_stride" in FWD_SOURCE


@pytest.fixture
def stand_ins(monkeypatch):
    """Stand-in libraries for the forward and both backward libraries (the
    entry points record their arguments and return 0, cudaSuccess) and
    tensors that pass for CUDA ones -> the list of (symbol, args)."""
    calls = []
    kernels = (flash.KERNEL, flash.BWD_KERNEL, flash.BWD_TC_KERNEL)
    for kernel in kernels:
        kernel._lib = SimpleNamespace(**{s: (lambda s: lambda *a: calls.append((s, a)) or 0)(s)
                                         for s in kernel.symbols})
        kernel.reset()
    monkeypatch.setattr(flash, "_check_inputs", lambda q, k, v: None)

    class Stream:
        cuda_stream = 0
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    yield calls
    for kernel in kernels:
        kernel._lib = None
        kernel.reset()


def _bf16(shape, grad=False):
    return torch.zeros(shape, dtype=torch.bfloat16, requires_grad=grad)


def test_backward_launches_the_tensor_core_entries_in_order(stand_ins):
    b, sq, skv, h, d = 2, 5, 70, 3, 64
    q, o, do = (_bf16((b, sq, h, d)) for _ in range(3))
    k, v = (_bf16((b, skv, h, d)) for _ in range(2))
    lse = torch.zeros((b, h, flash.lse_stride(sq)))
    flash.flash_attention_bwd(q, k, v, o, do, lse)
    assert [s for s, _ in stand_ins] == list(flash.BWD_TC_SYMBOLS.values())
    prep, dkdv, dq = (a for _, a in stand_ins)
    assert prep[:2] == (o.data_ptr(), do.data_ptr()) and prep[3:-1] == (b, sq, h, d, 64)
    delta = prep[2]
    for args in (dkdv, dq):
        assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr())
        assert args[4:6] == (lse.data_ptr(), delta)
        assert args[-10:-1] == (b, sq, skv, h, h, d, 0, 64, 1 / math.sqrt(d))
    assert flash.BWD_TC_KERNEL.launches == 3 and flash.BWD_KERNEL.launches == 0


def test_forced_route(stand_ins):
    """``route`` forces either route (the CUDA-core one on a tensor-core
    shape reads no lse); the tensor-core route raises for what it does not
    take: float32, D 96, or no lse of the right shape."""
    q, k, v = (_bf16((1, 8, 2, 64)) for _ in range(3))
    flash.flash_attention_bwd(q, k, v, q, q, route="cuda_core")
    assert [s for s, _ in stand_ins] == [f"flash_attention_bwd_{e}_bf16" for e in flash.BWD_ENTRIES]
    with pytest.raises(ValueError, match="log-sum-exp"):
        flash.flash_attention_bwd(q, k, v, q, q)
    with pytest.raises(ValueError, match="log-sum-exp"):
        flash.flash_attention_bwd(q, k, v, q, q, torch.zeros((1, 2, 8)))
    f32 = [t.float() for t in (q, k, v)]
    with pytest.raises(ValueError, match="no 'tensor_core' kernel"):
        flash.flash_attention_bwd(*f32, f32[0], f32[0], route="tensor_core")
    q96 = _bf16((1, 8, 2, 96))
    with pytest.raises(ValueError, match="no 'tensor_core' kernel"):
        flash.flash_attention_bwd(q96, q96, q96, q96, q96, route="tensor_core")
    with pytest.raises(ValueError, match="no route"):
        flash.flash_attention_bwd(q, k, v, q, q, route="fast")
    assert flash.BWD_TC_KERNEL.launches == 0 and flash.BWD_KERNEL.launches == 3


@pytest.mark.parametrize("d", [64, 80])
def test_the_autograd_function_saves_lse_and_passes_it(stand_ins, d):
    """On the tensor-core route the Function's forward launches the
    forward kernel with an lse buffer (B, H, lse_stride(Sq)) and saves it;
    the backward's dkdv and dq read that buffer, and D 80 reaches them as
    the caller's tensors (no padding copy) with D 80."""
    b, sq, skv, h = 2, 70, 33, 3
    q = _bf16((b, sq, h, d), grad=True)
    k, v = (_bf16((b, skv, h, d), grad=True) for _ in range(2))
    out = flash.flash_attention(q, k, v)
    (sym, fwd), = stand_ins
    assert sym == "flash_attention_bf16_sm90"
    assert fwd[4] is not None and fwd[5:13] == (b, sq, skv, h, h, flash.PADDED_D.get(d, d), 0,
                                                flash.lse_stride(sq))
    saved = out.grad_fn.saved_tensors
    lse = saved[4]
    assert lse.shape == (b, h, flash.lse_stride(sq)) and lse.dtype == torch.float32
    assert lse.data_ptr() == fwd[4]
    torch.autograd.grad(out.float().sum(), (q, k, v))
    assert [s for s, _ in stand_ins[1:]] == list(flash.BWD_TC_SYMBOLS.values())
    for _, args in stand_ins[2:]:
        assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
        assert args[4] == lse.data_ptr() and args[-5] == d
    assert flash.BWD_KERNEL.launches == 0


def test_a_call_without_a_gradient_writes_no_lse(stand_ins):
    """Inference (no input requiring a gradient, or ``torch.no_grad``)
    launches the forward with a null lse pointer, and saves nothing."""
    q, k, v = (_bf16((1, 8, 2, 64), grad=True) for _ in range(3))
    with torch.no_grad():
        flash.flash_attention(q, k, v)
    flash.flash_attention(*(t.detach() for t in (q, k, v)))
    assert [s for s, _ in stand_ins] == ["flash_attention_bf16_sm90"] * 2
    assert all(a[4] is None for _, a in stand_ins)


def test_the_cuda_core_route_keeps_its_forward(stand_ins):
    """float32 under autograd: the forward on its own entry (no lse
    argument), the backward on the CUDA-core entries."""
    q, k, v = (torch.zeros((1, 8, 2, 64), requires_grad=True) for _ in range(3))
    out = flash.flash_attention(q, k, v)
    assert out.grad_fn.saved_tensors[4] is None
    torch.autograd.grad(out.sum(), (q, k, v))
    assert [s for s, _ in stand_ins] == ["flash_attention_f32"] + [
        f"flash_attention_bwd_{e}_f32" for e in flash.BWD_ENTRIES]
    assert len(stand_ins[0][1]) == 13
