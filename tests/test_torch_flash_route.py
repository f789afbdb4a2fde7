"""The two routes of the port's ``flash_attention``, on the CPU.

The tensor-core kernel (``flash_attention_bf16_sm90`` in
``csrc/flash_attention.cu``) runs only on a card; ``chip_smoke.py``
holds it against the plain version there. Here: the route rule and the
per-entry launch counts, and a plain emulation of the tensor-core
kernel's arithmetic (exact bf16 products, the scale applied after the
product, online softmax over key tiles, p fed to the second product as
two bf16 halves) held against the reference's Pallas kernel (interpret
mode) and its oracle on float32-upcast inputs, within the tolerance
``chip_smoke.py`` applies on the card (rtol 2^-7, atol 1e-5), at D 64,
128 and 192, at D 80 as the wrapper sends it (ViT-H/14's heads: q, k, v
zero-padded to 128, ``sm_scale = 1/sqrt(80)``, the padded output
columns exactly 0 and cut), at ViT's ragged non-causal lengths (197 and
257 tokens), and on an MLA-shaped input (deepseek-v2-lite's prefill:
q/k heads of 128 + 64, v zero-padded to 192, whose padded columns come
out exactly 0). The same emulation with one bf16 p misses that
tolerance: the reason for the split. Inputs are made from a seed with
numpy.
"""
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as flash

# one intra-op thread, as in the other port tests run by parallel workers
torch.set_num_threads(1)

RTOL, ATOL = 2.0 ** -7, 1e-5  # chip_smoke.FLASH_BF16_RTOL / FLASH_BF16_ATOL
LOG2E = 1.4426950408889634


# ---------------------------------------------------------------------------
# the route rule and the launch counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "tensor_core"), (torch.bfloat16, 128, "tensor_core"),
    (torch.bfloat16, 192, "tensor_core"), (torch.bfloat16, 80, "tensor_core"),
    (torch.bfloat16, 16, "cuda_core"), (torch.bfloat16, 96, "cuda_core"),
    (torch.bfloat16, 100, "cuda_core"), (torch.bfloat16, 256, "cuda_core"),
    (torch.float32, 64, "cuda_core"), (torch.float32, 128, "cuda_core"),
    (torch.float32, 256, "cuda_core"),
])
def test_choose_route(dtype, d, route):
    assert flash.choose_route(dtype, d) == route
    assert flash.SYMBOLS[route, dtype] in flash.KERNEL.symbols


def test_d80_is_padded_to_a_native_head_dim():
    """The kernel has instantiations at ``TENSOR_CORE_D`` only (phase 1
    of chip_smoke.py checks each); D 80 reaches it zero-padded to 128."""
    assert flash.TENSOR_CORE_D == (64, 128, 192)
    assert flash.PADDED_D == {80: 128}
    assert all(dp in flash.TENSOR_CORE_D and dp > d for d, dp in flash.PADDED_D.items())


def test_every_route_has_one_entry_in_one_library():
    assert flash.SYMBOLS == {("tensor_core", torch.bfloat16): "flash_attention_bf16_sm90",
                             ("cuda_core", torch.float32): "flash_attention_f32",
                             ("cuda_core", torch.bfloat16): "flash_attention_bf16"}
    assert set(flash.KERNEL.symbols) == set(flash.SYMBOLS.values())
    assert flash.KERNEL.source.name == "flash_attention.cu"
    assert set(flash.KERNEL.symbol_launches) == set(flash.SYMBOLS.values())


def test_launches_are_counted_per_entry():
    """``launches`` counts every entry of a library, ``symbol_launches``
    each one; ``reset`` zeroes both (a library stand-in whose entry
    points return 0, cudaSuccess)."""
    kernel = _build.CudaKernel("flash_attention", {"a": [], "b": []})
    kernel._lib = SimpleNamespace(a=lambda *args: 0, b=lambda *args: 0)
    for sym in ("a", "a", "b"):
        kernel.launch(sym)
    assert kernel.launches == 3 and kernel.symbol_launches == {"a": 2, "b": 1}
    kernel.reset()
    assert kernel.launches == 0 and kernel.symbol_launches == {"a": 0, "b": 0}
    kernel._lib = SimpleNamespace(a=lambda *args: 700, b=lambda *args: 0)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        kernel.launch("a")
    assert kernel.launches == 0 and kernel.symbol_launches == {"a": 0, "b": 0}


# ---------------------------------------------------------------------------
# the tensor-core kernel's arithmetic, emulated
# ---------------------------------------------------------------------------

def emulate(q, k, v, *, causal, split=True, bk=64, sm_scale=None):
    """The tensor-core kernel's arithmetic on bf16 q (B, Sq, Hq, D) and
    k, v (B, Skv, Hkv, D) -> bf16 (B, Sq, Hq, D): s = q . k in float32
    (products of bf16 are exact), times sm_scale (1/sqrt(D) unless
    given) * log2(e) after the
    product; masked s = -1e30; over key tiles of ``bk``, the running max
    m and sum l with alpha = exp2(m_prev - m_new); p as bf16(p) plus
    bf16(p - bf16(p)) (or one bf16 p without ``split``); acc / max(l,
    1e-30) rounded once to bf16."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    qf = q.float().transpose(1, 2)
    kf = k.float().transpose(1, 2).repeat_interleave(rep, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(rep, dim=1)
    sm_scale = 1 / math.sqrt(d) if sm_scale is None else sm_scale
    c = torch.tensor(sm_scale, dtype=torch.float32) * torch.tensor(LOG2E)
    m = torch.full((b, hq, sq), -1e30)
    l = torch.zeros((b, hq, sq))
    acc = torch.zeros((b, hq, sq, d))
    qpos = torch.arange(sq)[:, None]
    for k0 in range(0, skv, bk):
        x = (qf @ kf[:, :, k0:k0 + bk].transpose(-1, -2)) * c
        if causal:
            x = x.masked_fill(torch.arange(k0, min(k0 + bk, skv))[None, :] > qpos, -1e30)
        mx = torch.maximum(m, x.amax(-1))
        alpha = torch.exp2(m - mx)
        p = torch.exp2(x - mx[..., None])
        l = l * alpha + p.sum(-1)
        m = mx
        vt = vf[:, :, k0:k0 + bk]
        hi = p.bfloat16().float()
        pv = hi @ vt
        if split:
            pv = pv + (p - hi).bfloat16().float() @ vt
        acc = acc * alpha[..., None] + pv
    return (acc / l.clamp(min=1e-30)[..., None]).bfloat16().transpose(1, 2)


def emulate_route(q, k, v, *, causal, split=True, bk=64, scale_d=None):
    """The wrapper and the kernel on the tensor-core route: a head dim of
    ``PADDED_D`` zero-padded to its native width, ``sm_scale`` of the
    true D (of ``scale_d`` if given), the padded output columns (exactly
    0, checked) cut."""
    d = q.shape[-1]
    dk = flash.PADDED_D.get(d, d)
    padded = [F.pad(t, (0, dk - d)) for t in (q, k, v)]
    out = emulate(*padded, causal=causal, split=split, bk=bk,
                  sm_scale=1 / math.sqrt(scale_d or d))
    assert out.shape[-1] == dk and bool((out[..., d:] == 0).all())
    return out[..., :d]


def _qkv(seed, b, sq, skv, hq, hkv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, skv, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, skv, hkv, d), dtype=np.float32)
    return tuple(torch.from_numpy(a).bfloat16() for a in (q, k, v))


# (b, sq, skv, hq, hkv, d, causal): the prefill's GQA and head dim,
# ragged lengths, D 64, Hq = Hkv, Sq < Skv; then D 192 (MLA's q/k heads);
# then ViT's non-causal attention, ViT-L/16's 197 tokens at D 64 and
# ViT-H/14's 257 at D 80 (zero-padded to 128), and D 80 at lengths the
# Pallas kernel takes
SHAPES = [(1, 256, 256, 4, 2, 128, True), (1, 200, 200, 4, 2, 128, True),
          (2, 256, 256, 4, 2, 64, False), (1, 256, 256, 4, 4, 128, True),
          (1, 128, 384, 4, 2, 128, False),
          (1, 256, 256, 4, 4, 192, True), (1, 200, 200, 4, 2, 192, True),
          (1, 128, 384, 4, 2, 192, False),
          (1, 197, 197, 4, 4, 64, False), (2, 257, 257, 4, 4, 80, False),
          (1, 256, 256, 4, 4, 80, False), (1, 128, 384, 4, 2, 80, True)]


def _upcast(t):
    return t.float().numpy()


@pytest.mark.parametrize("bk", [64, 128])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_emulated_kernel_matches_reference_on_upcast_inputs(shape, bk):
    """Within one bf16 rounding of the float32 algorithm: the reference's
    oracle on float32-upcast inputs, and its Pallas kernel in interpret
    mode where the lengths are multiples of its 128-row blocks."""
    *dims, causal = shape
    q, k, v = _qkv(sum(dims), *dims)
    got = emulate_route(q, k, v, causal=causal, bk=bk).float().numpy()
    up = [_upcast(t) for t in (q, k, v)]
    np.testing.assert_allclose(got, np.asarray(jref.attention(*up, causal=causal)),
                               rtol=RTOL, atol=ATOL)
    if dims[1] % 128 == 0 and dims[2] % 128 == 0:
        np.testing.assert_allclose(
            got, np.asarray(pallas_flash(*up, causal=causal, interpret=True)),
            rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_one_bf16_p_misses_the_tolerance(shape):
    """What SDPA and FA3 do, one bf16 p into the second product, leaves
    ~10% of the outputs outside rtol 2^-7, atol 1e-5 (the outputs near
    zero, where p's rounding is not relative to the output)."""
    *dims, causal = shape
    q, k, v = _qkv(sum(dims), *dims)
    want = np.asarray(jref.attention(*[_upcast(t) for t in (q, k, v)], causal=causal))
    one = emulate_route(q, k, v, causal=causal, split=False).float().numpy()
    outside = np.abs(one - want) > ATOL + RTOL * np.abs(want)
    assert outside.mean() > 0.05, outside.mean()
    two = emulate_route(q, k, v, causal=causal).float().numpy()
    assert not (np.abs(two - want) > ATOL + RTOL * np.abs(want)).any()


def test_emulated_kernel_on_mla_prefill_keeps_padded_columns_zero():
    """MLA's prefill attention as ``lm._mla_attend`` calls it, at the
    full model's head widths and the reduced deepseek's batch and heads
    (2 rows, Hq = Hkv = 4): q/k heads of nope 128 + rope 64 (the rope
    part of k one head, broadcast), v of 128 zero-padded to 192, 200
    positions (a ragged last tile). The padded columns come out exactly
    0 in the emulation and the reference; the first 128 are within the
    stated tolerance of the reference on float32-upcast inputs."""
    b, s, h, nope, rope, vd = 2, 200, 4, 128, 64, 128
    rng = np.random.default_rng(192)
    q = rng.standard_normal((b, s, h, nope + rope), dtype=np.float32)
    k_rope = np.broadcast_to(rng.standard_normal((b, s, 1, rope), dtype=np.float32),
                             (b, s, h, rope))
    k = np.concatenate([rng.standard_normal((b, s, h, nope), dtype=np.float32), k_rope], -1)
    v = np.pad(rng.standard_normal((b, s, h, vd), dtype=np.float32),
               [(0, 0)] * 3 + [(0, nope + rope - vd)])
    q, k, v = (torch.from_numpy(np.ascontiguousarray(a)).bfloat16() for a in (q, k, v))
    assert flash.choose_route(q.dtype, q.shape[-1]) == "tensor_core"
    got = emulate(q, k, v, causal=True).float().numpy()
    want = np.asarray(jref.attention(*[_upcast(t) for t in (q, k, v)], causal=True))
    assert got.shape == want.shape == (b, s, h, nope + rope)
    assert (got[..., vd:] == 0).all() and (want[..., vd:] == 0).all()
    np.testing.assert_allclose(got[..., :vd], want[..., :vd], rtol=RTOL, atol=ATOL)


def test_padded_d80_needs_the_true_head_dims_scale():
    """ViT-H/14's attention (257 tokens, heads of 80, non-causal) padded
    to 128: with ``sm_scale = 1/sqrt(80)`` within the tolerance of the
    reference on float32-upcast inputs; with the padded width's
    1/sqrt(128) (what the kernel would take from the tensor it is given)
    far outside it."""
    q, k, v = _qkv(80, 1, 257, 257, 4, 4, 80)
    want = np.asarray(jref.attention(*[_upcast(t) for t in (q, k, v)]))
    np.testing.assert_allclose(emulate_route(q, k, v, causal=False).float().numpy(), want,
                               rtol=RTOL, atol=ATOL)
    wrong = emulate_route(q, k, v, causal=False, scale_d=128).float().numpy()
    assert (np.abs(wrong - want) > ATOL + RTOL * np.abs(want)).mean() > 0.5


# ---------------------------------------------------------------------------
# the diffusion models' attention: DiT-S/2's and the UNet's heads are 64
# wide, so every call takes the kernel's native D 64 instantiation, at
# shapes no other path gives it: the UNet's cross-attention (77 keys, a
# partial last key tile, Sq >> Skv), the mid block's 64 tokens (less than
# one 128-row query tile), and ragged lengths
# ---------------------------------------------------------------------------

# (b, sq, skv, hq, hkv, d): full-width shapes of chip_smoke.py phase 14
# (B, Sq, Skv, H, H, 64)
DIFFUSION_FULL = [(16, 4096, 77, 5, 5, 64), (16, 4096, 4096, 5, 5, 64),
                  (16, 64, 64, 20, 20, 64), (4, 4096, 4096, 6, 6, 64),
                  (16, 1024, 1024, 6, 6, 64), (4, 16384, 77, 5, 5, 64)]
# emulated here: the ragged cross case, the mid block, a cross case with
# a whole query tile, 77 keys against 128-key tiles, Sq 1
DIFFUSION_SMALL = [(2, 200, 77, 4, 4, 64), (1, 64, 64, 4, 4, 64), (1, 256, 77, 5, 5, 64),
                   (1, 130, 77, 2, 2, 64), (2, 1, 77, 2, 2, 64)]


@pytest.mark.parametrize("shape", DIFFUSION_FULL, ids=lambda s: "x".join(map(str, s)))
def test_diffusion_shapes_take_the_native_tensor_core_entry(shape):
    """bf16 at D 64: the tensor-core route, unpadded (64 is a native
    width, not a ``PADDED_D``), and the launch grid within the kernel's
    limits (query tiles of 128 on grid z, up to 128 tiles at 16384)."""
    b, sq, skv, hq, hkv, d = shape
    assert flash.choose_route(torch.bfloat16, d) == "tensor_core"
    assert d in flash.TENSOR_CORE_D and d not in flash.PADDED_D
    assert -(-sq // 128) <= flash.MAX_GRID_YZ and max(b, hq) <= flash.MAX_GRID_YZ


@pytest.mark.parametrize("bk", [64, 128])
@pytest.mark.parametrize("shape", DIFFUSION_SMALL, ids=lambda s: "x".join(map(str, s)))
def test_emulated_kernel_at_diffusion_shapes(shape, bk):
    """The kernel's arithmetic at the diffusion shapes, non-causal,
    within one bf16 rounding of the reference's oracle on float32-upcast
    inputs (rtol 2^-7, atol 1e-5): the last key tile holds 13 (or 77 of
    128) valid keys, the rest of it is never read."""
    q, k, v = _qkv(sum(shape), *shape)
    got = emulate_route(q, k, v, causal=False, bk=bk).float().numpy()
    want = np.asarray(jref.attention(*[_upcast(t) for t in (q, k, v)], causal=False))
    assert got.shape == want.shape == (shape[0], shape[1], shape[3], shape[5])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", DIFFUSION_SMALL, ids=lambda s: "x".join(map(str, s)))
def test_plain_version_matches_reference_at_diffusion_shapes(shape):
    """The port's plain version (what a CPU tensor takes) against the
    reference's ``ref.attention`` on the same bf16 inputs, non-causal:
    the same mixed precision, so 99% bit-equal; the float32 sums' order
    may round a softmax weight to bf16 the other way, which moves an
    output by 2^-8 of that weight times a value of v (measured at most
    2.4e-4, in 5 of 16640 values): atol 2e-3."""
    from repro_torch.kernels import ref as tref
    q, k, v = _qkv(sum(shape) + 1, *shape)
    got = tref.attention(q, k, v, causal=False).float().numpy()
    want = np.asarray(jref.attention(*(jnp_bf16(t) for t in (q, k, v)), causal=False),
                      np.float32)
    assert np.mean(got == want) >= 0.99
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=2e-3)


def jnp_bf16(t):
    import jax.numpy as jnp
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)
