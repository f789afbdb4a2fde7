"""Neural-net primitives of the port: initializers, convolution (NHWC/
HWIO at the boundary), RMSNorm, RoPE and SwiGLU.

Counterpart of ``repro/models/layers.py``. Tensors keep JAX's layout at
the public functions: activations NHWC and weights HWIO for the
convolutions, dense weights (d_in, d_out) used as ``x @ w``. Inside, a
contiguous NHWC tensor permuted to NCHW is a channels-last view, which
cuDNN takes without a copy. Norm and RoPE compute in float32 and cast
back to the input's dtype, as the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def truncated_normal(gen: torch.Generator, shape, stddev: float,
                     dtype=torch.float32) -> torch.Tensor:
    """Normal on [-2, 2] times ``stddev``, drawn in float32 on the
    generator's device (a CPU generator gives the same weights whatever
    device they are moved to), then cast to ``dtype``."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(stddev).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype=torch.float32,
               stddev: float = None, lead=()) -> torch.Tensor:
    """(*lead, d_in, d_out) weights, stddev 1/sqrt(d_in) unless given;
    ``lead`` stacks layers on a leading axis."""
    stddev = stddev if stddev is not None else 1.0 / math.sqrt(d_in)
    return truncated_normal(gen, (*lead, d_in, d_out), stddev, dtype)


def conv_init(gen: torch.Generator, kh: int, kw: int, c_in: int, c_out: int,
              dtype=torch.float32) -> torch.Tensor:
    """HWIO conv weights with fan-in scaling, as the reference's."""
    return truncated_normal(gen, (kh, kw, c_in, c_out),
                            1.0 / math.sqrt(kh * kw * c_in), dtype)


def _same_pads(size: int, k: int, stride: int):
    """XLA's ``padding="SAME"``: (lo, hi) with the odd pixel at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d_nchw(x: torch.Tensor, w_oihw: torch.Tensor, stride: int = 1):
    """SAME convolution of an NCHW tensor with OIHW weights, no bias."""
    kh, kw = w_oihw.shape[2], w_oihw.shape[3]
    ph = _same_pads(x.shape[2], kh, stride)
    pw = _same_pads(x.shape[3], kw, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w_oihw, stride=stride, padding=(ph[0], pw[0]))
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w_oihw,
                    stride=stride)


def hwio_to_oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1).contiguous()


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NHWC input, HWIO weights, ``padding="SAME"`` -> NHWC output."""
    y = conv2d_nchw(x.permute(0, 3, 1, 2), hwio_to_oihw(w), stride)
    return y.permute(0, 2, 3, 1)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """theta ** (-2i / head_dim) for i < head_dim / 2, float32. The power
    is taken in float64 and rounded once, which gives XLA's float32
    result: positions up to 32k multiply any error of it into the angle."""
    e = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** e.double()).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, H, D); positions broadcastable to (..., S). Rotates the
    halves [x1, x2] -> [x1 cos - x2 sin, x2 cos + x1 sin]."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None, None].float() * freqs
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """silu(x @ w_gate) * (x @ w_up) @ w_down, each op rounding to x's
    dtype as the reference's einsums do."""
    h = silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), sigmoid as 1 / (1 + exp(-x)) with every op rounding
    to x's dtype: the reference's ``jax.nn.silu`` as XLA expands it. In
    bf16 this rounds four times where ``F.silu`` rounds once, and the two
    differ in the last bit of about 40% of values."""
    return x * torch.reciprocal(1.0 + torch.exp(-x))
