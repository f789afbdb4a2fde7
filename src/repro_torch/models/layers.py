"""Convolution primitives of the port (NHWC/HWIO at the boundary).

Counterpart of ``conv_init``/``conv2d`` in ``repro/models/layers.py``.
Tensors keep JAX's layout at the public functions: activations NHWC,
weights HWIO. Inside, a contiguous NHWC tensor permuted to NCHW is a
channels-last view, which cuDNN takes without a copy.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def truncated_normal(gen: torch.Generator, shape, stddev: float,
                     dtype=torch.float32) -> torch.Tensor:
    """Normal on [-2, 2] times ``stddev``, drawn on the CPU from ``gen``
    (so a seed gives the same weights on every device)."""
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * stddev).to(dtype)


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
