"""Kernel entry points of the port, dispatched by the tensor's device.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the plain PyTorch version in :mod:`ref`. There is
no switch and no fallback: the device of the data decides. Unlike the
reference's dispatch, no shape falls back either: ``attention`` sends
every CUDA tensor to the kernel, which takes ragged lengths and any head
dim up to 256 (see :mod:`repro_torch.kernels.flash_attention`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import int8_matmul as _int8
from repro_torch.kernels import iou as _iou
from repro_torch.kernels import kmeans_assign as _kmeans
from repro_torch.kernels import ref
from repro_torch.kernels import tile_moments as _moments

KERNELS = (_moments.KERNEL, _kmeans.KERNEL, _iou.KERNEL, _flash.KERNEL, _int8.KERNEL)


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def tile_moments(tiles):
    if _on_cuda(tiles):
        return _moments.tile_moments(tiles)
    return ref.tile_moments(tiles)


def kmeans_assign(x, centroids):
    if _on_cuda(x):
        return _kmeans.kmeans_assign(x, centroids)
    return ref.kmeans_assign(x, centroids)


def iou_matrix(a, b):
    if _on_cuda(a):
        return _iou.iou_matrix(a, b)
    return ref.iou_matrix(a, b)


def attention(q, k, v, *, causal: bool = False):
    """GQA attention: q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D)."""
    if _on_cuda(q):
        return _flash.flash_attention(q, k, v, causal=causal)
    return ref.attention(q, k, v, causal=causal)


def decode_attention(q, k, v, *, kv_len):
    """Single-token decode: q (B, 1, Hq, D) against a full-length cache
    with per-batch valid lengths kv_len (B,). No kernel, as in the
    reference: the plain version on both devices."""
    return ref.attention(q, k, v, causal=False, kv_len=kv_len)


def int8_matmul(x_q, w_q, x_scale, w_scale):
    if _on_cuda(x_q):
        return _int8.int8_matmul(x_q, w_q, x_scale, w_scale)
    return ref.int8_matmul(x_q, w_q, x_scale, w_scale)


def quantize_int8(x: torch.Tensor, dim: int = -1):
    """Symmetric int8 quantization along ``dim`` -> (q int8, scale f32):
    ``scale = max(amax, 1e-8) / 127``, ``q = clip(round(x / scale))``,
    rounding half to even as ``jnp.round`` does."""
    amax = torch.amax(torch.abs(x.float()), dim=dim, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(dim)
