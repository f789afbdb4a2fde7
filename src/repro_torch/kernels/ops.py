"""Kernel entry points of the port, dispatched by the tensor's device.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the plain PyTorch version in :mod:`ref`. There is
no switch and no fallback: the device of the data decides. Four kernels
have more than one entry in their one source:

- ``kmeans_assign`` (``csrc/kmeans_assign.cu``): ``kmeans_assign`` runs
  the dedup's Lloyd steps and final assignment (``kmeans_assign_f32``);
  ``kmeanspp_seed`` runs its whole k-means++ seeding in one launch
  (``kmeanspp_seed_f32``); ``kmeans_assign_lanes`` and
  ``kmeanspp_seed_lanes`` do the same for the L lanes of the fleet's
  dedup in one launch each (``kmeans_assign_lanes_f32``,
  ``kmeanspp_seed_lanes_f32``). The seeding kernel holds a row's features in
  a fixed register array of 16 and raises above that: the dedup's D is
  3C = 9, and no caller has more.
- ``iou_matrix`` (``csrc/iou.cu``): ``iou_matrix`` gives the IoU
  matrix (``iou_matrix_f32``); ``nms_keep`` runs the detector's whole
  NMS of a counting batch in one launch (``nms_keep_f32``), the matrix
  kept in shared memory as a bitmask. It takes k <= 1024 candidates an
  image; the detector's is 128.
- ``flash_attention`` (``csrc/flash_attention.cu``): bf16 with D 64, 128
  or 192 on the tensor cores (``flash_attention_bf16_sm90``; D 192 is
  deepseek-v2-lite's MLA prefill), and D 80 (ViT-H/14) zero-padded to
  128 there; float32 and bf16 of other head dims
  on the CUDA cores (the rule is
  :func:`repro_torch.kernels.flash_attention.choose_route`). Under
  autograd its gradient (``prep``, ``dkdv``, ``dq``; causal or not, GQA,
  D <= 128) is the seventh library, ``csrc/flash_attention_bwd_sm90.cu``
  (tensor cores, bf16 with D 64, 80, 128; ``flash_attention.BWD_TC_KERNEL``),
  or the sixth, ``csrc/flash_attention_bwd.cu`` (CUDA cores, everything
  else; ``flash_attention.BWD_KERNEL``); the rule is
  :func:`repro_torch.kernels.flash_attention.choose_bwd_route`. A CPU
  tensor's gradient is autograd's of ``ref.attention``.
- ``int8_matmul`` (``csrc/int8_matmul.cu``): the s8 tensor cores where
  K and N are multiples of 16, dp4a on the CUDA cores otherwise (the
  rule is :func:`repro_torch.kernels.int8_matmul.choose_route`).

Unlike the reference's dispatch, no shape falls back either:
``attention`` sends every CUDA tensor to the kernel, which takes ragged
lengths and any head dim up to 256 (see
:mod:`repro_torch.kernels.flash_attention`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import int8_matmul as _int8
from repro_torch.kernels import iou as _iou
from repro_torch.kernels import kmeans_assign as _kmeans
from repro_torch.kernels import ref
from repro_torch.kernels import tile_moments as _moments

KERNELS = (_moments.KERNEL, _kmeans.KERNEL, _iou.KERNEL, _flash.KERNEL, _int8.KERNEL,
           _flash.BWD_KERNEL, _flash.BWD_TC_KERNEL)


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


def kmeanspp_seed(x, n, first, k, k_pad):
    """The dedup's k-means++ seeding -> (centroids (k_pad, D), picks
    (k_pad,) int32); see :func:`ref.kmeanspp_seed`."""
    if _on_cuda(x):
        return _kmeans.kmeanspp_seed(x, n, first, k, k_pad)
    return ref.kmeanspp_seed(x, n, first, k, k_pad)


def kmeans_assign_lanes(x, centroids):
    """x (L, N, D), centroids (L, K, D) -> (assign (L, N) int32, sqdist
    (L, N) float32), lane by lane :func:`kmeans_assign`."""
    if _on_cuda(x):
        return _kmeans.kmeans_assign_lanes(x, centroids)
    return ref.kmeans_assign_lanes(x, centroids)


def kmeanspp_seed_lanes(x, n, first, k, k_pad):
    """The seeding of L dedup lanes -> (centroids (L, k_pad, D), picks
    (L, k_pad) int32); see :func:`ref.kmeanspp_seed_lanes`."""
    if _on_cuda(x):
        return _kmeans.kmeanspp_seed_lanes(x, n, first, k, k_pad)
    return ref.kmeanspp_seed_lanes(x, n, first, k, k_pad)


def iou_matrix(a, b):
    if _on_cuda(a):
        return _iou.iou_matrix(a, b)
    return ref.iou_matrix(a, b)


def nms_keep(boxes, top_i, top_s, iou_thresh, score_thresh):
    """Greedy NMS over the top-k candidates -> keep mask; see
    :func:`ref.nms_keep`."""
    if _on_cuda(boxes):
        return _iou.nms_keep(boxes, top_i, top_s, iou_thresh, score_thresh)
    return ref.nms_keep(boxes, top_i, top_s, iou_thresh, score_thresh)


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
