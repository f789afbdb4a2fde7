"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each function computes what its CUDA kernel computes, with the
reference's arithmetic (``repro/kernels/ref.py``). ``ops`` sends CPU
tensors here; ``chip_smoke.py`` holds every kernel against these on the
card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = False, q_offset: int = 0,
              kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head, GQA-aware attention: q (B, Sq, Hq, D), k/v
    (B, Skv, Hkv, D) with Hq % Hkv == 0 (query head h reads kv head
    h // rep) -> (B, Sq, Hq, D) in ``q.dtype``.

    ``causal`` masks key positions above ``q_offset + query index``;
    ``kv_len`` (B,) masks each batch row's cache tail (decode). The
    reference's mixed precision: q is scaled in float32 and rounded back
    to its dtype; both products accumulate in float32 (the bf16 operands
    are upcast, which is exact, where a bf16 product would round its
    output); the softmax is float32 and its weights are cast to
    ``v.dtype`` before the second product.
    """
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    qf = (q.float() / math.sqrt(d)).to(q.dtype).float()
    qf = qf.reshape(b, sq, hkv, rep, d)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qf, k.float())
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(skv, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        logits = logits.masked_fill(~mask, NEG_INF)
    if kv_len is not None:
        valid = torch.arange(skv, device=q.device)[None, :] < kv_len[:, None]
        logits = logits.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhrqk,bkhd->bqhrd", w.to(v.dtype).float(), v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def tile_moments(tiles: torch.Tensor) -> torch.Tensor:
    """Color moments featurizer (paper §III-C): per tile and channel the
    mean, ``sqrt(m2 + 1e-12)`` and ``cbrt(m3)``, with m2 and m3 taken
    about the mean. tiles (N, H, W, C) -> (N, 3C) float32.

    The moments are taken in float64 and rounded once, as the CUDA kernel
    does: in float32 the third moment of a 416 x 416 tile keeps only a few
    digits (it cancels to ~1e-7 against terms of ~0.03), and the cube
    root multiplies that error by up to ~1e4.
    """
    x = tiles.to(torch.float64)
    mu = x.mean(dim=(1, 2))
    xc = x - mu[:, None, None, :]
    var = (xc * xc).mean(dim=(1, 2))
    m3 = (xc * xc * xc).mean(dim=(1, 2))
    sd = torch.sqrt(var.to(torch.float32) + 1e-12)
    # torch has no cbrt; sign * |m3|^(1/3) in float64 is the correctly
    # rounded float32 cube root but for ~1e-9 of inputs
    skew = torch.sign(m3) * torch.abs(m3).pow(1.0 / 3.0)
    return torch.cat([mu.to(torch.float32), sd, skew.to(torch.float32)], dim=-1)


def _fma_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ_d a[..., d] * b[..., d] in float32 as a chain of fused
    multiply-adds in index order, acc = fma(a_d, b_d, acc): the order
    XLA's CPU code and the CUDA kernel use. Each step is exact in
    float64 before one rounding to float32 (a float32 product is exact in
    float64), which is the fma's rounding except for double-rounding
    cases of probability ~2**-29."""
    a64, b64 = a.to(torch.float64), b.to(torch.float64)
    acc = (a64[..., 0] * b64[..., 0]).to(torch.float32)
    for d in range(1, a.shape[-1]):
        acc = (a64[..., d] * b64[..., d] + acc.to(torch.float64)).to(torch.float32)
    return acc


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor):
    """x (N, D), centroids (K, D) -> (assign (N,) int32, sqdist (N,) f32).

    ``d2 = Σx² − 2·x·cᵀ + Σc²``, each sum a chain of fused multiply-adds
    in index order (:func:`_fma_dot`); the argmin takes the first index
    on ties and the distance is clamped at 0.
    """
    xf = x.to(torch.float32)
    cf = centroids.to(torch.float32)
    x2 = _fma_dot(xf, xf)[:, None]
    c2 = _fma_dot(cf, cf)[None, :]
    dot = _fma_dot(xf[:, None, :], cf[None, :, :])
    d2 = (x2 - 2.0 * dot) + c2
    mn, a = torch.min(d2, dim=-1)
    return a.to(torch.int32), torch.clamp(mn, min=0.0)


def iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """xyxy boxes (..., N, 4), (..., M, 4) -> IoU (..., N, M) float32,
    with box areas clamped at 0 and the union at 1e-9. A leading batch
    axis, if any, is shared by both inputs."""
    a = boxes_a.to(torch.float32)
    b = boxes_b.to(torch.float32)
    ax1, ay1, ax2, ay2 = (a[..., :, None, i] for i in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, i] for i in range(4))
    ix = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1), min=0.0)
    iy = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1), min=0.0)
    inter = ix * iy
    area_a = torch.clamp(ax2 - ax1, min=0.0) * torch.clamp(ay2 - ay1, min=0.0)
    area_b = torch.clamp(bx2 - bx1, min=0.0) * torch.clamp(by2 - by1, min=0.0)
    union = area_a + area_b - inter
    return inter / torch.clamp(union, min=1e-9)


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """x_q (M, K) int8 @ w_q (K, N) int8, scaled per row by x_scale (M,)
    and per column by w_scale (N,) -> (M, N) float32:
    ``(acc_f32 * x_scale[:, None]) * w_scale[None, :]``.

    The products are summed in float64, which holds every partial sum of
    int8 products exactly (|acc| < 2**53), so ``acc`` is the exact int32
    sum on every device (CUDA has no int32 matrix product).
    """
    acc = x_q.double() @ w_q.double()
    return acc.float() * x_scale.float()[:, None] * w_scale.float()[None, :]
