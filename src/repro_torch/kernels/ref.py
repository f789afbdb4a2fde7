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


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                  do: torch.Tensor, *, causal: bool = False, q_offset: int = 0):
    """The plain version of ``flash_attention_bwd``: (dq, dk, dv) of
    :func:`attention` (GQA: k, v of Hkv heads, their gradients summed over
    each kv head's query heads; ``causal`` with ``q_offset``, 0 for the
    kernels) against the output gradient ``do``, by
    ``torch.autograd.grad`` through its arithmetic (q scaled in float32
    and rounded, float32 products and softmax, the weights cast to
    ``v.dtype``), each in its input's dtype. ``o``, the forward's output
    that the kernel reads, is recomputed here."""
    del o
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        out = attention(qq, kk, vv, causal=causal, q_offset=q_offset)
        return torch.autograd.grad(out, (qq, kk, vv), do)


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


FAR = 1e15  # unused centroid slots of the seeding (d2 stays finite in f32)


def kmeanspp_seed(x: torch.Tensor, n: int, first: int, k: int, k_pad: int):
    """Greedy farthest-point k-means++ seeding of one dedup lane.

    x (n_pad, D) float32 with the real rows in [:n]; ``first`` the first
    pick (< n). Pick i >= 1 is the argmax, first index on ties, over the
    real rows of the running ``d2 = min(d2, kmeans_assign(x, c_{i-1}))``.
    -> (centroids (k_pad, D) with rows past k set to :data:`FAR`, picked
    row indices (k_pad,) int32, -1 past k).
    """
    n_pad = x.shape[0]
    mask = torch.arange(n_pad, device=x.device) < n
    cents = x[first].repeat(k_pad, 1)
    picks = torch.full((k_pad,), -1, dtype=torch.int32, device=x.device)
    if k >= 1 and k_pad >= 1:
        picks[0] = first
    _, d2 = kmeans_assign(x, x[first:first + 1])
    for i in range(1, min(k, k_pad)):
        nxt = torch.argmax(torch.where(mask, d2, -torch.inf)).reshape(1)
        c = x.index_select(0, nxt)
        cents[i] = c[0]
        picks[i] = nxt[0]
        _, d2n = kmeans_assign(x, c)
        d2 = torch.minimum(d2, d2n)
    if k < k_pad:
        cents[max(k, 0):] = FAR
    return cents, picks


def kmeans_assign_lanes(x: torch.Tensor, centroids: torch.Tensor):
    """x (L, N, D), centroids (L, K, D) -> (assign (L, N) int32, sqdist
    (L, N) float32): :func:`kmeans_assign` lane by lane."""
    outs = [kmeans_assign(x[i], centroids[i]) for i in range(x.shape[0])]
    return torch.stack([a for a, _ in outs]), torch.stack([d for _, d in outs])


def kmeanspp_seed_lanes(x: torch.Tensor, n, first, k, k_pad: int):
    """x (L, n_pad, D); ``n``, ``first``, ``k``: L ints each ->
    (centroids (L, k_pad, D), picks (L, k_pad) int32):
    :func:`kmeanspp_seed` lane by lane."""
    outs = [kmeanspp_seed(x[i], int(n[i]), int(first[i]), int(k[i]), k_pad)
            for i in range(x.shape[0])]
    return torch.stack([c for c, _ in outs]), torch.stack([p for _, p in outs])


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



def nms_keep(boxes: torch.Tensor, top_i: torch.Tensor, top_s: torch.Tensor,
             iou_thresh: float, score_thresh: float) -> torch.Tensor:
    """Greedy NMS over the top-k candidates: boxes (..., N, 4), top_i and
    top_s (..., k) the first k indices and scores of a descending sort ->
    keep mask (..., N) bool. The candidates' IoU matrix, then the
    reference's ``fori_loop`` in steps of every image at once: candidate
    i, while kept, suppresses each later candidate j with
    ``iou[i, j] > iou_thresh``; a candidate starts kept if its score is
    above ``score_thresh``."""
    k = top_i.shape[-1]
    top_b = torch.gather(boxes, -2, top_i[..., None].expand(*top_i.shape, 4))
    iou = iou_matrix(top_b, top_b)
    keep = top_s > score_thresh
    ar = torch.arange(k, device=boxes.device)
    later = ar[None, :] > ar[:, None]  # later[i, j]: j after i
    over = iou > iou_thresh
    for i in range(k):
        keep = keep & ~(over[..., i, :] & later[i] & keep[..., i:i + 1])
    return torch.zeros(boxes.shape[:-1], dtype=torch.bool,
                       device=boxes.device).scatter(-1, top_i, keep)

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
