"""Clustering-based data deduplication (paper §III-C), PyTorch.

Counterpart of ``repro/core/dedup.py``: the color moments of the active
tiles are normalized, clustered by masked k-means++ and Lloyd on
power-of-two padded shapes, and the tile nearest each centroid stands
for its cluster. Every distance goes through ``ops.kmeans_assign``: the
CUDA kernel on the card, the plain version on the CPU. The first
centroid is JAX's own draw (:func:`repro_torch.random.randint`), so the
port picks the same one as the reference from the same seed.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import random as jrandom
from repro_torch.kernels import ops as kops

_N_BUCKET = 64
_K_BUCKET = 16
_FAR = 1e15  # sentinel for unused centroid slots (d2 stays finite in f32)


def bucket_size(v: int, floor: int = _N_BUCKET) -> int:
    """Next power-of-two bucket >= max(v, floor) for shape-stable padding."""
    b = floor
    while b < v:
        b *= 2
    return b


def dedup_pad_size(n: int) -> int:
    """Input bucket `dedup_from_moments` expects for a pre-padded gather."""
    return bucket_size(n, 2 * _N_BUCKET)


class DedupResult(NamedTuple):
    assign: torch.Tensor         # (N,) int32 cluster id
    centroids: torch.Tensor      # (K, D)
    rep_mask: torch.Tensor       # (N,) bool — True for cluster representatives
    cluster_sizes: torch.Tensor  # (K,) int32
    rep_idx: torch.Tensor        # (K,) int32 index of each cluster's representative


def _buckets_for(n: int, k: int):
    """(n_pad, k_pad) shape bucket of one dedup workload."""
    n_pad = dedup_pad_size(n)
    k_pad = (n_pad // 2 if int(k) <= n_pad // 2
             else bucket_size(int(k), _K_BUCKET))
    return n_pad, k_pad


def _dedup_core(m_pad: torch.Tensor, n: int, k: int, seed: int, *,
                k_pad: int, iters: int):
    """Masked featurize + k-means++ + Lloyd over padded raw moments.

    ``m_pad`` (n_pad, D) holds the real rows in [:n]; rows past ``n`` may
    hold any finite values and are masked out everywhere. Slots past
    ``k`` hold a far sentinel that no point selects. -> (x, centroids).
    """
    n_pad, d = m_pad.shape
    dev = m_pad.device
    mask = torch.arange(n_pad, device=dev) < n
    maskc = mask[:, None]
    nf = float(n)

    # masked normalize: per-feature mean, one global scale
    m0 = torch.where(maskc, m_pad, 0.0)
    mu = m0.sum(0, keepdim=True) / nf
    gmu = m0.sum() / (nf * d)
    var = torch.where(maskc, (m_pad - gmu).square(), 0.0).sum() / (nf * d)
    scale = torch.sqrt(var) + 1e-6
    x = torch.where(maskc, (m_pad - mu) / scale, 0.0)

    # incremental k-means++ (greedy farthest point), one distance per pick
    cents = x[jrandom.randint(seed, n)].repeat(k_pad, 1)
    _, d2 = kops.kmeans_assign(x, cents[:1])
    for i in range(1, min(k, k_pad)):
        nxt = torch.argmax(torch.where(mask, d2, -torch.inf)).reshape(1)
        c = x.index_select(0, nxt)
        cents[i] = c[0]
        _, d2n = kops.kmeans_assign(x, c)
        d2 = torch.minimum(d2, d2n)
    if k < k_pad:
        cents[k:] = _FAR

    # Lloyd iterations; pad rows carry weight 0
    for _ in range(iters):
        assign, _ = kops.kmeans_assign(x, cents)
        one = F.one_hot(assign.long(), k_pad).to(x.dtype) * maskc
        tot = one.T @ x
        cnt = one.sum(0)[:, None]
        cents = torch.where(cnt > 0, tot / torch.clamp(cnt, min=1), cents)
    return x, cents


def _dedup_finalize(x_pad: torch.Tensor, cent: torch.Tensor, n: int):
    """Final assignment + representative pick (scatter-min) over the
    padded features -> (assign, rep_mask, sizes, rep_clip)."""
    n_pad, k_pad = x_pad.shape[0], cent.shape[0]
    dev = x_pad.device
    assign, d2 = kops.kmeans_assign(x_pad, cent)
    a = assign.long()
    mask = torch.arange(n_pad, device=dev) < n
    big = 1e30
    d2m = torch.where(mask, d2, big)
    per_cluster = torch.full((k_pad,), big, device=dev).scatter_reduce(
        0, a, d2m, "amin")
    is_min = d2m <= per_cluster[a]
    idxs = torch.arange(n_pad, device=dev, dtype=torch.int32)
    rep_idx = torch.full((k_pad,), n_pad, dtype=torch.int32, device=dev)
    rep_idx = rep_idx.scatter_reduce(
        0, a, torch.where(is_min & mask, idxs, n_pad).to(torch.int32), "amin")
    rep_found = rep_idx < n
    rep_clip = torch.clamp(rep_idx, 0, n - 1)
    # scatter-max: duplicate empty-cluster writes can't clobber a real rep
    rep_mask = torch.zeros(n_pad, dtype=torch.int32, device=dev).scatter_reduce(
        0, rep_clip.long(), rep_found.to(torch.int32), "amax").bool()
    sizes = torch.zeros(k_pad, dtype=torch.int32, device=dev).scatter_add(
        0, a, mask.to(torch.int32))
    return assign, rep_mask, sizes, rep_clip


def _pad_rows(moments: torch.Tensor, n: int, n_pad: int) -> torch.Tensor:
    if moments.shape[0] == n_pad:
        return moments.contiguous()
    out = moments.new_zeros((n_pad, moments.shape[1]))
    out[:n] = moments[:n]
    return out


def dedup_from_moments(moments: torch.Tensor, k: int, seed: int,
                       iters: int = 10, n: int = None) -> DedupResult:
    """Dedup pass over raw color moments: featurize -> cluster -> reps.

    ``moments`` is (N, 3C) on the device that runs it; pass ``n`` when
    the trailing rows are padding from an already-bucketed gather.
    ``seed`` plays the reference's ``PRNGKey(seed)``.
    """
    n = int(moments.shape[0]) if n is None else int(n)
    n_pad, k_pad = _buckets_for(n, k)
    m_pad = _pad_rows(moments.to(torch.float32), n, n_pad)
    x_pad, cent = _dedup_core(m_pad, n, int(k), seed, k_pad=k_pad, iters=iters)
    assign, rep_mask, sizes, rep_clip = _dedup_finalize(x_pad, cent, n)
    return DedupResult(assign[:n], cent[:k], rep_mask[:n], sizes[:k],
                       rep_clip[:k])


def expanded_counts(rep_counts: torch.Tensor, res: DedupResult) -> torch.Tensor:
    """Counts measured on representatives only -> per-tile estimated counts
    (each tile inherits its cluster representative's count)."""
    return rep_counts[res.rep_idx.long()][res.assign.long()]
