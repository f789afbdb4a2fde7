"""Clustering-based data deduplication (paper §III-C), PyTorch.

Counterpart of ``repro/core/dedup.py``: the color moments of the active
tiles are normalized, clustered by masked k-means++ and Lloyd on
power-of-two padded shapes, and the tile nearest each centroid stands
for its cluster. In :func:`dedup_from_moments`, the core that the engine
and the reference path both enter, the k-means++ seeding is one call of
``ops.kmeanspp_seed`` and every other distance goes through
``ops.kmeans_assign``: the CUDA kernels on the card, the plain versions
on the CPU. :func:`kmeans` keeps the reference's unpadded k-means, one
``ops.kmeans_assign`` call a k-means++ pick. The first centroid is JAX's own draw
(:func:`repro_torch.random.randint`), so the port picks the same one as
the reference from the same seed.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import random as jrandom
from repro_torch.core import xfer
from repro_torch.core.fleet_sharding import ctx as sharding_ctx
from repro_torch.kernels import ops as kops

_N_BUCKET = 64
_K_BUCKET = 16


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


def normalize_moments(f: torch.Tensor) -> torch.Tensor:
    """(N, D) raw color moments -> features centered per feature and
    scaled by one global factor (the population std of all of them)."""
    mu = f.mean(0, keepdim=True)
    scale = (f - f.mean()).square().mean().sqrt() + 1e-6
    return (f - mu) / scale


def features(tiles: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, 3C) normalized color-moment features."""
    return normalize_moments(kops.tile_moments(tiles))


def _kmeanspp_init(x: torch.Tensor, k: int, seed: int) -> torch.Tensor:
    """k-means++ (greedy farthest-point) seeding -> (k, D) centroids: a
    running min-d2 updated against the newest centroid only, one
    ``ops.kmeans_assign(x, c[None])`` call a pick. The first centroid is
    ``jax.random.randint(PRNGKey(seed), (), 0, N)``'s draw."""
    cent0 = x[jrandom.randint(seed, x.shape[0])]
    _, d2 = kops.kmeans_assign(x, cent0[None])
    cents = cent0[None].repeat(k, 1)
    for i in range(1, k):
        c = x[torch.argmax(d2)]  # the first farthest point
        cents[i] = c
        _, d2_new = kops.kmeans_assign(x, c[None])
        d2 = torch.minimum(d2, d2_new)
    return cents


def kmeans(x: torch.Tensor, k: int, seed: int, iters: int = 10):
    """k-means with k-means++ seeding over all of ``x`` (no padding) ->
    (assign (N,) int32, centroids (k, D), d2 (N,))."""
    cent = _kmeanspp_init(x, k, seed)
    for _ in range(iters):
        assign, _ = kops.kmeans_assign(x, cent)
        one = F.one_hot(assign.long(), k).to(x.dtype)
        tot = one.T @ x
        cnt = one.sum(0)[:, None]
        cent = torch.where(cnt > 0, tot / torch.clamp(cnt, min=1), cent)
    assign, d2 = kops.kmeans_assign(x, cent)
    return assign, cent, d2


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

    # k-means++ seeding (greedy farthest point): one launch on the card
    cents, _ = kops.kmeanspp_seed(x, n, jrandom.randint(seed, n), k, k_pad)

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


def dedup(tiles: torch.Tensor, k: int, seed: int, iters: int = 10) -> DedupResult:
    """Full dedup pass over tiles (N, H, W, C): their moments
    (``ops.tile_moments``), then :func:`dedup_from_moments`."""
    return dedup_from_moments(kops.tile_moments(tiles), k, seed, iters)


def expanded_counts(rep_counts: torch.Tensor, res: DedupResult) -> torch.Tensor:
    """Counts measured on representatives only -> per-tile estimated counts
    (each tile inherits its cluster representative's count)."""
    return rep_counts[res.rep_idx.long()][res.assign.long()]


# --- the fleet's dedup: one lane a satellite, a launch a bucket ---

def _normalize_lane(m_pad: torch.Tensor, n: int) -> torch.Tensor:
    """The masked normalization of :func:`_dedup_core`, the same
    operations on the same (n_pad, D) shape, so a lane's features equal
    the one-lane dedup's bit for bit."""
    n_pad, d = m_pad.shape
    mask = torch.arange(n_pad, device=m_pad.device) < n
    maskc = mask[:, None]
    nf = float(n)
    m0 = torch.where(maskc, m_pad, 0.0)
    mu = m0.sum(0, keepdim=True) / nf
    gmu = m0.sum() / (nf * d)
    var = torch.where(maskc, (m_pad - gmu).square(), 0.0).sum() / (nf * d)
    scale = torch.sqrt(var) + 1e-6
    return torch.where(maskc, (m_pad - mu) / scale, 0.0)


def _dedup_finalize_lanes(x: torch.Tensor, cent: torch.Tensor, ns: torch.Tensor):
    """:func:`_dedup_finalize` over a lane axis: one assignment launch,
    then the same scatter-min / scatter-max / scatter-add along each lane
    (min, max and integer sums, so the order of the updates is moot)."""
    lanes, n_pad = x.shape[:2]
    k_pad = cent.shape[1]
    dev = x.device
    assign, d2 = kops.kmeans_assign_lanes(x, cent)
    a = assign.long()
    mask = torch.arange(n_pad, device=dev)[None, :] < ns[:, None]
    big = 1e30
    d2m = torch.where(mask, d2, big)
    per_cluster = torch.full((lanes, k_pad), big, device=dev).scatter_reduce(
        1, a, d2m, "amin")
    is_min = d2m <= per_cluster.gather(1, a)
    idxs = torch.arange(n_pad, device=dev, dtype=torch.int32).expand(lanes, n_pad)
    rep_idx = torch.full((lanes, k_pad), n_pad, dtype=torch.int32, device=dev)
    rep_idx = rep_idx.scatter_reduce(
        1, a, torch.where(is_min & mask, idxs, n_pad).to(torch.int32), "amin")
    rep_found = rep_idx < ns[:, None]
    rep_clip = torch.minimum(rep_idx.clamp(min=0), (ns - 1)[:, None].to(torch.int32))
    rep_mask = torch.zeros((lanes, n_pad), dtype=torch.int32, device=dev).scatter_reduce(
        1, rep_clip.long(), rep_found.to(torch.int32), "amax").bool()
    sizes = torch.zeros((lanes, k_pad), dtype=torch.int32, device=dev).scatter_add(
        1, a, mask.to(torch.int32))
    return assign, rep_mask, sizes, rep_clip


def _dedup_lanes(m: torch.Tensor, ns, firsts, ks, ns_t: torch.Tensor, k_pad: int,
                 iters: int):
    """One shape bucket's lanes: m (L, n_pad, D) zero-padded raw moments,
    the lanes' real rows ``ns``, first picks and cluster counts (host
    ints) and ``ns_t`` (the rows on m's device) -> (assign, centroids,
    rep_mask, sizes, rep_clip), each with a leading lane axis."""
    x = torch.stack([_normalize_lane(m[i], n) for i, n in enumerate(ns)])
    dev = x.device
    maskc = (torch.arange(m.shape[1], device=dev)[None, :] < ns_t[:, None])[..., None]
    cents, _ = kops.kmeanspp_seed_lanes(x, ns, firsts, ks, k_pad)
    for _ in range(iters):
        assign, _ = kops.kmeans_assign_lanes(x, cents)
        one = F.one_hot(assign.long(), k_pad).to(x.dtype) * maskc
        tot = torch.stack([one[i].T @ x[i] for i in range(len(ns))])
        cnt = one.sum(1)[..., None]
        cents = torch.where(cnt > 0, tot / torch.clamp(cnt, min=1), cents)
    return (cents,) + _dedup_finalize_lanes(x, cents, ns_t)


def dedup_multi(parts, iters: int = 10, sharding=None):
    """The dedup of many satellites, a lane each, batched by shape bucket.

    Counterpart of ``repro/core/dedup.py``'s ``dedup_multi``. ``parts``:
    list of ``(moments, k, seed, n)``, one a satellite, as
    :func:`dedup_from_moments` takes them (``n`` None: all rows real).
    Satellites are grouped by their (n_pad, k_pad) bucket, and each group
    runs as one lane batch: one ``ops.kmeanspp_seed_lanes`` call for its
    seeding, one ``ops.kmeans_assign_lanes`` call a Lloyd step and one for
    the final assignment. The normalization and each Lloyd step's
    centroid sums run lane by lane, with :func:`dedup_from_moments`'s
    operations on its shapes, so every lane equals the one-lane dedup
    bit for bit (a batched reduction could sum in another order). The
    reference pads the lane count to a power of two to bound its
    compiles; nothing here compiles, so lanes are not padded off the mesh.

    ``sharding``: an optional
    :class:`~repro_torch.core.fleet_sharding.FleetSharding`. On its mesh
    a group's lanes are padded to a device multiple with copies of lane 0
    (inert: real shapes, never read), split along the ``sats`` axis, and
    each rank runs the whole group program above on its own lanes (its
    share of the host lists taken by its coordinate), so each lane is
    still the one-lane dedup's; the results are gathered on every rank.

    -> a :class:`DedupResult` a part, aligned with ``parts``.
    """
    sh = sharding_ctx(sharding)
    groups: dict = {}
    for slot, (moments, k, seed, n) in enumerate(parts):
        n = int(moments.shape[0]) if n is None else int(n)
        groups.setdefault(_buckets_for(n, k), []).append(
            (slot, moments, int(k), int(seed), n))
    out = [None] * len(parts)
    for (n_pad, k_pad), items in groups.items():
        g = len(items)
        lane0 = [0] * (sh.pad(g) - g)   # the inert pad lanes, copies of lane 0
        items_pad = items + [items[i] for i in lane0]
        ns = [n for *_, n in items_pad]
        firsts = [jrandom.randint(seed, n) for _, _, _, seed, n in items_pad]
        ks = [k for _, _, k, _, _ in items_pad]
        m = torch.stack([_pad_rows(mo.to(torch.float32), n, n_pad)
                         for _, mo, _, _, n in items_pad])
        if sh.on_mesh:
            def lanes(m_local, ns_local):
                r = sh.lanes(len(ns))
                return _dedup_lanes(m_local, ns[r], firsts[r], ks[r], ns_local, k_pad, iters)
            res = sh.map_lanes(lanes, (sh.device_put(m),
                                       xfer.device_constant(np.asarray(ns, np.int64),
                                                            sharding=sh)), 5)
            cents, assign, rep_mask, sizes, rep_clip = (sh.gather(o, g) for o in res)
        else:
            cents, assign, rep_mask, sizes, rep_clip = _dedup_lanes(
                m, ns, firsts, ks, torch.tensor(ns, device=m.device), k_pad, iters)
        for i, (slot, _, k, _, n) in enumerate(items):
            out[slot] = DedupResult(assign[i, :n], cents[i, :k], rep_mask[i, :n],
                                    sizes[i, :k], rep_clip[i, :k])
    return out
