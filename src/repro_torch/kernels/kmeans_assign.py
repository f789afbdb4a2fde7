"""Wrappers of the hand-written CUDA ``kmeans_assign`` kernels.

Replace the Pallas kernel ``repro/kernels/kmeans_assign.py``
(``kmeans_assign`` / ``_kernel``). One source, ``csrc/kmeans_assign.cu``,
holds two entries, each with its caller:

- ``kmeans_assign_f32`` (:func:`kmeans_assign`): nearest centroid of
  every row, for the dedup's Lloyd steps and its final assignment
  (K = k_pad centroids). One warp per row, its lanes splitting the K
  centroids, the centroid table in shared memory; each lane keeps its
  first best (d2, index) and the warp takes their lexicographic minimum
  with shuffles, which is the sequential first-index scan. The roofline
  counts (N + K)·D·4 bytes read, N·8 written and 2·N·K·D operations.
- ``kmeanspp_seed_f32`` (:func:`kmeanspp_seed`): the dedup's whole
  k-means++ seeding in one launch, where the reference scans k - 1
  greedy farthest-point picks, each a one-centroid ``kmeans_assign``.
  One block: x in shared memory, each thread's running distances in
  registers, a block-wide (value, index) argmax a pick. It is a chain
  of k - 1 dependent block reductions, so latency bounds it, not bytes
  or operations. Rows that do not fit in shared memory are read from
  L2 by the same block, with the distances in a scratch buffer.

Both keep the reference's formula and roundings (see the source) and
equal their plain versions, ``ref.kmeans_assign`` and
``ref.kmeanspp_seed``, bit for bit. They take CUDA tensors only.

Two lane entries serve the fleet's dedup (``dedup_multi``), where the
reference vmaps the one-lane dedup over a bucket of satellites:
``kmeans_assign_lanes_f32`` (:func:`kmeans_assign_lanes`) and
``kmeanspp_seed_lanes_f32`` (:func:`kmeanspp_seed_lanes`) do the work of
the one-lane entries for L lanes in one launch; lane l equals the
one-lane entry on lane l's inputs bit for bit (plain versions
``ref.kmeans_assign_lanes`` and ``ref.kmeanspp_seed_lanes``, loops of the
one-lane plain versions).
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import I, P, CudaKernel

KERNEL = CudaKernel("kmeans_assign",
                    {"kmeans_assign_f32": [P, P, P, P, I, I, I, P],
                     "kmeanspp_seed_f32": [P, P, P, P, I, I, I, I, I, P],
                     "kmeans_assign_lanes_f32": [P, P, P, P, I, I, I, I, P],
                     "kmeanspp_seed_lanes_f32": [P, P, P, P, P, I, I, I, I, P]})
MAX_D = 128
SEED_MAX_D = 16  # the dedup's D is 3C = 9; the seeding kernel holds 16


def _check_x(x: torch.Tensor, name: str = "x"):
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"kmeans_assign takes contiguous 2-D float32 "
                         f"{name}, got {tuple(x.shape)} {x.dtype}")


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor):
    """x (N, D), centroids (K, D), float32 contiguous on one CUDA device
    -> (assign (N,) int32, sqdist (N,) float32)."""
    if not (x.is_cuda and centroids.is_cuda) or x.device != centroids.device:
        raise ValueError("kmeans_assign kernel takes CUDA tensors on one device")
    _check_x(x)
    _check_x(centroids, "centroids")
    n, d = x.shape
    k = centroids.shape[0]
    if centroids.shape[1] != d or not 1 <= d <= MAX_D or k == 0:
        raise ValueError(f"kmeans_assign takes (N, D), (K >= 1, D) with "
                         f"1 <= D <= {MAX_D}, got {tuple(x.shape)}, "
                         f"{tuple(centroids.shape)}")
    assign = torch.empty(n, dtype=torch.int32, device=x.device)
    dist = torch.empty(n, dtype=torch.float32, device=x.device)
    if n:
        stream = torch.cuda.current_stream(x.device).cuda_stream
        KERNEL.launch("kmeans_assign_f32", x.data_ptr(), centroids.data_ptr(),
                      assign.data_ptr(), dist.data_ptr(), n, k, d, stream)
    return assign, dist


def kmeanspp_seed(x: torch.Tensor, n: int, first: int, k: int, k_pad: int):
    """x (n_pad, D) float32 contiguous on a CUDA device, real rows [:n],
    the first pick ``first`` < n -> (centroids (k_pad, D) float32 with
    rows past k at ``ref.FAR``, picked rows (k_pad,) int32, -1 past k)."""
    if not x.is_cuda:
        raise ValueError("kmeanspp_seed kernel takes a CUDA tensor")
    _check_x(x)
    n_pad, d = x.shape
    n, first, k, k_pad = int(n), int(first), int(k), int(k_pad)
    if not (1 <= d <= SEED_MAX_D and 1 <= n <= n_pad and 0 <= first < n
            and k >= 0 and k_pad >= 0):
        raise ValueError(f"kmeanspp_seed takes x (n_pad, D <= {SEED_MAX_D}), "
                         f"1 <= n <= n_pad, 0 <= first < n, k, k_pad >= 0; got "
                         f"{tuple(x.shape)}, n {n}, first {first}, k {k}, k_pad {k_pad}")
    cents = torch.empty((k_pad, d), dtype=torch.float32, device=x.device)
    picks = torch.empty(k_pad, dtype=torch.int32, device=x.device)
    scratch = torch.empty(n, dtype=torch.float32, device=x.device)
    if k_pad:
        stream = torch.cuda.current_stream(x.device).cuda_stream
        KERNEL.launch("kmeanspp_seed_f32", x.data_ptr(), cents.data_ptr(),
                      picks.data_ptr(), scratch.data_ptr(), n, d, first, k,
                      k_pad, stream)
    return cents, picks


def _check_lanes(x: torch.Tensor, name: str = "x"):
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"the lane entries take contiguous 3-D float32 "
                         f"{name}, got {tuple(x.shape)} {x.dtype}")


def kmeans_assign_lanes(x: torch.Tensor, centroids: torch.Tensor):
    """x (L, N, D), centroids (L, K, D), float32 contiguous on one CUDA
    device -> (assign (L, N) int32, sqdist (L, N) float32); lane l is
    :func:`kmeans_assign` of (x[l], centroids[l])."""
    if not (x.is_cuda and centroids.is_cuda) or x.device != centroids.device:
        raise ValueError("kmeans_assign_lanes kernel takes CUDA tensors on one device")
    _check_lanes(x)
    _check_lanes(centroids, "centroids")
    lanes, n, d = x.shape
    k = centroids.shape[1]
    if (centroids.shape[0] != lanes or centroids.shape[2] != d
            or not 1 <= d <= MAX_D or k == 0 or not 1 <= lanes <= 65535):
        raise ValueError(f"kmeans_assign_lanes takes (L, N, D), (L, K >= 1, D) with "
                         f"1 <= D <= {MAX_D}, 1 <= L <= 65535, got {tuple(x.shape)}, "
                         f"{tuple(centroids.shape)}")
    assign = torch.empty((lanes, n), dtype=torch.int32, device=x.device)
    dist = torch.empty((lanes, n), dtype=torch.float32, device=x.device)
    if n:
        stream = torch.cuda.current_stream(x.device).cuda_stream
        KERNEL.launch("kmeans_assign_lanes_f32", x.data_ptr(), centroids.data_ptr(),
                      assign.data_ptr(), dist.data_ptr(), lanes, n, k, d, stream)
    return assign, dist


def kmeanspp_seed_lanes(x: torch.Tensor, n, first, k, k_pad: int):
    """x (L, n_pad, D) float32 contiguous on a CUDA device; ``n``,
    ``first`` and ``k``: L ints each, lane l's real rows, first pick and
    cluster count -> (centroids (L, k_pad, D), picks (L, k_pad) int32);
    lane l is :func:`kmeanspp_seed` of (x[l], n[l], first[l], k[l],
    k_pad). The three vectors go to the card in one copy."""
    if not x.is_cuda:
        raise ValueError("kmeanspp_seed_lanes kernel takes a CUDA tensor")
    _check_lanes(x)
    lanes, n_pad, d = x.shape
    args = [[int(v) for v in vec] for vec in (n, first, k)]
    k_pad = int(k_pad)
    ok = (1 <= d <= SEED_MAX_D and 1 <= lanes <= 65535 and k_pad >= 0
          and all(len(vec) == lanes for vec in args)
          and all(1 <= nl <= n_pad and 0 <= fl < nl and kl >= 0
                  for nl, fl, kl in zip(*args)))
    if not ok:
        raise ValueError(f"kmeanspp_seed_lanes takes x (L, n_pad, D <= {SEED_MAX_D}) and "
                         f"per lane 1 <= n <= n_pad, 0 <= first < n, k >= 0; got "
                         f"{tuple(x.shape)}, n {args[0]}, first {args[1]}, k {args[2]}, "
                         f"k_pad {k_pad}")
    cents = torch.empty((lanes, k_pad, d), dtype=torch.float32, device=x.device)
    picks = torch.empty((lanes, k_pad), dtype=torch.int32, device=x.device)
    scratch = torch.empty((lanes, n_pad), dtype=torch.float32, device=x.device)
    lane_args = torch.tensor(args, dtype=torch.int32).to(x.device)
    if k_pad:
        stream = torch.cuda.current_stream(x.device).cuda_stream
        KERNEL.launch("kmeanspp_seed_lanes_f32", x.data_ptr(), cents.data_ptr(),
                      picks.data_ptr(), scratch.data_ptr(), lane_args.data_ptr(), lanes,
                      n_pad, d, k_pad, stream)
    return cents, picks
