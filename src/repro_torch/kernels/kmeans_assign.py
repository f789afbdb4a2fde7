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
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import I, P, CudaKernel

KERNEL = CudaKernel("kmeans_assign",
                    {"kmeans_assign_f32": [P, P, P, P, I, I, I, P],
                     "kmeanspp_seed_f32": [P, P, P, P, I, I, I, I, I, P]})
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
