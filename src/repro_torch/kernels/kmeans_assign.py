"""Wrapper of the hand-written CUDA ``kmeans_assign`` kernel.

Replaces the Pallas kernel ``repro/kernels/kmeans_assign.py``
(``kmeans_assign`` / ``_kernel``). At the dedup's shapes (D = 9,
N <= 1024, K <= 512) the launch bounds it; the roofline counts
(N + K)·D·4 bytes read, N·8 written and 2·N·K·D operations. One thread
per row, the centroid table in shared memory, fp32 with the reference's
formula and rounding pinned (see ``csrc/kmeans_assign.cu``). It takes
CUDA tensors only; the plain version is ``ref.kmeans_assign``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import I, P, CudaKernel

KERNEL = CudaKernel("kmeans_assign",
                    {"kmeans_assign_f32": [P, P, P, P, I, I, I, P]})
MAX_D = 128


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor):
    """x (N, D), centroids (K, D), float32 contiguous on one CUDA device
    -> (assign (N,) int32, sqdist (N,) float32)."""
    if not (x.is_cuda and centroids.is_cuda) or x.device != centroids.device:
        raise ValueError("kmeans_assign kernel takes CUDA tensors on one device")
    for t, name in ((x, "x"), (centroids, "centroids")):
        if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"kmeans_assign takes contiguous 2-D float32 "
                             f"{name}, got {tuple(t.shape)} {t.dtype}")
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
