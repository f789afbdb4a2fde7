"""Kernel entry points of the port, dispatched by the tensor's device.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the plain PyTorch version in :mod:`ref`. There is
no switch and no fallback: the device of the data decides.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import iou as _iou
from repro_torch.kernels import kmeans_assign as _kmeans
from repro_torch.kernels import ref
from repro_torch.kernels import tile_moments as _moments

KERNELS = (_moments.KERNEL, _kmeans.KERNEL, _iou.KERNEL)


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
