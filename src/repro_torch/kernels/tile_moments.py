"""Wrapper of the hand-written CUDA ``tile_moments`` kernel.

Replaces the Pallas kernel ``repro/kernels/tile_moments.py``
(``tile_moments`` / ``_kernel``). Memory-bound: the least time is the
input's N·H·W·C·4 bytes over the card's memory rate. The kernel reads
each element once with 16-byte loads, keeping shifted power sums in
double; each tile is split across a thread-block cluster of up to 8
CTAs (as many as fit the call on the card in one wave while each thread
keeps a whole batch of loads), each CTA's sums are added with warp
shuffles (through shared memory for C > 4), and the cluster's leader
adds the CTAs' through distributed shared memory (see
``csrc/tile_moments.cu``). One launch a call. It takes CUDA tensors
only; the plain version is ``ref.tile_moments`` and ``ops`` picks
between them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import I, P, CudaKernel

KERNEL = CudaKernel("tile_moments", {"tile_moments_f32": [P, P, I, I, I, P]})
MAX_C = 64


def tile_moments(tiles: torch.Tensor) -> torch.Tensor:
    """tiles (N, H, W, C) float32 contiguous, on CUDA -> (N, 3C) float32."""
    if not tiles.is_cuda:
        raise ValueError("tile_moments kernel takes a CUDA tensor")
    if tiles.dtype != torch.float32 or tiles.dim() != 4:
        raise ValueError(f"tile_moments takes (N, H, W, C) float32, got "
                         f"{tuple(tiles.shape)} {tiles.dtype}")
    if not tiles.is_contiguous():
        raise ValueError("tile_moments takes a contiguous tensor")
    n, h, w, c = tiles.shape
    if not 1 <= c <= MAX_C or h * w == 0:
        raise ValueError(f"tile_moments takes 1 <= C <= {MAX_C} and "
                         f"non-empty tiles, got {tuple(tiles.shape)}")
    out = torch.empty((n, 3 * c), dtype=torch.float32, device=tiles.device)
    if n:
        stream = torch.cuda.current_stream(tiles.device).cuda_stream
        KERNEL.launch("tile_moments_f32", tiles.data_ptr(), out.data_ptr(),
                      n, h * w, c, stream)
    return out
