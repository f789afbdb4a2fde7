"""Wrapper of the hand-written CUDA ``iou_matrix`` kernel.

Replaces the Pallas kernel ``repro/kernels/iou.py`` (``iou_matrix`` /
``_kernel``), batched: the detector's NMS runs it over a whole counting
batch in one launch. Memory-bound by the output write, B·N·M·4 bytes.
One block per 32 x 32 output tile with its boxes in shared memory, every
rounding an explicit IEEE intrinsic (see ``csrc/iou.cu``). It takes CUDA
tensors only; the plain version is ``ref.iou_matrix``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import I, P, CudaKernel

KERNEL = CudaKernel("iou", {"iou_matrix_f32": [P, P, P, I, I, I, P]})
MAX_BATCH = 65535
MAX_ROWS = 65535 * 32


def iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """xyxy boxes (N, 4), (M, 4) -> (N, M), or (B, N, 4), (B, M, 4) ->
    (B, N, M); float32 contiguous on one CUDA device."""
    a, b = boxes_a, boxes_b
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError("iou_matrix kernel takes CUDA tensors on one device")
    if a.dim() != b.dim() or a.dim() not in (2, 3):
        raise ValueError(f"iou_matrix takes (N,4),(M,4) or (B,N,4),(B,M,4), "
                         f"got {tuple(a.shape)}, {tuple(b.shape)}")
    batched = a.dim() == 3
    if not batched:
        a, b = a[None], b[None]
    for t in (a, b):
        if (t.dtype != torch.float32 or t.shape[-1] != 4
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"iou_matrix takes contiguous, 16-byte aligned "
                             f"float32 boxes, got {tuple(t.shape)} {t.dtype}")
    bsz, n, m = a.shape[0], a.shape[1], b.shape[1]
    if b.shape[0] != bsz or bsz > MAX_BATCH or n > MAX_ROWS:
        raise ValueError(f"iou_matrix: batch {bsz} vs {b.shape[0]}, at most "
                         f"{MAX_BATCH} batches of {MAX_ROWS} rows")
    out = torch.empty((bsz, n, m), dtype=torch.float32, device=a.device)
    if out.numel():
        stream = torch.cuda.current_stream(a.device).cuda_stream
        KERNEL.launch("iou_matrix_f32", a.data_ptr(), b.data_ptr(),
                      out.data_ptr(), bsz, n, m, stream)
    return out if batched else out[0]
