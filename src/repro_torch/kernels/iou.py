"""Wrappers of the hand-written CUDA ``iou_matrix`` kernels.

Replace the Pallas kernel ``repro/kernels/iou.py`` (``iou_matrix`` /
``_kernel``) and, with it, the greedy suppression the detector's NMS
runs over its output. One source, ``csrc/iou.cu``, holds two entries:

- ``iou_matrix_f32`` (:func:`iou_matrix`): the batched IoU matrix,
  memory-bound by the output write, B·N·M·4 bytes. One block per
  32 x 32 output tile with its boxes in shared memory.
- ``nms_keep_f32`` (:func:`nms_keep`): the detector's whole NMS of a
  counting batch in one launch, one CTA an image: the top-k boxes
  gathered into shared memory, the overlap bitmask of iou > iou_thresh
  above the diagonal (one ``__ballot_sync`` a 32-column word), the
  greedy scan over the kept candidates on one warp, and the scatter of
  the keep flags. The IoU matrix never reaches device memory. Latency
  bounds it: the scan is one dependent step a kept box.

Both compute the IoU with every rounding an explicit IEEE intrinsic and
NaN-propagating min and max, so they equal their plain versions,
``ref.iou_matrix`` and ``ref.nms_keep``, bit for bit, NaN boxes
included. They take CUDA tensors only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import I, P, CudaKernel

KERNEL = CudaKernel("iou", {"iou_matrix_f32": [P, P, P, I, I, I, P],
                            "nms_keep_f32": [P, P, P, P, I, I, I, I, ctypes.c_float,
                                             ctypes.c_float, P]})
MAX_BATCH = 65535
MAX_ROWS = 65535 * 32
MAX_K = 1024  # nms_keep_f32's candidates an image: a 128 KB bitmask in shared memory


def _check_boxes(t: torch.Tensor, name: str):
    if (t.dtype != torch.float32 or t.shape[-1] != 4
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(f"{name} takes contiguous, 16-byte aligned float32 "
                         f"boxes, got {tuple(t.shape)} {t.dtype}")


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
        _check_boxes(t, "iou_matrix")
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


def nms_keep(boxes: torch.Tensor, top_i: torch.Tensor, top_s: torch.Tensor,
             iou_thresh: float, score_thresh: float) -> torch.Tensor:
    """Greedy NMS over the top-k candidates -> keep mask (N,) or (B, N)
    bool; see :func:`ref.nms_keep`.

    boxes (N, 4) or (B, N, 4) float32 contiguous on a CUDA device;
    top_i (int64) and top_s (float32), (k,) or (B, k) with 0 <= k <=
    min(N, MAX_K): the first k indices and scores of each row's
    descending sort, each row contiguous (a slice of the sort's output
    is taken as it is). The thresholds are rounded to float32, as
    PyTorch does comparing a float32 tensor with a Python float."""
    if not (boxes.is_cuda and top_i.is_cuda and top_s.is_cuda) or not (
            boxes.device == top_i.device == top_s.device):
        raise ValueError("nms_keep kernel takes CUDA tensors on one device")
    if boxes.dim() not in (2, 3) or top_i.dim() != boxes.dim() - 1:
        raise ValueError(f"nms_keep takes boxes (N, 4) or (B, N, 4) and top-k (k,) or "
                         f"(B, k), got {tuple(boxes.shape)}, {tuple(top_i.shape)}")
    batched = boxes.dim() == 3
    if not batched:
        boxes, top_i, top_s = boxes[None], top_i[None], top_s[None]
    _check_boxes(boxes, "nms_keep")
    bsz, n = boxes.shape[0], boxes.shape[1]
    k = top_i.shape[-1]
    if (top_i.dtype != torch.int64 or top_s.dtype != torch.float32
            or top_s.shape != top_i.shape or top_i.shape[0] != bsz
            or top_i.stride(-1) != 1 or top_s.stride(-1) != 1
            or (bsz > 1 and top_i.stride(0) != top_s.stride(0))
            or not 0 <= k <= min(n, MAX_K)):
        raise ValueError(f"nms_keep takes int64 top_i and float32 top_s of one shape "
                         f"(B, k), rows contiguous and strided alike, 0 <= k <= "
                         f"min(N, {MAX_K}); got {tuple(top_i.shape)} {top_i.dtype}, "
                         f"{tuple(top_s.shape)} {top_s.dtype}, N {n}")
    keep = torch.empty((bsz, n), dtype=torch.bool, device=boxes.device)
    if keep.numel():
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        KERNEL.launch("nms_keep_f32", boxes.data_ptr(), top_i.data_ptr(),
                      top_s.data_ptr(), keep.data_ptr(), bsz, n, k, top_i.stride(0),
                      float(iou_thresh), float(score_thresh), stream)
    return keep if batched else keep[0]
