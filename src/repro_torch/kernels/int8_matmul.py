"""Wrapper of the hand-written CUDA ``int8_matmul`` kernel.

Replaces the Pallas kernel ``repro/kernels/int8_matmul.py``
(``int8_matmul`` / ``_kernel``): int8 (M, K) @ int8 (K, N) summed
exactly in int32, then ``(acc_f32 * x_scale[:, None]) * w_scale[None, :]``
in float32. One block per 64 x 64 output tile, K in chunks of 64 packed
four to a word for ``__dp4a`` (see ``csrc/int8_matmul.cu``); any shape,
and bit-equal to the plain version ``ref.int8_matmul``. It takes CUDA
tensors only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import I, P, CudaKernel

KERNEL = CudaKernel("int8_matmul", {"int8_matmul_s8": [P, P, P, P, P, I, I, I, P]})
MAX_M = 65535 * 64


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """x_q (M, K) int8, w_q (K, N) int8, x_scale (M,) and w_scale (N,)
    float32, contiguous on one CUDA device -> (M, N) float32."""
    ts = (x_q, w_q, x_scale, w_scale)
    if not all(t.is_cuda and t.device == x_q.device for t in ts):
        raise ValueError("int8_matmul kernel takes CUDA tensors on one device")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8 or \
            x_scale.dtype != torch.float32 or w_scale.dtype != torch.float32:
        raise ValueError(f"int8_matmul takes int8 operands and float32 scales, got "
                         f"{[t.dtype for t in ts]}")
    if (x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[0]
            or x_scale.shape != (x_q.shape[0],) or w_scale.shape != (w_q.shape[1],)
            or x_q.shape[0] > MAX_M):
        raise ValueError(f"int8_matmul takes (M, K) @ (K, N) with (M,), (N,) scales and "
                         f"M <= {MAX_M}, got {[tuple(t.shape) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("int8_matmul takes contiguous tensors")
    m, k = x_q.shape
    n = w_q.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x_q.device)
    if out.numel():
        stream = torch.cuda.current_stream(x_q.device).cuda_stream
        KERNEL.launch("int8_matmul_s8", x_q.data_ptr(), w_q.data_ptr(), x_scale.data_ptr(),
                      w_scale.data_ptr(), out.data_ptr(), m, k, n, stream)
    return out
