"""Wrapper of the hand-written CUDA ``int8_matmul`` kernels.

Replaces the Pallas kernel ``repro/kernels/int8_matmul.py``
(``int8_matmul`` / ``_kernel``): int8 (M, K) @ int8 (K, N) summed
exactly in int32, then ``(acc_f32 * x_scale[:, None]) * w_scale[None, :]``
in float32. One source, ``csrc/int8_matmul.cu``, holds two routes, and
:func:`choose_route` is the rule between them:

- ``"tensor_core"`` (``int8_matmul_s8_sm90``): K and N multiples of 16
  (TMA's 16-byte strides), any M. 256 x 128 output tiles, TMA loads,
  wgmma s8 x s8 -> s32; each w tile is transposed to K-major in shared
  memory, as 8-bit wgmma reads both operands K-major only.
- ``"cuda_core"`` (``int8_matmul_s8``): any shape, ragged ones such as
  (100, 200, 150) or (1, 64, 1). 64 x 64 output tiles, K packed four to
  a word for ``__dp4a``.

Both are bit-equal to the plain version ``ref.int8_matmul``. A CUDA
tensor launches the kernel its route names or raises; there is no
fallback between routes. ``KERNEL.symbol_launches`` counts each entry.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._build import I, P, CudaKernel

TENSOR_CORE, CUDA_CORE = "tensor_core", "cuda_core"
SYMBOLS = {TENSOR_CORE: "int8_matmul_s8_sm90", CUDA_CORE: "int8_matmul_s8"}
_ARGS = [P, P, P, P, P, I, I, I, P]
KERNEL = CudaKernel("int8_matmul", {sym: _ARGS for sym in SYMBOLS.values()})
MAX_M = 65535 * 64
MAX_N_TENSOR_CORE = 65535 * 128


def choose_route(m: int, k: int, n: int) -> str:
    """The route of a CUDA call: ``"tensor_core"`` when K and N are
    positive multiples of 16, ``"cuda_core"`` otherwise."""
    if k > 0 and k % 16 == 0 and n % 16 == 0 and 0 < n <= MAX_N_TENSOR_CORE:
        return TENSOR_CORE
    return CUDA_CORE


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor, *, route: Optional[str] = None) -> torch.Tensor:
    """x_q (M, K) int8, w_q (K, N) int8, x_scale (M,) and w_scale (N,)
    float32, contiguous on one CUDA device -> (M, N) float32. ``route``
    defaults to :func:`choose_route`; naming one forces it (a benchmark
    times the CUDA-core route at a tensor-core shape)."""
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
    route = choose_route(m, k, n) if route is None else route
    if route not in SYMBOLS or (route == TENSOR_CORE and choose_route(m, k, n) != route):
        raise ValueError(f"int8_matmul: no {route!r} kernel for ({m}, {k}) x ({k}, {n})")
    if route == TENSOR_CORE and (x_q.data_ptr() % 16 or w_q.data_ptr() % 16):
        raise ValueError("int8_matmul's tensor-core route reads 16-byte aligned data "
                         "(its TMA maps)")
    out = torch.empty((m, n), dtype=torch.float32, device=x_q.device)
    if out.numel():
        stream = torch.cuda.current_stream(x_q.device).cuda_stream
        KERNEL.launch(SYMBOLS[route], x_q.data_ptr(), w_q.data_ptr(), x_scale.data_ptr(),
                      w_scale.data_ptr(), out.data_ptr(), m, k, n, stream)
    return out
