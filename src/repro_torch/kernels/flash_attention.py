"""Wrapper of the hand-written CUDA ``flash_attention`` kernels.

Replaces the Pallas kernel ``repro/kernels/flash_attention.py``
(``flash_attention`` / ``_flash_kernel``): online-softmax GQA attention,
float32 inside, ``sm_scale = 1/sqrt(D)``, an optional causal mask by
absolute position, output in q's dtype. Operations-bound at the LM's
prefill shapes. One source, ``csrc/flash_attention.cu``, holds two
routes, and :func:`choose_route` is the rule between them:

- ``"tensor_core"`` (``flash_attention_bf16_sm90``): bf16 with D 64,
  128 or 192, the kernel's native head dims (``TENSOR_CORE_D``), and
  with a head dim of ``PADDED_D`` (D 80, ViT-H/14's heads): the wrapper
  zero-pads q, k and v to the next native width (128), passes the true
  D's ``sm_scale = 1/sqrt(80)``, and returns the first 80 columns (a
  view). Zero columns add nothing to q . k, and v's zero columns give
  zero outputs, so the result is the D 80 attention. 128 query rows a
  block, TMA loads of K and V tiles, both
  products on wgmma with float32 accumulation, p fed to the second
  product as two bf16 halves (hi + lo), so the result is the float32
  algorithm's. D 192 is deepseek-v2-lite's MLA prefill (q/k heads of
  128 + 64, v zero-padded to 192); its block has a whole producer
  warpgroup that hands its registers to the consumers (``setmaxnreg``),
  since the 96-float accumulator does not fit the D 128 layout.
- ``"cuda_core"`` (``flash_attention_f32``, ``flash_attention_bf16``):
  float32, and bf16 of any other head dim (96, 100, 256, ...). 64
  query rows a block, float32 FMAs on the CUDA cores (TF32 would break
  float32's contract).

Both skip key tiles past a causal block's diagonal, take any Sq, Skv
(the ragged tail is masked), and read the kv head in place. The CUDA-core
route takes any D up to 256, so ``ops.attention`` sends every CUDA tensor
here, where the reference's dispatch sends shapes that are not multiples
of 128 to its oracle. Against the plain version (``ref.attention``) both
agree within 2e-5 in float32 and 3e-2 in bf16, the contract of
tests/test_kernels.py: in bf16 the plain version rounds the scaled q and
the softmax weights to bf16, the kernels keep them in float32. A CUDA
tensor launches the kernel its route names or raises; there is no
fallback between routes. ``KERNEL.symbol_launches`` counts each route's
entry point.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels._build import I, P, CudaKernel

TENSOR_CORE, CUDA_CORE = "tensor_core", "cuda_core"
TENSOR_CORE_D = (64, 128, 192)
# head dims the tensor-core route takes zero-padded to a native one
PADDED_D = {80: 128}
SYMBOLS = {(TENSOR_CORE, torch.bfloat16): "flash_attention_bf16_sm90",
           (CUDA_CORE, torch.float32): "flash_attention_f32",
           (CUDA_CORE, torch.bfloat16): "flash_attention_bf16"}
_ARGS = [P, P, P, P, I, I, I, I, I, I, I, ctypes.c_float, P]
KERNEL = CudaKernel("flash_attention", {sym: _ARGS for sym in SYMBOLS.values()})
MAX_D = 256
MAX_GRID_YZ = 65535


def choose_route(dtype: torch.dtype, head_dim: int) -> str:
    """The route of a CUDA call: ``"tensor_core"`` for bf16 with D 64,
    128 or 192, or D 80 (padded to 128), ``"cuda_core"`` for everything
    else."""
    if dtype == torch.bfloat16 and (head_dim in TENSOR_CORE_D or head_dim in PADDED_D):
        return TENSOR_CORE
    return CUDA_CORE


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, route: Optional[str] = None) -> torch.Tensor:
    """q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), contiguous, float32 or
    bf16, on one CUDA device -> (B, Sq, Hq, D) in q's dtype. ``route``
    defaults to :func:`choose_route`; naming one forces it (a benchmark
    times the CUDA-core route at a tensor-core shape)."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda) or not (q.device == k.device == v.device):
        raise ValueError("flash_attention kernel takes CUDA tensors on one device")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes float32 or bf16 of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if (k.shape[0] != b or k.shape[3] != d or not 1 <= d <= MAX_D or hkv == 0
            or hq % hkv or skv == 0 or max(b, hq) > MAX_GRID_YZ):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v {tuple(k.shape)} "
                         f"need one batch and head dim D <= {MAX_D}, Hq % Hkv == 0, Skv > 0")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous tensors")
    route = choose_route(q.dtype, d) if route is None else route
    symbol = SYMBOLS.get((route, q.dtype))
    if symbol is None or (route == TENSOR_CORE and d not in TENSOR_CORE_D
                          and d not in PADDED_D):
        raise ValueError(f"flash_attention: no {route!r} kernel for {q.dtype} with D {d}")
    dk = PADDED_D.get(d, d) if route == TENSOR_CORE else d
    if dk != d:   # new contiguous, aligned tensors, zero past column d
        q, k, v = (torch.nn.functional.pad(t, (0, dk - d)) for t in (q, k, v))
    if route == TENSOR_CORE and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention's tensor-core route reads 16-byte aligned data "
                         "(its TMA maps)")
    out = torch.empty_like(q)
    if out.numel():
        stream = torch.cuda.current_stream(q.device).cuda_stream
        KERNEL.launch(symbol, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), b, sq, skv, hq, hkv, dk, int(causal),
                      1.0 / math.sqrt(d), stream)
    return out[..., :d] if dk != d else out
