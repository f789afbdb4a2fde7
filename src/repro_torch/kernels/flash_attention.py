"""Wrapper of the hand-written CUDA ``flash_attention`` kernel.

Replaces the Pallas kernel ``repro/kernels/flash_attention.py``
(``flash_attention`` / ``_flash_kernel``): online-softmax GQA attention,
float32 inside, ``sm_scale = 1/sqrt(D)`` on q, an optional causal mask by
absolute position, output in q's dtype. Operations-bound at the LM's
prefill shapes. One block per 64 query rows of a (batch, head), 64-key
tiles of its kv head read in place, float32 FMAs on the CUDA cores, and
key tiles past a causal block's diagonal skipped (see
``csrc/flash_attention.cu``).

Unlike the Pallas kernel it takes any Sq, Skv (the ragged tail is
masked) and any D up to 256, so ``ops.attention`` sends every CUDA
tensor here, where the reference's dispatch sends shapes that are not
multiples of 128 to its oracle. Against the plain version
(``ref.attention``) it agrees within 2e-5 in float32 and 3e-2 in bf16,
the contract of tests/test_kernels.py: in bf16 the plain version rounds
the scaled q and the softmax weights to bf16, the kernel keeps them in
float32. It takes CUDA tensors only.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels._build import I, P, CudaKernel

_ARGS = [P, P, P, P, I, I, I, I, I, I, I, ctypes.c_float, P]
KERNEL = CudaKernel("flash_attention", {"flash_attention_f32": _ARGS,
                                        "flash_attention_bf16": _ARGS})
_SYMBOL = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}
MAX_D = 256
MAX_GRID_YZ = 65535


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False) -> torch.Tensor:
    """q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), contiguous, float32 or
    bf16, on one CUDA device -> (B, Sq, Hq, D) in q's dtype."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda) or not (q.device == k.device == v.device):
        raise ValueError("flash_attention kernel takes CUDA tensors on one device")
    if q.dtype not in _SYMBOL or k.dtype != q.dtype or v.dtype != q.dtype:
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
    out = torch.empty_like(q)
    if out.numel():
        stream = torch.cuda.current_stream(q.device).cuda_stream
        KERNEL.launch(_SYMBOL[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), b, sq, skv, hq, hkv, d, int(causal),
                      1.0 / math.sqrt(d), stream)
    return out
