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

The gradient: where grad mode is on and q, k or v requires a gradient,
:func:`flash_attention` runs through a ``torch.autograd.Function`` whose
forward is the call above (same routes, padding and ``sm_scale``) and
saves q, k, v and the unpadded output; its backward is
:func:`flash_attention_bwd`, the hand-written CUDA-core kernel of
``csrc/flash_attention_bwd.cu`` (no TPU counterpart: the reference lets
XLA differentiate its oracle), whose three entries count their launches
on ``BWD_KERNEL``. It takes non-causal attention with Hq == Hkv and D <=
``MAX_BWD_D``, any Sq and Skv; a causal mask or GQA raises a
``ValueError`` before the forward launches. Without a gradient nothing is
saved and the launches are the forward's alone.
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
# the backward's three entries a dtype, launched in this order
BWD_ENTRIES = ("prep", "dkdv", "dq")
BWD_SYMBOLS = {(e, dt): f"flash_attention_bwd_{e}_{n}" for e in BWD_ENTRIES
               for dt, n in ((torch.float32, "f32"), (torch.bfloat16, "bf16"))}
_BWD_ARGS = {"prep": [P] * 6 + [I] * 5 + [ctypes.c_float, P],
             "dkdv": [P] * 8 + [I] * 5 + [ctypes.c_float, P],
             "dq": [P] * 7 + [I] * 5 + [ctypes.c_float, P]}
BWD_KERNEL = CudaKernel("flash_attention_bwd",
                        {sym: _BWD_ARGS[e] for (e, _), sym in BWD_SYMBOLS.items()})
MAX_BWD_D = 128


def choose_route(dtype: torch.dtype, head_dim: int) -> str:
    """The route of a CUDA call: ``"tensor_core"`` for bf16 with D 64,
    128 or 192, or D 80 (padded to 128), ``"cuda_core"`` for everything
    else."""
    if dtype == torch.bfloat16 and (head_dim in TENSOR_CORE_D or head_dim in PADDED_D):
        return TENSOR_CORE
    return CUDA_CORE


def check_backward(q_shape, k_shape, causal: bool) -> None:
    """Raise a ``ValueError`` for what the backward kernel does not take:
    a causal mask, GQA (Hq != Hkv) or D > ``MAX_BWD_D`` (shapes other than
    4-D are left to the input checks)."""
    if len(q_shape) != 4 or len(k_shape) != 4:
        return
    if causal:
        raise ValueError("flash_attention's backward takes non-causal attention only "
                         "(the causal backward is the LM training slice's)")
    if q_shape[2] != k_shape[2]:
        raise ValueError(f"flash_attention's backward takes Hq == Hkv, got {q_shape[2]} "
                         f"query and {k_shape[2]} kv heads (GQA is the LM training slice's)")
    if q_shape[3] > MAX_BWD_D:
        raise ValueError(f"flash_attention's backward takes D <= {MAX_BWD_D}, got "
                         f"{q_shape[3]}")


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, and :func:`flash_attention_bwd` as its
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, route):
        out = _forward(q, k, v, False, route).contiguous()
        ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, out, dout.contiguous()), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, route: Optional[str] = None) -> torch.Tensor:
    """q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), contiguous, float32 or
    bf16, on one CUDA device -> (B, Sq, Hq, D) in q's dtype. ``route``
    defaults to :func:`choose_route`; naming one forces it (a benchmark
    times the CUDA-core route at a tensor-core shape). Where grad mode is
    on and an input requires a gradient, the result carries
    :func:`flash_attention_bwd` as its backward (checked first by
    :func:`check_backward`)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        check_backward(q.shape, k.shape, causal)
        return _FlashAttention.apply(q, k, v, route)
    return _forward(q, k, v, causal, route)


def _check_inputs(q, k, v):
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


def _forward(q, k, v, causal, route):
    _check_inputs(q, k, v)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
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


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        dout: torch.Tensor):
    """The gradient of non-causal :func:`flash_attention` -> (dq, dk, dv)
    in the inputs' dtype: q, o, dout (B, Sq, H, D), k, v (B, Skv, H, D),
    contiguous, float32 or bf16, on one CUDA device, D <= ``MAX_BWD_D``,
    ``o`` the forward's output. Three launches: ``prep`` (each row's
    log-sum-exp, recomputed from q and k, and rowsum(dout * o) into
    float32 scratch), ``dkdv``, ``dq``; ``sm_scale = 1/sqrt(D)``."""
    check_backward(q.shape, k.shape, False)
    _check_inputs(q, k, v)
    if o.shape != q.shape or dout.shape != q.shape or o.dtype != q.dtype or \
            dout.dtype != q.dtype or o.device != q.device or dout.device != q.device:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} {o.dtype} and dout "
                         f"{tuple(dout.shape)} {dout.dtype} must be q's shape and dtype "
                         f"{tuple(q.shape)} {q.dtype}, on its device")
    if not (o.is_contiguous() and dout.is_contiguous()):
        raise ValueError("flash_attention_bwd takes contiguous tensors")
    b, sq, h, d = q.shape
    skv = k.shape[1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    ptr = {n: t.data_ptr() for n, t in dict(q=q, k=k, v=v, o=o, do=dout, lse=lse, delta=delta,
                                            dq=dq, dk=dk, dv=dv).items()}
    sizes = (b, sq, skv, h, d, 1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    sym = {e: BWD_SYMBOLS[e, q.dtype] for e in BWD_ENTRIES}
    BWD_KERNEL.launch(sym["prep"], ptr["q"], ptr["k"], ptr["o"], ptr["do"], ptr["lse"],
                      ptr["delta"], *sizes)
    BWD_KERNEL.launch(sym["dkdv"], ptr["q"], ptr["k"], ptr["v"], ptr["do"], ptr["lse"],
                      ptr["delta"], ptr["dk"], ptr["dv"], *sizes)
    BWD_KERNEL.launch(sym["dq"], ptr["q"], ptr["k"], ptr["v"], ptr["do"], ptr["lse"],
                      ptr["delta"], ptr["dq"], *sizes)
    return dq, dk, dv
