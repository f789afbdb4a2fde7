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
:func:`flash_attention_bwd` (no TPU counterpart: the reference lets XLA
differentiate its oracle), three launches on one of two routes, the rule
:func:`choose_bwd_route`:

- ``"tensor_core"`` (``csrc/flash_attention_bwd_sm90.cu``, entries
  counted on ``BWD_TC_KERNEL``): bf16 with D 64, 80 or 128
  (``TENSOR_CORE_BWD_D``; D 80 read in place, no padding). wgmma and
  TMA, P and dS fed to their products as one bf16 each. It reads each
  row's log-sum-exp from the forward: on this route the Function's
  forward has ``flash_attention_bf16_sm90`` write it (float32 (B, H,
  ``lse_stride(Sq)``), log2 units) and saves it. ``prep`` is then
  rowsum(dO * O) alone.
- ``"cuda_core"`` (``csrc/flash_attention_bwd.cu``, on ``BWD_KERNEL``):
  float32 and bf16 of other head dims; float32 FMAs, ``prep`` recomputing
  the log-sum-exp from q and k.

A forced ``route`` applies to the Function's forward and backward alike.
Both take the causal mask (the forward's, top-left: key > query index
masked; the training forward writes the masked rows' log-sum-exp) and
GQA (k, v of Hkv heads read in place, no repeat: ``dkdv`` walks each kv
head's Hq / Hkv query heads and sums their shares before one store,
``dq`` reads its query head's kv head), any Sq and Skv, D <=
``MAX_BWD_D``; D > 128 (MLA's 192) raises a ``ValueError`` before the
forward launches. Without a gradient nothing is saved, the forward writes
no log-sum-exp (its lse pointer is null) and the launches are the
forward's alone.
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
# the tensor-core entry also takes the lse pointer (null, or float32 (B, Hq,
# lse_stride)) after o, and lse_stride after causal
_TC_ARGS = [P, P, P, P, P, I, I, I, I, I, I, I, I, ctypes.c_float, P]
KERNEL = CudaKernel("flash_attention", {
    sym: _TC_ARGS if route == TENSOR_CORE else _ARGS for (route, _), sym in SYMBOLS.items()})
MAX_D = 256
MAX_GRID_YZ = 65535
# the backward's three entries a dtype, launched in this order
BWD_ENTRIES = ("prep", "dkdv", "dq")
BWD_SYMBOLS = {(e, dt): f"flash_attention_bwd_{e}_{n}" for e in BWD_ENTRIES
               for dt, n in ((torch.float32, "f32"), (torch.bfloat16, "bf16"))}
# after the pointers: b, sq, skv, hq, hkv, d, causal, then sm_scale and the stream
_BWD_ARGS = {"prep": [P] * 6 + [I] * 7 + [ctypes.c_float, P],
             "dkdv": [P] * 8 + [I] * 7 + [ctypes.c_float, P],
             "dq": [P] * 7 + [I] * 7 + [ctypes.c_float, P]}
BWD_KERNEL = CudaKernel("flash_attention_bwd",
                        {sym: _BWD_ARGS[e] for (e, _), sym in BWD_SYMBOLS.items()})
MAX_BWD_D = 128
# the tensor-core backward: bf16 head dims, entries (in launch order), and
# the row padding of its float32 lse and Delta buffers (a multiple of its
# query tile, kBwdTile, so every tile's rows are one aligned bulk copy)
TENSOR_CORE_BWD_D = (64, 80, 128)
BWD_TC_SYMBOLS = {e: f"flash_attention_bwd_{e}_bf16_sm90" for e in BWD_ENTRIES}
# prep: b, sq, hq, d, stride; dkdv and dq: b, sq, skv, hq, hkv, d, causal,
# stride, then sm_scale and the stream
_BWD_TC_ARGS = {"prep": [P] * 3 + [I] * 5 + [P],
                "dkdv": [P] * 8 + [I] * 8 + [ctypes.c_float, P],
                "dq": [P] * 7 + [I] * 8 + [ctypes.c_float, P]}
BWD_TC_KERNEL = CudaKernel("flash_attention_bwd_sm90",
                           {sym: _BWD_TC_ARGS[e] for e, sym in BWD_TC_SYMBOLS.items()})
LSE_ROW_PAD = 64


def choose_route(dtype: torch.dtype, head_dim: int) -> str:
    """The route of a CUDA call: ``"tensor_core"`` for bf16 with D 64,
    128 or 192, or D 80 (padded to 128), ``"cuda_core"`` for everything
    else."""
    if dtype == torch.bfloat16 and (head_dim in TENSOR_CORE_D or head_dim in PADDED_D):
        return TENSOR_CORE
    return CUDA_CORE


def choose_bwd_route(dtype: torch.dtype, head_dim: int) -> str:
    """The route of the gradient of a CUDA call: ``"tensor_core"`` for
    bf16 with D 64, 80 or 128, ``"cuda_core"`` for everything else."""
    if dtype == torch.bfloat16 and head_dim in TENSOR_CORE_BWD_D:
        return TENSOR_CORE
    return CUDA_CORE


def lse_stride(sq: int) -> int:
    """Row length of the log-sum-exp and Delta buffers (B, H, stride) of
    the tensor-core backward: Sq rounded up to ``LSE_ROW_PAD``."""
    return -(-sq // LSE_ROW_PAD) * LSE_ROW_PAD


def check_backward(q_shape, k_shape) -> None:
    """Raise a ``ValueError`` for what the backward kernels do not take:
    D > ``MAX_BWD_D`` (causal and GQA are taken; shapes other than 4-D are
    left to the input checks)."""
    if len(q_shape) != 4 or len(k_shape) != 4:
        return
    if q_shape[3] > MAX_BWD_D:
        raise ValueError(f"flash_attention's backward takes D <= {MAX_BWD_D}, got "
                         f"{q_shape[3]} (D 192, MLA's heads, is the MoE and MLA training "
                         f"slice's)")


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, and :func:`flash_attention_bwd` as its
    gradient, on the backward's route (``route`` if forced, else
    :func:`choose_bwd_route`); on the tensor-core route the forward also
    writes and saves each row's log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, route):
        ctx.route = choose_bwd_route(q.dtype, q.shape[-1]) if route is None else route
        ctx.causal = causal
        if ctx.route == TENSOR_CORE:
            out, lse = _forward(q, k, v, causal, route, with_lse=True)
        else:
            out, lse = _forward(q, k, v, causal, route), None
        out = out.contiguous()
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, out, dout.contiguous(), lse, causal=ctx.causal,
                                     route=ctx.route),
                None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, route: Optional[str] = None) -> torch.Tensor:
    """q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), contiguous, float32 or
    bf16, on one CUDA device -> (B, Sq, Hq, D) in q's dtype. ``route``
    defaults to :func:`choose_route`; naming one forces it (a benchmark
    times the CUDA-core route at a tensor-core shape). Where grad mode is
    on and an input requires a gradient, the result carries
    :func:`flash_attention_bwd` as its backward (checked first by
    :func:`check_backward`), on the forced route if one is named."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        check_backward(q.shape, k.shape)
        return _FlashAttention.apply(q, k, v, causal, route)
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


def _forward(q, k, v, causal, route, with_lse=False):
    """The forward launch -> out, or (out, lse) ``with_lse`` (tensor-core
    route only): lse float32 (B, Hq, ``lse_stride(Sq)``), each row's
    log-sum-exp of ``s * sm_scale`` in log2 units, the rows past Sq
    unwritten."""
    _check_inputs(q, k, v)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    route = choose_route(q.dtype, d) if route is None else route
    symbol = SYMBOLS.get((route, q.dtype))
    if symbol is None or (route == TENSOR_CORE and d not in TENSOR_CORE_D
                          and d not in PADDED_D):
        raise ValueError(f"flash_attention: no {route!r} kernel for {q.dtype} with D {d}")
    if with_lse and route != TENSOR_CORE:
        raise ValueError("flash_attention writes the log-sum-exp on its tensor-core route only")
    dk = PADDED_D.get(d, d) if route == TENSOR_CORE else d
    if dk != d:   # new contiguous, aligned tensors, zero past column d
        q, k, v = (torch.nn.functional.pad(t, (0, dk - d)) for t in (q, k, v))
    if route == TENSOR_CORE and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention's tensor-core route reads 16-byte aligned data "
                         "(its TMA maps)")
    out = torch.empty_like(q)
    stride = lse_stride(sq)
    lse = (torch.empty((b, hq, stride), dtype=torch.float32, device=q.device) if with_lse
           else None)
    if out.numel():
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == TENSOR_CORE:
            KERNEL.launch(symbol, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                          None if lse is None else lse.data_ptr(), b, sq, skv, hq, hkv, dk,
                          int(causal), stride, 1.0 / math.sqrt(d), stream)
        else:
            KERNEL.launch(symbol, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), b, sq, skv, hq, hkv, dk, int(causal),
                          1.0 / math.sqrt(d), stream)
    out = out[..., :d] if dk != d else out
    return (out, lse) if with_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        dout: torch.Tensor, lse: Optional[torch.Tensor] = None, *,
                        causal: bool = False, route: Optional[str] = None):
    """The gradient of :func:`flash_attention` -> (dq, dk, dv) in the
    inputs' dtype: q, o, dout (B, Sq, Hq, D), k, v (B, Skv, Hkv, D), Hq %
    Hkv == 0, contiguous, float32 or bf16, on one CUDA device, D <=
    ``MAX_BWD_D``, ``o`` the forward's output with the same ``causal``;
    ``sm_scale = 1/sqrt(D)``. dk and dv sum the shares of each kv head's
    Hq / Hkv query heads. ``route`` defaults to :func:`choose_bwd_route`.
    Three launches each, ``causal``, Hq and Hkv passed to each but the
    tensor-core ``prep``:

    - ``"tensor_core"``: ``lse`` is the forward's log-sum-exp (``_forward(...,
      with_lse=True)`` with the same ``causal``), float32 (B, Hq,
      ``lse_stride(Sq)``); ``prep`` (rowsum(dout * o) into float32 scratch
      of that shape), ``dkdv``, ``dq`` on wgmma.
    - ``"cuda_core"``: ``lse`` is not read; ``prep`` (each row's
      log-sum-exp, recomputed from q and k under the mask, and rowsum(dout
      * o)), ``dkdv``, ``dq`` on float32 FMAs."""
    check_backward(q.shape, k.shape)
    _check_inputs(q, k, v)
    if o.shape != q.shape or dout.shape != q.shape or o.dtype != q.dtype or \
            dout.dtype != q.dtype or o.device != q.device or dout.device != q.device:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} {o.dtype} and dout "
                         f"{tuple(dout.shape)} {dout.dtype} must be q's shape and dtype "
                         f"{tuple(q.shape)} {q.dtype}, on its device")
    if not (o.is_contiguous() and dout.is_contiguous()):
        raise ValueError("flash_attention_bwd takes contiguous tensors")
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    route = choose_bwd_route(q.dtype, d) if route is None else route
    if route == TENSOR_CORE:
        _check_tensor_core_bwd(q, k, v, o, dout, lse)
    elif route != CUDA_CORE:
        raise ValueError(f"flash_attention_bwd: no route {route!r}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route == TENSOR_CORE:
        stride = lse.shape[2]
        delta = torch.empty_like(lse)
        ptr = {n: t.data_ptr() for n, t in dict(q=q, k=k, v=v, o=o, do=dout, lse=lse,
                                                delta=delta, dq=dq, dk=dk, dv=dv).items()}
        sizes = (b, sq, skv, h, hkv, d, int(causal), stride, 1.0 / math.sqrt(d), stream)
        sym = BWD_TC_SYMBOLS
        BWD_TC_KERNEL.launch(sym["prep"], ptr["o"], ptr["do"], ptr["delta"], b, sq, h, d,
                             stride, stream)
        BWD_TC_KERNEL.launch(sym["dkdv"], ptr["q"], ptr["k"], ptr["v"], ptr["do"], ptr["lse"],
                             ptr["delta"], ptr["dk"], ptr["dv"], *sizes)
        BWD_TC_KERNEL.launch(sym["dq"], ptr["q"], ptr["k"], ptr["v"], ptr["do"], ptr["lse"],
                             ptr["delta"], ptr["dq"], *sizes)
        return dq, dk, dv
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    ptr = {n: t.data_ptr() for n, t in dict(q=q, k=k, v=v, o=o, do=dout, lse=lse, delta=delta,
                                            dq=dq, dk=dk, dv=dv).items()}
    sizes = (b, sq, skv, h, hkv, d, int(causal), 1.0 / math.sqrt(d), stream)
    sym = {e: BWD_SYMBOLS[e, q.dtype] for e in BWD_ENTRIES}
    BWD_KERNEL.launch(sym["prep"], ptr["q"], ptr["k"], ptr["o"], ptr["do"], ptr["lse"],
                      ptr["delta"], *sizes)
    BWD_KERNEL.launch(sym["dkdv"], ptr["q"], ptr["k"], ptr["v"], ptr["do"], ptr["lse"],
                      ptr["delta"], ptr["dk"], ptr["dv"], *sizes)
    BWD_KERNEL.launch(sym["dq"], ptr["q"], ptr["k"], ptr["v"], ptr["do"], ptr["lse"],
                      ptr["delta"], ptr["dq"], *sizes)
    return dq, dk, dv


def _check_tensor_core_bwd(q, k, v, o, dout, lse):
    """What the tensor-core backward takes beyond :func:`check_backward`:
    bf16 with D in ``TENSOR_CORE_BWD_D``, 16-byte aligned data (its TMA
    maps and 16-byte loads), and the forward's lse."""
    b, sq, h, d = q.shape
    if q.dtype != torch.bfloat16 or d not in TENSOR_CORE_BWD_D:
        raise ValueError(f"flash_attention_bwd: no 'tensor_core' kernel for {q.dtype} with D {d}")
    if any(t.data_ptr() % 16 for t in (q, k, v, o, dout)):
        raise ValueError("flash_attention_bwd's tensor-core route reads 16-byte aligned data")
    if lse is None or lse.shape != (b, h, lse_stride(sq)) or lse.dtype != torch.float32 or \
            lse.device != q.device or not lse.is_contiguous():
        got = None if lse is None else (tuple(lse.shape), lse.dtype)
        raise ValueError(f"flash_attention_bwd's tensor-core route reads the forward's "
                         f"log-sum-exp, float32 {(b, h, lse_stride(sq))}, got {got}")
