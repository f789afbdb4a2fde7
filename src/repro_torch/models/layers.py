"""Neural-net primitives of the port: initializers, convolution (NHWC/
HWIO at the boundary), RMSNorm, LayerNorm, GroupNorm, BatchNorm, RoPE,
SwiGLU, the GELU MLP, the sinusoidal embedding, and the training
forward's helpers (``unstack`` of a layer stack, ``remat`` of a block).

Counterpart of ``repro/models/layers.py``. Tensors keep JAX's layout at
the public functions: activations NHWC and weights HWIO for the
convolutions, dense weights (d_in, d_out) used as ``x @ w``. Inside, a
contiguous NHWC tensor permuted to NCHW is a channels-last view, which
cuDNN takes without a copy. The norms and RoPE compute in float32 and
cast back to the input's dtype, as the reference; the activations round
op by op in the input's dtype, as XLA expands them.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import tree as T
from repro_torch.sharding.local import is_dtensor, keep, local_op, partial_where_sharded, replicated


class _ShapesOnly:
    """The generator an init takes on the ``meta`` device: a meta tensor
    has no values, so nothing is drawn."""
    device = torch.device("meta")


# ``init(SHAPES_ONLY, cfg, device="meta")``: a model's parameter tree as
# shapes and dtypes, allocating nothing (the counterpart of
# ``jax.eval_shape`` over the reference's inits)
SHAPES_ONLY = _ShapesOnly()


def truncated_normal(gen: torch.Generator, shape, stddev: float,
                     dtype=torch.float32) -> torch.Tensor:
    """Normal on [-2, 2] times ``stddev``, drawn in float32 on the
    generator's device (a CPU generator gives the same weights whatever
    device they are moved to), then cast to ``dtype``; on the ``meta``
    device (``SHAPES_ONLY``) the shape alone."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    if t.is_meta:
        return t.to(dtype)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(stddev).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype=torch.float32,
               stddev: float = None, lead=()) -> torch.Tensor:
    """(*lead, d_in, d_out) weights, stddev 1/sqrt(d_in) unless given;
    ``lead`` stacks layers on a leading axis."""
    stddev = stddev if stddev is not None else 1.0 / math.sqrt(d_in)
    return truncated_normal(gen, (*lead, d_in, d_out), stddev, dtype)


def conv_init(gen: torch.Generator, kh: int, kw: int, c_in: int, c_out: int,
              dtype=torch.float32, lead=()) -> torch.Tensor:
    """(*lead, kh, kw, c_in, c_out) HWIO conv weights with fan-in scaling,
    as the reference's; ``lead`` stacks layers on a leading axis."""
    return truncated_normal(gen, (*lead, kh, kw, c_in, c_out),
                            1.0 / math.sqrt(kh * kw * c_in), dtype)


def _same_pads(size: int, k: int, stride: int):
    """XLA's ``padding="SAME"``: (lo, hi) with the odd pixel at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d_nchw(x: torch.Tensor, w_oihw: torch.Tensor, stride: int = 1,
                padding: str = "SAME", groups: int = 1):
    """Convolution of an NCHW tensor with OIHW weights, no bias, with
    XLA's ``padding`` ("SAME" or "VALID") and ``feature_group_count``
    (``groups``: w is (C_out, C_in / groups, kh, kw)).

    On DTensors it runs on each rank's batch rows with the whole weight
    (any other sharding of x, and the weight's channel sharding, are
    gathered first): DTensor's own convolution rule refuses a batch split
    over two mesh dims, the serve cell's pure data parallel layout."""
    if is_dtensor(x) or is_dtensor(w_oihw):
        pl = keep(x, (0,)) if is_dtensor(x) else replicated(w_oihw.device_mesh)
        mesh = (x if is_dtensor(x) else w_oihw).device_mesh
        return local_op(lambda a, b: conv2d_nchw(a, b, stride, padding, groups), (x, w_oihw),
                        mesh, (pl, replicated(mesh)), pl,
                        grad_pl=(pl, partial_where_sharded(pl)))
    if padding == "VALID":
        return F.conv2d(x, w_oihw, stride=stride, groups=groups)
    if padding != "SAME":
        raise ValueError(f"padding {padding!r}: SAME or VALID")
    kh, kw = w_oihw.shape[2], w_oihw.shape[3]
    ph = _same_pads(x.shape[2], kh, stride)
    pw = _same_pads(x.shape[3], kw, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w_oihw, stride=stride, padding=(ph[0], pw[0]), groups=groups)
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w_oihw,
                    stride=stride, groups=groups)


def hwio_to_oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1).contiguous()


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: str = "SAME",
           groups: int = 1) -> torch.Tensor:
    """NHWC input, HWIO weights -> NHWC output: the reference's
    ``conv2d(x, w, stride, padding, groups)``. A depthwise conv's
    (kh, kw, 1, C) weights with ``groups=C`` become (C, 1, kh, kw)."""
    y = conv2d_nchw(x.permute(0, 3, 1, 2), hwio_to_oihw(w), stride, padding, groups)
    return y.permute(0, 2, 3, 1)


def max_pool_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """NHWC max over k x k windows, XLA's ``reduce_window(-inf, max, ...,
    "SAME")``: the odd padded pixel at the end, padded with -inf (a
    symmetric ``F.max_pool2d`` padding differs where the pads differ)."""
    ph = _same_pads(x.shape[1], k, stride)
    pw = _same_pads(x.shape[2], k, stride)
    xn = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(xn, k, stride).permute(0, 2, 3, 1)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in float32 (population variance),
    cast back to x's dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def groupnorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int = 32,
              eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the channel (last) axis of an NHWC tensor; the group
    count shrinks from ``min(groups, C)`` until it divides C."""
    b, h, w, c = x.shape
    g = min(groups, c)
    while c % g:
        g -= 1
    xf = x.float().reshape(b, h, w, g, c // g)
    mu = torch.mean(xf, dim=(1, 2, 4), keepdim=True)
    var = torch.var(xf, dim=(1, 2, 4), keepdim=True, correction=0)
    xf = ((xf - mu) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    return (xf * scale.float() + bias.float()).to(x.dtype)


def batchnorm_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5):
    """BatchNorm of an NHWC tensor on its batch statistics -> (y, batch
    mean, batch population variance), the statistics float32; the caller
    keeps the running ones."""
    xf = x.float()
    mu = torch.mean(xf, dim=(0, 1, 2))
    var = torch.var(xf, dim=(0, 1, 2), correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return y.to(x.dtype), mu, var


def batchnorm_eval(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm of an NHWC tensor on running statistics."""
    y = (x.float() - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return y.to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """theta ** (-2i / head_dim) for i < head_dim / 2, float32. The power
    is taken in float64 and rounded once, which gives XLA's float32
    result: positions up to 32k multiply any error of it into the angle."""
    e = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** e.double()).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, H, D); positions broadcastable to (..., S). Rotates the
    halves [x1, x2] -> [x1 cos - x2 sin, x2 cos + x1 sin]."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None, None].float() * freqs
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """silu(x @ w_gate) * (x @ w_up) @ w_down, each op rounding to x's
    dtype as the reference's einsums do."""
    h = silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), sigmoid as 1 / (1 + exp(-x)) with every op rounding
    to x's dtype: the reference's ``jax.nn.silu`` as XLA expands it. In
    bf16 this rounds four times where ``F.silu`` rounds once, and the two
    differ in the last bit of about 40% of values."""
    return x * torch.reciprocal(1.0 + torch.exp(-x))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh form: x * 0.5 * (1 + tanh(
    sqrt(2 / pi) * (x + 0.044715 * x**3))), the constants rounded to x's
    dtype and every op rounding to it, as XLA expands it (``F.gelu`` takes
    the erf form)."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype).item()
    a = torch.tensor(0.044715, dtype=x.dtype).item()
    return x * (0.5 * (1.0 + torch.tanh(c * (x + a * (x * x * x)))))


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor, w_out: torch.Tensor,
             b_out: torch.Tensor) -> torch.Tensor:
    """gelu(x @ w_in + b_in) @ w_out + b_out."""
    return gelu(x @ w_in + b_in) @ w_out + b_out


def sinusoidal_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """t (B,) -> (B, dim) float32 [cos, sin] of t times the frequencies
    exp(-log(max_period) * i / (dim // 2))."""
    half = dim // 2
    i = torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(torch.tensor(-math.log(max_period), dtype=torch.float32) * i / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def unstack(stack) -> list:
    """A tree (:mod:`repro_torch.tree`) of layer-stacked leaves (n, ...) ->
    n trees of one layer's slices (views), each leaf unbound once: under
    autograd ``torch.unbind``'s backward stacks the n slices' gradients in
    one copy, where indexing ``a[i]`` a layer makes a zero gradient of the
    whole stack for each."""
    parts = [torch.unbind(a) for a in T.leaves(stack)]
    return [T.unflatten(stack, list(layer)) for layer in zip(*parts)]


# the ops whose outputs a rematerialized block keeps: matrix products and
# convolutions, as they reach the dispatcher (``x @ w`` is mm or bmm,
# ``F.conv2d`` is convolution)
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                   torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default,
                   torch.ops.aten.convolution.default})


def _dots_saveable(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, cfg, train: bool):
    """``fn`` as the reference's models wrap a block: where ``train`` and
    ``cfg.remat != "none"``, a checkpoint (``torch.utils.checkpoint``, not
    reentrant) whose policy keeps the outputs of matrix products and
    convolutions and recomputes the rest in the backward (JAX's
    ``dots_saveable``, which the reference applies for every remat value
    but "none"); else ``fn`` itself. The recompute runs the same ops on
    the same inputs, so the gradients are those without it."""
    if not train or cfg.remat == "none":
        return fn
    context = functools.partial(create_selective_checkpoint_contexts, _dots_saveable)
    return functools.partial(checkpoint, fn, use_reentrant=False, context_fn=context)
