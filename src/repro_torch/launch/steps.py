"""The cell layer: (arch x input shape) -> a step and its inputs, and
the training steps of every family.

Counterpart of ``repro/launch/steps.py``. :func:`build_cell` returns
a :class:`CellPlan`: the step of one
cell of the model configurations' shape sets (``configs.all_cells()``
and the counters' ``DETECTOR_SHAPES``), its input tree of ``meta``
tensors (shapes and dtypes in JAX's leaf order, :mod:`repro_torch.tree`)
and the reference's ``meta`` keys; :func:`input_specs` gives the inputs
alone and :func:`model_flops` a cell's useful FLOPs by the reference's
formulas. Nothing is allocated: the parameter, optimizer and cache trees
come from the inits on the ``meta`` device (``layers.SHAPES_ONLY``),
the counterpart of ``jax.eval_shape``. A plan's ``fn`` runs where its
inputs are (a card or the CPU) and refuses ``meta`` inputs. On a mesh
(``build_cell(arch, shape, mesh)``) the plan also holds the reference's
``in_shardings`` and ``out_shardings`` and its step runs on DTensors
(:func:`place_inputs`).

The cells: an LM's ``train`` (:func:`lm_train`), ``prefill``
(``lm.prefill``) and ``decode`` (``lm.decode_step``); a vision model's
``cls`` (:func:`vision_train`) and ``serve`` (the forward); a diffusion
model's ``train`` (:func:`diffusion_train`) and ``gen`` (one
``diffusion.ddim_step``); a counter's ``serve``, the paper's onboard
pipeline as one step (the counter's forward, count and confidence after
NMS, ``tile_moments``, ``kmeans_assign``, the ``dynamic_conf`` throttle
and the space tier's count: on a card three kernel launches,
``nms_keep_f32``, ``tile_moments_f32`` and ``kmeans_assign_f32``, and
no host sync) and ``train`` (``models.detector.loss_fn``'s AdamW step).

``lm_train``, ``vision_train`` and ``diffusion_train`` return
``(opt_init, step)`` for one config, ``step`` one AdamW update of the
port's ``optim/adamw.py`` on a batch.
``models.lm.loss_fn``, ``vision_loss``, ``diffusion_loss`` and
``models.detector.loss_fn`` are the steps' loss functions, and
``value_and_grad`` their gradient: ``torch.autograd.grad`` of the loss
over the parameter tree's leaves in JAX's leaf order, through the
models' training forwards (``cfg.remat`` rematerializes their blocks as
the reference's). On a card every attention's gradient is the
``flash_attention`` backward kernel's (the LMs' causal and GQA; MLA's
q/k heads of 192 on its D 192 entries), and the MoE layers' dispatch and
combine add no gradient with atomics (``models/moe.py``), so a step
reruns bit for bit.

The diffusion steps take the timesteps ``t`` and the noise as arguments,
where the reference's draw them from a key inside the step:
``models.diffusion.draw_train_inputs`` draws them from a generator. The
plan of a diffusion ``train`` cell so holds ``t`` (B,) int32 and
``noise`` (B, lr, lr, C) float32 where the reference's holds a (2,)
uint32 key: the one way its inputs differ from the reference's.

``donate=True`` is the counterpart of the reference cells'
``donate_argnums``: the step writes the new parameters, moments (and
ResNet's running statistics) into its arguments' tensors and returns
those tensors, so the caller must not read the old values after the
call: AdamW writes its new values into the parameters' and moments'
tensors (``in_place=True``). The state then stays where it was
allocated, and every step asks the caching allocator for the same blocks
in the same order; without it each step allocates the new state beside
the old, and the cache's layout may take many steps to repeat. A
full-width LM's state leaves no room for that second copy
(phi4-mini-3.8b: 46 GB of bf16 weights and gradients and float32
moments). The numbers are the same either way. Every training cell's
step is built with ``donate=True``.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tree as T
from repro_torch.configs.base import ShapeSpec, get_config, get_shape
from repro_torch.core.energy import detector_gflops
from repro_torch.core.throttle import throttle
from repro_torch.kernels import ops as kops
from repro_torch.models import convnext, detector, diffusion, dit, lm, resnet, unet, vit
from repro_torch.models import layers as L
from repro_torch.optim.adamw import AdamWState, adamw
from repro_torch.sharding import NamedSharding, P, axis_sizes
from repro_torch.sharding import ctx
from repro_torch.sharding import policy as pol
from repro_torch.sharding.place import distribute
from repro_torch.sharding.rules import param_specs


def ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of integer labels on float32 log-softmax, as
    the reference's ``ce``."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels.long()[:, None]))


def _donate(old, new):
    """``new``'s leaves copied into ``old``'s tensors -> ``old`` (ResNet's
    running statistics)."""
    from torch.distributed.tensor import DTensor
    with torch.no_grad():
        olds, news = T.leaves(old), T.leaves(new)
        if any(isinstance(x, DTensor) for x in olds):   # on a mesh: shard by shard
            for o, n in zip(olds, news):
                o.to_local().copy_(n.redistribute(o.device_mesh, o.placements).to_local())
        else:
            torch._foreach_copy_(olds, news)
    return old


def _update(opt_update, grads, opt_state, params, donate):
    """One AdamW update -> (params, opt_state), written into the
    arguments' tensors when ``donate`` (AdamW's ``in_place``)."""
    params, opt_state, _ = opt_update(grads, opt_state, params, in_place=donate)
    return params, opt_state


def value_and_grad(loss_fn, params):
    """``jax.value_and_grad`` of ``loss_fn(p)``, which returns the loss
    or (loss, aux), at ``params`` -> (loss, the gradient tree, aux or
    None), all detached. ``p`` is ``params``' tree of leaves detached to
    require a gradient."""
    leaves = [x.detach().requires_grad_() for x in T.leaves(params)]
    out = loss_fn(T.unflatten(params, leaves))
    loss, aux = out if isinstance(out, tuple) else (out, None)
    grads = torch.autograd.grad(loss, leaves)
    aux = None if aux is None else T.map_leaves(torch.Tensor.detach, aux)
    return loss.detach(), T.unflatten(params, list(grads)), aux


def vision_loss(cfg):
    """The vision step's loss: ``loss_fn(params, images, labels)`` ->
    ``ce`` of the training forward's logits; for ResNet
    ``loss_fn(params, bn_state, images, labels)`` -> (loss, the running
    statistics updated by the batch's)."""
    if cfg.kind == "resnet":
        def loss_fn(params, bn_state, images, labels):
            logits, new_bn = resnet.forward(params, bn_state, cfg, images, train=True)
            return ce(logits, labels), new_bn
        return loss_fn
    mod = {"vit": vit, "convnext": convnext}[cfg.kind]
    return lambda params, images, labels: ce(mod.forward(params, cfg, images, train=True),
                                             labels)


def diffusion_loss(cfg):
    """The diffusion step's loss: ``loss_fn(params, latents, cond, t,
    noise)`` -> ``diffusion.train_loss`` of the training forward's eps,
    ``cond`` DiT's class ids (B,) or the UNet's text context (B,
    ctx_len, ctx_dim)."""
    def loss_fn(params, latents, cond, t, noise):
        if cfg.kind == "dit":
            def eps_fn(x, tt):
                return dit.forward(params, cfg, x, tt, cond, train=True)[0]
        else:
            def eps_fn(x, tt):
                return unet.forward(params, cfg, x, tt, cond, train=True)
        return diffusion.train_loss(eps_fn, latents, t, noise)
    return loss_fn


def vision_train(cfg, lr: float = 1e-3, donate: bool = False):
    """-> (opt_init, step) of a ViT, ConvNeXt or ResNet config:
    ``step(params, opt_state, images, labels) -> (params, opt_state,
    loss)``; for ResNet ``step(params, bn_state, opt_state, images,
    labels) -> (params, bn_state, opt_state, loss)``. ``donate``: see
    the module's docstring."""
    opt_init, opt_update = adamw(lr)
    loss_fn = vision_loss(cfg)
    if cfg.kind == "resnet":
        def step(params, bn_state, opt_state, images, labels):
            loss, grads, new_bn = value_and_grad(
                lambda p: loss_fn(p, bn_state, images, labels), params)
            if donate:
                new_bn = _donate(bn_state, new_bn)
            params, opt_state = _update(opt_update, grads, opt_state, params, donate)
            return params, new_bn, opt_state, loss
        return opt_init, step

    def step(params, opt_state, images, labels):
        loss, grads, _ = value_and_grad(lambda p: loss_fn(p, images, labels), params)
        params, opt_state = _update(opt_update, grads, opt_state, params, donate)
        return params, opt_state, loss
    return opt_init, step


def diffusion_train(cfg, lr: float = 1e-4, donate: bool = False):
    """-> (opt_init, step) of a DiT or UNet config: ``step(params,
    opt_state, latents, cond, t, noise) -> (params, opt_state, loss)``
    (``cond`` as ``diffusion_loss``'s; ``donate``: see the module's
    docstring)."""
    opt_init, opt_update = adamw(lr)
    loss_fn = diffusion_loss(cfg)

    def step(params, opt_state, latents, cond, t, noise):
        loss, grads, _ = value_and_grad(lambda p: loss_fn(p, latents, cond, t, noise), params)
        params, opt_state = _update(opt_update, grads, opt_state, params, donate)
        return params, opt_state, loss
    return opt_init, step


def lm_train(cfg, lr: float = 1e-4, grad_accum: int = 1, donate: bool = False):
    """-> (opt_init, step) of an LM config, the reference's ``_lm_train``
    step: ``step(params, opt_state, tokens, labels) -> (params, opt_state,
    loss)``, tokens and labels (B, S) with B a multiple of ``grad_accum``.
    With ``grad_accum > 1`` the batch is split into micro-batches of B /
    grad_accum rows in order (row i of micro-batch j is row j B /
    grad_accum + i), and each micro-batch's gradient is added to float32
    zeros as ``g.float() / grad_accum`` and its loss to 0 as ``loss /
    grad_accum``, in the reference's scan order; AdamW takes that float32
    tree. The accumulator's leaves are updated in place, leaf by leaf, as
    each micro-batch's gradient is freed. ``donate``: AdamW writes the new
    parameters and moments into the arguments' tensors (``in_place``, see
    the module's docstring) and the step returns those tensors."""
    opt_init, opt_update = adamw(lr)

    def grad_of(params, tokens, labels):
        loss, grads, _ = value_and_grad(lambda p: lm.loss_fn(p, cfg, tokens, labels), params)
        return loss, grads

    def step(params, opt_state, tokens, labels):
        if grad_accum > 1:
            b, s = tokens.shape
            acc = T.map_leaves(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                                     device=x.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for t, lab in zip(tokens.reshape(grad_accum, b // grad_accum, s),
                              labels.reshape(grad_accum, b // grad_accum, s)):
                micro_loss, g = grad_of(params, t, lab)
                for a, x in zip(T.leaves(acc), T.leaves(g)):
                    a.add_(x.float() / grad_accum)
                del g
                loss = loss + micro_loss / grad_accum
            grads = acc
        else:
            loss, grads = grad_of(params, tokens, labels)
        params, opt_state = _update(opt_update, grads, opt_state, params, donate)
        return params, opt_state, loss
    return opt_init, step


# ---------------------------------------------------------------------------
# the cell layer
# ---------------------------------------------------------------------------


@dataclass
class CellPlan:
    """One cell's step and its inputs. ``fn(*args)`` runs where its
    inputs are; ``args`` holds its input trees as ``meta`` tensors in
    JAX's leaf order. ``donate_argnums``: the arguments the step may
    overwrite (the reference's), which the caller must not read after
    the call. ``meta``: the reference's keys (``tokens``, ``images``,
    ``tiles``, ``kind``, ``steps``, ``cache_len``) and ``host_scalars``,
    the positions of the 0-d int32 arguments that the step reads as host
    ints (a decode's ``pos``, a DDIM step's ``t_cur`` and ``t_prev``):
    pass them as CPU tensors or ints, so reading them waits on no card.

    A plan built on a mesh also holds ``mesh`` and the reference's
    ``in_shardings`` and ``out_shardings``: trees of
    :class:`~repro_torch.sharding.NamedSharding` (a spec, :class:`P`, and
    its DTensor placements on ``mesh``) shaped like ``args`` and like the
    step's outputs, in JAX's leaf order. Its ``fn`` takes inputs placed by
    :func:`place_inputs` and returns DTensors laid out by
    ``out_shardings``."""
    arch: str
    shape: str
    fn: Callable
    args: Tuple
    donate_argnums: Tuple[int, ...] = ()
    meta: Dict[str, Any] = field(default_factory=dict)
    mesh: Any = None
    in_shardings: Tuple = None
    out_shardings: Any = None


# build_cell's options: the reference's; the mesh options need a mesh
_OPTIONS = ("remat", "grad_accum", "mla_absorb", "unroll")
_MESH_OPTIONS = ("zero1_axis", "no_pure_dp", "dp_serve")


def opt_init(params):
    """AdamW's first state for ``params`` (float32 zero moments, step 0),
    the optimizer state of every training cell: the same at any rate."""
    return adamw(0.0)[0](params)


def _spec(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _shapes(mod, cfg):
    """``mod.init``'s parameter tree (ResNet's: with its running
    statistics) as ``meta`` tensors."""
    return mod.init(L.SHAPES_ONLY, cfg, device="meta")


def _first_leaf(tree):
    while isinstance(tree, (dict, list, tuple)) and len(tree):
        tree = tree[sorted(tree)[0]] if isinstance(tree, dict) else tree[0]
    return tree


def _computes(step):
    """``step`` refusing shape-only inputs: a plan's ``args`` describe its
    inputs, they are not inputs."""
    @functools.wraps(step)
    def run(*args):
        for a in args:
            x = _first_leaf(a)
            if isinstance(x, torch.Tensor) and x.is_meta:
                raise ValueError("a cell's step computes on a card or the CPU; its plan's "
                                 "args are meta tensors that give shapes only")
        return step(*args)
    return run


def _host_int(x) -> int:
    """A host scalar argument (an int, or a 0-d tensor on the CPU)."""
    if isinstance(x, torch.Tensor) and x.device.type != "cpu":
        raise ValueError(f"a host scalar lies on {x.device}: reading it would wait on the card")
    return int(x)


def _plan(arch, shape, step, args, donate=(), **meta):
    return CellPlan(arch, shape.name, _computes(step), tuple(args), tuple(donate), meta)


def _lm_train(arch, cfg, shape: ShapeSpec, opts):
    b, s = shape.global_batch, shape.seq_len
    step = lm_train(cfg, 1e-4, grad_accum=opts.get("grad_accum", 1), donate=True)[1]
    params = _shapes(lm, cfg)
    args = (params, opt_init(params), _spec((b, s), torch.int32), _spec((b, s), torch.int32))
    return _plan(arch, shape, step, args, (0, 1), tokens=b * s, kind="train")


def _lm_prefill(arch, cfg, shape: ShapeSpec, opts):
    b, s = shape.global_batch, shape.seq_len

    def step(params, tokens):
        return lm.prefill(params, cfg, tokens)
    args = (_shapes(lm, cfg), _spec((b, s), torch.int32))
    return _plan(arch, shape, step, args, tokens=b * s, kind="prefill")


def _lm_decode(arch, cfg, shape: ShapeSpec, opts):
    b, s = shape.global_batch, shape.seq_len
    absorb = opts.get("mla_absorb", True)

    def step(params, token, caches, pos):
        return lm.decode_step(params, cfg, token, caches, _host_int(pos), absorb=absorb)
    args = (_shapes(lm, cfg), _spec((b, 1), torch.int32), lm.init_cache(cfg, b, s, "meta"),
            _spec((), torch.int32))
    return _plan(arch, shape, step, args, (2,), tokens=b, kind="decode", cache_len=s,
                 host_scalars=(3,))


def _vision_module(cfg):
    return {"vit": vit, "convnext": convnext, "resnet": resnet}[cfg.kind]


def _vision_train(arch, cfg, shape: ShapeSpec, opts):
    b, r = shape.global_batch, shape.img_res
    step = vision_train(cfg, 1e-3, donate=True)[1]
    batch = (_spec((b, r, r, 3)), _spec((b,), torch.int32))
    if cfg.kind == "resnet":
        params, bn = _shapes(resnet, cfg)
        return _plan(arch, shape, step, (params, bn, opt_init(params), *batch), (0, 1, 2),
                     images=b, kind="train")
    params = _shapes(_vision_module(cfg), cfg)
    return _plan(arch, shape, step, (params, opt_init(params), *batch), (0, 1),
                 images=b, kind="train")


def _vision_serve(arch, cfg, shape: ShapeSpec, opts):
    b, r = shape.global_batch, shape.img_res
    images = _spec((b, r, r, 3))
    if cfg.kind == "resnet":
        def step(params, bn_state, images):
            return resnet.forward(params, bn_state, cfg, images, train=False)[0]
        args = (*_shapes(resnet, cfg), images)
    else:
        mod = _vision_module(cfg)

        def step(params, images):
            return mod.forward(params, cfg, images, train=False)
        args = (_shapes(mod, cfg), images)
    return _plan(arch, shape, step, args, images=b, kind="serve")


def _cond_spec(cfg, b):
    """DiT's class ids (B,) int32 or the UNet's text context (B, ctx_len,
    ctx_dim) float32."""
    if cfg.kind == "dit":
        return _spec((b,), torch.int32)
    return _spec((b, cfg.ctx_len, cfg.ctx_dim))


def _diff_train(arch, cfg, shape: ShapeSpec, opts):
    b, lr = shape.global_batch, shape.img_res // cfg.latent_factor
    step = diffusion_train(cfg, 1e-4, donate=True)[1]
    params = _shapes(dit if cfg.kind == "dit" else unet, cfg)
    latents = _spec((b, lr, lr, cfg.latent_ch))
    args = (params, opt_init(params), latents, _cond_spec(cfg, b), _spec((b,), torch.int32),
            _spec(latents.shape))
    return _plan(arch, shape, step, args, (0, 1), images=b, kind="train", steps=shape.steps)


def _diff_gen(arch, cfg, shape: ShapeSpec, opts):
    b, lr = shape.global_batch, shape.img_res // cfg.latent_factor
    mod = dit if cfg.kind == "dit" else unet

    def step(params, latents, cond, t_cur, t_prev):
        def eps_fn(x, t):
            out = mod.forward(params, cfg, x, t, cond, train=False)
            return out[0] if cfg.kind == "dit" else out
        return diffusion.ddim_step(eps_fn, latents, _host_int(t_cur), _host_int(t_prev))
    args = (_shapes(mod, cfg), _spec((b, lr, lr, cfg.latent_ch)), _cond_spec(cfg, b),
            _spec((), torch.int32), _spec((), torch.int32))
    return _plan(arch, shape, step, args, (1,), images=b, kind="gen", steps=shape.steps,
                 host_scalars=(3, 4))


# the onboard serve cell: k-means clusters over the tiles' 3C moments,
# and the throttle's thresholds and byte budget (a share of the batch's
# raw bytes), the reference's
SERVE_CLUSTERS = 64
SERVE_CONF_P, SERVE_CONF_Q, SERVE_BUDGET_SHARE = 0.10, 0.55, 0.15


def _targetfuse_serve(arch, cfg, shape: ShapeSpec, opts):
    b, r = shape.global_batch, shape.img_res

    def step(params, tiles, centroids):
        """The full onboard pipeline of Fig. 3 as one step -> (counts (B,),
        conf (B,), assign (B,) int32, downlink (B,) bool, c_space 0-d)."""
        raw = detector.forward(params, cfg, tiles)
        counts, conf = detector.count_and_confidence(raw, cfg, input_size=r)
        feats = kops.tile_moments(tiles)
        assign, _ = kops.kmeans_assign(feats, centroids)
        sizes = torch.full((b,), float(r * r * 3), device=tiles.device)
        tr = throttle(conf, sizes, b * r * r * 3 * SERVE_BUDGET_SHARE, SERVE_CONF_P,
                      SERVE_CONF_Q, "dynamic_conf")
        c_space = torch.sum(torch.where(tr.space, counts, 0.0))
        return counts, conf, assign, tr.downlink, c_space
    args = (_shapes(detector, cfg), _spec((b, r, r, 3)), _spec((SERVE_CLUSTERS, 9)))
    return _plan(arch, shape, step, args, tiles=b, kind="serve")


def _detector_train(arch, cfg, shape: ShapeSpec, opts):
    """The counter's training step, donated: ``step(params, opt_state,
    images, targets) -> (params, opt_state, loss)``, images (B, S, S, 3)
    float32 and targets (B, G, G, A, 5 + C) float32;
    ``detector.loss_fn`` under ``value_and_grad``, then AdamW at 1e-3."""
    b, r = shape.global_batch, shape.img_res
    g = detector.grid_size(cfg, r)
    opt_update = adamw(1e-3)[1]

    def step(params, opt_state, images, targets):
        loss, grads, _ = value_and_grad(
            lambda p: detector.loss_fn(p, cfg, images, targets), params)
        params, opt_state = _update(opt_update, grads, opt_state, params, True)
        return params, opt_state, loss
    params = _shapes(detector, cfg)
    args = (params, opt_init(params), _spec((b, r, r, 3)),
            _spec((b, g, g, cfg.n_anchors, 5 + cfg.n_classes)))
    return _plan(arch, shape, step, args, (0, 1), tiles=b, kind="train")


_CELLS = {("lm", "train"): _lm_train, ("lm", "prefill"): _lm_prefill,
          ("lm", "decode"): _lm_decode, ("vision", "cls"): _vision_train,
          ("vision", "serve"): _vision_serve, ("diffusion", "train"): _diff_train,
          ("diffusion", "gen"): _diff_gen, ("detector", "train"): _detector_train,
          ("detector", "serve"): _targetfuse_serve}


# ---------------------------------------------------------------------------
# the cells' shardings on a mesh, the reference's
# ---------------------------------------------------------------------------


def _replicated_specs(tree):
    return T.map_leaves(lambda x: P(*([None] * x.ndim)), tree)


def _state_specs(params, cfg, mesh, zero1_axis=None):
    """Spec trees of (params, AdamW state). ZeRO-1: the moments also
    shard over ``zero1_axis`` on their first replicated dim of a size
    divisible by 16 (on top of the parameter's own layout)."""
    pspec = param_specs(params, cfg, mesh)

    def moment_spec(ps, leaf):
        if zero1_axis is None:
            return ps
        parts = list(ps)
        for i, axis in enumerate(parts):
            if axis is None and leaf.shape[i] % 16 == 0:
                parts[i] = zero1_axis
                break
        return P(*parts)
    mspec = T.unflatten(params, [moment_spec(ps, x) for ps, x in
                                 zip(T.leaves(pspec), T.leaves(params))])
    return pspec, AdamWState(step=P(), mu=mspec, nu=mspec)


def _pure_dp_axes(mesh, batch: int, n_params: int, max_params: float = 1.5e9):
    """Pure data parallelism for small models: when the global batch
    divides the whole mesh and the replicated model and optimizer fit,
    tensor parallelism buys nothing and costs an all-reduce a layer ->
    the batch axes, or None when pure data parallelism does not apply."""
    if n_params > max_params:
        return None
    sizes = axis_sizes(mesh)
    for axes in (("pod", "data", "model"), ("data", "model")):
        if all(a in sizes for a in axes):
            n = 1
            for a in axes:
                n *= sizes[a]
            if batch % n == 0:
                return axes
    return None


def _train_state_specs(params, cfg, mesh, batch, opts):
    """-> (param specs, AdamW state specs, batch axes, pure data
    parallel): the vision and diffusion training cells' layout."""
    dp = None if opts.get("no_pure_dp") else _pure_dp_axes(mesh, batch, cfg.n_params)
    if dp is not None:
        pspec = _replicated_specs(params)
        return pspec, AdamWState(step=P(), mu=pspec, nu=pspec), dp, True
    pspec, opt_spec = _state_specs(params, cfg, mesh, opts.get("zero1_axis"))
    return pspec, opt_spec, pol.batch_axes(mesh, batch), False


def _bspec(ba):
    return ba if ba else None


def _lm_train_specs(cfg, shape, mesh, args, opts):
    b, s = shape.global_batch, shape.seq_len
    pspec, opt_spec = _state_specs(args[0], cfg, mesh, opts.get("zero1_axis"))
    tok = pol.lm_specs(mesh, "train", b, s)
    return (pspec, opt_spec, tok["tokens"], tok["labels"]), (pspec, opt_spec, P())


def _lm_prefill_specs(cfg, shape, mesh, args, opts):
    b, s = shape.global_batch, shape.seq_len
    pspec = param_specs(args[0], cfg, mesh)
    one = pol.lm_cache_spec(mesh, cfg, b, pol.cache_len_axes(mesh, b, s))
    caches = {k: one for k in lm.init_cache(cfg, b, s, "meta")}
    logits = P(_bspec(pol.batch_axes(mesh, b)), "model")
    return (pspec, pol.lm_specs(mesh, "prefill", b, s)["tokens"]), (logits, caches)


def _lm_decode_specs(cfg, shape, mesh, args, opts):
    b, s = shape.global_batch, shape.seq_len
    pspec = param_specs(args[0], cfg, mesh)
    one = pol.lm_cache_spec(mesh, cfg, b, pol.cache_len_axes(mesh, b, s))
    caches = {k: one for k in args[2]}
    logits = P(_bspec(pol.batch_axes(mesh, b)), "model")
    return ((pspec, pol.lm_specs(mesh, "decode", b, s)["token"], caches, P()),
            (logits, caches))


def _vision_train_specs(cfg, shape, mesh, args, opts):
    b = shape.global_batch
    pspec, opt_spec, ba, dp = _train_state_specs(args[0], cfg, mesh, b, opts)
    img = P(ba, None, None, None) if dp else pol.image_specs(mesh, b)
    lab = P(_bspec(ba))
    if cfg.kind == "resnet":
        bn = T.map_leaves(lambda _: P(None), args[1])
        return (pspec, bn, opt_spec, img, lab), (pspec, bn, opt_spec, P())
    return (pspec, opt_spec, img, lab), (pspec, opt_spec, P())


def _vision_serve_specs(cfg, shape, mesh, args, opts):
    b = shape.global_batch
    pspec = param_specs(args[0], cfg, mesh)
    img = pol.image_specs(mesh, b)
    out = P(_bspec(pol.batch_axes(mesh, b)), None)
    if cfg.kind == "resnet":
        return (pspec, T.map_leaves(lambda _: P(None), args[1]), img), out
    return (pspec, img), out


def _cond_specs(cfg, bspec):
    return P(bspec) if cfg.kind == "dit" else P(bspec, None, None)


def _diff_train_specs(cfg, shape, mesh, args, opts):
    """The reference's key (P(None)) is the port's ``t`` and ``noise``:
    ``t`` laid out as the class ids, ``noise`` as the latents."""
    b = shape.global_batch
    pspec, opt_spec, ba, dp = _train_state_specs(args[0], cfg, mesh, b, opts)
    lat = P(ba, None, None, None) if dp else pol.image_specs(mesh, b)
    bspec = _bspec(ba)
    return ((pspec, opt_spec, lat, _cond_specs(cfg, bspec), P(bspec), lat),
            (pspec, opt_spec, P()))


def _diff_gen_specs(cfg, shape, mesh, args, opts):
    b = shape.global_batch
    pspec = param_specs(args[0], cfg, mesh)
    lat = pol.image_specs(mesh, b)
    bspec = _bspec(pol.batch_axes(mesh, b))
    return (pspec, lat, _cond_specs(cfg, bspec), P(), P()), lat


def _targetfuse_serve_specs(cfg, shape, mesh, args, opts):
    """The counter is small (~5 M parameters): sharding its channels over
    "model" buys nothing and costs an all-reduce a convolution. When the
    tile batch divides the whole (non-pod) mesh it runs pure data
    parallel: the batch over ("data", "model"), the weights replicated
    (``dp_serve``, on by default)."""
    b = shape.global_batch
    sizes = axis_sizes(mesh)
    dp_axes = tuple(a for a in ("data", "model") if a in sizes)
    n_dp = 1
    for a in dp_axes:
        n_dp *= sizes[a]
    if opts.get("dp_serve", True) and b % n_dp == 0:
        pspec, ba = _replicated_specs(args[0]), dp_axes
    else:
        pspec, ba = param_specs(args[0], cfg, mesh), pol.batch_axes(mesh, b)
    bspec = _bspec(ba)
    return (pspec, P(bspec, None, None, None), P(None, None)), (P(bspec),) * 4 + (P(),)


def _detector_train_specs(cfg, shape, mesh, args, opts):
    b = shape.global_batch
    pspec = param_specs(args[0], cfg, mesh)
    ba = pol.batch_axes(mesh, b)
    return ((pspec, AdamWState(step=P(), mu=pspec, nu=pspec), pol.image_specs(mesh, b),
             P(_bspec(ba), None, None, None, None)),
            (pspec, AdamWState(step=P(), mu=pspec, nu=pspec), P()))


_SPECS = {_lm_train: _lm_train_specs, _lm_prefill: _lm_prefill_specs,
          _lm_decode: _lm_decode_specs, _vision_train: _vision_train_specs,
          _vision_serve: _vision_serve_specs, _diff_train: _diff_train_specs,
          _diff_gen: _diff_gen_specs, _detector_train: _detector_train_specs,
          _targetfuse_serve: _targetfuse_serve_specs}


def _named(mesh, specs):
    return T.map_leaves(lambda s: NamedSharding(mesh, s), specs)


def _lay_out(out, shardings):
    """The step's DTensor outputs redistributed to ``shardings`` where
    their placements differ (the reference's ``out_shardings``)."""
    from torch.distributed.tensor import DTensor
    outs, want = T.leaves(out), T.leaves(shardings)
    if len(outs) != len(want):
        raise ValueError(f"{len(outs)} outputs for {len(want)} out_shardings")
    laid = [x.redistribute(x.device_mesh, w.placements)
            if isinstance(x, DTensor) and tuple(x.placements) != w.placements else x
            for x, w in zip(outs, want)]
    return T.unflatten(out, laid)


def _on_mesh(plan: CellPlan, mesh, in_specs, out_specs) -> CellPlan:
    """``plan`` laid out on ``mesh``: its step runs with ``mesh`` active
    (the models' ``ctx.constrain`` points) under DTensor's implicit
    replication (the plain tensors a model makes inside, positions,
    masks, lengths, are the same on every rank), and returns its outputs
    laid out by the out shardings."""
    from torch.distributed.tensor.experimental import implicit_replication
    step = plan.fn
    out_sh = _named(mesh, out_specs)

    @functools.wraps(step)
    def run(*args):
        with ctx.use_mesh(mesh), implicit_replication():
            return _lay_out(step(*args), out_sh)
    return dataclasses.replace(plan, fn=run, mesh=mesh, in_shardings=_named(mesh, in_specs),
                               out_shardings=out_sh)


def place_inputs(plan: CellPlan, *args, src_data_rank=0) -> tuple:
    """Real inputs of a mesh plan's step, each tree laid out on its mesh
    by its ``in_shardings`` (``distribute_tensor`` from ``src_data_rank``'s
    copy; None: every rank's own, which must be the same). Host scalars
    (0-d) stay on the host."""
    if plan.mesh is None:
        raise ValueError("place_inputs: the plan has no mesh")
    return tuple(distribute(a, sh, plan.mesh, src_data_rank)
                 for a, sh in zip(args, plan.in_shardings))


def build_cell(arch: str, shape_name: str, mesh=None, **opts) -> CellPlan:
    """The plan of one cell, allocating nothing. Options, the reference's:
    ``remat`` (the config's ``remat`` replaced), ``grad_accum`` (an LM
    train cell's micro-batches), ``mla_absorb`` (an LM decode cell's MLA
    path, True by default) and ``unroll``, taken and unused: the port runs
    its layers in a loop, as the reference's ``scan_layers=False``, and
    the reference's dry run passes ``unroll`` to every cell. On a
    ``mesh`` (a ``DeviceMesh`` with named dims, or an ``AbstractMesh``
    for its specs alone) the plan holds the reference's shardings, and
    the mesh options are taken: ``zero1_axis`` (the training cells'
    moments also sharded over that axis), ``no_pure_dp`` (no pure data
    parallelism for small vision and diffusion models) and ``dp_serve``
    (the serve cell's pure data parallelism, on by default). Without a
    mesh they raise ``TypeError``; ``mesh=None`` gives the plain plan."""
    return build_plan(get_config(arch), get_shape(arch, shape_name), arch, mesh, **opts)


def build_plan(cfg, shape: ShapeSpec, arch: str, mesh=None, **opts) -> CellPlan:
    """:func:`build_cell` of ``arch``'s config and shape, for a cell cut
    in depth (``cfg.n_layers``) or batch (``shape.global_batch``)."""
    for k in opts:
        if k in _MESH_OPTIONS:
            if mesh is None:
                raise TypeError(f"build_cell: {k!r} is a mesh option, and no mesh was given")
        elif k not in _OPTIONS:
            raise TypeError(f"build_cell: unknown option {k!r}")
    if opts.get("remat"):
        cfg = dataclasses.replace(cfg, remat=opts["remat"])
    cell = _CELLS[cfg.family, shape.kind]
    plan = cell(arch, cfg, shape, opts)
    if mesh is None:
        return plan
    in_specs, out_specs = _SPECS[cell](cfg, shape, mesh, plan.args, opts)
    return _on_mesh(plan, mesh, in_specs, out_specs)


def input_specs(arch: str, shape_name: str) -> Tuple:
    """The cell's input trees as ``meta`` tensors (the reference's
    ``ShapeDtypeStruct`` stand-ins); nothing is allocated."""
    return build_cell(arch, shape_name).args


# ---------------------------------------------------------------------------
# useful FLOPs, the reference's formulas
# ---------------------------------------------------------------------------


def _vit_fwd_flops(cfg, img_res: int) -> float:
    """Exact matmul FLOPs of one ViT forward image."""
    t = (img_res // cfg.patch) ** 2 + 1
    d, f = cfg.d_model, cfg.d_ff
    patch = 2.0 * (img_res // cfg.patch) ** 2 * cfg.patch ** 2 * 3 * d
    blk = 2.0 * t * (4 * d * d + 2 * d * f) + 4.0 * t * t * d
    head = 2.0 * d * cfg.n_classes
    return patch + cfg.n_layers * blk + head


def _convnext_fwd_flops(cfg, img_res: int) -> float:
    r = img_res // 4
    total = 2.0 * r * r * 4 * 4 * 3 * cfg.dims[0]
    for i, (dep, dim) in enumerate(zip(cfg.depths, cfg.dims)):
        hw = r * r
        blk = 2.0 * hw * (49 * dim + 8 * dim * dim)
        total += dep * blk
        if i + 1 < len(cfg.dims):
            total += 2.0 * (r // 2) ** 2 * 4 * dim * cfg.dims[i + 1]
            r //= 2
    return total + 2.0 * cfg.dims[-1] * cfg.n_classes


def _resnet_fwd_flops(cfg, img_res: int) -> float:
    w = cfg.width
    r = img_res // 2
    total = 2.0 * r * r * 49 * 3 * w
    r //= 2  # maxpool
    c_in = w
    for i, dep in enumerate(cfg.depths):
        mid = w * (2 ** i)
        out = mid * 4
        if i > 0:
            r //= 2
        for b in range(dep):
            total += 2.0 * r * r * (c_in * mid + 9 * mid * mid + mid * out)
            if b == 0:
                total += 2.0 * r * r * c_in * out  # projection
            c_in = out
    return total + 2.0 * c_in * cfg.n_classes


def _dit_fwd_flops(cfg, img_res: int) -> float:
    lr = img_res // cfg.latent_factor
    t = (lr // cfg.patch) ** 2
    d = cfg.d_model
    # adaLN conditioning is per image (B, 6d), not per token
    blk = 2.0 * t * (4 * d * d + 8 * d * d) + 4.0 * t * t * d + 2.0 * 6 * d * d
    io = 2.0 * t * (cfg.patch ** 2 * cfg.latent_ch * d * 3)
    return cfg.n_layers * blk + io


def _unet_fwd_flops(cfg, img_res: int) -> float:
    """Walks the same structure as ``models.unet`` (down, mid, up). The
    reference's own approximation: it prices a transformer block's
    projections as 8 c x c products a token, counts the cross-attention's
    k and v products a block, and leaves out norms and elementwise work."""
    lr = img_res // cfg.latent_factor
    ch = cfg.ch
    chans = [ch * m for m in cfg.ch_mult]

    def res_block(hw, cin, cout):
        f = 2.0 * hw * 9 * (cin * cout + cout * cout) + 2.0 * hw * 4 * ch * cout
        if cin != cout:
            f += 2.0 * hw * cin * cout
        return f

    def attn_block(hw, c):
        heads_proj = 2.0 * hw * c * c * (3 + 1 + 1 + 1 + 2)
        sa = 4.0 * hw * hw * c
        ca = 4.0 * hw * cfg.ctx_len * c + 2.0 * cfg.ctx_len * cfg.ctx_dim * c * 2
        ff = 2.0 * hw * (8 * c * c + 4 * c * c)
        return heads_proj + sa + ca + ff

    total = 2.0 * lr * lr * 9 * cfg.latent_ch * ch
    r = lr
    prev = ch
    for lvl, c in enumerate(chans):   # down
        hw = r * r
        for _ in range(cfg.n_res_blocks):
            total += res_block(hw, prev, c)
            if lvl in cfg.attn_levels:
                total += attn_block(hw, c)
            prev = c
        if lvl + 1 < len(chans):
            r //= 2
            total += 2.0 * r * r * 9 * c * c
    hw = r * r   # mid
    total += 2 * res_block(hw, chans[-1], chans[-1]) + attn_block(hw, chans[-1])
    for lvl in reversed(range(len(chans))):   # up: the skip concats raise cin
        c = chans[lvl]
        hw = r * r
        for _ in range(cfg.n_res_blocks + 1):
            total += res_block(hw, c + prev, c)
            if lvl in cfg.attn_levels:
                total += attn_block(hw, c)
            prev = c
        if lvl > 0:
            r *= 2
            total += 2.0 * r * r * 9 * c * c
    return total + 2.0 * lr * lr * 9 * ch * cfg.latent_ch


def cell_flops(cfg, shape: ShapeSpec) -> float:
    """:func:`model_flops` of a config and shape, for a cell cut in depth
    (``cfg.n_layers``) or batch (``shape.global_batch``)."""
    mult = 3.0 if shape.kind in ("train", "cls") else 1.0
    if cfg.family == "lm":
        b, s = shape.global_batch, shape.seq_len
        n_active = cfg.n_active_params
        if cfg.mla is None:
            qk_dim = v_dim = cfg.head_dim
        else:
            qk_dim = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
            v_dim = cfg.mla.v_head_dim
        h = cfg.n_heads
        if shape.kind in ("train", "prefill"):
            base = 2.0 * n_active * b * s
            # causal: half the S^2 pairs are useful
            attn_fwd = cfg.n_layers * b * s * s * h * (qk_dim + v_dim)
            return (base + attn_fwd) * mult
        # decode: one token a sequence against an s-long cache
        base = 2.0 * n_active * b
        if cfg.mla is not None:   # the absorbed latent decode's scores and combine
            attn = 2.0 * cfg.n_layers * b * s * h * (
                cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim + cfg.mla.kv_lora_rank)
        else:
            attn = 2.0 * cfg.n_layers * b * s * h * (qk_dim + v_dim)
        return base + attn
    b, r = shape.global_batch, shape.img_res
    if cfg.family == "vision":
        per = {"vit": _vit_fwd_flops, "convnext": _convnext_fwd_flops,
               "resnet": _resnet_fwd_flops}[cfg.kind](cfg, r)
    elif cfg.family == "diffusion":
        per = (_dit_fwd_flops if cfg.kind == "dit" else _unet_fwd_flops)(cfg, r)
    else:
        per = detector_gflops(cfg, r) * 1e9
    return per * b * mult


def model_flops(arch: str, shape_name: str) -> float:
    """A cell's useful FLOPs (the reference's ``model_flops``): exact
    matmul and conv counts by family; a training step 3x the forward
    (remat's recompute is overhead, not useful work); an MoE's active
    parameters only; causal attention's used half; a gen cell one DDIM
    step; a decode cell one token a sequence."""
    return cell_flops(get_config(arch), get_shape(arch, shape_name))
