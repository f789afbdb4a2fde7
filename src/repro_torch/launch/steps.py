"""Training steps of the LMs and the model zoo's vision and diffusion
families.

Counterpart of the step closures in ``repro/launch/steps.py``
(``_lm_train``, ``_vision_train``, ``_diff_train``) without their
shardings, meshes and ``CellPlan``: ``lm_train``, ``vision_train`` and
``diffusion_train`` return ``(opt_init, step)`` for one config, ``step``
one AdamW update of the port's ``optim/adamw.py`` on a batch.
``models.lm.loss_fn``, ``vision_loss`` and ``diffusion_loss`` are the
steps' loss functions, and ``value_and_grad`` their gradient:
``torch.autograd.grad`` of the loss over the parameter tree's leaves in
JAX's leaf order (:mod:`repro_torch.tree`), through the models' training
forwards (``cfg.remat`` rematerializes their blocks as the reference's).
On a card every attention's gradient is the ``flash_attention`` backward
kernel's (the LMs' causal and GQA).

The diffusion steps take the timesteps ``t`` and the noise as arguments,
where the reference's draw them from a key inside the step:
``models.diffusion.draw_train_inputs`` draws them from a generator.

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
moments). The numbers are the same either way.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import tree as T
from repro_torch.models import convnext, diffusion, dit, lm, resnet, unet, vit
from repro_torch.optim.adamw import adamw


def ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of integer labels on float32 log-softmax, as
    the reference's ``ce``."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels.long()[:, None]))


def _donate(old, new):
    """``new``'s leaves copied into ``old``'s tensors -> ``old`` (ResNet's
    running statistics)."""
    with torch.no_grad():
        torch._foreach_copy_(T.leaves(old), T.leaves(new))
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
