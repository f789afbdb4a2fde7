"""AdamW with global-norm clipping over a tree of tensors, PyTorch.

Counterpart of ``repro/optim/adamw.py``, term for term: float32 moments,
the step counted before the schedule reads it, bias corrections
``1 - b**t``, ``mhat / (sqrt(vhat) + eps) + wd * p``, and the gradient
clipped by its global norm, the leaves summed in JAX's leaf order
(:mod:`repro_torch.tree`). ``torch.optim.AdamW`` is another algorithm
in float32: its decay is applied before the step and its bias
corrections fold into the rate, and it has no global-norm clip.

The update is functional, as the reference's: it returns new parameter
and moment trees. Its per-leaf arithmetic runs as ``torch._foreach_*``
ops (one launch a term on the card). The step and the scalars derived
from it (rate, bias corrections) live on the CPU; the gradient norm and
the clip scale stay on the parameters' device, so an update never waits
for the card.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Union

import torch

from repro_torch import tree as T


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-d int32, on the CPU
    mu: dict
    nu: dict


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, leaf by leaf in
    JAX's order (a 0-d float32 tensor on the leaves' device)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in T.leaves(tree)))


def clip_by_global_norm(tree, max_norm):
    """-> (tree scaled so that its global norm is at most ``max_norm``,
    the norm before scaling)."""
    n = global_norm(tree)
    scale = torch.clamp(torch.full_like(n, max_norm) / torch.clamp(n, min=1e-9), max=1.0)
    return T.map_leaves(lambda x: x * scale, tree), n


def adamw(lr: Union[float, Callable], b1=0.9, b2=0.999, eps=1e-8,
          weight_decay=0.01, clip_norm=1.0):
    """Returns (init_fn, update_fn).

    update_fn(grads, state, params) -> (new_params, new_state, metrics),
    metrics ``{"grad_norm": 0-d tensor on the device, "lr": 0-d float32
    tensor on the CPU}``.
    """
    lr_fn = lr if callable(lr) else (lambda _: torch.tensor(lr, dtype=torch.float32))

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamWState(step=torch.zeros((), dtype=torch.int32),
                          mu=T.map_leaves(zeros, params), nu=T.map_leaves(zeros, params))

    def update(grads, state, params):
        grads = T.map_leaves(lambda g: g.float(), grads)
        if clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
        else:
            gnorm = global_norm(grads)
        step = state.step + 1
        t = step.to(torch.float32)
        lr_t = lr_fn(step)
        bc1 = float(1.0 - b1 ** t)
        bc2 = float(1.0 - b2 ** t)

        p = [x.float() for x in T.leaves(params)]
        g, m, v = T.leaves(grads), T.leaves(state.mu), T.leaves(state.nu)
        m2 = torch._foreach_add(torch._foreach_mul(m, b1), torch._foreach_mul(g, 1 - b1))
        v2 = torch._foreach_add(torch._foreach_mul(v, b2),
                                torch._foreach_mul(torch._foreach_mul(g, 1 - b2), g))
        mhat = torch._foreach_div(m2, bc1)
        vhat = torch._foreach_div(v2, bc2)
        denom = torch._foreach_add(torch._foreach_sqrt(vhat), eps)
        delta = torch._foreach_add(torch._foreach_div(mhat, denom),
                                   torch._foreach_mul(p, weight_decay))
        new_p = torch._foreach_sub(p, torch._foreach_mul(delta, float(lr_t)))
        new_p = [x.to(q.dtype) for x, q in zip(new_p, T.leaves(params))]
        return (T.unflatten(params, new_p),
                AdamWState(step, T.unflatten(params, m2), T.unflatten(params, v2)),
                {"grad_norm": gnorm, "lr": lr_t})

    return init, update
