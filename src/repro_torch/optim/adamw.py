"""AdamW with global-norm clipping over a tree of tensors, PyTorch.

Counterpart of ``repro/optim/adamw.py``, term for term: float32 moments,
the step counted before the schedule reads it, bias corrections
``1 - b**t``, ``mhat / (sqrt(vhat) + eps) + wd * p``, and the gradient
clipped by its global norm, the leaves summed in JAX's leaf order
(:mod:`repro_torch.tree`). ``torch.optim.AdamW`` is another algorithm
in float32: its decay is applied before the step and its bias
corrections fold into the rate, and it has no global-norm clip.

The update is functional, as the reference's: it returns new parameter
and moment trees. ``in_place=True`` writes the new values into the
parameters' and moments' own tensors instead, and the functional update
is that same body run on copies of them. The body cuts every leaf into
slices of at most ``CHUNK`` elements and runs its per-element arithmetic
as ``torch._foreach_*`` ops over groups of slices, several leaves to a
group, of ``CHUNK`` elements in all: one launch a term and group on the
card, and a group's float32 temporaries where a whole-tree update would
hold several float32 copies of every parameter at once (77 GB for
phi4-mini-3.8b's 3.84 B). Every term is elementwise, so the grouping
changes no bit. The step and the scalars derived from it (rate, bias
corrections) live on the CPU; the gradient norm and the clip scale stay
on the parameters' device, so an update never waits for the card.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Union

import torch

from repro_torch import tree as T


# elements the update takes at a time: the most of one slice of a leaf,
# and of one group of slices
CHUNK = 1 << 24


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


def _groups(params, grads, mu, nu):
    """The leaves' flat slices of at most ``CHUNK`` elements, gathered in
    leaf order into groups of at most ``CHUNK`` elements -> per group the
    lists (params, grads, mu, nu) of its slices."""
    group, n = [], 0
    for leaf in zip(T.leaves(params), T.leaves(grads), T.leaves(mu), T.leaves(nu)):
        x, g, m, v = (a.view(-1).split(CHUNK) for a in (leaf[0], leaf[1].reshape(-1),
                                                        leaf[2], leaf[3]))
        for s in zip(x, g, m, v):
            if group and n + s[0].numel() > CHUNK:
                yield [list(a) for a in zip(*group)]
                group, n = [], 0
            group.append(s)
            n += s[0].numel()
    if group:
        yield [list(a) for a in zip(*group)]


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _shards(params, grads, mu, nu):
    """DTensor leaves as the shards that the elementwise update runs on,
    each in its moments' layout -> (params, grads, mu, nu) trees of local
    tensors, and the (parameter, its moment-layout copy) pairs whose new
    values must be written back (ZeRO-1: the moments sharded further
    than the parameters). A gradient comes in its moments' layout (a
    partial sum is reduced)."""
    out, back = [[], [], [], []], []
    for p, g, m, v in zip(T.leaves(params), T.leaves(grads), T.leaves(mu), T.leaves(nu)):
        if not _is_dtensor(m):
            for lst, x in zip(out, (p, g, m, v)):
                lst.append(x)
            continue
        if tuple(g.placements) != tuple(m.placements):
            g = g.redistribute(m.device_mesh, m.placements)
        pm = p
        if tuple(p.placements) != tuple(m.placements):
            pm = p.redistribute(m.device_mesh, m.placements)
            back.append((p, pm))
        for lst, x in zip(out, (pm, g, m, v)):
            lst.append(x.to_local())
    return tuple(T.unflatten(t, xs) for t, xs in zip((params, grads, mu, nu), out)), back


def adamw(lr: Union[float, Callable], b1=0.9, b2=0.999, eps=1e-8,
          weight_decay=0.01, clip_norm=1.0):
    """Returns (init_fn, update_fn).

    update_fn(grads, state, params, in_place=False) -> (new_params,
    new_state, metrics), metrics ``{"grad_norm": 0-d tensor on the device,
    "lr": 0-d float32 tensor on the CPU}``; ``in_place`` writes the new
    values into ``params``' and the moments' tensors (contiguous) and
    returns them: the caller must not read the old values after the call.
    Without it the arguments are left as they were.
    """
    lr_fn = lr if callable(lr) else (lambda _: torch.tensor(lr, dtype=torch.float32))

    def init(params):
        def zeros(p):
            if _is_dtensor(p):   # laid out as the parameter
                return torch.zeros_like(p, dtype=torch.float32,
                                        memory_format=torch.contiguous_format)
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        # the step on the CPU; beside shape-only (meta) parameters, a shape too
        host = "meta" if any(p.is_meta for p in T.leaves(params)) else "cpu"
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=host),
                          mu=T.map_leaves(zeros, params), nu=T.map_leaves(zeros, params))

    def update(grads, state, params, in_place=False):
        if not in_place:
            copy = lambda x: x.detach().clone(memory_format=torch.contiguous_format)
            params = T.map_leaves(copy, params)
            state = state._replace(mu=T.map_leaves(copy, state.mu),
                                   nu=T.map_leaves(copy, state.nu))
        with torch.no_grad():
            gnorm = global_norm(grads)
            if _is_dtensor(gnorm):   # leaves on a mesh: the update runs on their shards
                gnorm = gnorm.full_tensor()
            (lp, lg, lm, lv), back = _shards(params, grads, state.mu, state.nu)
            scale = None
            if clip_norm is not None:
                scale = torch.clamp(torch.full_like(gnorm, clip_norm)
                                    / torch.clamp(gnorm, min=1e-9), max=1.0)
            step = state.step + 1
            t = step.to(torch.float32)
            lr_t = lr_fn(step)
            bc1, bc2 = float(1.0 - b1 ** t), float(1.0 - b2 ** t)
            for xs, gs, ms, vs in _groups(lp, lg, lm, lv):
                g = [x.float() for x in gs]
                if scale is not None:
                    g = torch._foreach_mul(g, scale)
                p = [x.float() for x in xs]
                torch._foreach_mul_(ms, b1)
                torch._foreach_add_(ms, torch._foreach_mul(g, 1 - b1))
                torch._foreach_mul_(vs, b2)
                torch._foreach_add_(vs, torch._foreach_mul(torch._foreach_mul(g, 1 - b2), g))
                del g
                u = torch._foreach_div(ms, bc1)
                w = torch._foreach_div(vs, bc2)
                torch._foreach_sqrt_(w)
                torch._foreach_add_(w, eps)
                torch._foreach_div_(u, w)
                torch._foreach_add_(u, torch._foreach_mul(p, weight_decay))
                torch._foreach_sub_(p, torch._foreach_mul(u, float(lr_t)))
                done = [(x, q) for x, q in zip(xs, p) if q is not x]
                if done:   # the slices of leaves that are not float32
                    torch._foreach_copy_(*(list(a) for a in zip(*done)))
            for x, xm in back:
                x.to_local().copy_(xm.redistribute(x.device_mesh, x.placements).to_local())
        return params, AdamWState(step, state.mu, state.nu), {"grad_norm": gnorm, "lr": lr_t}

    return init, update
