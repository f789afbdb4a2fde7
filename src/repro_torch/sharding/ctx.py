"""The active mesh, and activation layout constraints that are no-ops off
the mesh.

Counterpart of ``repro/sharding/ctx.py``. Models call ``constrain(x,
..axes..)`` at layout-critical points (the MoE dispatch buffers, the
attention's q, k, v). Under :func:`use_mesh` (the counterpart of
``jax.sharding.set_mesh``) a DTensor is redistributed to that layout;
off the mesh, or on a plain tensor, ``x`` comes back as it is, so the
model code stays mesh-agnostic and its plain results unchanged. Unlike
the reference's, a constraint that fails raises: it is a fault, not a
no-op.
"""
from __future__ import annotations

import contextlib
import contextvars

from repro_torch.sharding import P, axis_sizes, entry_axes, placements

_MESH = contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the active mesh inside the block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def axis_size(name: str):
    """Size of an axis of the active mesh (None off the mesh or when the
    mesh has no such axis)."""
    m = _MESH.get()
    return None if m is None else axis_sizes(m).get(name)


def constrain_spec(shape, spec, mesh) -> P:
    """The spec that ``constrain`` applies: each entry cut to the axes
    the mesh has, and a dim whose axes' product does not divide it
    replicated."""
    sizes = axis_sizes(mesh)
    parts = []
    for dim, ax in zip(shape, spec):
        axs = tuple(a for a in entry_axes(ax) if a in sizes)
        n = 1
        for a in axs:
            n *= sizes[a]
        parts.append(axs if axs and dim % n == 0 else None)
    return P(*parts)


def constrain(x, *spec):
    """``spec``: an axis name, names or None for each dim of ``x``."""
    m = _MESH.get()
    from torch.distributed.tensor import DTensor
    if m is None or not isinstance(x, DTensor):
        return x
    want = placements(constrain_spec(x.shape, spec, m), m)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def zeros(shape, dtype, like, *spec):
    """A zero tensor: off the mesh, or beside a plain ``like``, on
    ``like``'s device; beside a DTensor, a DTensor on its mesh laid out
    by ``spec`` as :func:`constrain` lays one out (a buffer that a step
    fills in place, which a plain tensor could not take)."""
    import torch
    from torch.distributed.tensor import DTensor
    m = _MESH.get()
    if m is None or not isinstance(like, DTensor):
        return torch.zeros(shape, dtype=dtype, device=like.device)
    from torch.distributed import tensor as dt
    return dt.zeros(shape, dtype=dtype, device_mesh=like.device_mesh,
                    placements=placements(constrain_spec(shape, spec, m), m))


def settle(x):
    """A DTensor's pending partial reductions done (its ``Partial``
    placements made ``Replicate()``); anything else as it is. DTensor's
    masked gather over a sharded dim leaves a partial that a later view
    of it cannot carry."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(x, DTensor) or not any(isinstance(p, Partial) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if isinstance(p, Partial) else p
                                          for p in x.placements])


def split_heads(x, *shape):
    """``x.reshape(*shape)``, ``shape`` splitting x's last dim into
    (heads, head dim). A DTensor whose last dim is sharded over more
    ranks than divide the heads is first gathered on that dim (DTensor
    cannot split a dim sharded unevenly; DiT-S/2's 6 heads and the UNet's
    5 on a model axis of 4)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if isinstance(x, DTensor):
        last = x.ndim - 1
        on_last = [isinstance(p, Shard) and p.dim == last for p in x.placements]
        n = 1
        for i, hit in enumerate(on_last):
            if hit:
                n *= x.device_mesh.size(i)
        if n > 1 and shape[-2] % n:
            x = x.redistribute(x.device_mesh, [Replicate() if hit else p
                                               for p, hit in zip(x.placements, on_last)])
    return x.reshape(*shape)
