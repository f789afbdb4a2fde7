"""Trees of tensors placed on a mesh, and back.

:func:`distribute` lays each leaf of a tree out by its spec
(``distribute_tensor``: each rank keeps its shard of the source rank's
copy); :func:`from_shards` wraps shards that each rank already holds
(``DTensor.from_local``, no communication: the dry run's fake inputs);
:func:`full` gathers each DTensor leaf back into a plain tensor. A leaf
that is not a tensor, or a 0-d tensor (a host scalar, the optimizer's
step), stays as it is.
"""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.sharding import NamedSharding, P, placements, shard_shape


def _placed(x) -> bool:
    """A leaf that goes on the mesh: a tensor of one dim or more (0-d
    leaves, a step counter or a host scalar, stay as they are)."""
    return isinstance(x, torch.Tensor) and x.ndim > 0


def _spec(s) -> P:
    return s.spec if isinstance(s, NamedSharding) else s


def _specs_like(tree, specs):
    """``specs``' leaves (a tree of :class:`P` or of ``NamedSharding``,
    or one for the whole tree) as specs in ``tree``'s leaf order."""
    if isinstance(specs, (P, NamedSharding)):
        return [_spec(specs)] * len(T.leaves(tree))
    out = [_spec(s) for s in T.leaves(specs)]
    if len(out) != len(T.leaves(tree)):
        raise ValueError(f"{len(out)} specs for {len(T.leaves(tree))} leaves")
    return out


def distribute(tree, specs, mesh, src_data_rank=0):
    """``tree``'s tensors as DTensors on ``mesh``, each by its spec.
    ``src_data_rank=None`` takes each rank's own copy (all ranks must
    hold the same values) and sends nothing."""
    from torch.distributed.tensor import distribute_tensor
    out = [distribute_tensor(x, mesh, placements(s, mesh), src_data_rank=src_data_rank)
           if _placed(x) else x for x, s in zip(T.leaves(tree), _specs_like(tree, specs))]
    return T.unflatten(tree, out)


def from_shards(tree, specs, mesh, make):
    """DTensors on ``mesh`` of ``tree``'s shapes and dtypes, each rank's
    shard ``make(shard_shape, dtype)`` (no communication)."""
    from torch.distributed.tensor import DTensor
    out = []
    for x, s in zip(T.leaves(tree), _specs_like(tree, specs)):
        if not _placed(x):
            out.append(x)
            continue
        local = make(shard_shape(s, x.shape, mesh), x.dtype)
        out.append(DTensor.from_local(local, mesh, placements(s, mesh), run_check=False,
                                      shape=x.shape, stride=torch.empty(x.shape, device="meta").stride()))
    return T.unflatten(tree, out)


def full(tree):
    """Each DTensor leaf gathered into a plain tensor on every rank."""
    from torch.distributed.tensor import DTensor
    return T.map_leaves(lambda x: x.full_tensor() if isinstance(x, DTensor) else x, tree)
