"""Shardings of the port: the reference's ``PartitionSpec`` and
``NamedSharding`` as DTensor placements on a torch ``DeviceMesh``.

A spec (:class:`P`) has one entry per tensor dim: a mesh axis name, a
tuple of names, or ``None``; it normalizes its entries as JAX's does (a
one-name tuple is the name, an empty tuple is ``None``, a list a tuple),
so the two compare entry by entry. :func:`placements` maps a spec on a
mesh to DTensor placements, one a mesh dim: ``Shard(d)`` where the
spec puts that axis on tensor dim ``d``, else ``Replicate()``. A dim
spread over several axes, ``("pod", "data")``, is ``Shard(d)`` on each:
DTensor splits a dim over its mesh dims left to right, as JAX does major
to minor, so rank (i, j) holds chunk ``i * n_data + j`` in both.

A mesh is a ``DeviceMesh`` with named dims, or an :class:`AbstractMesh`
(names and sizes, no devices or process group: the counterpart of
``jax.sharding.AbstractMesh``), which is all that the rules, the
policies and the cells' specs read.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple


class P:
    """A partition spec: one entry per tensor dim (an axis name, a tuple
    of names, or None). Not a tuple, as JAX's is not, so that a tree of
    specs has the specs as its leaves (:mod:`repro_torch.tree`)."""
    __slots__ = ("_entries",)

    def __init__(self, *entries):
        self._entries = tuple(_entry(e) for e in entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self):
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other):
        if isinstance(other, P):
            return self._entries == other._entries
        return NotImplemented

    def __hash__(self):
        return hash(self._entries)

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self._entries)) + ")"


def _entry(e):
    if isinstance(e, (list, tuple)):
        e = tuple(e)
        if not e:
            return None
        return e[0] if len(e) == 1 else e
    return e


def entry_axes(e) -> Tuple[str, ...]:
    """The axis names of one spec entry, major to minor."""
    if e is None:
        return ()
    return (e,) if isinstance(e, str) else tuple(e)


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with no devices: what the rules,
    policies and cell specs read from a ``DeviceMesh``."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def size(self) -> int:
        return math.prod(self.shape)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one a mesh dim
    (``Replicate()`` on a mesh dim of size 1). A spec axis the mesh
    lacks, an axis used by two tensor dims, or a dim's axes out of the
    mesh's order raise."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    dim_of = {}
    for d, e in enumerate(spec):
        axes = entry_axes(e)
        order = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec!r}: the mesh {names} has no axis {a!r}")
            if a in dim_of:
                raise ValueError(f"spec {spec!r}: axis {a!r} shards two dims")
            dim_of[a] = d
            order.append(names.index(a))
        if order != sorted(order):
            raise ValueError(f"spec {spec!r}: dim {d}'s axes are not in the mesh's "
                             f"order {names}")
    sizes = axis_sizes(mesh)
    # on a mesh dim of size 1 a shard is the whole tensor: Replicate(),
    # which DTensor's rules take everywhere (they refuse to reshape a
    # size-1 tensor dim sharded over a size-1 mesh dim)
    return tuple(Shard(dim_of[n]) if n in dim_of and sizes[n] > 1 else Replicate()
                 for n in names)


def shard_shape(spec, shape, mesh) -> tuple:
    """The shape of one device's shard of a ``shape`` tensor laid out by
    ``spec``: each dim divided by the product of its axes' sizes (which
    must divide it, as JAX's ``NamedSharding.shard_shape`` asks)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, e in enumerate(spec):
        n = math.prod(sizes[a] for a in entry_axes(e))
        if out[d] % n:
            raise ValueError(f"spec {spec!r}: dim {d} of {tuple(shape)} does not divide "
                             f"into {n}")
        out[d] //= n
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, the reference's ``NamedSharding``: ``spec``,
    ``placements`` (DTensor's) and ``shard_shape``."""
    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def shard_shape(self, shape) -> tuple:
        return shard_shape(self.spec, shape, self.mesh)
