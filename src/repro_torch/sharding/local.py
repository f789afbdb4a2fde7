"""Running a plain function on each rank's shards of DTensors.

``local_op`` is how a DTensor reaches code that must see plain tensors:
the kernels (which take raw pointers) and the few ops whose DTensor
rules do not cover the port's layouts (a convolution over a batch split
across two mesh dims). The arguments are redistributed to the placements
under which the function is local; the function then runs once a rank
on the shards (``local_map``), and its outputs are DTensors again.
"""
from __future__ import annotations

import torch


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient comes back contiguous: a shard's
    gradient from the local function may be strided (a transposed
    product's), and DTensor plans its views on the global layout."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def _contiguous_grads(fn):
    def run(*args):
        return fn(*[_ContiguousGrad.apply(a) if isinstance(a, torch.Tensor) and a.requires_grad
                    else a for a in args])
    return run


def local_op(fn, args, mesh, in_pl, out_pl, grad_pl=None):
    """``fn(*args)`` on each rank's shards: the tensor args redistributed
    to ``in_pl`` (one placement tuple a tensor arg, None for the rest; a
    plain tensor arg is taken as replicated), the outputs DTensors of
    ``out_pl``. ``grad_pl``: the placements of the args' gradients where
    they are not ``in_pl`` (a replicated weight applied to sharded rows
    gets a partial sum on each rank)."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map
    from torch.distributed.tensor import Placement
    args = [DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
            if isinstance(a, torch.Tensor) and not is_dtensor(a) else a for a in args]
    if all(isinstance(p, Placement) for p in out_pl):   # one output: a list, not a tuple
        out_pl = list(out_pl)
    return local_map(_contiguous_grads(fn), out_placements=out_pl, in_placements=tuple(in_pl),
                     in_grad_placements=None if grad_pl is None else tuple(grad_pl),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def partial_where_sharded(pl):
    """The gradient placements of a replicated operand applied to shards
    of ``pl``: a partial sum on each mesh dim that shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    return tuple(Partial() if isinstance(p, Shard) else Replicate() for p in pl)


def keep(x, dims):
    """x's placements with only ``Shard(d)`` for d in ``dims`` kept, the
    rest ``Replicate()`` (a partial sum reduced)."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(p if isinstance(p, Shard) and p.dim in dims else Replicate()
                 for p in x.placements)


def replicated(mesh):
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * mesh.ndim


def refill(tensors, args):
    """``args`` with its tensors replaced, in order, by ``tensors`` (the
    shards ``local_op`` hands a function whose other args are not
    tensors)."""
    it = iter(tensors)
    return [next(it) if isinstance(a, torch.Tensor) else a for a in args]
