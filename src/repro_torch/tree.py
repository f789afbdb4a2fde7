"""Trees of tensors in JAX's leaf order.

The reference flattens nested dicts, lists, tuples and named tuples with
``jax.tree_util``: a dict's keys sorted, a sequence's items in order, a
named tuple's fields in order. A leaf's path joins the keys, the item
indices and the fields (as ``.name``) with ``/``. The port's optimizer
sums leaves in that order and its checkpoints name them by those paths,
so a checkpoint written by either package reads in the other.
:func:`from_numpy` is the models' weight bridge: the reference's
parameter trees become the port's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _children(tree):
    """-> [(key, child), ...] of a node in JAX's order, or None for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


# The walks below are module-level functions with explicit accumulators:
# a nested function that calls itself through its own closure cell is a
# reference cycle, and the leaves it reaches (a model's weights, its
# optimizer moments) would outlive the call until the cyclic collector ran.

def _walk(node, prefix, paths, leaves):
    kids = _children(node)
    if kids is None:
        paths.append("/".join(prefix))
        leaves.append(node)
        return
    for k, child in kids:
        _walk(child, prefix + [str(k)], paths, leaves)


def flatten_with_paths(tree):
    """-> (paths, leaves), both in JAX's leaf order."""
    paths, leaves = [], []
    _walk(tree, [], paths, leaves)
    return paths, leaves


def leaves(tree) -> list:
    return flatten_with_paths(tree)[1]


def _build(node, it):
    kids = _children(node)
    if kids is None:
        return next(it)
    if isinstance(node, dict):
        return {k: _build(child, it) for k, child in kids}
    built = [_build(child, it) for _, child in kids]
    if hasattr(node, "_fields"):
        return type(node)(*built)
    return type(node)(built)


def unflatten(template, values):
    """A tree shaped like ``template`` holding ``values`` (in JAX's leaf
    order) at its leaves; dicts come out with sorted keys, as JAX's do."""
    return _build(template, iter(values))


def map_leaves(fn, tree):
    """``jax.tree_util.tree_map`` of one tree: ``fn`` of each leaf."""
    return unflatten(tree, [fn(x) for x in leaves(tree)])


def _tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: exact through float32
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def from_numpy(tree, device="cuda"):
    """A reference model's ``init`` tree (nested dicts, lists and tuples
    of arrays, layer axes kept), or the port's own parameters, -> the
    same tree of tensors on ``device`` ("cuda", the default, raises
    without a card), each leaf in its own dtype: a bf16 model's float32
    leaves (an MoE router, BatchNorm statistics) stay float32. bf16
    arrays come out of JAX as ``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` refuses: they go through float32, which holds
    every bf16 value exactly."""
    device = resolve_device(device)
    return map_leaves(lambda a: _tensor(a, device), tree)
