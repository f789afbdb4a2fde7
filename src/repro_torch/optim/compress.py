"""Gradient compression for bandwidth-constrained data parallelism,
PyTorch.

Counterpart of ``repro/optim/compress.py``, its two codecs term for term:

- int8 stochastic-rounding quantization with a per-tensor scale (8x
  smaller all-reduce payload; unbiased in expectation). The reference
  draws its uniforms with ``jax.random.uniform``; here they come from an
  explicit ``torch.Generator`` (:func:`int8_encode`), which gives other
  numbers from the same seed, so the rounding itself is
  :func:`int8_encode_draws`, which takes the uniforms: handed the
  reference's draws it gives the reference's bits.
- top-k sparsification with error feedback (residual accumulation), the
  classic deep-gradient-compression scheme. ``torch.topk`` keeps the
  same set as ``jax.lax.top_k`` wherever the k-th and (k+1)-th
  magnitudes differ; among equal magnitudes the two may pick other
  indices.

Trees are :mod:`repro_torch.tree`'s, visited in JAX's leaf order.

A gradient on a mesh (a DTensor leaf) takes the int8 codec too: every
rank draws the uniforms of the whole leaf from its generator, which is in
the same state on every rank, and keeps its shard of them, and the scale
is the whole leaf's largest magnitude (a DTensor reduction), so a
sharded leaf's round trip equals the one-device round trip of the same
values bit for bit. The cost is one leaf's uniforms, float32, whole on
every rank while that leaf is encoded (4 bytes an element of the largest
leaf: an embedding table of 151936 x 4096 is 2.5 GB).
"""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.sharding.ctx import settle
from repro_torch.sharding.local import is_dtensor


def int8_encode_draws(g: torch.Tensor, r: torch.Tensor):
    """-> (q int8, scale float32 0-d) of ``g`` with uniforms ``r`` in [0,
    1) of g's shape: ``scale = max(max |g|, 1e-12) / 127``, x = g / scale,
    q = clip(floor(x) + (r < x - floor(x)), -127, 127)."""
    gf = g.float()
    scale = torch.clamp(settle(torch.max(torch.abs(gf))), min=1e-12) / 127.0
    x = gf / scale
    lo = torch.floor(x)
    p = x - lo
    q = torch.clamp(lo + (r < p), -127, 127).to(torch.int8)
    return q, scale


def int8_encode(g: torch.Tensor, gen: torch.Generator):
    """-> (q int8, scale float32 0-d): :func:`int8_encode_draws` with
    uniforms drawn from ``gen`` (on g's device). E[decode] = g. A DTensor
    ``g`` takes its shard of the whole leaf's draws."""
    if is_dtensor(g):
        from torch.distributed.tensor import distribute_tensor
        r = torch.rand(g.shape, generator=gen, device=g.to_local().device)
        r = distribute_tensor(r, g.device_mesh, g.placements, src_data_rank=None)
        return int8_encode_draws(g, r)
    r = torch.rand(g.shape, generator=gen, device=g.device)
    return int8_encode_draws(g, r)


def int8_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def int8_roundtrip_tree(grads, gen: torch.Generator):
    """Encode and decode every leaf (what the wire sees under int8 data
    parallelism), the leaves' uniforms drawn from ``gen`` in leaf order."""
    return T.map_leaves(lambda g: int8_decode(*int8_encode(g, gen)), grads)


def topk_encode(g: torch.Tensor, frac: float):
    """Keep the top ``frac`` fraction of entries by magnitude (at least
    one) -> (values, flat indices, residual): the values float32 in
    descending magnitude, the residual g in float32 with those entries 0
    (it feeds error feedback)."""
    gf = g.float().reshape(-1)
    k = max(1, int(gf.numel() * frac))
    _, idx = torch.topk(torch.abs(gf), k)
    sel = gf[idx]
    residual = gf.clone()
    residual[idx] = 0.0
    return sel, idx, residual.reshape(g.shape)


def topk_decode(vals: torch.Tensor, idx: torch.Tensor, shape) -> torch.Tensor:
    out = torch.zeros(torch.Size(shape).numel(), dtype=torch.float32, device=vals.device)
    out[idx] = vals
    return out.reshape(shape)


def topk_roundtrip_tree(grads, residuals, frac: float):
    """Error-feedback top-k over a tree: each leaf plus its residual is
    sparsified -> (decoded sparse gradients, new residuals)."""
    dec, new_res = [], []
    for g, r in zip(T.leaves(grads), T.leaves(residuals)):
        vals, idx, resid = topk_encode(g.float() + r, frac)
        dec.append(topk_decode(vals, idx, g.shape))
        new_res.append(resid)
    return T.unflatten(grads, dec), T.unflatten(grads, new_res)
