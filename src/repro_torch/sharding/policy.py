"""Input and activation sharding policies per (family, shape, mesh).

Counterpart of ``repro/sharding/policy.py``; each function reads only
the mesh's axis names and sizes (a ``DeviceMesh`` or an
:class:`~repro_torch.sharding.AbstractMesh`).

- The batch shards over ("pod", "data") when divisible, over a prefix of
  those axes when partly divisible, else falls back to sequence or
  spatial sharding (gen_1024 B=4, serve_b1 / long_500k B=1).
- Decode KV caches shard their *length* dim over "data" when the batch
  cannot use it (long_500k: a 512k-token cache, B=1), flash-decode style.
- Spatial dims shard over "data" for big-image diffusion cells.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.sharding import P, axis_sizes


def batch_axes(mesh, batch: int) -> Tuple:
    """The longest prefix of ("pod", "data") whose product divides
    ``batch``."""
    sizes = axis_sizes(mesh)
    chosen = []
    prod = 1
    for a in (a for a in ("pod", "data") if a in sizes):
        if batch % (prod * sizes[a]) == 0:
            chosen.append(a)
            prod *= sizes[a]
    return tuple(chosen)


def free_data_axis(mesh, batch_ax: Tuple) -> Optional[str]:
    """The "data" axis if the batch did not take it (for sequence or
    spatial dims)."""
    return "data" if "data" not in batch_ax else None


def lm_specs(mesh, kind: str, batch: int, seq: int):
    """{name: spec} of an LM step's token inputs."""
    ba = batch_axes(mesh, batch)
    bspec = ba if ba else None
    if kind == "train":
        return {"tokens": P(bspec, None), "labels": P(bspec, None)}
    if kind == "prefill":
        return {"tokens": P(bspec, None)}
    return {"token": P(bspec, None)}


def cache_len_axes(mesh, batch: int, seq: int):
    """The KV cache's *length* sharding (the flash-decode layout): the
    model axis always (heads rarely divide 16; the length does), and the
    data axis when the batch leaves it free; None unless their product
    divides ``seq``."""
    ba = batch_axes(mesh, batch)
    sizes = axis_sizes(mesh)
    axes = []
    if "data" not in ba and "data" in sizes:
        axes.append("data")
    if "model" in sizes:
        axes.append("model")
    n = 1
    for a in axes:
        n *= sizes[a]
    if axes and seq % n == 0:
        return tuple(axes)
    return None


def lm_cache_spec(mesh, cfg, batch: int, len_axes):
    """The spec tree of one stacked KV cache."""
    ba = batch_axes(mesh, batch)
    bspec = ba if ba else None
    la = len_axes if len_axes else None
    if cfg.mla is not None:
        return {"c_kv": P(None, bspec, la, None), "k_rope": P(None, bspec, la, None)}
    return {"k": P(None, bspec, la, None, None), "v": P(None, bspec, la, None, None)}


def image_specs(mesh, batch: int, spatial_dims: int = 2):
    """(B, H, W, C) inputs: the batch over pod / data, else H over data."""
    ba = batch_axes(mesh, batch)
    return P(ba if ba else None, free_data_axis(mesh, ba), None, None)


def token_image_specs(mesh, batch: int):
    ba = batch_axes(mesh, batch)
    return P(ba if ba else None, None, None, None)
