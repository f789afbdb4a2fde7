"""Content-keyed host-to-device cache for small control-plane arrays.

Counterpart of ``repro/core/xfer.py``. The fleet's batched rounds upload
the same little host arrays every ``ingest()``: padded gather indices
(the dedup's moment gathers, the counting gathers). They are values
(never mutated, never aliased), so they are cached by ``(device, dtype,
shape, bytes)``, and a scenario that repeats its shapes stops uploading
them after its first round.

``transfer_stats()['device_puts']`` counts the uploads made here and
``cache_reuses`` those avoided. The cache and the counters are behind a
lock: the ground segment's recount workers call in from their own
threads.

On a ``sats`` mesh (:class:`~repro_torch.core.fleet_sharding.
FleetSharding`) a cached vector is a lane stack placed along the mesh,
and the key holds the mesh, so two meshes never share a tensor.

On a CUDA device the key also holds the calling thread's current
stream, so each stream reads only copies it uploaded itself. A recount
worker runs on its own stream; a vector it shared with the foreground
stream could be freed (:func:`clear_cache`, an overflow) and its memory
handed to the other stream while a kernel still read it.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

# cache only small arrays (index vectors); data arrays are unique per round
_MAX_ITEM_BYTES = 1 << 16
_MAX_ENTRIES = 4096

_lock = threading.Lock()
_cache: dict = {}
_stats = {"device_puts": 0, "cache_reuses": 0}


def record_transfer(n: int = 1) -> None:
    """Count ``n`` host-to-device uploads (every miss of this cache)."""
    with _lock:
        _stats["device_puts"] += n


def transfer_stats() -> dict:
    """Snapshot of the transfer counters."""
    with _lock:
        return dict(_stats)


def reset_transfer_stats() -> None:
    with _lock:
        _stats["device_puts"] = 0
        _stats["cache_reuses"] = 0


def clear_cache() -> None:
    """Drop every cached tensor (the counters are kept)."""
    with _lock:
        _cache.clear()


def cache_size() -> int:
    with _lock:
        return len(_cache)


def _put(arr: np.ndarray, device, sharding) -> torch.Tensor:
    if sharding is not None:
        return sharding.device_put(arr)  # counts its own transfer
    record_transfer()
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def device_constant(arr, device=None, sharding=None) -> torch.Tensor:
    """``arr`` (a small host array whose value tends to repeat) as a
    tensor on ``device``, cached by content; with an on-mesh
    ``sharding``, as a DTensor split along its ``sats`` axis on the
    mesh's device (``arr``'s leading axis a device multiple). Arrays
    above the size cap are uploaded each time (and counted). The result
    is shared: callers only read it."""
    arr = np.asarray(arr)
    on_mesh = sharding is not None and sharding.on_mesh
    if on_mesh:
        device = sharding.device
    else:
        sharding = None
        device = torch.device(device)
    if arr.nbytes > _MAX_ITEM_BYTES:
        return _put(arr, device, sharding)
    stream = (torch.cuda.current_stream(device).cuda_stream
              if device.type == "cuda" else None)
    key = (id(sharding.mesh) if on_mesh else str(device), stream, arr.dtype.str,
           arr.shape, arr.tobytes())
    with _lock:
        hit = _cache.get(key)
        if hit is not None:
            _stats["cache_reuses"] += 1
            return hit
    dev = _put(arr, device, sharding)
    with _lock:
        if len(_cache) >= _MAX_ENTRIES:
            _cache.clear()
        _cache[key] = dev
    return dev
