"""Fault-tolerant checkpoints of trees of tensors, PyTorch.

Counterpart of ``repro/checkpoint/ckpt.py``, in its on-disk format, so
either package reads what the other writes:

- ``ckpt_dir/step_XXXXXXXX/`` holding ``manifest.json`` (the step, and
  each leaf's path, dtype and shape in JAX's leaf order), ``arrays.npz``
  (leaf i as ``a{i}``; a dtype numpy lacks, such as bfloat16, as raw
  bytes) and ``COMMITTED``;
- written to ``.tmp`` and renamed into place, so a crash mid-save never
  leaves a step that looks complete; restore skips uncommitted steps;
- an optional save on a background thread (the tensors are copied to
  the host before it starts); ``keep`` newest steps are kept.

A tree is nested dicts, lists, tuples and named tuples of tensors or
numpy arrays (:mod:`repro_torch.tree`).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch import tree as T

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"
_COMMIT = "COMMITTED"
_NP_NATIVE = {"bool", "int8", "uint8", "int16", "uint16", "int32", "uint32",
              "int64", "uint64", "float16", "float32", "float64",
              "complex64", "complex128"}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_host(v):
    """A leaf -> (a host copy to store, its dtype's name, its shape)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().to("cpu", copy=True).contiguous()
        name = _dtype_name(v.dtype)
        if name not in _NP_NATIVE:  # numpy has no such dtype: its raw bytes
            return v.view(torch.uint8).numpy(), name, list(v.shape)
        return v.numpy(), name, list(v.shape)
    v = np.array(v)
    if v.dtype.name not in _NP_NATIVE:
        return v.view(np.uint8), v.dtype.name, list(v.shape)
    return v, v.dtype.name, list(v.shape)


def save(ckpt_dir: str, step: int, tree, keep: int = 3,
         async_: bool = False) -> Optional[threading.Thread]:
    """Save ``tree`` under ckpt_dir/step_{step:08d} atomically; with
    ``async_`` on a started thread, which is returned."""
    os.makedirs(ckpt_dir, exist_ok=True)
    keys, vals = T.flatten_with_paths(tree)
    host = [_to_host(v) for v in vals]

    def _write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, _ARRAYS), **{f"a{i}": h[0] for i, h in enumerate(host)})
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump({"step": step, "keys": keys, "dtypes": [h[1] for h in host],
                       "shapes": [h[2] for h in host]}, f)
        with open(os.path.join(tmp, _COMMIT), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        _gc(ckpt_dir, keep)

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


def all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, _COMMIT)):
                out.append(int(d[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _from_host(a: np.ndarray, name: str, shape, like):
    """A stored array -> a leaf of ``like``'s kind, dtype and device."""
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(np.array(a))
        if name not in _NP_NATIVE:
            t = t.view(getattr(torch, name)).reshape(shape)
        return t.to(device=like.device, dtype=like.dtype)
    if name not in _NP_NATIVE:  # raw bytes of a dtype numpy lacks
        return np.asarray(a).view(like.dtype).reshape(shape)
    return np.asarray(a).astype(like.dtype) if hasattr(like, "dtype") else a


def restore(ckpt_dir: str, template, step: Optional[int] = None):
    """-> (step, tree shaped like ``template``, each leaf of its template
    leaf's kind, dtype and device). Raises FileNotFoundError without a
    committed step, ValueError if the saved paths are not the template's."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    keys, tvals = T.flatten_with_paths(template)
    if keys != manifest["keys"]:
        raise ValueError(
            f"checkpoint structure mismatch: {len(manifest['keys'])} saved "
            f"keys vs {len(keys)} template keys")
    with np.load(os.path.join(d, _ARRAYS)) as data:
        out = [_from_host(data[f"a{i}"], name, shape, t)
               for i, (name, shape, t) in enumerate(zip(manifest["dtypes"],
                                                        manifest["shapes"], tvals))]
    return step, T.unflatten(template, out)
