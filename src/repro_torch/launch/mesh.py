"""Mesh builders: ``DeviceMesh``es over the default process group.

Counterpart of ``repro/launch/mesh.py``. Single pod: 16 x 16 = 256 ranks,
axes ("data", "model"). Multi-pod: 2 x 16 x 16 = 512 ranks, axes ("pod",
"data", "model"): "pod" is pure data parallelism across pods (the
gradient all-reduce crosses the inter-pod links once a step).

The process group must be up (``torch.distributed.init_process_group``)
with the mesh's number of ranks: a production mesh on any other group
raises, there is no silent shrink. The device type is "cuda" unless the
caller asks for "cpu" (the tests, and the dry run on a ``fake`` group).
Functions, not module constants: importing this module touches no
process group.
"""
from __future__ import annotations


def _mesh(shape, names, device_type):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs a process group of {n} ranks; none is up")
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the process group has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_test_mesh(n_devices: int = None, model: int = 2, device_type: str = "cuda"):
    """A (n / model, model) ("data", "model") mesh over the group's ranks
    (all of them by default; ``model`` cut to ``n``)."""
    import torch.distributed as dist
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    model = min(model, n)
    return _mesh((n // model, model), ("data", "model"), device_type)
