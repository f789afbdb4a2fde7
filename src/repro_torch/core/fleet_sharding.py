"""The fleet's placement context: the ``sats`` device mesh.

Counterpart of ``repro/core/fleet_sharding.py``. The fleet stacks every
satellite's device work into lane arrays (the shared capture buckets,
the counting and recount batches, the dedup lanes of a shape bucket).
Lanes never couple, so splitting their leading axis over a
one-dimensional ``DeviceMesh`` named ``sats`` changes which device
computes a lane, not what it computes. The reference also places the
ledger's energy caps and a drain step's throttle lanes on its mesh; here
every rank computes those few dozen lanes on the host, as the one-device
fleet does.

The reference has one controller with N devices; the port is SPMD over
a ``torch.distributed`` process group, one rank a device. Every rank
runs the whole ``Fleet`` host program from the same seeds, so every rank
holds the same host arrays and the same gathered device tensors. A lane
stack is placed ``(Shard(0),)`` with each rank uploading only its own
rows (``DTensor.from_local``, no communication); the per-lane program
runs once a rank on that rank's lanes
(:func:`repro_torch.sharding.local.local_op`), and where the reference
reads a sharded array to the host the port gathers it
(``full_tensor()``) and slices the pad lanes off. Every rank then ends
with the same results, equal to the one-device fleet's bit for bit.

Uneven fleets are padded: a leading axis goes up to a device multiple
(:meth:`FleetSharding.pad`, :meth:`FleetSharding.shard`), and pad lanes
are sliced off before any result is read.

Built without a mesh, every helper is the identity (``pad(n) == n``,
``shard`` and ``device_put`` return their input), so the one-card fleet
runs the code it ran before the mesh existed.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import xfer

SATS_AXIS = "sats"


def sats_mesh(n_devices: Optional[int] = None, device_type: str = "cuda"):
    """A one-dim ``sats`` ``DeviceMesh`` over the first ``n_devices`` ranks
    of the default process group (all of them by default), or None (the
    one-device fleet) when only one would take part. Every rank of the
    group must call it, in the same order as its other collectives.
    Raises where more than one device is asked for and no process group
    is up, or where ``n_devices`` exceeds the group's size."""
    import torch.distributed as dist
    if n_devices is not None and int(n_devices) <= 1:
        return None
    if not dist.is_initialized():
        raise RuntimeError(
            f"sats_mesh: a mesh of {n_devices or 'every'} device(s) needs a process "
            f"group (torch.distributed.init_process_group); none is up")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(f"sats_mesh: {n} devices requested but the process group has "
                         f"{world} ranks")
    if n <= 1:
        return None
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    if n == world:
        return init_device_mesh(device_type, (n,), mesh_dim_names=(SATS_AXIS,))
    return DeviceMesh(device_type, list(range(n)), mesh_dim_names=(SATS_AXIS,))


class FleetSharding:
    """Placement context for the ``sats`` axis (the identity when ``mesh``
    is None).

    The primitives the fleet's call sites compose: :meth:`pad` (a lane
    count up to a device multiple), :meth:`shard` (zero-pad the leading
    axis, then :meth:`device_put`), :meth:`map_lanes` (a per-lane function
    on each rank's lanes) and :meth:`gather` (a lane stack back on every
    rank, pad lanes sliced off)."""

    __slots__ = ("mesh", "device", "rank")

    def __init__(self, mesh=None):
        self.mesh = mesh
        self.device = None
        self.rank = 0
        if mesh is None:
            return
        if tuple(mesh.mesh_dim_names or ()) != (SATS_AXIS,):
            raise ValueError(f"FleetSharding takes a one-dim ({SATS_AXIS!r},) mesh, got "
                             f"dims {mesh.mesh_dim_names}")
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("FleetSharding: this rank is not in the sats mesh")
        self.rank = int(coord[0])
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if mesh.device_type == "cuda" else torch.device(mesh.device_type))

    @property
    def on_mesh(self) -> bool:
        return self.mesh is not None

    @property
    def n_devices(self) -> int:
        return 1 if self.mesh is None else int(self.mesh.size())

    def pad(self, n: int) -> int:
        """Smallest device multiple >= n (the identity off the mesh)."""
        nd = self.n_devices
        return -(-int(n) // nd) * nd

    def lanes(self, n: int) -> slice:
        """This rank's rows of a leading axis of ``n`` (a device
        multiple): also its slice of a host list of per-lane values."""
        k = int(n) // self.n_devices
        return slice(self.rank * k, (self.rank + 1) * k)

    def device_put(self, arr):
        """``arr`` (a host array or a tensor every rank holds, its leading
        axis a device multiple) as a DTensor split along ``sats``: each
        rank uploads only its own rows, no communication. Every placement
        is counted in :mod:`repro_torch.core.xfer`'s transfer ledger. The
        identity off the mesh."""
        if self.mesh is None:
            return arr
        from torch.distributed.tensor import DTensor, Shard
        n = int(arr.shape[0])
        if n % self.n_devices:
            raise ValueError(f"device_put: a leading axis of {n} does not split over "
                             f"{self.n_devices} devices (pad it first: shard)")
        rows = arr[self.lanes(n)]
        if isinstance(rows, np.ndarray):
            rows = torch.from_numpy(np.ascontiguousarray(rows))
        xfer.record_transfer()
        local = rows.to(self.device).contiguous()
        shape = (n, *local.shape[1:])
        return DTensor.from_local(local, self.mesh, (Shard(0),),
                                  run_check=False, shape=torch.Size(shape),
                                  stride=torch.empty(shape, device="meta").stride())

    def shard(self, arr):
        """Zero-pad the leading axis to a device multiple and place it.
        Pad rows hold zeros; every fleet program is per lane, so they
        give garbage in their own rows only, which :meth:`gather` slices
        off. The identity off the mesh."""
        if self.mesh is None:
            return arr
        n = int(arr.shape[0])
        extra = self.pad(n) - n
        if extra:
            if isinstance(arr, torch.Tensor):
                arr = torch.cat([arr, arr.new_zeros((extra, *arr.shape[1:]))])
            else:
                arr = np.concatenate([arr, np.zeros((extra, *arr.shape[1:]), arr.dtype)])
        return self.device_put(arr)

    def map_lanes(self, fn, args, n_out: int, out_dims=None):
        """``fn(*local_args)`` once a rank on its lanes of the placed
        ``args`` -> ``n_out`` DTensors, each split along ``sats`` on its
        ``out_dims`` entry (dim 0 by default)."""
        from torch.distributed.tensor import Shard
        from repro_torch.sharding.local import local_op
        out_dims = (0,) * n_out if out_dims is None else tuple(out_dims)
        return local_op(fn, args, self.mesh, tuple(a.placements for a in args),
                        tuple((Shard(d),) for d in out_dims))

    def gather(self, x, n: int):
        """A lane stack on every rank (``full_tensor()``), its first ``n``
        lanes (the pad lanes sliced off)."""
        return x.full_tensor()[:int(n)]

    def agree(self, flag: bool) -> bool:
        """``flag`` or'ed over the ranks (one small all-reduce): a branch
        that hangs on timing, decided the same way on every rank. The
        identity off the mesh."""
        if self.mesh is None:
            return bool(flag)
        import torch.distributed as dist
        t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.mesh.get_group())
        return bool(t.item())


# the shared off-mesh context: call sites take ``sharding=None`` and
# normalize through :func:`ctx`, so None and "no mesh" behave the same
OFF_MESH = FleetSharding(None)


def ctx(sharding: Optional[FleetSharding]) -> FleetSharding:
    """An optional sharding argument, None as the off-mesh context."""
    return OFF_MESH if sharding is None else sharding
