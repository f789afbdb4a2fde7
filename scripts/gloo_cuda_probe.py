"""Can four processes share one card on ``gloo`` for the fleet's sats mesh?

Four ranks on ``cuda:0``, a ``file://`` store, backends ``gloo`` and
``cpu:gloo,cuda:gloo``, each rank printing what each step gives:
``torch.distributed``'s own ``all_reduce``, ``all_gather`` and
``all_gather_into_tensor`` on CUDA tensors, then (with a mesh)
``init_device_mesh("cuda", (4,), mesh_dim_names=("sats",))`` and a
DTensor's ``full_tensor()``, the functional collective every gather of
the fleet makes. A rank that dies ends its run; the next one starts.

    python3 scripts/gloo_cuda_probe.py      # on the GPU machine
"""
import faulthandler
import sys
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4


def step(rank, name, fn):
    print(f"rank {rank}: {name} ...", flush=True)
    try:
        out = fn()
    except Exception:  # noqa: BLE001 - a probe reports every failure and goes on
        print(f"rank {rank}: {name} FAILED\n{traceback.format_exc()}", flush=True)
        return None
    print(f"rank {rank}: {name} -> {out}", flush=True)
    return out


def rank_main(rank, world, store, backend, with_mesh):
    faulthandler.enable()
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{store}/store", rank=rank,
                            world_size=world)
    local = torch.full((2, 3), float(rank), device="cuda")

    def all_reduce():
        t = torch.tensor([rank], dtype=torch.int32, device="cuda")
        dist.all_reduce(t)
        return t.item()

    def all_gather():
        out = [torch.empty_like(local) for _ in range(world)]
        dist.all_gather(out, local)
        return [x[0, 0].item() for x in out]

    def all_gather_into_tensor():
        out = torch.empty((2 * world, 3), device="cuda")
        dist.all_gather_into_tensor(out, local)
        return out[:, 0].tolist()
    for name, fn in (("all_reduce", all_reduce), ("all_gather", all_gather),
                     ("all_gather_into_tensor", all_gather_into_tensor)):
        step(rank, name, fn)
    if with_mesh:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Shard
        mesh = step(rank, "init_device_mesh",
                    lambda: init_device_mesh("cuda", (world,), mesh_dim_names=("sats",)))
        if mesh is not None:
            x = DTensor.from_local(local, mesh, (Shard(0),), run_check=False)
            step(rank, "full_tensor", lambda: x.full_tensor()[:, 0].tolist())
    dist.barrier()
    dist.destroy_process_group()


def main():
    print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.device_count(),
          torch.cuda.get_device_name(0), flush=True)
    for backend in ("gloo", "cpu:gloo,cuda:gloo"):
        for with_mesh in (False, True):
            print(f"=== backend {backend}, mesh {with_mesh}", flush=True)
            with tempfile.TemporaryDirectory() as store:
                try:
                    mp.spawn(rank_main, args=(WORLD, store, backend, with_mesh), nprocs=WORLD,
                             join=True)
                    print(f"=== backend {backend}, mesh {with_mesh}: every rank ended", flush=True)
                except mp.ProcessExitedException as e:
                    print(f"=== backend {backend}, mesh {with_mesh}: {e}", flush=True)


if __name__ == "__main__":
    main()
