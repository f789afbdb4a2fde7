"""Dry run: trace every (arch x input shape) cell on a mesh without a
card, and record its per-device FLOPs, bytes, peak and collectives.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh tiny

Counterpart of ``repro/launch/dryrun.py``, whose lower-and-compile for
a mesh executes nothing. Here the process brings up a ``fake`` process
group of the mesh's size (rank 0 of it; its collectives send nothing),
builds the cell's plan on a ``cpu`` DeviceMesh, places fake inputs by the
plan's ``in_shardings`` (each rank's shard, ``DTensor.from_local``) and
runs the step once under ``FakeTensorMode``: shapes, dtypes and
placements propagate, nothing is allocated and no kernel runs (the
plain versions stand in for the kernels, whose entries see CPU shards).
A dispatch mode over the trace records, per device:

- FLOPs of the local ops (``torch.utils.flop_counter``'s formulas; an op
  on DTensors is counted through the local ops it runs, never itself);
- HBM bytes: the inputs plus outputs of each local op that is not a view;
  a kernel's plain version counts as its kernel: its inputs and outputs,
  its FLOPs, and none of its temporaries (``KERNEL_FNS``);
- argument and output bytes, from the local shapes (the arguments' from
  the ``in_shardings``' shard shapes, as the reference's memory analysis);
- the peak of live local bytes over the trace, arguments included;
- the collectives (its mode is a :class:`launch.roofline.CollectiveMode`,
  the counter of :func:`launch.roofline.count_collectives`);
- the roofline (:class:`launch.roofline.Roofline`, with ``model_flops``).

The record goes to ``artifacts/dryrun_torch/<mesh>/<arch>__<shape>.json``
and each cell prints the reference's ``[ok] ...`` line. The ``fake``
group is ``torch.testing._internal.distributed.fake_pg``, a private
module of PyTorch: the dry run fails loudly where it is missing.

Meshes: ``single`` (16, 16) ("data", "model") and ``multi`` (2, 16, 16)
("pod", "data", "model"), the production meshes; ``tiny`` (2, 4) and
``tinymulti`` (2, 2, 2), their CI-scale stand-ins; ``one`` (1, 1), one
card's. ``--batch N`` cuts the cell's global batch to N, as a one-card
run cuts it (the record's name then ends ``__b<N>``). ``--hlo-out``
writes the trace's local ops, one a line, where the reference writes
HLO.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref

import torch

from repro_torch import tree as T
from repro_torch.launch.roofline import CollectiveMode, Roofline, collective_kind
from repro_torch.configs import all_cells, get_config, get_shape
from repro_torch.launch.steps import build_plan, cell_flops
from repro_torch.models.diffusion import coef_table

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "artifacts", "dryrun_torch")

MESHES = {"one": ((1, 1), ("data", "model")),
          "single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "tiny": ((2, 4), ("data", "model")),
          "tinymulti": ((2, 2, 2), ("pod", "data", "model"))}


def fake_group(n: int):
    """A ``fake`` default process group of ``n`` ranks (this process is
    rank 0), replacing one of another size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def mesh_for(name: str):
    """The named mesh on the ``cpu`` device type, over a ``fake`` group of
    its size."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.mesh import make_production_mesh
    shape, names = MESHES[name]
    fake_group(math.prod(shape))
    if name in ("single", "multi"):
        return make_production_mesh(multi_pod=name == "multi", device_type="cpu")
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


def _tensors(tree):
    return [x for x in torch.utils._pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


class _Live:
    """Live local bytes, by storage: a storage counts from the first
    tensor that holds it to the death of the last."""

    def __init__(self):
        self.refs, self.size = {}, {}
        self.bytes = self.peak = 0

    def hold(self, t: torch.Tensor, owner=None):
        """``t``'s storage live while ``owner`` (``t`` by default) is."""
        st = t.untyped_storage()
        key = st._cdata
        if key not in self.refs:
            self.refs[key] = 0
            self.size[key] = st.nbytes()
            self.bytes += self.size[key]
            self.peak = max(self.peak, self.bytes)
        self.refs[key] += 1
        weakref.finalize(t if owner is None else owner, self._drop, key)

    def _drop(self, key):
        self.refs[key] -= 1
        if not self.refs[key]:
            del self.refs[key]
            self.bytes -= self.size.pop(key)


def _counting_mode(live, ops):
    """A fake mode that records, for each local op it runs (the shards'
    ops, which DTensor dispatches to it, collectives included), FLOPs,
    HBM bytes and live bytes -> (mode, acc); its base class counts the
    collectives in ``mode.collectives``. ``mode.counting`` turns the
    FLOP, byte and op records on; the ops DTensor's sharding propagation
    runs on global shapes to derive an output's metadata are not the
    step's and are left out (:class:`_Hidden`)."""
    from torch.distributed.tensor import DTensor
    from torch.utils.flop_counter import flop_registry
    acc = {"flops": 0.0, "bytes": 0.0, "ops": 0}

    class _Mode(CollectiveMode):
        counting = False
        hidden = 0
        in_kernel = 0

        def kernel_io(self, args, kwargs, out):
            """A kernel's traffic: its inputs read and outputs written
            once; its outputs live, its plain version's temporaries not."""
            if self.counting and not self.hidden:
                acc["bytes"] += sum(_nbytes(t) for t in _tensors((args, kwargs, out)))
                for t in _tensors(out):
                    live.hold(t)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if (not self.counting or self.hidden or out is NotImplemented
                    or func.namespace in ("prim", "prims")
                    or any(isinstance(a, DTensor)
                           for a in torch.utils._pytree.tree_leaves((args, kwargs)))):
                return out
            kind = collective_kind(func)
            acc["ops"] += 1
            if ops is not None:
                ops.append(f"{func} -> {[tuple(t.shape) for t in _tensors(out)]}")
            packet = func.overloadpacket
            if packet in flop_registry:
                acc["flops"] += flop_registry[packet](*args, **kwargs, out_val=out)
            if self.in_kernel:   # a kernel's plain version: its FLOPs only
                return out
            if (kind is None and not func.is_view and func.namespace == "aten"
                    and not packet.__name__.startswith("empty")):
                acc["bytes"] += sum(_nbytes(t) for t in _tensors((args, kwargs, out)))
            for t in _tensors(out):
                live.hold(t)
            return out

    return _Mode(allow_non_fake_inputs=True), acc


# the kernels' plain versions (``kernels.ref``) that ``kernels.ops``
# sends CPU tensors to; the decode attention, which has no kernel, is
# the plain ops it runs (``kv_len`` given)
KERNEL_FNS = ("tile_moments", "kmeans_assign", "kmeanspp_seed", "kmeans_assign_lanes",
              "kmeanspp_seed_lanes", "iou_matrix", "nms_keep", "attention", "int8_matmul")


class _Recompute(torch.autograd.Function):
    """A kernel's plain version under autograd, counted as a flash-style
    kernel pair: the forward saves only its inputs, the backward
    recomputes and differentiates it as one kernel (FLOPs, the bytes of
    its inputs, output gradient and input gradients; no temporaries)."""

    @staticmethod
    def forward(ctx, fn, mode, kwargs, *args):
        ctx.fn, ctx.mode, ctx.kwargs = fn, mode, kwargs
        ctx.save_for_backward(*args)
        mode.in_kernel += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            mode.in_kernel -= 1
        mode.kernel_io(args, kwargs, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        mode = ctx.mode
        args = [a.detach().requires_grad_(a.is_floating_point()) for a in ctx.saved_tensors]
        mode.in_kernel += 1
        try:
            with torch.enable_grad():
                out = ctx.fn(*args, **ctx.kwargs)
                want = [a for a in args if a.requires_grad]
                grads = iter(torch.autograd.grad(out, want, grad))
        finally:
            mode.in_kernel -= 1
        got = [next(grads) if a.requires_grad else None for a in args]
        mode.kernel_io((*args, grad), {}, [g for g in got if g is not None])
        return (None, None, None, *got)


class _AsKernels:
    """``kernels.ops``' plain versions counted as their kernels run: the
    FLOPs of the plain ops, the bytes of the inputs and outputs, and no
    temporaries (the plain attention's score matrix is not the flash
    kernel's)."""

    def __init__(self, mode):
        self.mode = mode

    def __enter__(self):
        from repro_torch.kernels import ops, ref
        self.ref = ops.ref
        mode = self.mode

        def wrap(fn):
            def run(*args, **kwargs):
                if kwargs.get("kv_len") is not None:
                    return fn(*args, **kwargs)
                if torch.is_grad_enabled() and any(isinstance(a, torch.Tensor) and a.requires_grad
                                                   for a in args):
                    return _Recompute.apply(fn, mode, kwargs, *args)
                mode.in_kernel += 1
                try:
                    out = fn(*args, **kwargs)
                finally:
                    mode.in_kernel -= 1
                mode.kernel_io(args, kwargs, out)
                return out
            return run
        ops.ref = type("ref", (), {n: staticmethod(wrap(getattr(ref, n))) for n in KERNEL_FNS})

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.ref = self.ref


class _Hidden:
    """Around DTensor's sharding propagation of an op's output metadata
    (``ShardingPropagator._propagate_tensor_meta_non_cached``, which runs
    the op on fake tensors of the global shapes): the mode records
    nothing there."""

    def __init__(self, mode):
        self.mode = mode

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        self.orig = orig = ShardingPropagator._propagate_tensor_meta_non_cached
        mode = self.mode

        def hidden(prop, *args, **kwargs):
            mode.hidden += 1
            try:
                return orig(prop, *args, **kwargs)
            finally:
                mode.hidden -= 1
        ShardingPropagator._propagate_tensor_meta_non_cached = hidden

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        ShardingPropagator._propagate_tensor_meta_non_cached = self.orig


def _inputs(plan, mesh):
    """Fake inputs of a mesh plan: each leaf a DTensor of fake shards; the
    host scalars Python ints, and other 0-d leaves (the optimizer's step)
    real CPU zeros."""
    from repro_torch.sharding.place import from_shards
    host = set(plan.meta.get("host_scalars", ()))
    args = []
    for i, (a, sh) in enumerate(zip(plan.args, plan.in_shardings)):
        if i in host:
            args.append(1 if i == plan.meta["host_scalars"][0] else 0)
            continue
        with torch._subclasses.fake_tensor.unset_fake_temporarily():
            a = T.map_leaves(lambda x: torch.zeros((), dtype=x.dtype) if x.ndim == 0 else x, a)
        args.append(from_shards(a, T.map_leaves(lambda s: s.spec, sh), mesh,
                                lambda shape, dt: torch.empty(shape, dtype=dt)))
    return args


def argument_bytes(plan) -> int:
    """Per-device bytes of the plan's inputs: each leaf's shard shape
    under its ``in_shardings``."""
    total = 0
    for a, sh in zip(plan.args, plan.in_shardings):
        for x, s in zip(T.leaves(a), T.leaves(sh)):
            total += math.prod(s.shard_shape(x.shape)) * x.element_size()
    return total


def run_cell(arch: str, shape: str, mesh_name: str, opts=None, save: bool = True,
             hlo_out: str = None, batch: int = None) -> dict:
    from torch.distributed.tensor import DTensor
    opts = {"unroll": True, **(opts or {})}
    mesh = mesh_for(mesh_name)
    n_chips = mesh.size()
    t0 = time.time()
    cfg, spec = get_config(arch), get_shape(arch, shape)
    if batch is not None:
        spec = dataclasses.replace(spec, global_batch=batch)
    plan = build_plan(cfg, spec, arch, mesh, **opts)
    t_plan = time.time() - t0
    coef_table()   # the DDIM coefficients, host floats read outside the trace
    live, ops = _Live(), [] if hlo_out else None
    mode, acc = _counting_mode(live, ops)
    with mode:
        args = _inputs(plan, mesh)
        for t in _tensors(args):   # a DTensor's shard lives as long as the DTensor
            live.hold(t.to_local() if isinstance(t, DTensor) else t, owner=t)
        mode.counting = True
        with _Hidden(mode), _AsKernels(mode):
            out = plan.fn(*args)
        mode.counting = False
        out_bytes = sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
                        for t in T.leaves(out) if isinstance(t, torch.Tensor))
        del out, args
    t_trace = time.time() - t0 - t_plan
    arg_bytes = argument_bytes(plan)
    mem = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
           "peak_bytes": live.peak, "temp_bytes": max(live.peak - arg_bytes, 0)}
    mem["total_bytes"] = mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
    c = mode.collectives.as_dict()
    mf = cell_flops(cfg, spec)
    rl = Roofline(flops=acc["flops"], bytes_hbm=acc["bytes"], bytes_coll=c["total"],
                  n_chips=n_chips, model_flops_total=mf,
                  min_bytes=float(arg_bytes + out_bytes))
    rec = {
        "arch": arch, "shape": shape, "mesh": mesh_name, "batch": spec.global_batch,
        "mesh_shape": list(mesh.shape), "n_chips": n_chips,
        "plan_s": round(t_plan, 2), "trace_s": round(t_trace, 2),
        "memory_analysis": mem,
        "cost_analysis": {"flops": acc["flops"], "bytes_accessed": acc["bytes"]},
        "collectives": {k: v for k, v in c.items() if k != "counts"},
        "collective_counts": c["counts"],
        "roofline": rl.as_dict(),
        "opts": {k: str(v) for k, v in opts.items()},
        "local_ops": acc["ops"],
    }
    if hlo_out:
        with open(hlo_out, "w") as f:
            f.write("\n".join(ops) + "\n")
    if save:
        d = os.path.join(ART_DIR, mesh_name)
        os.makedirs(d, exist_ok=True)
        tag = "" if not opts else "__" + "_".join(f"{k}-{v}" for k, v in opts.items())
        tag += "" if batch is None else f"__b{batch}"
        with open(os.path.join(d, f"{arch}__{shape}{tag}.json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both", "tiny", "tinymulti", "one"])
    ap.add_argument("--batch", type=int, default=None,
                    help="cut the cell's global batch to this (a one-card run's cut)")
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--no-mla-absorb", action="store_true")
    ap.add_argument("--hlo-out", default=None,
                    help="write the trace's local ops here, one a line")
    ap.add_argument("--continue-on-error", action="store_true")
    ap.add_argument("--scan", action="store_true",
                    help="the reference's scan over layers; the port always runs "
                         "its layers in a loop, so this changes nothing but the tag")
    args = ap.parse_args(argv)

    opts = {}
    if args.scan:
        opts["unroll"] = False
    if args.grad_accum:
        opts["grad_accum"] = args.grad_accum
    if args.zero1:
        opts["zero1_axis"] = "data"
    if args.no_mla_absorb:
        opts["mla_absorb"] = False

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = all_cells() if args.all else [(args.arch, args.shape)]
    failures = []
    for mesh_name in meshes:
        for arch, shape in cells:
            tag = f"{arch} x {shape} @ {mesh_name}"
            try:
                rec = run_cell(arch, shape, mesh_name, opts, hlo_out=args.hlo_out,
                               batch=args.batch)
                r = rec["roofline"]
                print(f"[ok] {tag}: trace={rec['trace_s']:.1f}s "
                      f"flops/dev={r['flops_per_dev']:.3e} "
                      f"dominant={r['dominant']} "
                      f"bound={max(r['compute_s'], r['memory_s'], r['collective_s']):.4f}s "
                      f"useful={r['useful_ratio']:.2f}", flush=True)
            except Exception as e:
                failures.append((tag, repr(e)))
                print(f"[FAIL] {tag}: {e!r}", flush=True)
                if not args.continue_on_error:
                    traceback.print_exc()
                    raise SystemExit(1)
    if failures:
        print(f"\n{len(failures)} failures:")
        for t, e in failures:
            print(" ", t, e)
        raise SystemExit(1)
    print("\nall cells passed")


if __name__ == "__main__":
    main()
