#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository's sources; it imports
nothing of JAX or of the reference package ``repro``. Phases:

1. device: the card's name and power limit, torch/CUDA versions, and
   the build of every hand-written kernel from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, in parallel);
2. kernels: each kernel against its plain PyTorch version on the card,
   at the shapes the Mission gives it and at ragged ones, timed with CUDA
   events beside the plain version and the least time the card could
   take (``bound_ms``);
3. the Mission at full width: the ``targetfuse-space`` and
   ``targetfuse-ground`` counters (seeded random weights) on xview-like
   traffic, every selection policy, with every kernel's launch count
   from this run;
4. CUDA against CPU: the same reduced-config Mission on the card
   (kernels) and on the CPU (plain versions), per-tile predictions equal.

It prints a ``{"kernels": [...]}`` line, then the ``nvidia-smi`` name and
power limit, and last ``{"ok": true, "device": {...}}``. Any failure
exits non-zero before that last line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate
FP32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
SEED = 0
XVIEW_SCENES, XVIEW_REVISITS = 3, 3


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int, warmup: int = 2, hold: bool = True) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events.

    ``hold`` first keeps the card busy (``torch.cuda._sleep``) while the
    host queues all the runs, so the events time the device alone; else
    a small kernel's time is the host's launch rate (wrapper checks,
    ``ctypes`` and the launch).
    """
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if hold:
        torch.cuda._sleep(50_000_000)  # ~25 ms at the H100's clock
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_flops: float):
    """The larger of the bytes over the memory rate and the operations
    over the float32 rate -> (ms, what bounds it)."""
    t_b, t_f = n_bytes / HBM_BYTES_PER_S, n_flops / FP32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_cases(dev):
    """-> {kernel name: [case, ...]}; the first case of each kernel is its
    main-path shape, the one the ``kernels`` line reports."""
    import torch
    from repro_torch.kernels import iou, kmeans_assign, ref, tile_moments

    g = torch.Generator(device=dev).manual_seed(SEED)
    cases = {"tile_moments": [], "kmeans_assign": [], "iou_matrix": []}
    for shape in [(256, 416, 416, 3), (130, 64, 64, 3)]:
        t = torch.rand(shape, generator=g, device=dev)
        n, h, w, c = shape
        cases["tile_moments"].append(dict(
            shape=str(shape), kernel=lambda t=t: tile_moments.tile_moments(t),
            plain=lambda t=t: ref.tile_moments(t), atol=1e-4,
            bytes=t.numel() * 4 + n * 3 * c * 4, flops=7 * t.numel()))
    for n, k in [(1024, 512), (1024, 1), (1024, 64), (1000, 1), (1000, 64),
                 (1000, 512), (128, 1), (128, 64), (128, 512)]:
        x = torch.randn((n, 9), generator=g, device=dev)
        cent = torch.randn((k, 9), generator=g, device=dev)
        if k > 1:
            cent[k // 2] = cent[0]   # duplicate centroid: ties go to index 0
            cent[-1] = x[3]          # an exact hit
        x[5] = x[3]
        cases["kmeans_assign"].append(dict(
            shape=f"x({n}, 9) c({k}, 9)",
            kernel=lambda x=x, c=cent: kmeans_assign.kmeans_assign(x, c),
            plain=lambda x=x, c=cent: ref.kmeans_assign(x, c), atol=1e-4,
            bytes=(n + k) * 9 * 4 + n * 8, flops=2 * n * k * 9 + 3 * n * k))
    for b, n, m in [(64, 128, 128), (None, 200, 300)]:
        lead = () if b is None else (b,)
        bx = torch.rand((*lead, n + m, 4), generator=g, device=dev) * 50
        bx[..., 2:] = bx[..., :2] + bx[..., 2:].abs() + 0.01
        a, bb = bx[..., :n, :].contiguous(), bx[..., n:, :].contiguous()
        if b is not None:
            bb = a           # NMS: the candidates against themselves
            m = n
        bs = b or 1
        cases["iou_matrix"].append(dict(
            shape=f"{tuple(a.shape)} x {tuple(bb.shape)}",
            kernel=lambda a=a, bb=bb: iou.iou_matrix(a, bb),
            plain=lambda a=a, bb=bb: ref.iou_matrix(a, bb), atol=1e-5,
            bytes=bs * (n + m) * 16 + bs * n * m * 4, flops=12 * bs * n * m))
    return cases


LIBRARY_NOTE = {
    "tile_moments": "no one PyTorch call computes mean, stddev and cube-root skew",
    "kmeans_assign": "torch.cdist gives the distances but not the argmin (two calls)",
    "iou_matrix": "no batched box IoU in PyTorch (torchvision's box_iou is 2-D and "
                  "not installed)",
}


def phase_kernels(dev):
    import torch
    rows = {}
    for name, cases in kernel_cases(dev).items():
        for i, case in enumerate(cases):
            got, want = case["kernel"](), case["plain"]()
            torch.cuda.synchronize()
            if name == "kmeans_assign":
                check(torch.equal(got[0], want[0]),
                      f"{name} {case['shape']}: assignments differ")
                err = (got[1] - want[1]).abs().max().item()
                check(torch.allclose(got[1], want[1], atol=case["atol"], rtol=1e-4),
                      f"{name} {case['shape']}: distances off by {err}")
            else:
                err = (got - want).abs().max().item()
                check(torch.allclose(got, want, atol=case["atol"], rtol=1e-4),
                      f"{name} {case['shape']}: off by {err}")
            ms = cuda_ms(case["kernel"], reps=20)
            host_ms = cuda_ms(case["kernel"], reps=20, hold=False)
            plain_ms = cuda_ms(case["plain"], reps=5, warmup=1)
            b_ms, b_by = bound_ms(case["bytes"], case["flops"])
            print(f"kernel {name} {case['shape']}: max_abs_err {err:.3e} "
                  f"ms {ms:.4f} (with host launch {host_ms:.4f}) "
                  f"plain_ms {plain_ms:.4f} bound_ms {b_ms:.4f} "
                  f"({b_by}) share {b_ms / ms:.3f}", flush=True)
            if i == 0:
                rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=b_ms, bound_by=b_by)
    for name, why in LIBRARY_NOTE.items():
        print(f"kernel {name}: library_ms null ({why})")
    return rows


# ---------------------------------------------------------------------------
# phases 3 and 4: the Mission
# ---------------------------------------------------------------------------

POLICIES = ("space_only", "ground_only", "tiansuan", "kodan", "targetfuse")


def counters(cfg_pair, dev, head_scale=1.0):
    """Seeded random counters with the head's objectness and class-0
    biases raised (to 2), so every tile has boxes for NMS to keep and
    suppress and confidences fall between the throttle's thresholds.
    ``head_scale`` widens the head's weights, so confidences spread."""
    import torch
    from repro_torch.models import detector
    out = []
    for seed, cfg in enumerate(cfg_pair):
        p = detector.init(torch.Generator().manual_seed(SEED + seed), cfg)
        p["head_w"] = p["head_w"] * head_scale
        hb = p["head_b"].view(cfg.n_anchors, 5 + cfg.n_classes)
        hb[:, 4] = 2.0
        hb[:, 5] = 2.0
        out.append((detector.to_device(p, dev), cfg))
    return out


def scene_frames(spec, n_scenes, n_revisits, seed):
    import numpy as np
    from repro_torch.data.synthetic import make_scene, revisit_frames
    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(n_scenes):
        img, b, c = make_scene(rng, spec)
        frames += revisit_frames(rng, img, b, c, n_revisits)
    return frames


class Timed:
    """A Mission stage with a wall-clock timer around it; the card is
    synchronized on both sides, so the time is the stage's own."""

    def __init__(self, stage, times: dict):
        self.stage, self.times, self.name = stage, times, stage.name

    def run(self, mission, seg, window=None):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.stage.run(mission, seg, window)
        torch.cuda.synchronize()
        self.times[self.name] = self.times.get(self.name, 0.0) + time.perf_counter() - t0


def phase_full_width(dev, kernels):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import mission as M
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.data.synthetic import DATASETS

    cfgs = (get_config("targetfuse-space"), get_config("targetfuse-ground"))
    space, ground = counters(cfgs, dev)
    frames = scene_frames(DATASETS["xview"], XVIEW_SCENES, XVIEW_REVISITS, SEED)
    n_tiles = len(frames) * (DATASETS["xview"].scene_px // 128) ** 2
    print(f"full width: {len(frames)} xview frames, {n_tiles} tiles; "
          f"space {cfgs[0].widths} ground {cfgs[1].widths} at "
          f"{cfgs[0].input_size} px", flush=True)

    def pcfg(method):
        return PipelineConfig(method=method, score_thresh=0.25, seed=SEED)

    M.Mission(space, ground, pcfg("targetfuse"), device=dev).run(frames)  # warm-up
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    per_policy = {}
    for method in POLICIES:
        before = {k.name: k.launches for k in kernels}
        torch.cuda.reset_peak_memory_stats()
        stages = {}
        m = M.Mission(space, ground, pcfg(method), device=dev,
                      ingest_stages=[Timed(st, stages) for st in M.default_ingest_stages()],
                      contact_stages=[Timed(st, stages) for st in M.default_contact_stages()])
        t0 = time.perf_counter()
        m.ingest(frames)
        t1 = time.perf_counter()
        m.contact_window()
        t2 = time.perf_counter()
        r = m.result()
        launches = {k.name: k.launches - before[k.name] for k in kernels}
        check(r.tiles_total == n_tiles, f"{method}: {r.tiles_total} tiles")
        check(np.isfinite(r.per_tile_pred).all() and r.per_tile_pred.shape == (n_tiles,),
              f"{method}: bad predictions")
        per_policy[method] = dict(
            ingest_s=t1 - t0, contact_s=t2 - t1,
            tiles_per_s=n_tiles / (t2 - t0),
            max_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            launches=launches, stages_s=stages, cmae=r.cmae,
            total_pred=r.total_pred, total_true=r.total_true,
            processed=r.tiles_processed_space, downlinked=r.tiles_downlinked)
        print(f"mission {method}: " + json.dumps(per_policy[method]), flush=True)
    tf = per_policy["targetfuse"]["launches"]
    check(all(v > 0 for v in tf.values()), f"targetfuse missed a kernel: {tf}")
    check(per_policy["targetfuse"]["downlinked"] > 0, "targetfuse downlinked nothing")
    return {k.name: k.launches for k in kernels}


class ReplayDedup:
    """Dedup stage that runs the port's own clustering, keeps its result,
    then gives each segment the representatives of another run."""

    def __init__(self, rep_ofs):
        from repro_torch.core.mission import Dedup
        self.inner, self.rep_ofs, self.own = Dedup(), list(rep_ofs), []
        self.name = "dedup"

    def run(self, mission, seg, window=None):
        self.inner.run(mission, seg, window)
        self.own.append(seg.rep_of.copy())
        seg.rep_of = self.rep_ofs.pop(0).copy()


def same_partition(a, b) -> bool:
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


def phase_cuda_vs_cpu(dev):
    """The reduced Mission on the card and on the CPU: equal per-tile
    predictions. Two-member clusters are ties that the last bit of the
    moments decides (kernel and plain version sum in another order), so
    the clustering policies are compared with the CPU run's
    representatives replayed on the card, after checking that the card
    found the same clusters."""
    import numpy as np
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import mission as M
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.data.synthetic import SceneSpec

    cfgs = (reduced(get_config("targetfuse-space")), reduced(get_config("targetfuse-ground")))
    spec = SceneSpec("golden", 384, (12, 18), (10, 24), cloud_fraction=0.2)
    frames = scene_frames(spec, 2, 3, 42)
    cpu_counters = counters(cfgs, "cpu", head_scale=30.0)
    gpu_counters = counters(cfgs, dev, head_scale=30.0)
    for method in POLICIES:
        pcfg = PipelineConfig(method=method, score_thresh=0.25, seed=SEED)
        cpu = M.Mission(*cpu_counters, pcfg, device="cpu")
        want = cpu.run(frames)
        gpu = M.Mission(*gpu_counters, pcfg, device=dev)
        free = gpu.run(frames)
        stages, replay = None, None
        if method in ("kodan", "targetfuse"):
            replay = ReplayDedup([s.rep_of for s in cpu._segments])
            stages = [M.Capture(), M.RoiFilter(), replay, M.OnboardCount()]
        got = M.Mission(*gpu_counters, pcfg, ingest_stages=stages, device=dev).run(frames)
        if replay is not None:
            check(same_partition(replay.own[0], cpu._segments[0].rep_of),
                  f"{method}: the card's clusters differ from the CPU's")
        equal = np.array_equal(got.per_tile_pred, want.per_tile_pred)
        print(f"cuda vs cpu {method}: preds equal {equal} (free-running dedup: "
              f"{np.array_equal(free.per_tile_pred, want.per_tile_pred)}); "
              f"pred {got.total_pred} true {want.total_true} "
              f"downlinked {got.tiles_downlinked} processed {got.tiles_processed_space}",
              flush=True)
        check(equal, f"{method}: CUDA and CPU per-tile predictions differ")
        check(got.summary() == want.summary(), f"{method}: summaries differ")
        check(want.total_pred > 0, f"{method}: nothing counted")


# ---------------------------------------------------------------------------

def main():
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    try:
        from repro_torch.kernels import _build, ops
    except ImportError as e:
        fail(f"the port's sources are not beside this script: {e}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    _build.build_all(ops.KERNELS)
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(ops.KERNELS)} kernels",
          flush=True)

    t0 = time.perf_counter()
    rows = phase_kernels(dev)
    print(f"phase kernels: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches = phase_full_width(dev, ops.KERNELS)
    print(f"phase full-width mission: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_cuda_vs_cpu(dev)
    print(f"phase cuda vs cpu: {time.perf_counter() - t0:.1f} s", flush=True)

    replaces = {"tile_moments": "src/repro/kernels/tile_moments.py:33",
                "kmeans_assign": "src/repro/kernels/kmeans_assign.py:29",
                "iou_matrix": "src/repro/kernels/iou.py:30"}
    sources = {"tile_moments": "tile_moments", "kmeans_assign": "kmeans_assign",
               "iou_matrix": "iou"}
    line = {"kernels": [
        dict(name=name, route="cuda",
             source=f"src/repro_torch/csrc/{sources[name]}.cu",
             replaces=replaces[name], launches=launches[sources[name]],
             library_ms=None, **rows[name])
        for name in ("tile_moments", "kmeans_assign", "iou_matrix")]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
