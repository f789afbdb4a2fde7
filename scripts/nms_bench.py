#!/usr/bin/env python3
"""Time the detector's NMS on one or more trees, alone and inside Missions.

    python3 scripts/nms_bench.py [ROOT ...]

Needs one CUDA card and ``nvcc``. Each ROOT (default: this checkout) is a
checkout of the repository. For each, in a process of its own, its
``src/repro_torch`` is imported and the Mission's kernels
(``tile_moments``, ``kmeans_assign``, ``iou``) are built from its own
sources into its own ``build/kernels/``. Then, with helpers and inputs
from this checkout's ``chip_smoke.py`` (so every tree gets the same):

1. ``detector.nms_keep(boxes, scores, 0.25, 0.25, max_det)`` at each of
   ``NMS_CASES``' shapes: its keep mask against the same tree's call on
   CPU copies of the inputs (equal), its device time (CUDA events, the
   card held busy while the host queues the calls), its time a call when
   the host launches them one after another, and the device operations
   one call runs (kernels, copies and fills, by ``torch.profiler``);
2. a warm-up Mission, then one full-width Mission of each policy
   (``chip_smoke.run_mission``: the ``targetfuse-space`` and
   ``targetfuse-ground`` counters with seeded weights on xview-like
   traffic): stage times, tiles/s, and in each counting stage the
   device time of its counter chunks and of their ``detector.nms_keep``.

Name a tree twice, in turns (parent, change, change, parent), to see the
spread. Prints one JSON line per tree and case or policy, then
``nvidia-smi``'s name and power limit; exits non-zero if a build fails
or a keep mask differs from the CPU's.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def device_ops(fn) -> int:
    """Device operations (kernels, copies, fills) of one call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def one(root: Path):
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch
    from chip_smoke import (NMS_CASES, NMS_IOU, NMS_SCORE, POLICIES, SEED, XVIEW_REVISITS,
                            XVIEW_SCENES, counters, cuda_ms, nms_args, run_mission,
                            scene_frames)  # puts this checkout's src first
    sys.path.insert(0, str(root / "src"))  # so the tree's own goes before it
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import DATASETS
    from repro_torch.kernels import _build, iou, kmeans_assign, tile_moments
    from repro_torch.models import detector
    assert Path(detector.__file__).is_relative_to(root), detector.__file__

    _build.build_all([tile_moments.KERNEL, kmeans_assign.KERNEL, iou.KERNEL])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    failed = []
    for case, b, n, max_det in NMS_CASES:
        boxes, scores = nms_args(g, dev, case, b, n)

        def nms(boxes=boxes, scores=scores, max_det=max_det):
            return detector.nms_keep(boxes, scores, NMS_IOU, NMS_SCORE, max_det)
        got = nms()
        want = detector.nms_keep(boxes.cpu(), scores.cpu(), NMS_IOU, NMS_SCORE, max_det)
        equal = bool(torch.equal(got.cpu(), want))
        reps = 10 if max_det > 128 else 20
        print(json.dumps(dict(
            root=str(root), case=case, boxes=list(boxes.shape), k=min(max_det, n),
            ms=cuda_ms(nms, reps=reps), host_ms=cuda_ms(nms, reps=reps, hold=False),
            device_ops=device_ops(nms), kept=int(want.sum()), keep_equal_cpu=equal)), flush=True)
        if not equal:
            failed.append(f"nms {case}: keep mask differs from the CPU's")

    cfgs = (get_config("targetfuse-space"), get_config("targetfuse-ground"))
    space, ground = counters(cfgs, dev)
    frames = scene_frames(DATASETS["xview"], XVIEW_SCENES, XVIEW_REVISITS, SEED)
    run_mission(space, ground, frames, "targetfuse", dev)  # warm-up
    for method in POLICIES:
        r, run = run_mission(space, ground, frames, method, dev)
        check_finite = bool(np.isfinite(r.per_tile_pred).all())
        stages = run["stages_s"]
        print(json.dumps(dict(
            root=str(root), policy=method, tiles_per_s=run["tiles_per_s"],
            ingest_s=run["ingest_s"], contact_s=run["contact_s"],
            onboard_count_s=stages.get("onboard_count", 0.0),
            ground_recount_s=stages.get("ground_recount", 0.0),
            counter_chunks={st: len(v) for st, v in run["chunk_ms"].items()},
            chunk_ms_by_stage={st: sum(v) for st, v in run["chunk_ms"].items()},
            nms_ms_by_stage={st: sum(v) for st, v in run["nms_ms"].items()},
            nms_ms_each=run["nms_ms"], total_pred=r.total_pred, finite=check_finite)),
            flush=True)
        if not check_finite:
            failed.append(f"mission {method}: predictions not finite")
    if failed:
        print("FAIL: " + "; ".join(failed), file=sys.stderr)
        sys.exit(1)


def main():
    if sys.argv[1:2] == ["--one"]:
        one(Path(sys.argv[2]).resolve())
        return
    roots = [Path(r).resolve() for r in sys.argv[1:]] or [HERE]
    rcs = [subprocess.run([sys.executable, __file__, "--one", str(root)]).returncode
           for root in roots]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if any(rcs):
        sys.exit(f"FAIL: exit codes {rcs} for {[str(r) for r in roots]}")


if __name__ == "__main__":
    main()
