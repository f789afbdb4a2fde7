#!/usr/bin/env python3
"""The fleet's device memory round by round, and its throughput, on one
or more trees.

    python3 scripts/fleet_memory_bench.py [ROOT ...]

Needs one CUDA card and ``nvcc``. Each ROOT (default: this checkout) is a
checkout of the repository. For each, in a process of its own, its
``src/repro_torch`` is imported and the Mission's kernels are built from
its own sources. Then, with the cells of this checkout's
``chip_smoke.py`` phase 11c (so every tree gets the same inputs), on an
emptied allocator cache:

1. tests/test_analysis.py's JitGuard cell on phase 3's counters: a
   2-satellite Fleet ingesting one frame of the 256 px "jg" scene a
   satellite a round, 4 rounds;
2. phase 6's cell (32 satellites, 8 stations, 3 rounds): a Fleet driven
   round by round, ingest then the round's ContactPlan.

For every round it prints one JSON line: the caching allocator's new
segments (``segment.all.allocated``, split by pool), the change of live
memory, reserved memory, the round's synchronized wall time, and the
largest new segments. After each cell, a digest of the per-tile
predictions (equal across trees when results are unchanged) and the
cell's peak memory. Then phase 6's cell through ``run_scenario`` as
phase 6 and phase 8 drive it, at ground-segment depth 0 and 1: one
warm-up run and ``RUNS`` timed runs, one JSON line each (tiles/s,
ingest and contact seconds, windows/s, peak memory, the digest); on a
tree whose recount remakes tiles (``engine.ground_tiles``), one more
depth-0 run with each remake synchronized and timed (its calls and
seconds, beside that run's contact seconds). Name
a tree twice, in turns (parent, change, change, parent), to see the
spread. Ends with ``nvidia-smi``'s name and power
limit; exits non-zero if a build fails.
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
RUNS = 3  # timed run_scenario runs a depth


def rounds(root: Path, cell: str, round_fns, finalize):
    """Run ``round_fns`` one by one, printing each round's memory line;
    -> the digest of ``finalize()``'s per-tile predictions."""
    import numpy as np
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for r, fn in enumerate(round_fns, start=1):
        before = {s["address"] for s in torch.cuda.memory_snapshot()}
        st0 = torch.cuda.memory_stats()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st1 = torch.cuda.memory_stats()
        new = sorted((s["total_size"] for s in torch.cuda.memory_snapshot()
                      if s["address"] not in before), reverse=True)

        def delta(key):
            return st1[key] - st0[key]
        print(json.dumps(dict(
            root=str(root), cell=cell, round=r, wall_s=wall,
            new_segments=delta("segment.all.allocated"),
            new_large=delta("segment.large_pool.allocated"),
            new_small=delta("segment.small_pool.allocated"),
            live_mb=delta("allocated_bytes.all.current") / 1e6,
            reserved_gb=st1["reserved_bytes.all.current"] / 1e9,
            largest_new_mb=[round(b / 1e6, 1) for b in new[:6]])), flush=True)
    print(json.dumps(dict(root=str(root), cell=cell, **digest(finalize()),
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9)), flush=True)


def digest(results) -> dict:
    import numpy as np
    preds = np.concatenate([r.per_tile_pred for r in results])
    return dict(tiles=int(preds.size),
                preds_sha256=hashlib.sha256(preds.tobytes()).hexdigest()[:16])


def one(root: Path):
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch
    from chip_smoke import (FLEET_SATS, FLEET_SEED, FLEET_STATIONS, GUARD_JG_SPEC, NMS_SCORE,
                            SEED, contact_spec, counters)  # puts this checkout's src first
    sys.path.insert(0, str(root / "src"))  # so the tree's own goes before it
    from repro_torch.configs import get_config
    from repro_torch.core import engine, fleet as F
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.data.scenarios import generate_scenario
    from repro_torch.data.synthetic import SceneSpec, make_scene, revisit_frames
    from repro_torch.kernels import _build, iou, kmeans_assign, tile_moments
    assert Path(F.__file__).is_relative_to(root), F.__file__

    _build.build_all([tile_moments.KERNEL, kmeans_assign.KERNEL, iou.KERNEL])
    dev = torch.device("cuda")
    space, ground = counters((get_config("targetfuse-space"), get_config("targetfuse-ground")),
                             dev)
    name, px, n_obj, size, cloud = GUARD_JG_SPEC
    rng = np.random.default_rng(17)
    img, b, c = make_scene(rng, SceneSpec(name, px, n_obj, size, cloud_fraction=cloud))
    fl = F.Fleet(space, ground, PipelineConfig(method="targetfuse", score_thresh=0.25),
                 n_sats=2, device=dev)

    def jg_round():
        fl.ingest([revisit_frames(rng, img, b, c, 1) for _ in range(2)])
    rounds(root, "jg", [jg_round] * 4, fl.finalize)
    del fl

    sc = generate_scenario(contact_spec(FLEET_SATS, FLEET_STATIONS, FLEET_SEED))
    n = FLEET_SATS
    fl = F.Fleet(space, ground, PipelineConfig(method="targetfuse", score_thresh=NMS_SCORE,
                                               seed=SEED), n_sats=n, device=dev)

    def round_fn(rnd):
        def go():
            fl.ingest(rnd.frames_per_sat(n), rnd.harvest_per_sat(n))
            if rnd.contacts:
                fl.contact_round(plan=rnd.contact_plan(n))
        return go
    rounds(root, "phase 6", [round_fn(rnd) for rnd in sc.rounds], fl.finalize)
    del fl

    pcfg = PipelineConfig(method="targetfuse", score_thresh=NMS_SCORE, seed=SEED)
    for depth in (0, 1):
        kw = dict(async_depth=depth) if depth else {}
        for run in range(RUNS + 1):  # the first is a warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            got, fl = F.run_scenario(space, ground, pcfg, sc, device=dev, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            summ = fl.summary()
            del fl
            if run:
                print(json.dumps(dict(
                    root=str(root), cell="phase 6 run_scenario", depth=depth, run=run,
                    wall_s=wall, tiles_per_s=summ["tiles_per_s"], ingest_s=summ["ingest_s"],
                    contact_s=summ["contact_s"], windows_served=summ["windows_served"],
                    windows_per_s=summ["windows_per_s"],
                    peak_gb=torch.cuda.max_memory_allocated() / 1e9, **digest(got))),
                    flush=True)
    if hasattr(engine, "ground_tiles"):
        remake, calls = engine.ground_tiles, []

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = remake(*a, **kw)
            torch.cuda.synchronize()
            calls.append(time.perf_counter() - t0)
            return out
        engine.ground_tiles = timed
        try:
            got, fl = F.run_scenario(space, ground, pcfg, sc, device=dev)
        finally:
            engine.ground_tiles = remake
        print(json.dumps(dict(root=str(root), cell="phase 6 remake timed", depth=0,
                              remakes=len(calls), remake_s=sum(calls),
                              contact_s=fl.summary()["contact_s"], **digest(got))), flush=True)
        del fl


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
