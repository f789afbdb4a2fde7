#!/usr/bin/env python3
"""Time the fleet's ground-segment recount pipeline at depths 0, 1 and 2.

    python3 scripts/recount_pipeline_bench.py [--reps N] [--intervals S ...]

Needs one CUDA card and ``nvcc``. Builds the port's kernels, then runs
``chip_smoke.py``'s phase 6 cell (benchmarks/fleet_bench.py's
``_contact_spec(32, 8, seed=6)``: targetfuse, 32 satellites, 8
stations, 3 rounds, the full-width counters with seeded weights) through
``run_scenario`` at ``async_depth`` 0, 1 and 2, in turns (the order
reversed every repetition), under each interpreter switch interval
(``sys.setswitchinterval``; Python's default is 0.005 s). The recount
worker and the foreground share the interpreter lock: a thread that
returns from a call which let the lock go (a ``ctypes`` kernel launch, a
device-to-host copy, a stream synchronize) waits up to one switch
interval for the other thread to give it back.

Prints one JSON line a run (the run's wall time, ingest_s, contact_s,
tiles/s, windows/s, recount_s, recount_wait_s, recount_hidden_frac),
then the medians by interval and depth, then ``nvidia-smi``'s name and
power limit. Exits non-zero if a depth's results differ from depth 0's.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
DEPTHS = (0, 1, 2)
KEYS = ("wall_s", "ingest_s", "contact_s", "tiles_per_s", "windows_per_s", "recount_s",
        "recount_wait_s", "recount_hidden_frac")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--intervals", type=float, nargs="+", default=[0.005, 0.001, 0.0002])
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch
    from chip_smoke import (FLEET_SATS, FLEET_SEED, FLEET_STATIONS, NMS_SCORE, SEED,
                            contact_spec, counters)
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.core import fleet as F
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.data.scenarios import generate_scenario
    from repro_torch.kernels import _build, ops

    dev = torch.device("cuda")
    _build.build_all(ops.KERNELS)
    space, ground = counters((get_config("targetfuse-space"),
                              get_config("targetfuse-ground")), dev)
    sc = generate_scenario(contact_spec(FLEET_SATS, FLEET_STATIONS, FLEET_SEED))
    pcfg = PipelineConfig(method="targetfuse", score_thresh=NMS_SCORE, seed=SEED)

    def run(depth):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, fl = F.run_scenario(space, ground, pcfg, sc, async_depth=depth, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s = fl.summary()
        del fl
        return res, dict(wall_s=wall, **{k: s[k] for k in KEYS[1:]})

    want, _ = run(0)  # warm-up; depth 0's results are the reference
    default = sys.getswitchinterval()
    rows = {}
    try:
        for interval in args.intervals:
            sys.setswitchinterval(interval)
            for rep in range(args.reps):
                for depth in (DEPTHS if rep % 2 == 0 else DEPTHS[::-1]):
                    res, row = run(depth)
                    same = all(np.array_equal(a.per_tile_pred, b.per_tile_pred)
                               and a.summary() == b.summary() for a, b in zip(res, want))
                    if not same:
                        sys.exit(f"depth {depth} at interval {interval}: results differ")
                    rows.setdefault((interval, depth), []).append(row)
                    print(json.dumps(dict(interval=interval, depth=depth, rep=rep, **row)),
                          flush=True)
    finally:
        sys.setswitchinterval(default)
    for (interval, depth), rs in rows.items():
        med = {k: statistics.median(r[k] for r in rs) for k in KEYS}
        print(f"interval {interval} depth {depth} median of {len(rs)}: "
              + ", ".join(f"{k} {v:.4f}" for k, v in med.items()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())


if __name__ == "__main__":
    main()
