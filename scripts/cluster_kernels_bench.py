#!/usr/bin/env python3
"""Time ``tile_moments`` and ``kmeans_assign_f32`` on one or more trees.

    python3 scripts/cluster_kernels_bench.py [ROOT ...]

Needs one CUDA card and ``nvcc``. Each ROOT (default: this checkout) is a
checkout of the repository. For each, in a process of its own, its
``src/repro_torch`` is imported and its ``tile_moments`` and
``kmeans_assign`` libraries are built from its own sources into its own
``build/kernels/``. Every case of ``chip_smoke.py``'s
``TILE_MOMENTS_CASES`` and ``KMEANS_CASES`` is held against the tree's
plain version (``tile_moments`` within 1e-4, with the count of outputs
that differ in any bit; ``kmeans_assign_f32`` bit-equal, assignments and
distances) and timed with CUDA events, the card held busy while the host
queues the calls; beside each uniform ``tile_moments`` case, one
``torch.sum`` of the same tiles, a yardstick of the read rate the card
reaches. Name a tree twice, in turns (parent, change, change,
parent), to see the spread. Prints one JSON line per tree and case, then
``nvidia-smi``'s name and power limit; exits non-zero if a build fails
or a result disagrees.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def one(root: Path):
    sys.path.insert(0, str(HERE))
    import torch
    from chip_smoke import (KMEANS_CASES, TILE_MOMENTS_CASES, bound_ms, cuda_ms, kmeans_args,
                            moment_tiles)  # puts this checkout's src first
    sys.path.insert(0, str(root / "src"))  # so the tree's own goes before it
    from repro_torch.kernels import _build, kmeans_assign, ref, tile_moments
    assert Path(tile_moments.__file__).is_relative_to(root), tile_moments.__file__

    logs = _build.build_all([tile_moments.KERNEL, kmeans_assign.KERNEL])
    for name, log in logs.items():
        entry = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "spill stores" in line or ": Used " in line:
                print(f"ptxas {root.name or root} {name} {entry[:70]}: {line.strip()}", flush=True)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    failed = []
    for shape, data in TILE_MOMENTS_CASES:
        t = moment_tiles(g, dev, shape, data)
        got, want = tile_moments.tile_moments(t), ref.tile_moments(t)
        err = (got - want).abs().max().item()
        differ = int((got != want).sum().item())
        ok = bool(torch.allclose(got, want, atol=1e-4, rtol=1e-4))
        ms = cuda_ms(lambda: tile_moments.tile_moments(t), reps=20)
        b_ms, b_by = bound_ms(t.numel() * 4 + got.numel() * 4, 7 * t.numel())
        # a yardstick of the read rate the card reaches: one float32 sum of the tiles
        sum_ms = cuda_ms(lambda: t.sum(), reps=20) if data == "uniform" else None
        print(json.dumps(dict(root=str(root), kernel="tile_moments_f32", shape=list(shape),
                              data=data, ms=ms, torch_sum_ms=sum_ms, bound_ms=b_ms, bound_by=b_by,
                              share=b_ms / ms, max_abs_err=err, outputs_not_bit_equal=differ,
                              outputs=got.numel(), ok=ok)), flush=True)
        if not ok:
            failed.append(f"tile_moments {shape} {data}: off by {err}")
        del t, got, want
    for n, k, d in KMEANS_CASES:
        x, c = kmeans_args(g, dev, n, k, d)
        (a, dist), (wa, wd) = kmeans_assign.kmeans_assign(x, c), ref.kmeans_assign(x, c)
        ok = bool(torch.equal(a, wa) and torch.equal(dist, wd))
        ms = cuda_ms(lambda: kmeans_assign.kmeans_assign(x, c), reps=50)
        host_ms = cuda_ms(lambda: kmeans_assign.kmeans_assign(x, c), reps=50, hold=False)
        b_ms, b_by = bound_ms((n + k) * d * 4 + n * 8, 2 * n * k * d + 3 * n * k)
        print(json.dumps(dict(root=str(root), kernel="kmeans_assign_f32", shape=[n, k, d],
                              ms=ms, host_ms=host_ms, bound_ms=b_ms, bound_by=b_by,
                              share=b_ms / ms, bit_equal=ok,
                              assignments_differ=int((a != wa).sum().item()))), flush=True)
        if not ok:
            failed.append(f"kmeans_assign {(n, k, d)}: not bit-equal")
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
