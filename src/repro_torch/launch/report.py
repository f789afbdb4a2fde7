"""Dry-run and roofline tables from the records ``launch.dryrun`` writes.

  PYTHONPATH=src python -m repro_torch.launch.report [--mesh tiny] [--kind dryrun]

Counterpart of ``repro/launch/report.py``; reads
``artifacts/dryrun_torch/<mesh>/*.json`` (or ``--dir``). The counts are
the dry run's on the CPU; the seconds are the H100 data sheet's rates
(:mod:`repro_torch.launch.roofline`), not measurements.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "artifacts", "dryrun_torch")


def load(mesh: str, art_dir: str = ART_DIR):
    """The latest record of each (arch, shape) on ``mesh``, sorted."""
    best = {}
    for f in sorted(glob.glob(os.path.join(art_dir, mesh, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        best[(r["arch"], r["shape"])] = r
    return [best[k] for k in sorted(best)]


def fmt_bytes(b):
    if b >= 1e12:
        return f"{b / 1e12:.2f}T"
    if b >= 1e9:
        return f"{b / 1e9:.2f}G"
    if b >= 1e6:
        return f"{b / 1e6:.1f}M"
    return f"{b / 1e3:.0f}K"


def roofline_table(mesh: str = "single", art_dir: str = ART_DIR) -> str:
    """MODEL_FLOPS, the useful ratio and the roofline fraction are
    recomputed from ``launch.steps.model_flops``, so a formula's fix
    shows without a new dry run."""
    from repro_torch.launch.roofline import Roofline
    from repro_torch.launch.steps import model_flops
    rows = [
        "| arch | shape | FLOPs/dev | HBM B/dev | coll B/dev | compute s | "
        "memory s | coll s | bound | MODEL_FLOPS | useful | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in load(mesh, art_dir):
        rl = r["roofline"]
        mf = model_flops(r["arch"], r["shape"])
        ma = r["memory_analysis"]
        rr = Roofline(flops=rl["flops_per_dev"], bytes_hbm=rl["hbm_bytes_per_dev"],
                      bytes_coll=rl["coll_bytes_per_dev"], n_chips=r["n_chips"],
                      model_flops_total=mf,
                      min_bytes=float(ma["argument_bytes"] + ma["output_bytes"]))
        rows.append(
            f"| {r['arch']} | {r['shape']} | {rr.flops:.2e} | "
            f"{fmt_bytes(rr.bytes_hbm)} | {fmt_bytes(rr.bytes_coll)} | "
            f"{rr.compute_s:.3f} | {rr.memory_s:.3f} | "
            f"{rr.collective_s:.3f} | **{rr.dominant}** | "
            f"{mf:.2e} | {rr.useful_ratio:.2f} | {rr.roofline_fraction:.3f} |")
    return "\n".join(rows)


def dryrun_table(mesh: str, art_dir: str = ART_DIR) -> str:
    rows = [
        "| arch | shape | trace s | arg B/dev | peak B/dev | ag | ar | rs | a2a | cp |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in load(mesh, art_dir):
        m = r["memory_analysis"]
        c = r["collective_counts"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['trace_s']:.0f} | "
            f"{fmt_bytes(m['argument_bytes'])} | {fmt_bytes(m['peak_bytes'])} | "
            f"{c['all-gather']} | {c['all-reduce']} | {c['reduce-scatter']} | "
            f"{c['all-to-all']} | {c['collective-permute']} |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--kind", default="roofline", choices=["roofline", "dryrun"])
    ap.add_argument("--dir", default=ART_DIR)
    args = ap.parse_args(argv)
    if args.kind == "roofline":
        print(roofline_table(args.mesh, args.dir))
    else:
        print(dryrun_table(args.mesh, args.dir))


if __name__ == "__main__":
    main()
