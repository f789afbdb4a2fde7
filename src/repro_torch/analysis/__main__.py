"""CLI: ``python -m repro_torch.analysis [paths...] [options]``.

Exit codes: 0 - no findings beyond the baseline; 1 - new findings (or
malformed waivers). Default target is ``src/repro_torch``; the default
baseline is ``analysis_baseline_torch.json`` at the repo root (missing
file = empty baseline).

    python -m repro_torch.analysis                     # gate the tree
    python -m repro_torch.analysis src/repro_torch/core  # subset
    python -m repro_torch.analysis --update-baseline   # accept current findings
    python -m repro_torch.analysis --verbose           # show waived/baselined
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

from repro_torch.analysis import engine


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's static analysis: thread-ownership, "
                    "host-sync, and determinism rules")
    ap.add_argument("paths", nargs="*", type=Path,
                    help="files/dirs to analyze (default: src/repro_torch)")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="suppression baseline JSON (default: "
                         "analysis_baseline_torch.json at the repo root)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="write current findings to the baseline and "
                         "exit 0 (ratchet: run after fixing/waiving)")
    ap.add_argument("--verbose", action="store_true",
                    help="also list waived and baselined findings")
    args = ap.parse_args(argv)

    paths = args.paths or [engine.DEFAULT_TARGET]
    baseline_path = args.baseline or engine.DEFAULT_BASELINE

    findings, waived = engine.analyze(paths)
    baseline = engine.load_baseline(baseline_path)
    new, old, stale = engine.apply_baseline(findings, baseline)

    if args.update_baseline:
        engine.write_baseline(findings, baseline_path)
        print(f"analysis: baseline updated ({len(findings)} finding(s) "
              f"recorded) -> {baseline_path}")
        return 0

    for f in new:
        print(f.format())
    if args.verbose:
        for f in old:
            print(f"{f.format()}  [baselined]")
        for f in waived:
            print(f"{f.format()}  [waived]")
    if stale:
        print(f"analysis: {len(stale)} baseline entr"
              f"{'y is' if len(stale) == 1 else 'ies are'} stale "
              f"(fixed findings) — ratchet down with --update-baseline:")
        for k in stale:
            print(f"  - {k}")
    print(f"analysis: {len(new)} new, {len(old)} baselined, "
          f"{len(waived)} waived finding(s) over "
          f"{', '.join(str(p) for p in paths)}")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
