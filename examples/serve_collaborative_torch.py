"""End-to-end collaborative serving with the PyTorch port (the counterpart
of examples/serve_collaborative.py): batched tile requests stream through
the satellite-ground cascade over several simulated orbital passes, with
energy/bandwidth ledgers and a straggler deadline.

The ground segment speaks the ContactPlan API: one persistent plan
stream — ``ContactPlan.rotating`` carrying its pointer across passes —
feeds ``Fleet.contact_round(plan=...)``, so every window goes through
the batched lane-stacked planner. ``--overlap`` defers each pass's
ground recount to a worker thread that hides behind the next pass's
ingest; ``--depth K`` keeps up to K passes' recounts in flight as a
bounded pipeline (the same results either way; the final
``finalize()`` syncs).

  PYTHONPATH=src python examples/serve_collaborative_torch.py [--passes 3]
  PYTHONPATH=src python examples/serve_collaborative_torch.py --device cpu

Runs on the GPU unless ``--device cpu`` is given; imports nothing of the
JAX package.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.core.contact import ContactPlan
from repro_torch.core.fleet import Fleet
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.data.synthetic import SceneSpec, make_scene, revisit_frames
from repro_torch.launch.serve import get_counters
from repro_torch.runtime.supervisor import DeadlineBatcher


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--bandwidth", type=float, default=50.0)
    ap.add_argument("--deadline-s", type=float, default=120.0)
    ap.add_argument("--overlap", action="store_true",
                    help="overlap each pass's ground recount with the "
                         "next pass's ingest (async ground segment; "
                         "shorthand for --depth 1)")
    ap.add_argument("--depth", type=int, default=None, metavar="K",
                    help="bounded recount pipeline depth: up to K passes' "
                         "recounts in flight (0 = synchronous)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    overlapped = bool(args.overlap or args.depth)

    space, ground = get_counters(device=args.device)
    rng = np.random.default_rng(7)
    spec = SceneSpec("orbit", 512, (20, 30), (10, 24), cloud_fraction=0.25)

    batcher = DeadlineBatcher(deadline_s=args.deadline_s)
    # ONE persistent single-satellite Fleet: energy/byte ledgers carry
    # across passes and every contact goes through the batched planner
    fleet = Fleet(space, ground,
                  PipelineConfig(method="targetfuse", score_thresh=0.25,
                                 bandwidth_mbps=args.bandwidth),
                  n_sats=1, async_ground=args.overlap,
                  async_depth=args.depth, device=args.device)
    station = {"ptr": 0}  # the persistent plan stream's rotation pointer

    def one_pass(i):
        img, b, c = make_scene(rng, spec)
        frames = revisit_frames(rng, img, b, c, 2)
        [ing] = fleet.ingest([frames])
        # next plan in the stream: one entitlement window, pointer carried
        plan, station["ptr"] = ContactPlan.rotating(
            fleet.n_sats, stations=1, start=station["ptr"])
        [(_, win)] = fleet.contact_round(plan=plan)
        print(f"  pass {i}: {ing.n_tiles} tiles, "
              f"{ing.tiles_processed_space} counted onboard, "
              f"{win.tiles_downlinked} downlinked "
              f"({win.bytes_spent / 1e6:.2f} MB)")
        return win

    print(f"== collaborative serving: {args.passes} orbital passes "
          f"({'overlapped' if overlapped else 'synchronous'} ground "
          f"recount) ==")
    _, dropped = batcher.run(range(args.passes), one_pass)
    if dropped:
        print(f"  straggler mitigation: {len(dropped)} passes re-queued "
              f"(missed the {args.deadline_s}s contact deadline)")
    [r] = fleet.finalize()
    s = fleet.summary()
    print(f"aggregate: CMAE={r.cmae:.3f} pred={r.total_pred:.0f} "
          f"true={r.total_true:.0f} "
          f"rel err={abs(r.total_pred - r.total_true) / max(r.total_true, 1):.3f} "
          f"energy={r.energy_spent_j:.1f}/{r.energy_budget_j:.1f}J "
          f"bytes={r.bytes_downlinked / 1e6:.2f}MB "
          f"of {r.bytes_budget / 1e6:.2f}MB")
    print(f"ground segment: {s['windows_served']} windows, "
          f"{s['windows_per_s']:.1f} windows/s"
          + (f", depth-{s['async_depth']} recount pipeline, "
             f"{s['recount_hidden_frac']:.0%} hidden"
             if overlapped else ""))


if __name__ == "__main__":
    main()
