"""Quickstart of the PyTorch port: the TargetFuse pipeline on one synthetic
EO scene via the Mission API (the counterpart of examples/quickstart.py).

  PYTHONPATH=src python examples/quickstart_torch.py
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu

A Mission executes the paper's Fig. 3 workflow as an explicit stage
graph — ingest(frames) runs Capture -> RoiFilter -> Dedup ->
OnboardCount under the energy budget; contact_window() runs Select ->
Downlink -> GroundRecount -> Aggregate under the byte budget — with the
five baselines available as registered selection policies. Runs on the
GPU unless ``--device cpu`` is given; imports nothing of the JAX package.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.core.mission import Mission
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.core.policies import available_policies
from repro_torch.data.synthetic import SceneSpec, make_scene, revisit_frames
from repro_torch.launch.serve import get_counters


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    print("== TargetFuse quickstart (Mission API) ==")
    spec = SceneSpec("demo", 512, (24, 32), (10, 24), cloud_fraction=0.2)
    rng = np.random.default_rng(42)
    img, boxes, classes = make_scene(rng, spec)
    frames = revisit_frames(rng, img, boxes, classes, 2)
    print(f"scene: {img.shape}, {len(boxes)} objects, "
          f"{(spec.scene_px // 128) ** 2} tiles x {len(frames)} revisits")
    print(f"registered selection policies: {', '.join(available_policies())}")

    space, ground = get_counters(device=args.device)

    # full system, streamed: onboard stages at ingest, ground stages at
    # the contact window
    mission = Mission(space, ground,
                      PipelineConfig(method="targetfuse", score_thresh=0.25),
                      device=args.device)
    ing = mission.ingest(frames)
    print(f"ingest: {ing.n_tiles} tiles, {ing.tiles_processed_space} counted "
          f"onboard within {ing.energy_granted_j:.1f} J")
    win = mission.contact_window()
    print(f"contact window: {win.tiles_downlinked} tiles downlinked "
          f"({win.bytes_spent / 1e6:.2f} MB of {win.budget_bytes / 1e6:.2f} MB)")
    r = mission.result()
    print(f"counts: true={r.total_true:.0f} pred={r.total_pred:.0f} "
          f"CMAE={r.cmae:.3f}")

    # same frames through the space-only policy for comparison
    so = Mission(space, ground,
                 PipelineConfig(method="space_only", score_thresh=0.25),
                 device=args.device).run(frames)
    print(f"vs space-only CMAE={so.cmae:.3f} "
          f"({so.cmae / max(r.cmae, 1e-9):.1f}x better)")


if __name__ == "__main__":
    main()
