"""Serving entry point of the port: a one-window Mission for every registered
selection policy, and the CMAE table (counterpart of
``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --frames 3 --revisits 3

The counters are the reduced ones the reference's ``serve`` trains and
caches in ``artifacts/counters/{space,ground}``; the port reads that
checkpoint with numpy (training is not ported yet).
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.core.mission import Mission
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.core.policies import available_policies
from repro_torch.data.synthetic import DATASETS, SceneSpec, make_scene, revisit_frames
from repro_torch.models.detector import load_jax_checkpoint

CACHE = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                     "artifacts", "counters")


def get_counters(cache_dir=CACHE):
    """(space (params, cfg), ground (params, cfg)) from the reference's
    cached checkpoints; raises if they are missing."""
    pair = []
    for name, arch in (("space", "targetfuse-space"),
                       ("ground", "targetfuse-ground")):
        d = os.path.join(cache_dir, name)
        try:
            params = load_jax_checkpoint(d)
        except FileNotFoundError:
            raise FileNotFoundError(
                f"no counter checkpoint in {os.path.abspath(d)}: run "
                f"`PYTHONPATH=src python -m repro.launch.serve` once to "
                f"train and cache the counters") from None
        pair.append((params, reduced(get_config(arch))))
    return pair[0], pair[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--revisits", type=int, default=3)
    ap.add_argument("--dataset", default="mini")
    ap.add_argument("--bandwidth", type=float, default=50.0)
    ap.add_argument("--counters", default=CACHE,
                    help="folder holding the space/ and ground/ checkpoints")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    spec = (DATASETS[args.dataset] if args.dataset in DATASETS
            else SceneSpec("mini", 512, (20, 30), (10, 24), cloud_fraction=0.2))
    space, ground = get_counters(args.counters)

    rng = np.random.default_rng(1)
    frames = []
    for _ in range(args.frames):
        img, b, c = make_scene(rng, spec)
        frames += revisit_frames(rng, img, b, c, args.revisits)
    print(f"{len(frames)} frames, {(spec.scene_px // 128) ** 2} tiles each")

    print(f"{'method':14s} {'CMAE':>7s} {'pred':>6s} {'true':>6s} "
          f"{'down':>5s} {'proc':>5s} {'MB':>7s}")
    for method in available_policies():
        pcfg = PipelineConfig(method=method, bandwidth_mbps=args.bandwidth,
                              score_thresh=0.25)
        s = Mission(space, ground, pcfg, device=args.device).run(frames).summary()
        print(f"{method:14s} {s['cmae']:7.3f} {s['total_pred']:6.0f} "
              f"{s['total_true']:6.0f} {s['tiles_downlinked']:5d} "
              f"{s['tiles_processed_space']:5d} "
              f"{s['bytes_downlinked'] / 1e6:7.2f}")


if __name__ == "__main__":
    main()
