"""Serving entry point of the port: a one-window Mission for every registered
selection policy, and the CMAE table (counterpart of
``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --frames 3 --revisits 3

Trains the reduced counters with :func:`repro_torch.core.cascade.fit_counter`
on the first run (``--retrain`` trains again) and caches them in
``artifacts/counters_torch/{space,ground}``. The checkpoint format is the
reference's, so ``--counters artifacts/counters`` serves the counters
that ``python -m repro.launch.serve`` trained.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config, reduced
from repro_torch.core.cascade import fit_counter
from repro_torch.core.mission import Mission
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.core.policies import available_policies
from repro_torch.data.synthetic import DATASETS, SceneSpec, make_scene, revisit_frames
from repro_torch.device import resolve_device
from repro_torch.models import detector

CACHE = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                     "artifacts", "counters_torch")


def training_scenes(scene=None, seed=0):
    """The counters' training set: 8 scenes of ``scene`` or, by default,
    2 of each of four profiles (mini and the three dataset analogues),
    so confidence calibration transfers across benchmarks."""
    rng = np.random.default_rng(seed)
    if scene is not None:
        profiles = [scene]
    else:
        profiles = [
            SceneSpec("mini", 512, (20, 30), (10, 24), cloud_fraction=0.2),
            SceneSpec("xview", 768, (30, 60), (8, 20), cloud_fraction=0.3),
            SceneSpec("dota", 768, (22, 45), (10, 32), cloud_fraction=0.3),
            SceneSpec("uavod", 512, (8, 24), (12, 40), cloud_fraction=0.2),
        ]
    scenes = []
    for p in profiles:
        scenes += [make_scene(rng, p) for _ in range(max(2, 8 // len(profiles)))]
    return scenes


def get_counters(train_steps=(800, 2000), scene=None, force=False,
                 cache_dir=CACHE, seed=0, device="cuda"):
    """(space (params, cfg), ground (params, cfg)) — cached on disk.

    Trained on :func:`training_scenes`; read from
    ``cache_dir/{space,ground}`` unless ``force``.
    """
    device = resolve_device(device)
    sp_cfg = reduced(get_config("targetfuse-space"))
    gd_cfg = reduced(get_config("targetfuse-ground"))
    pair, scenes = [], None
    for name, cfg, steps, k in (("space", sp_cfg, train_steps[0], 0),
                                ("ground", gd_cfg, train_steps[1], 1)):
        d = os.path.join(cache_dir, name)
        if not force:
            template = detector.init(torch.Generator().manual_seed(k), cfg, device)
            try:
                _, params = ckpt.restore(d, template)
                pair.append((params, cfg))
                continue
            except (FileNotFoundError, ValueError):
                pass
        scenes = scenes or training_scenes(scene, seed)
        params, _ = fit_counter(cfg, scenes, 128, steps, torch.Generator().manual_seed(k),
                                device=device)
        ckpt.save(d, steps, params)
        pair.append((params, cfg))
    return pair[0], pair[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--revisits", type=int, default=3)
    ap.add_argument("--dataset", default="mini")
    ap.add_argument("--bandwidth", type=float, default=50.0)
    ap.add_argument("--counters", default=CACHE,
                    help="folder holding the space/ and ground/ checkpoints")
    ap.add_argument("--retrain", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    spec = (DATASETS[args.dataset] if args.dataset in DATASETS
            else SceneSpec("mini", 512, (20, 30), (10, 24), cloud_fraction=0.2))
    space, ground = get_counters(force=args.retrain, cache_dir=args.counters,
                                 device=args.device)

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
