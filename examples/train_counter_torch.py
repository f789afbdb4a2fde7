"""Train the onboard + ground counters with the PyTorch port on synthetic
EO scenes, then compare them on held-out scenes (the counterpart of
examples/train_counter.py).

  PYTHONPATH=src python examples/train_counter_torch.py --steps 300
  PYTHONPATH=src python examples/train_counter_torch.py --device cpu --steps 100

Runs on the GPU unless ``--device cpu`` is given; imports nothing of the
JAX package.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import tiling
from repro_torch.core.cascade import count_tiles_batched, fit_counter
from repro_torch.core.metrics import cmae
from repro_torch.data.synthetic import SceneSpec, make_scene, tile_counts


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ground-steps", type=int, default=800)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    spec = SceneSpec("train", 512, (20, 30), (10, 24), cloud_fraction=0.2)
    rng = np.random.default_rng(0)
    scenes = [make_scene(rng, spec) for _ in range(8)]

    sp_cfg = reduced(get_config("targetfuse-space"))
    gd_cfg = reduced(get_config("targetfuse-ground"))
    print(f"space tier:  {sp_cfg.widths} x{sp_cfg.n_blocks_per_stage}")
    print(f"ground tier: {gd_cfg.widths} x{gd_cfg.n_blocks_per_stage}")

    print(f"training space counter ({args.steps} steps) on {args.device}...")
    sp_params, sp_loss = fit_counter(sp_cfg, scenes, 128, args.steps,
                                     torch.Generator().manual_seed(0), log_every=100,
                                     device=args.device)
    print(f"training ground counter ({args.ground_steps} steps) on {args.device}...")
    gd_params, gd_loss = fit_counter(gd_cfg, scenes, 128, args.ground_steps,
                                     torch.Generator().manual_seed(1), log_every=200,
                                     device=args.device)

    # held-out evaluation
    errs_s, errs_g = [], []
    for _ in range(3):
        img, b, c = make_scene(rng, spec)
        true = tile_counts(b, spec.scene_px, 128)
        t = tiling.tile_image(torch.from_numpy(img).to(args.device), 128)
        cs, _ = count_tiles_batched(sp_params, sp_cfg, tiling.resize_tiles(t, sp_cfg.input_size),
                                    score_thresh=0.25)
        cg, _ = count_tiles_batched(gd_params, gd_cfg, tiling.resize_tiles(t, gd_cfg.input_size),
                                    score_thresh=0.25)
        errs_s.append(cmae(cs, true))
        errs_g.append(cmae(cg, true))
    print(f"final losses: space {sp_loss:.3f} / ground {gd_loss:.3f}")
    print(f"held-out CMAE: space {np.mean(errs_s):.3f} / ground {np.mean(errs_g):.3f} "
          f"(accuracy asymmetry x{np.mean(errs_s) / max(np.mean(errs_g), 1e-9):.1f})")


if __name__ == "__main__":
    main()
