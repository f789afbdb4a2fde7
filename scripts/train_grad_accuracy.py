#!/usr/bin/env python3
"""Per-leaf error of the port's float32 counter gradients against float64.

    python3 scripts/train_grad_accuracy.py                 # GPU, full width
    PYTHONPATH=src python3 scripts/train_grad_accuracy.py --device cpu --reduced --threads 1

The batch is ``chip_smoke.py`` phase 9a's: 2 tiles of one training scene
through ``build_target_pool`` (``--reduced``: the reduced configs, 4
tiles of two mini scenes, as ``tests/test_torch_train.py``), with seeded
weights. For each counter and leaf it prints max|g32 - g64| / max|g64|,
g64 being the float64 gradient on the CPU. On CUDA it also prints the
error with ``cudnn.deterministic`` and with cuDNN off (PyTorch's own
convolutions), and of float64 on the card. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs import get_config, reduced
from repro_torch.core import cascade
from repro_torch.data.synthetic import SceneSpec, make_scene
from repro_torch.launch import serve
from repro_torch.models import detector


def gradients(params, cfg, xb, yb, device, dtype=torch.float32):
    """The loss's gradient by leaf, in ``dtype`` on ``device`` -> float64
    CPU tensors."""
    pg = T.map_leaves(lambda x: x.to(device, dtype).detach().requires_grad_(True), params)
    loss, _ = detector.loss_fn(pg, cfg, xb.to(device, dtype), yb.to(device, dtype))
    return [g.double().cpu() for g in torch.autograd.grad(loss, T.leaves(pg))]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--threads", type=int, default=0)
    args = ap.parse_args()
    if args.threads:
        torch.set_num_threads(args.threads)
    on_card = args.device == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            sys.exit("no CUDA device")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    if args.reduced:
        rng = np.random.default_rng(0)
        spec = SceneSpec("mini", 512, (20, 30), (10, 24), cloud_fraction=0.2)
        scenes, n = [make_scene(rng, spec) for _ in range(2)], 4
    else:
        scenes, n = serve.training_scenes()[:1], 2
    for arch in ("targetfuse-space", "targetfuse-ground"):
        cfg = reduced(get_config(arch)) if args.reduced else get_config(arch)
        xs, ys = cascade.build_target_pool(cfg, scenes, 128, device="cpu")
        idx = np.random.default_rng(0).integers(0, len(xs), n)
        xb, yb = xs[idx], torch.from_numpy(ys[idx])
        params = detector.init(torch.Generator().manual_seed(0), cfg, device="cpu")
        want = gradients(params, cfg, xb, yb, "cpu", torch.float64)
        runs = {"float32": gradients(params, cfg, xb, yb, args.device)}
        if on_card:
            torch.backends.cudnn.deterministic = True
            runs["cudnn.deterministic"] = gradients(params, cfg, xb, yb, "cuda")
            torch.backends.cudnn.deterministic = False
            torch.backends.cudnn.enabled = False
            runs["cudnn off"] = gradients(params, cfg, xb, yb, "cuda")
            torch.backends.cudnn.enabled = True
            runs["float64 on the card"] = gradients(params, cfg, xb, yb, "cuda", torch.float64)
        print(f"{cfg.name} on {args.device}, batch {n}: max|g - g64| / max|g64| by leaf "
              f"({', '.join(runs)})")
        for i, path in enumerate(T.flatten_with_paths(params)[0]):
            top = want[i].abs().max().item()
            errs = " ".join(f"{(g[i] - want[i]).abs().max().item() / top:.2e}" for g in runs.values())
            print(f"  {path:14s} {errs}")


if __name__ == "__main__":
    main()
