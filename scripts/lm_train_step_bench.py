#!/usr/bin/env python3
"""Time the LM training step and its AdamW update on the card.

    python3 scripts/lm_train_step_bench.py [--arch phi4-mini-3.8b] [--warmup 3]
        [--steps 8] [--updates 5]

Needs one CUDA card and ``nvcc`` (the flash kernels build on their first
launch). Phase 16's cell of ``--arch`` (``chip_smoke.lm_train_config``:
full width, qwen3-8b's depth cut; bf16 weights from a seeded generator,
one fixed batch of seeded tokens of 4096, labels the tokens rolled by
one, ``chip_smoke.lm_train_setup``): ``lm_train``'s donated step,
``--warmup`` steps, then ``--steps`` steps timed by CUDA events. Then the
gradient of one more batch, and AdamW's update alone, in place, on it
``--updates`` times, each timed by CUDA events, then twice more, the
second under torch.profiler (``chip_smoke.profile_step``: device busy
ms, wall ms and kernel launches). Prints one JSON
line of the times and the card's name and power limit as ``nvidia-smi``
gives them.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def timed(fn) -> float:
    """Device ms of ``fn()`` between two CUDA events."""
    import torch
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--updates", type=int, default=5)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.optim.adamw import adamw
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    cfg, cuts = cs.lm_train_config(args.arch)
    accum = cs.LM_TRAIN_ACCUM[args.arch]
    step, state = cs.lm_train_setup(dev, cfg, accum, cs.SEED)
    for _ in range(args.warmup):
        state, _ = step(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(args.steps):
        def one():
            nonlocal state
            state, _ = step(state)
        step_ms.append(timed(one))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    params, opt_state = state
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
    tokens = torch.randint(0, cfg.vocab_size, (1, cs.LM_TRAIN_SEQ), generator=g, device=dev)
    labels = torch.roll(tokens, -1, dims=1)
    _, grads, _ = steps.value_and_grad(lambda p: lm.loss_fn(p, cfg, tokens, labels), params)
    _, update = adamw(1e-4)

    def upd():
        nonlocal params, opt_state
        params, opt_state, _ = update(grads, opt_state, params, in_place=True)
    update_ms = [timed(upd) for _ in range(args.updates)]
    kernels = cs.profile_step(f"{args.arch} AdamW update", upd)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(json.dumps(dict(
        arch=args.arch, cut=cuts, grad_accum=accum, seq=cs.LM_TRAIN_SEQ,
        step_ms=step_ms, step_ms_mean=sum(step_ms) / len(step_ms), peak_gb=peak_gb,
        update_ms=update_ms, update_ms_min=min(update_ms), update_busy_ms=busy_ms,
        update_launches=sum(e.count for e in kernels), device=smi)), flush=True)
    print(smi)


if __name__ == "__main__":
    main()
