"""Learning-rate schedules, PyTorch.

Counterpart of ``repro/optim/schedule.py``. A schedule maps the step (an
int or an integer tensor) to a 0-d float32 tensor on the CPU, computed
with the reference's float32 arithmetic op by op; its cosine is glibc's
``cosf``, which the reference's XLA CPU program calls. The optimizer
keeps its step on the CPU, so reading the rate never waits for the card.
"""
from __future__ import annotations

import math

import torch

from repro_torch.orbits.propagation import cosf


def cosine_with_warmup(peak_lr: float, warmup_steps: int, total_steps: int,
                       floor: float = 0.0):
    def fn(step):
        s = torch.as_tensor(step).to(device="cpu", dtype=torch.float32)
        warm = peak_lr * s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + (peak_lr - floor) * 0.5 * (1.0 + cosf(math.pi * prog))
        return torch.where(s < warmup_steps, warm, cos)
    return fn


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)
