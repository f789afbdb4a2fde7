"""Fault-tolerant training supervisor, PyTorch.

Counterpart of ``repro/runtime/supervisor.py``:

- a checkpoint every N steps, saved atomically
  (:mod:`repro_torch.checkpoint.ckpt`, optionally on a background
  thread), and on (re)start a resume from the latest committed step, so
  a failed node is restarted and picks up where the last commit left off;
- bad-step rejection: a non-finite loss discards that step's update;
- simulated failure injection for tests (``fail_at_step``);
- straggler mitigation for serving: :class:`DeadlineBatcher` drops work
  that misses the contact window's deadline.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import ckpt

CKPT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                        "artifacts", "supervisor_torch")


class SimulatedFailure(RuntimeError):
    pass


@dataclass
class SupervisorConfig:
    ckpt_dir: str = CKPT_DIR
    ckpt_every: int = 50
    keep: int = 3
    async_save: bool = True
    max_steps: int = 1000
    fail_at_step: Optional[int] = None  # test hook


@dataclass
class TrainReport:
    steps_run: int
    resumed_from: Optional[int]
    losses: list = field(default_factory=list)
    rejected_steps: int = 0


def run_training(state, step_fn: Callable, data_fn: Callable,
                 cfg: SupervisorConfig) -> tuple:
    """Drive ``step_fn(state, batch) -> (state, loss)`` with checkpoints.

    ``state`` is a tree of tensors (params, optimizer state, ...). On
    entry, resumes from the latest committed checkpoint in
    ``cfg.ckpt_dir`` if there is one. Each step's loss is read on the
    host (``float(loss)``, one synchronization a step) -> (final state,
    :class:`TrainReport`).
    """
    start = 0
    resumed = None
    try:
        start, state = ckpt.restore(cfg.ckpt_dir, state)
        resumed = start
    except (FileNotFoundError, ValueError):
        pass

    report = TrainReport(steps_run=0, resumed_from=resumed)
    pending = None
    for step in range(start, cfg.max_steps):
        if cfg.fail_at_step is not None and step == cfg.fail_at_step:
            raise SimulatedFailure(f"injected failure at step {step}")
        batch = data_fn(step)
        new_state, loss = step_fn(state, batch)
        loss_v = float(loss)
        if not np.isfinite(loss_v):
            report.rejected_steps += 1  # drop the update, keep old state
        else:
            state = new_state
            report.losses.append(loss_v)
        report.steps_run += 1
        if (step + 1) % cfg.ckpt_every == 0 or step + 1 == cfg.max_steps:
            if pending is not None:
                pending.join()
            pending = ckpt.save(cfg.ckpt_dir, step + 1, state, keep=cfg.keep,
                                async_=cfg.async_save)
    if pending is not None:
        pending.join()
    return state, report


@dataclass
class DeadlineBatcher:
    """Runs work items within a hard deadline; items reached after it
    are dropped and handed back for the next window (a satellite cannot
    extend a contact window for a straggler)."""

    deadline_s: float
    clock: Callable[[], float] = time.monotonic

    def run(self, work_items, fn):
        """fn(item) -> result. Returns (results, dropped_items)."""
        t0 = self.clock()
        results, dropped = [], []
        for item in work_items:
            if self.clock() - t0 > self.deadline_s:
                dropped.append(item)
                continue
            results.append(fn(item))
        return results, dropped


def reshard_state(state, new_mesh, spec_fn):
    """Re-lay-out ``state`` for another device mesh (elastic scaling up
    or down). ``spec_fn(host_state)`` -> a tree of specs
    (:class:`repro_torch.sharding.P`) for the new mesh. Every leaf is
    pulled to the host whole (a DTensor gathered), then placed on
    ``new_mesh`` by its spec; right for any pair of old and new device
    counts. Every rank of the new mesh's group must call it; each takes
    its shards from its own copy, which is the same on every rank."""
    from repro_torch import tree as T
    from repro_torch.sharding.place import distribute, full
    if not hasattr(new_mesh, "device_type"):
        raise ValueError(f"reshard_state: new_mesh must be a DeviceMesh, not {new_mesh!r}")
    host = T.map_leaves(lambda x: x.cpu() if isinstance(x, torch.Tensor) else x, full(state))
    dev = torch.device(new_mesh.device_type)
    host = T.map_leaves(lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x, host)
    return distribute(host, spec_fn(host), new_mesh, src_data_rank=None)
