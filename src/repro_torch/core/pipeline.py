"""Pipeline config/result types and the ``run_pipeline`` wrapper over a
one-window :class:`~repro_torch.core.mission.Mission`.

Counterpart of ``repro/core/pipeline.py``. Budget model: the simulated
tile set stands for a ``day_fraction`` = n_tiles / ``tiles_per_day``
slice of one operational day; the energy budget and the downlink byte
budget are prorated by that fraction, and priced at full counter scale
(416-px tiles, the full-width Table II counters) whatever size the
executing counters are.
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.energy import RPI4, DeviceProfile


@dataclass
class PipelineConfig:
    method: str = "targetfuse"           # a registered SelectionPolicy name
    tile_size: int = 128
    conf_p: float = 0.10
    conf_q: float = 0.55
    policy: str = "dynamic_conf"         # throttle fill order (Fig. 6)
    bandwidth_mbps: float = 50.0
    contact_s: float = 360.0
    contacts_per_day: float = 4.0
    energy_budget_j: float = 150_000.0
    hardware: DeviceProfile = RPI4
    use_dedup: bool = True
    k_clusters: Optional[int] = None     # default: n_active // 2
    use_roi: bool = True
    roi_std_thresh: float = 0.02
    score_thresh: float = 0.15
    tiansuan_thresh: float = 0.5
    # credit ground recounts to downlinked-but-unprocessed tiles in the
    # tiansuan baseline (False reproduces the paper's behaviour)
    tiansuan_credit_unprocessed: bool = False
    # --- day-fraction calibration (see module docstring) ---
    tiles_per_day: float = 100_000.0
    real_tile_px: int = 416              # byte/energy pricing scale
    seed: int = 0
    # device-resident engine (False = the seed's host-orchestrated
    # reference path)
    use_engine: bool = True


@dataclass
class PipelineResult:
    cmae: float
    total_true: float
    total_pred: float
    bytes_downlinked: float
    bytes_budget: float
    tiles_processed_space: int
    tiles_downlinked: int
    tiles_total: int
    energy_spent_j: float
    energy_budget_j: float
    per_tile_pred: Optional[np.ndarray] = field(repr=False, default=None)
    per_tile_true: Optional[np.ndarray] = field(repr=False, default=None)

    def summary(self) -> dict:
        """Scalar fields only (no per-tile arrays)."""
        return {f.name: getattr(self, f.name) for f in fields(self)
                if not f.name.startswith("per_tile")}


def budgets_for(pcfg: PipelineConfig, n_tiles: int) -> Tuple[float, float, float]:
    """-> (energy_budget_j, byte_budget, bytes_per_tile) for the sim slice;
    zero budgets for a degenerate slice."""
    tile_bytes = float(pcfg.real_tile_px ** 2 * 3)
    if n_tiles <= 0 or pcfg.tiles_per_day <= 0:
        return 0.0, 0.0, tile_bytes
    day_fraction = n_tiles / pcfg.tiles_per_day
    energy = pcfg.energy_budget_j * day_fraction
    byte_budget = (pcfg.bandwidth_mbps * 1e6 / 8.0 * pcfg.contact_s
                   * pcfg.contacts_per_day * day_fraction)
    return energy, byte_budget, tile_bytes


def run_pipeline(frames, space, ground, pcfg: PipelineConfig = None,
                 energy_cfgs=None, device="cuda") -> PipelineResult:
    """One-window Mission: ``Mission(space, ground, pcfg, ...).run(frames)``.

    frames: list of (image, boxes, classes). space/ground: (params, cfg).
    """
    from repro_torch.core.mission import Mission
    return Mission(space, ground, pcfg, energy_cfgs=energy_cfgs,
                   device=device).run(frames)
