"""Mission sessions: the stage-graph pipeline with streaming contact
windows, PyTorch.

Counterpart of ``repro/core/mission.py``. A :class:`Mission` owns the
budget state of one satellite (an energy ledger and a downlink byte
ledger) and runs an explicit stage graph over ingested frame segments:

    ingest(frames):          Capture -> RoiFilter -> Dedup -> OnboardCount
    contact_window(bytes):   Select -> Downlink -> GroundRecount -> Aggregate

Tiles, moments, the clustering and the counters run on the Mission's
``device`` ("cuda" unless the caller asks for "cpu"; there is no quiet
fallback to the CPU). Selection and the ledgers are host logic.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

import repro_torch.core.dedup as dd
from repro_torch.core import engine
from repro_torch.core.cascade import count_tiles_batched
from repro_torch.core.energy import (ByteLedger, EnergyLedger, detector_gflops,
                                     max_tiles_within_budget)
from repro_torch.core.metrics import cmae
from repro_torch.core.pipeline import PipelineConfig, PipelineResult, budgets_for
from repro_torch.core.policies import PolicyContext, Selection, get_policy
from repro_torch.core.throttle import clamp_budget_bytes
from repro_torch.device import resolve_device
from repro_torch.models import detector


@dataclass
class Segment:
    """One ingested frame batch (an orbital pass's tile slice) and the
    per-tile state the stages accumulate over it."""
    frames: list
    energy_grant_override: Optional[float] = None
    # Capture
    n: int = 0
    prep: Optional[engine.PreparedFrames] = None
    tiles_sp: Optional[torch.Tensor] = None  # device
    tiles_gd: Optional[torch.Tensor] = None
    true: Optional[np.ndarray] = None
    energy_granted_j: float = 0.0
    byte_entitlement: float = 0.0
    # RoiFilter / Dedup
    active: Optional[np.ndarray] = None
    rep_of: Optional[np.ndarray] = None
    # OnboardCount
    conf: Optional[np.ndarray] = None
    counts_sp: Optional[np.ndarray] = None
    processed: Optional[np.ndarray] = None
    n_processed: int = 0
    # contact-window stages
    selection: Optional[Selection] = None
    counts_gd: Optional[np.ndarray] = None
    bytes_requested: float = 0.0
    bytes_spent: float = 0.0
    pred: Optional[np.ndarray] = None


@dataclass
class ContactWindow:
    """Mutable byte budget shared by the segments of one window."""
    budget: float
    remaining: float


@dataclass
class IngestReport:
    n_frames: int
    n_tiles: int
    tiles_processed_space: int
    energy_granted_j: float
    energy_remaining_j: float
    byte_entitlement: float


@dataclass
class WindowReport:
    budget_bytes: float
    bytes_requested: float
    bytes_spent: float
    tiles_downlinked: int
    segments: int


class Stage:
    """One node of the Mission stage graph. Ingest stages are called as
    ``run(mission, seg)``; contact stages as ``run(mission, seg, window)``."""

    name = "stage"

    def run(self, mission: "Mission", seg: Segment,
            window: Optional[ContactWindow] = None) -> None:
        raise NotImplementedError


class Capture(Stage):
    """Tile + resize + moments on the device, collect ground truth, and
    grant this slice's day-fraction budgets."""

    name = "capture"

    def run(self, mission, seg, window=None):
        self.prepare(mission, seg)
        self.admit(mission, seg)

    def prepare(self, mission, seg):
        pcfg = mission.pcfg
        # skip the moments when this policy consumes neither statistic
        with_stats = ((pcfg.use_roi and mission.policy.wants_roi)
                      or (pcfg.use_dedup and mission.policy.wants_dedup))
        prep = engine.prepare_frames(seg.frames, pcfg.tile_size,
                                     mission.space[1].input_size,
                                     mission.ground[1].input_size,
                                     with_stats=with_stats,
                                     device=mission.device)
        seg.prep = prep
        seg.tiles_sp, seg.tiles_gd = prep.tiles_sp, prep.tiles_gd
        seg.true, seg.n = prep.true, prep.n

    def admit(self, mission, seg):
        energy, byte_budget, _ = budgets_for(mission.pcfg, seg.n)
        if seg.energy_grant_override is not None:
            energy = float(seg.energy_grant_override)
        seg.energy_granted_j = energy
        seg.byte_entitlement = byte_budget
        mission.ledger.grant(energy)
        mission.ledger.charge_capture(len(seg.frames))
        seg.active = np.ones(seg.n, bool)
        seg.rep_of = np.arange(seg.n)
        seg.conf = np.full(seg.n, -1.0)
        seg.counts_sp = np.zeros(seg.n)
        seg.processed = np.zeros(seg.n, bool)


class RoiFilter(Stage):
    """Drop low-variance tiles (background/cloud) when the policy uses ROI."""

    name = "roi_filter"

    def run(self, mission, seg, window=None):
        pcfg = mission.pcfg
        if not (pcfg.use_roi and mission.policy.wants_roi) or seg.n == 0:
            return
        seg.active &= seg.prep.roi_std > pcfg.roi_std_thresh


class Dedup(Stage):
    """Cluster active tiles into geographic contexts; representatives
    stand for their cluster downstream."""

    name = "dedup"

    def run(self, mission, seg, window=None):
        pcfg = mission.pcfg
        if (not (pcfg.use_dedup and mission.policy.wants_dedup)
                or seg.active.sum() <= 4):
            return
        k = pcfg.k_clusters or max(2, int(seg.active.sum()) // 2)
        idx_active = np.where(seg.active)[0]
        # bucketed gather of the moments: pad the index vector so the
        # whole dedup runs at a power-of-two shape
        n_act = len(idx_active)
        idx_pad = np.zeros(dd.dedup_pad_size(n_act), np.int64)
        idx_pad[:n_act] = idx_active
        moments = seg.prep.moments.index_select(
            0, torch.from_numpy(idx_pad).to(mission.device))
        res = dd.dedup_from_moments(moments, k, pcfg.seed, n=n_act)
        assign = res.assign.cpu().numpy()
        rep_local = res.rep_idx.cpu().numpy()
        seg.rep_of[idx_active] = idx_active[rep_local[assign]]
        mission.ledger.charge_aggregate(len(idx_active))


class OnboardCount(Stage):
    """Energy-capped onboard counting of representatives (the paper's
    '22% of observable images' bottleneck), charged to the ledger."""

    name = "onboard_count"

    def run(self, mission, seg, window=None):
        if not mission.policy.wants_onboard:
            return
        pcfg = mission.pcfg
        reps = np.unique(seg.rep_of[seg.active])
        cap = max_tiles_within_budget(mission.ledger.remaining * 0.95,
                                      mission.gflops_space, pcfg.hardware)
        process = reps[:cap] if len(reps) > cap else reps
        seg.n_processed = len(process)
        mission.ledger.charge_compute(seg.n_processed, mission.gflops_space,
                                      pcfg.hardware)
        counts_sp = np.zeros(seg.n)
        conf = np.full(seg.n, -1.0)
        if seg.n_processed:
            c, f = mission._count(mission.space, seg.tiles_sp, process)
            counts_sp[process] = c
            conf[process] = f
        seg.counts_sp = counts_sp[seg.rep_of]
        seg.conf = conf[seg.rep_of]
        seg.processed = np.isin(seg.rep_of, process) & seg.active


def policy_context(mission: "Mission", seg: Segment) -> PolicyContext:
    """Selection-time view of one segment."""
    return PolicyContext(n=seg.n, active=seg.active, rep_of=seg.rep_of,
                         conf=seg.conf, counts_sp=seg.counts_sp,
                         processed=seg.processed,
                         tile_bytes=mission.tile_bytes, pcfg=mission.pcfg)


class Select(Stage):
    """Delegate the accept/transmit/credit decision to the registered
    :class:`~repro_torch.core.policies.SelectionPolicy`."""

    name = "select"

    def run(self, mission, seg, window=None):
        budget = window.remaining if window is not None else 0.0
        seg.selection = mission.policy.select(policy_context(mission, seg),
                                              budget)


class Downlink(Stage):
    """Charge the byte/radio ledgers; actual spend is capped by the
    window budget even when the policy is bandwidth-oblivious."""

    name = "downlink"

    def run(self, mission, seg, window=None):
        sel = seg.selection
        remaining = window.remaining if window is not None else 0.0
        spend = min(sel.bytes_requested, remaining)
        mission.ledger.charge_downlink(spend, mission.pcfg.bandwidth_mbps)
        if window is not None:
            window.remaining = clamp_budget_bytes(window.remaining - spend)
        seg.bytes_requested = sel.bytes_requested
        seg.bytes_spent = spend
        mission.bytes_ledger.requested += sel.bytes_requested
        mission.bytes_ledger.spent += spend


class GroundRecount(Stage):
    """Recount transmitted tiles with the deeper ground-tier counter."""

    name = "ground_recount"

    def run(self, mission, seg, window=None):
        counts_gd = np.zeros(seg.n)
        down = seg.selection.downlink
        if len(down):
            c, _ = mission._count(mission.ground, seg.tiles_gd, down)
            counts_gd[down] = c
        seg.counts_gd = counts_gd[seg.rep_of]


class Aggregate(Stage):
    """Fuse onboard and ground counts into per-tile predictions."""

    name = "aggregate"

    def run(self, mission, seg, window=None):
        sel = seg.selection
        pred = np.zeros(seg.n, np.float64)
        pred[sel.accept_space] = seg.counts_sp[sel.accept_space]
        pred[sel.ground_credit] = seg.counts_gd[sel.ground_credit]
        seg.pred = pred


def default_ingest_stages() -> List[Stage]:
    return [Capture(), RoiFilter(), Dedup(), OnboardCount()]


def default_contact_stages() -> List[Stage]:
    return [Select(), Downlink(), GroundRecount(), Aggregate()]


class Mission:
    """One satellite's pipeline session (see module docstring).

    Parameters
    ----------
    space, ground : (params, cfg) counter pairs; the params (a tensor
        tree, e.g. from ``detector.params_from_jax``) are moved to
        ``device``.
    pcfg : PipelineConfig — ``method`` names the registered selection
        policy.
    energy_cfgs : optional (space_cfg_full, ground_cfg_full) used to
        PRICE compute; defaults to the paper's full-scale counters.
    ingest_stages, contact_stages : optional custom stage lists.
    device : "cuda" (default; raises without a card) or "cpu".
    """

    def __init__(self, space, ground, pcfg: PipelineConfig = None,
                 energy_cfgs=None, ingest_stages: List[Stage] = None,
                 contact_stages: List[Stage] = None, device="cuda"):
        self.device = resolve_device(device)
        self.pcfg = pcfg if pcfg is not None else PipelineConfig()
        if not self.pcfg.use_engine:
            raise NotImplementedError(
                "the reference host path (use_engine=False) is not ported")
        self.space = (detector.to_device(space[0], self.device), space[1])
        self.ground = (detector.to_device(ground[0], self.device), ground[1])
        if energy_cfgs is None:
            from repro_torch.configs import get_config
            energy_cfgs = (get_config("targetfuse-space"),
                           get_config("targetfuse-ground"))
        self.gflops_space = detector_gflops(energy_cfgs[0])
        self.policy = get_policy(self.pcfg.method)
        self.tile_bytes = float(self.pcfg.real_tile_px ** 2 * 3)
        self.ledger = EnergyLedger(budget_j=0.0)
        self.bytes_ledger = ByteLedger()
        self._finalized = False
        self.ingest_stages = (list(ingest_stages) if ingest_stages is not None
                              else default_ingest_stages())
        self.contact_stages = (list(contact_stages)
                               if contact_stages is not None
                               else default_contact_stages())
        self._segments: List[Segment] = []  # ingest order
        self._pending: List[Segment] = []   # awaiting a contact window

    @property
    def bytes_budget(self) -> float:
        """Bytes offered across contact windows."""
        return self.bytes_ledger.budget

    @property
    def bytes_requested(self) -> float:
        """Bytes the policies asked to transmit."""
        return self.bytes_ledger.requested

    @property
    def bytes_spent(self) -> float:
        """Bytes actually charged (<= budget)."""
        return self.bytes_ledger.spent

    # -- streaming API ------------------------------------------------------

    def ingest(self, frames, energy_budget_j: float = None) -> IngestReport:
        """Run the onboard stages over one frame batch (an orbital pass).

        Grants the slice's day-fraction energy budget (or an explicit
        ``energy_budget_j``) to the persistent ledger first; onboard
        counting then runs under whatever energy remains mission-wide.
        """
        self._finalized = False
        seg = Segment(frames=list(frames),
                      energy_grant_override=energy_budget_j)
        for stage in self.ingest_stages:
            stage.run(self, seg)
        self._segments.append(seg)
        self._pending.append(seg)
        return IngestReport(
            n_frames=len(seg.frames), n_tiles=seg.n,
            tiles_processed_space=seg.n_processed,
            energy_granted_j=seg.energy_granted_j,
            energy_remaining_j=self.ledger.remaining,
            byte_entitlement=seg.byte_entitlement)

    def contact_window(self, budget_bytes: float = None) -> WindowReport:
        """Drain pending segments FIFO through the ground-side stages
        within one window's byte budget (default: the pending segments'
        accumulated entitlement); unspent budget flows to later segments.
        After :meth:`finalize` (and before a new ingest) this is a no-op.
        """
        if self._finalized and not self._pending:
            return WindowReport(budget_bytes=0.0, bytes_requested=0.0,
                                bytes_spent=0.0, tiles_downlinked=0,
                                segments=0)
        segs, self._pending = self._pending, []
        if budget_bytes is None:
            budget_bytes = sum(s.byte_entitlement for s in segs)
        budget_bytes = clamp_budget_bytes(budget_bytes)
        window = ContactWindow(budget=budget_bytes, remaining=budget_bytes)
        self.bytes_ledger.budget += window.budget
        for seg in segs:
            for stage in self.contact_stages:
                stage.run(self, seg, window)
        return WindowReport(
            budget_bytes=window.budget,
            bytes_requested=sum(s.bytes_requested for s in segs),
            bytes_spent=sum(s.bytes_spent for s in segs),
            tiles_downlinked=sum(len(s.selection.downlink) for s in segs),
            segments=len(segs))

    # -- one-shot API -------------------------------------------------------

    def run(self, frames) -> PipelineResult:
        """Single ingest + one full-entitlement contact window."""
        self.ingest(frames)
        self.contact_window()
        return self.result()

    def finalize(self) -> PipelineResult:
        """Flush pending segments through a zero-byte window (onboard
        results land, nothing transmits), then aggregate. Idempotent."""
        if self._pending:
            self.contact_window(0.0)
        self._finalized = True
        return self.result()

    def result(self) -> PipelineResult:
        """Aggregate over every segment that has been through a contact
        window. Call :meth:`finalize` to include un-windowed segments."""
        done = [s for s in self._segments if s.pred is not None]
        if done:
            pred = np.concatenate([s.pred for s in done])
            true = np.concatenate([s.true for s in done])
        else:
            pred = np.zeros(0, np.float64)
            true = np.zeros(0, np.float64)
        return PipelineResult(
            cmae=cmae(pred, true),
            total_true=float(true.sum()),
            total_pred=float(pred.sum()),
            bytes_downlinked=float(self.bytes_requested),
            bytes_budget=float(self.bytes_budget),
            tiles_processed_space=int(sum(s.n_processed for s in done)),
            tiles_downlinked=int(sum(len(s.selection.downlink) for s in done
                                     if s.selection is not None)),
            tiles_total=int(sum(s.n for s in done)),
            energy_spent_j=float(self.ledger.spent),
            energy_budget_j=float(self.ledger.budget_j),
            per_tile_pred=pred,
            per_tile_true=true,
        )

    @property
    def pending_segments(self) -> int:
        return len(self._pending)

    def _count(self, counter, tiles, idx):
        """Count ``tiles[idx]``: a device gather, then fixed-shape batches."""
        params, cfg = counter
        return count_tiles_batched(params, cfg, tiles, idx=idx,
                                   score_thresh=self.pcfg.score_thresh)
