"""Pluggable selection policies for the Mission stage graph (§III-D).

Counterpart of ``repro/core/policies.py``: each of the paper's five
baselines (§IV-A7) is a ``SelectionPolicy`` registered under its method
name. A policy declares which optional ingest stages apply to it
(``wants_roi`` / ``wants_dedup`` / ``wants_onboard``) and maps the
onboard state of one segment plus a window's byte budget to a
:class:`Selection`. ``PipelineConfig.method`` names the policy;
``PipelineConfig.policy`` is the throttle fill order.

The batched contact tier (:mod:`repro_torch.core.contact`) hands a
policy the lanes of one drain step at once (:class:`PolicyContextBatch`,
one lane a window) through :meth:`SelectionPolicy.select_batch`: the
two-threshold policies run every lane's throttle in one
``throttle_padded_batch`` call; the others select lane by lane.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Sequence, Tuple, Type

import numpy as np

from repro_torch.core.dedup import bucket_size
from repro_torch.core.throttle import throttle, throttle_padded, throttle_padded_batch

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.pipeline import PipelineConfig


@dataclass
class PolicyContext:
    """Read-only view of one ingested segment at selection time."""
    n: int                  # tile count
    active: np.ndarray      # (n,) bool  ROI-surviving tiles
    rep_of: np.ndarray      # (n,) int   dedup representative of each tile
    conf: np.ndarray        # (n,) f64   onboard confidence (-1 = unprocessed)
    counts_sp: np.ndarray   # (n,) f64   onboard counts, rep-expanded
    processed: np.ndarray   # (n,) bool  counted onboard within the energy cap
    tile_bytes: float       # downlink cost of one tile (full counter scale)
    pcfg: "PipelineConfig"


@dataclass
class Selection:
    """Select-stage output, consumed by Downlink/GroundRecount/Aggregate."""
    accept_space: np.ndarray   # (n,) bool: pred <- onboard count
    downlink: np.ndarray       # (k,) int64: tile indices to transmit
    ground_credit: np.ndarray  # (n,) bool: pred <- ground count of the rep
    bytes_requested: float     # bytes the policy asks to transmit (kodan
    #                            is bandwidth-oblivious and may exceed the
    #                            window budget; the ledger charges capped)


@dataclass
class PolicyContextBatch:
    """Lane-stacked :class:`PolicyContext`: L windows' segments as
    (L, n_max) padded arrays. Pad slots are inert (``active`` and
    ``processed`` False, ``conf`` -1, ``rep_of`` -1); :meth:`lane` gives
    back lane i's :class:`PolicyContext` (row slices equal to the
    segment's arrays). ``policies`` holds each lane's own policy
    instance."""

    n: np.ndarray            # (L,) int64 per-lane tile counts
    active: np.ndarray       # (L, n_max) bool
    rep_of: np.ndarray       # (L, n_max) int64 (pad slots -1)
    conf: np.ndarray         # (L, n_max) f64   (pad slots -1)
    counts_sp: np.ndarray    # (L, n_max) f64
    processed: np.ndarray    # (L, n_max) bool
    tile_bytes: np.ndarray   # (L,) f64
    pcfgs: Tuple             # per-lane PipelineConfig
    policies: Tuple          # per-lane SelectionPolicy instances

    @property
    def n_lanes(self) -> int:
        return len(self.pcfgs)

    @classmethod
    def stack(cls, ctxs: Sequence[PolicyContext],
              policies: Sequence["SelectionPolicy"]) -> "PolicyContextBatch":
        L = len(ctxs)
        n = np.array([c.n for c in ctxs], np.int64)
        n_max = max(int(n.max()) if L else 0, 1)

        def pack(fld, dtype, fill):
            out = np.full((L, n_max), fill, dtype)
            for i, c in enumerate(ctxs):
                out[i, :c.n] = getattr(c, fld)
            return out

        return cls(
            n=n,
            active=pack("active", bool, False),
            rep_of=pack("rep_of", np.int64, -1),
            conf=pack("conf", np.float64, -1.0),
            counts_sp=pack("counts_sp", np.float64, 0.0),
            processed=pack("processed", bool, False),
            tile_bytes=np.array([c.tile_bytes for c in ctxs], np.float64),
            pcfgs=tuple(c.pcfg for c in ctxs),
            policies=tuple(policies))

    def lane(self, i: int) -> PolicyContext:
        """Lane ``i``'s :class:`PolicyContext` (unpadded row slices)."""
        n = int(self.n[i])
        return PolicyContext(
            n=n, active=self.active[i, :n], rep_of=self.rep_of[i, :n],
            conf=self.conf[i, :n], counts_sp=self.counts_sp[i, :n],
            processed=self.processed[i, :n],
            tile_bytes=float(self.tile_bytes[i]), pcfg=self.pcfgs[i])


@dataclass
class SelectionBatch:
    """select_batch's output: a :class:`Selection` a lane, and the
    lanes' requested bytes as one vector."""

    selections: List[Selection]
    bytes_requested: np.ndarray = field(default=None)  # (L,) f64

    def __post_init__(self):
        if self.bytes_requested is None:
            self.bytes_requested = np.array(
                [s.bytes_requested for s in self.selections], np.float64)


class SelectionPolicy:
    """Base plugin: stage wants + the selection decision.

    :meth:`select` decides one segment under one budget;
    :meth:`select_batch` decides the lanes of a drain step, by default
    through each lane's own policy's :meth:`select`."""

    name = "?"
    wants_roi = False       # run the ROI variance filter for this policy
    wants_dedup = False     # run clustering dedup for this policy
    wants_onboard = True    # run energy-capped onboard counting

    def select(self, ctx: PolicyContext, budget_bytes: float) -> Selection:
        raise NotImplementedError

    def select_batch(self, batch: PolicyContextBatch,
                     budgets: np.ndarray) -> SelectionBatch:
        """Lane by lane :meth:`select`, through each lane's own policy
        instance (the calls the window-by-window loop would make)."""
        return SelectionBatch([
            batch.policies[i].select(batch.lane(i), float(budgets[i]))
            for i in range(batch.n_lanes)])


_REGISTRY: Dict[str, Type[SelectionPolicy]] = {}


def register_policy(name: str):
    """Class decorator: register a :class:`SelectionPolicy` under ``name``."""
    def deco(cls: Type[SelectionPolicy]) -> Type[SelectionPolicy]:
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get_policy(name: str) -> SelectionPolicy:
    """Instantiate the policy registered under ``name``."""
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise ValueError(
            f"unknown selection policy {name!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def available_policies() -> tuple:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# the paper's five baselines
# ---------------------------------------------------------------------------

@register_policy("space_only")
class SpaceOnlyPolicy(SelectionPolicy):
    """Onboard counts only; nothing is transmitted."""

    def select(self, ctx, budget_bytes):
        return Selection(ctx.processed.copy(), np.zeros(0, np.int64),
                         np.zeros(ctx.n, bool), 0.0)


@register_policy("ground_only")
class GroundOnlyPolicy(SelectionPolicy):
    """Bent-pipe: raw tiles downlinked in index order within bandwidth;
    the rest contribute 0. No onboard compute at all."""

    wants_onboard = False

    def select(self, ctx, budget_bytes):
        k = int(budget_bytes // ctx.tile_bytes)
        sel = np.arange(min(k, ctx.n))
        credit = np.zeros(ctx.n, bool)
        credit[sel] = True
        return Selection(np.zeros(ctx.n, bool), sel.astype(np.int64),
                         credit, len(sel) * ctx.tile_bytes)


@register_policy("tiansuan")
class TiansuanPolicy(SelectionPolicy):
    """Fixed confidence threshold: results above it are accepted onboard,
    the rest are downlinked indiscriminately within bandwidth; leftovers
    are lost. Only processed tiles are credited with the ground recount
    unless ``PipelineConfig.tiansuan_credit_unprocessed`` is set."""

    def select(self, ctx, budget_bytes):
        accept = ctx.processed & (ctx.conf > ctx.pcfg.tiansuan_thresh)
        cand = np.where(ctx.active & ~accept)[0]
        cand_reps = np.unique(ctx.rep_of[cand])
        k = int(budget_bytes // ctx.tile_bytes)
        sel_reps = cand_reps[:k]
        credit = np.isin(ctx.rep_of, sel_reps) & ~accept
        if not ctx.pcfg.tiansuan_credit_unprocessed:
            credit &= ctx.processed
        return Selection(accept, sel_reps.astype(np.int64), credit,
                         len(sel_reps) * ctx.tile_bytes)


class TwoThresholdPolicy(SelectionPolicy):
    """Shared kodan/targetfuse logic: two-threshold selection over dedup
    representatives (Algorithm 2) + leftover-bandwidth raw downlink of
    representatives the energy budget never let us process onboard (an
    unprocessed tile earns a ground count instead of counting 0)."""

    wants_roi = True
    wants_dedup = True
    bandwidth_oblivious = False  # kodan: selects as if bandwidth were infinite

    @staticmethod
    def _reps(ctx) -> np.ndarray:
        """Processed dedup representatives: the throttle's candidates."""
        rep_self = ctx.rep_of == np.arange(ctx.n)
        return np.where(ctx.processed & rep_self)[0]

    def _budget(self, budget_bytes) -> np.float64:
        return (np.float64(1e18) if self.bandwidth_oblivious
                else np.float64(budget_bytes))

    def select(self, ctx, budget_bytes):
        pcfg = ctx.pcfg
        rep_idx = self._reps(ctx)
        n_rep = len(rep_idx)
        budget = self._budget(budget_bytes)
        if pcfg.use_engine:
            # pad the rep set to a bucket, as the reference does; pad
            # slots are inactive, so they sort last and take no budget
            space_m, down_m = throttle_padded(
                ctx.conf[rep_idx], ctx.tile_bytes, budget,
                pcfg.conf_p, pcfg.conf_q, pcfg.policy,
                n_pad=bucket_size(max(n_rep, 1)))
        else:  # the reference path's unpadded throttle
            tr = throttle(ctx.conf[rep_idx], np.full(n_rep, ctx.tile_bytes),
                          budget, pcfg.conf_p, pcfg.conf_q, pcfg.policy)
            space_m, down_m = tr.space.numpy(), tr.downlink.numpy()
        return self._finish(ctx, rep_idx, budget, space_m, down_m)

    @staticmethod
    def _finish(ctx, rep_idx, budget, space_m, down_m):
        """One lane's tail after the throttle: leftover-bandwidth raw
        downlink of unprocessed reps, then the rep-expanded masks."""
        n = ctx.n
        rep_self = ctx.rep_of == np.arange(n)
        down_reps = rep_idx[down_m]
        unproc_reps = np.where(ctx.active & rep_self & ~ctx.processed)[0]
        k_extra = int(max(budget - len(down_reps) * ctx.tile_bytes, 0.0)
                      // ctx.tile_bytes)
        down_all = np.concatenate([down_reps,
                                   unproc_reps[:k_extra]]).astype(np.int64)
        rep_space = np.zeros(n, bool)
        rep_space[rep_idx[space_m]] = True
        rep_down = np.zeros(n, bool)
        rep_down[down_all] = True
        use_ground = rep_down[ctx.rep_of] & ctx.active
        use_space = rep_space[ctx.rep_of] & ctx.processed & ~use_ground
        return Selection(use_space, down_all, use_ground,
                         len(down_all) * ctx.tile_bytes)

    def select_batch(self, batch, budgets):
        """Every lane's candidates in one ``throttle_padded_batch`` call a
        fill order, each padded to the bucket of the fill order's longest
        candidate set (a lane's masks do not depend on its padding).
        Reference-path lanes (``use_engine=False``) go to the lane-by-lane
        adapter and their unpadded throttle."""
        if not all(p.use_engine for p in batch.pcfgs):
            return SelectionPolicy.select_batch(self, batch, budgets)
        L = batch.n_lanes
        ctxs = [batch.lane(i) for i in range(L)]
        rep_idxs = [self._reps(c) for c in ctxs]
        budget_eff = np.array([self._budget(float(budgets[i])) for i in range(L)],
                              np.float64)
        masks: list = [None] * L
        by_fill: Dict[str, list] = {}
        for i, c in enumerate(ctxs):
            by_fill.setdefault(c.pcfg.policy, []).append(i)
        for fill, ids in by_fill.items():
            n_pad = bucket_size(max(max(len(rep_idxs[i]) for i in ids), 1))
            res = throttle_padded_batch(
                [ctxs[i].conf[rep_idxs[i]] for i in ids],
                [ctxs[i].tile_bytes for i in ids], budget_eff[ids],
                [ctxs[i].pcfg.conf_p for i in ids],
                [ctxs[i].pcfg.conf_q for i in ids], fill, n_pad=n_pad)
            for i, m in zip(ids, res):
                masks[i] = m
        return SelectionBatch(
            [self._finish(ctxs[i], rep_idxs[i], np.float64(budget_eff[i]), *masks[i])
             for i in range(L)])


@register_policy("targetfuse")
class TargetFusePolicy(TwoThresholdPolicy):
    """Full system: tiling + dedup + dynamic-conf throttling."""


@register_policy("kodan")
class KodanPolicy(TwoThresholdPolicy):
    """Value-ranked downlink with dedup/ROI but bandwidth-oblivious —
    the paper treats it as an upper bound."""

    bandwidth_oblivious = True
