"""Pluggable selection policies for the Mission stage graph (§III-D).

Counterpart of ``repro/core/policies.py``: each of the paper's five
baselines (§IV-A7) is a ``SelectionPolicy`` registered under its method
name. A policy declares which optional ingest stages apply to it
(``wants_roi`` / ``wants_dedup`` / ``wants_onboard``) and maps the
onboard state of one segment plus a window's byte budget to a
:class:`Selection`. ``PipelineConfig.method`` names the policy;
``PipelineConfig.policy`` is the throttle fill order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, Type

import numpy as np

from repro_torch.core.dedup import bucket_size
from repro_torch.core.throttle import throttle_padded

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


class SelectionPolicy:
    """Base plugin: stage wants + the selection decision."""

    name = "?"
    wants_roi = False       # run the ROI variance filter for this policy
    wants_dedup = False     # run clustering dedup for this policy
    wants_onboard = True    # run energy-capped onboard counting

    def select(self, ctx: PolicyContext, budget_bytes: float) -> Selection:
        raise NotImplementedError


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

    def select(self, ctx, budget_bytes):
        pcfg = ctx.pcfg
        n = ctx.n
        rep_self = ctx.rep_of == np.arange(n)
        rep_idx = np.where(ctx.processed & rep_self)[0]
        budget = (np.float64(1e18) if self.bandwidth_oblivious
                  else np.float64(budget_bytes))
        # pad the rep set to a bucket, as the reference does; pad slots
        # are inactive, so they sort last and take no budget
        space_m, down_m = throttle_padded(
            ctx.conf[rep_idx], ctx.tile_bytes, budget,
            pcfg.conf_p, pcfg.conf_q, pcfg.policy,
            n_pad=bucket_size(max(len(rep_idx), 1)))
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


@register_policy("targetfuse")
class TargetFusePolicy(TwoThresholdPolicy):
    """Full system: tiling + dedup + dynamic-conf throttling."""


@register_policy("kodan")
class KodanPolicy(TwoThresholdPolicy):
    """Value-ranked downlink with dedup/ROI but bandwidth-oblivious —
    the paper treats it as an upper bound."""

    bandwidth_oblivious = True
