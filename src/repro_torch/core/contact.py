"""The ground segment's contact tier, ported at depth 0: ContactPlan, the
batched lane-stacked executor and its FIFO reference.

Counterpart of ``repro/core/contact.py``:

* :class:`ContactPlan`: one round's windows as ``(n_windows,)``
  satellite / byte-budget / station arrays, built from explicit windows
  (:meth:`ContactPlan.build`), the fleet's rotation
  (:meth:`ContactPlan.rotating`) or a scenario's contact events
  (:meth:`ContactPlan.from_contacts`). A malformed window (a satellite
  outside the fleet, a NaN, infinite or negative budget) raises
  ``ValueError`` when the plan is built.
* :func:`execute_plan`: windows open in plan order (budgets accrued in
  one ledger op), then the round drains in steps: at step ``p`` every
  window still holding a ``p``-th pending segment is one lane of a
  :class:`~repro_torch.core.policies.PolicyContextBatch`, Select runs as
  one ``select_batch`` call a policy class, and Downlink charges every
  lane in one vectorized ledger op. A window's remaining budget is its
  plan budget less the prefix of its earlier segments' spends, so the
  batched drain equals draining each window through the scalar stage
  loop (:func:`execute_plan_reference`). The ground recounts of all
  windows then share counting batches (``count_tiles_multi``).
* :class:`GroundSegment`: the fleet's contact executor, a bounded
  depth-``k`` recount pipeline. At depth 0 the round's recounts run
  inline; at depth ``k >= 1`` each round's recount and Aggregate run on
  a worker thread, up to ``k`` rounds in flight, with the watchdog and
  the injected worker faults of :mod:`repro_torch.core.faults`. On a
  CUDA device every worker launches on the segment's own stream, ordered
  after the foreground's writes by an event recorded at dispatch. On a
  ``sats`` mesh a worker only launches its rank's counting, and the
  foreground gathers the round when it retires it.
"""
from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.cascade import count_tiles_multi
from repro_torch.core.faults import FaultContext, WorkerCrash
from repro_torch.core.mission import WindowReport, policy_context, recount_tiles
from repro_torch.core.policies import PolicyContextBatch
from repro_torch.core.throttle import clamp_budget_bytes

__all__ = ["ContactPlan", "GroundSegment", "execute_plan",
           "execute_plan_reference"]

@dataclass(frozen=True)
class ContactPlan:
    """One contact round, declaratively: lane-stacked window arrays.

    ``sats[w]`` is window ``w``'s target satellite, ``budgets[w]`` its
    byte budget, ``entitlement[w]`` True when the window offers the
    satellite's pending entitlement instead of an explicit budget (the
    ``budget_bytes=None`` semantics of the legacy API — ``budgets[w]``
    is 0 and ignored there), and ``stations[w]`` a label for
    reports/logs. Windows execute in array order; a satellite may
    appear in several windows (the first drains its pending passes,
    later ones find nothing and only offer budget).

    Instances are validated — construct through :meth:`build`,
    :meth:`rotating`, or :meth:`from_contacts`.
    """

    sats: np.ndarray         # (n_windows,) int64
    budgets: np.ndarray      # (n_windows,) float64, finite and >= 0
    entitlement: np.ndarray  # (n_windows,) bool
    stations: Tuple[str, ...]
    n_sats: int

    @property
    def n_windows(self) -> int:
        return int(self.sats.shape[0])

    def __post_init__(self):
        sats = np.asarray(self.sats)
        budgets = np.asarray(self.budgets, np.float64)
        ent = np.asarray(self.entitlement, bool)
        if not (sats.ndim == budgets.ndim == ent.ndim == 1
                and sats.shape == budgets.shape == ent.shape):
            raise ValueError(
                "ContactPlan: sats/budgets/entitlement must be aligned "
                f"1-D arrays, got shapes {sats.shape}/{budgets.shape}/"
                f"{ent.shape}")
        if len(self.stations) != sats.shape[0]:
            raise ValueError(
                f"ContactPlan: {len(self.stations)} station labels for "
                f"{sats.shape[0]} windows")
        if not np.issubdtype(sats.dtype, np.integer):
            raise ValueError(
                f"ContactPlan: satellite indices must be integers, got "
                f"dtype {sats.dtype}")
        if sats.size:
            bad = (sats < 0) | (sats >= self.n_sats)
            if bad.any():
                w = int(np.flatnonzero(bad)[0])
                raise ValueError(
                    f"ContactPlan: window {w} targets satellite "
                    f"{int(sats[w])}, outside the {self.n_sats}-satellite "
                    f"fleet [0, {self.n_sats})")
            explicit = ~ent
            bad = explicit & ~np.isfinite(budgets)
            if bad.any():
                w = int(np.flatnonzero(bad)[0])
                raise ValueError(
                    f"ContactPlan: window {w} has a non-finite byte "
                    f"budget ({budgets[w]}); use budget=None for the "
                    f"pending-entitlement default")
            bad = explicit & (budgets < 0.0)
            if bad.any():
                w = int(np.flatnonzero(bad)[0])
                raise ValueError(
                    f"ContactPlan: window {w} has a negative byte budget "
                    f"({budgets[w]}); downlink budgets must be >= 0")
        object.__setattr__(self, "sats", np.ascontiguousarray(sats, np.int64))
        object.__setattr__(self, "budgets", np.ascontiguousarray(budgets))
        object.__setattr__(self, "entitlement", np.ascontiguousarray(ent))
        object.__setattr__(self, "stations", tuple(self.stations))

    # -- builders -----------------------------------------------------------

    @staticmethod
    def build(windows: Sequence[Tuple[int, Optional[float]]], n_sats: int,
              stations: Optional[Sequence[str]] = None) -> "ContactPlan":
        """From explicit ``[(sat, budget_bytes_or_None), ...]`` windows
        (the legacy ``Fleet.contact_round(windows=...)`` shape)."""
        sats = np.array([w[0] for w in windows], np.int64) \
            if windows else np.zeros(0, np.int64)
        ent = np.array([w[1] is None for w in windows], bool) \
            if windows else np.zeros(0, bool)
        budgets = np.array([0.0 if w[1] is None else w[1] for w in windows],
                           np.float64) if windows else np.zeros(0)
        if stations is None:
            stations = tuple(f"w{i}" for i in range(len(windows)))
        return ContactPlan(sats=sats, budgets=budgets, entitlement=ent,
                           stations=tuple(stations), n_sats=int(n_sats))

    @staticmethod
    def rotating(n_sats: int, stations: int, start: int = 0,
                 budget_bytes: Optional[float] = None
                 ) -> Tuple["ContactPlan", int]:
        """The rotating default: the next ``stations`` satellites
        round-robin from ``start``, each offered ``budget_bytes``
        (None = pending entitlement). Returns ``(plan, next_start)`` so
        the caller can carry the rotation pointer across rounds."""
        if int(n_sats) < 1:
            raise ValueError(
                f"ContactPlan.rotating: n_sats must be >= 1 to rotate "
                f"over, got {int(n_sats)}")
        if int(stations) < 0:
            raise ValueError(
                f"ContactPlan.rotating: stations must be >= 0, got "
                f"{int(stations)}")
        wins, ptr = [], int(start)
        for _ in range(int(stations)):
            wins.append((ptr, budget_bytes))
            ptr = (ptr + 1) % int(n_sats)
        return (ContactPlan.build(
            wins, n_sats,
            stations=tuple(f"gs{i}" for i in range(len(wins)))), ptr)

    @staticmethod
    def from_contacts(contacts, n_sats: int) -> "ContactPlan":
        """From :class:`repro_torch.data.scenarios.ContactEvent` objects —
        the scenario generator's per-round contact schedule becomes the
        round's plan directly. ``station`` may be a :class:`GroundStation`-like
        object (its ``name`` labels the window) or a plain string, so
        lightweight schedule sources need not build station objects."""
        return ContactPlan(
            sats=np.array([c.sat for c in contacts], np.int64),
            budgets=np.array([c.budget_bytes for c in contacts], np.float64),
            entitlement=np.zeros(len(contacts), bool),
            stations=tuple(getattr(c.station, "name", c.station)
                           for c in contacts),
            n_sats=int(n_sats))

    def window_budget(self, w: int) -> Optional[float]:
        """Window ``w``'s budget in the scalar API's terms
        (None = pending entitlement)."""
        return None if self.entitlement[w] else float(self.budgets[w])


# ---------------------------------------------------------------------------
# the batched executor core
# ---------------------------------------------------------------------------

def _select_downlink(fleet, plan: ContactPlan,
                     ctx: Optional[FaultContext] = None):
    """The synchronous half of a batched round: open every window, then
    drain Select + Downlink step-wise across lanes.

    ``ctx`` (a faulty round) adds the segment-granular fault hooks:
    mid-window truncation zeroes a window's remaining budget at its
    drawn drain step, and corrupted transmissions are detected (and
    refunded/re-queued) immediately after each step's Downlink charges —
    so every ledger lane sees the exact charge/refund float sequence of
    the scalar fault drain (:func:`_contact_window_faulty`).

    Returns ``(out, jobs)`` — the per-window ``(sat, WindowReport)``
    list (complete: reports never depend on the recount) and the jobs
    whose GroundRecount + Aggregate still have to run.
    """
    out: List[Optional[Tuple[int, WindowReport]]] = [None] * plan.n_windows
    jobs = []  # (slot, sat, mission, window, segs) — batched lanes
    open_sats, open_budgets = [], []
    for w in range(plan.n_windows):
        sat = int(plan.sats[w])
        m = fleet.missions[sat]
        if not fleet._batchable[sat]:
            # reference-path satellites take the exact scalar window
            # drain, in plan order
            if ctx is None:
                out[w] = (sat, m.contact_window(plan.window_budget(w)))
            else:
                out[w] = (sat, _contact_window_faulty(
                    m, plan.window_budget(w), ctx, int(ctx.orig_windows[w])))
            continue
        if m._window_is_noop():
            out[w] = (sat, m._drained_window_report())
            continue
        segs, window = m._open_window(plan.window_budget(w), accrue=False)
        open_sats.append(sat)
        open_budgets.append(window.budget)
        jobs.append((w, sat, m, window, segs))
    if open_sats:
        fleet.ledger.accrue_window_budgets(open_sats, open_budgets)

    truncs: Dict[int, int] = {}  # job index -> drain step the link dies at
    if ctx is not None:
        for j, (slot, _, _, _, segs) in enumerate(jobs):
            t = ctx.faults.truncated_at(ctx.rnd, int(ctx.orig_windows[slot]),
                                        len(segs))
            if t is not None and 0 <= t < len(segs):
                truncs[j] = t
                ctx.stats.windows_truncated += 1

    depth = max((len(segs) for *_, segs in jobs), default=0)
    for p in range(depth):
        for j, t in truncs.items():
            if t == p:  # the link died here: later segments see 0 budget
                jobs[j][3].remaining = 0.0
        if ctx is None:
            served = None
            lanes = [(sat, m, window, segs[p])
                     for _, sat, m, window, segs in jobs if len(segs) > p]
        else:
            served = [jb for jb in jobs if len(jb[4]) > p]
            lanes = [(sat, m, window, segs[p])
                     for _, sat, m, window, segs in served]
        for _, _, _, seg in lanes:
            # this attempt starts clean — also on clean rounds, which may
            # re-drain a segment a FAULTY round re-queued (the finalize
            # flush): stale flags would skip its recount/aggregate
            seg.requeued = False
            seg.corrupted = False
        # --- Select: one select_batch per policy class; each lane's
        # budget is its window's remaining prefix ---
        by_cls: Dict[type, list] = {}
        for lane in lanes:
            by_cls.setdefault(type(lane[1].policy), []).append(lane)
        for group in by_cls.values():
            ctxs = [policy_context(m, seg) for _, m, _, seg in group]
            batch = PolicyContextBatch.stack(
                ctxs, policies=[m.policy for _, m, _, seg in group])
            budgets = np.array([window.remaining
                                for _, _, window, _ in group], np.float64)
            sb = group[0][1].policy.select_batch(batch, budgets)
            for (_, _, _, seg), sel in zip(group, sb.selections):
                seg.selection = sel
        # --- Downlink: per-lane spend caps on the host (python-float
        # min, exactly the scalar stage), ledger charges vectorized ---
        sats_v, reqs, spends, bws = [], [], [], []
        for sat, m, window, seg in lanes:
            sel = seg.selection
            spend = min(sel.bytes_requested, window.remaining)
            window.remaining = clamp_budget_bytes(window.remaining - spend)
            seg.bytes_requested = sel.bytes_requested
            seg.bytes_spent = spend
            sats_v.append(sat)
            reqs.append(sel.bytes_requested)
            spends.append(spend)
            bws.append(m.pcfg.bandwidth_mbps)
        fleet.ledger.charge_downlink_windows(sats_v, reqs, spends, bws)
        if ctx is not None:
            _apply_corruption(fleet, ctx, served, p)

    for slot, sat, m, window, segs in jobs:
        out[slot] = (sat, m._window_report(window, segs))
    return out, jobs


def _apply_corruption(fleet, ctx: FaultContext, served, p: int) -> None:
    """Detect (deterministically) which of drain step ``p``'s
    transmissions the ground discards, reconcile the ledger per the
    refund policy, and route each failed segment to retry or permanent
    loss. Refunds land as ONE vectorized inverse-charge op immediately
    after the step's charges, so each lane's float sequence is exactly
    the scalar drain's charge-then-refund pair."""
    r_sats, r_spends, r_bws = [], [], []
    for slot, sat, m, _window, segs in served:
        seg = segs[p]
        ow = int(ctx.orig_windows[slot])
        if len(seg.selection.downlink) and \
                ctx.faults.segment_corrupted(ctx.rnd, ow, p):
            seg.corrupted = True
            ctx.stats.segments_corrupted += 1
            ctx.events.append((ow, p, "wasted", seg.bytes_spent))
            if ctx.faults.refund_policy == "refund" and seg.bytes_spent > 0.0:
                r_sats.append(sat)
                r_spends.append(seg.bytes_spent)
                r_bws.append(m.pcfg.bandwidth_mbps)
                ctx.events.append((ow, p, "refunded", seg.bytes_spent))
            if seg.retries < ctx.faults.max_retries:
                seg.retries += 1
                seg.eligible_round = ctx.rnd + seg.retries  # linear backoff
                seg.requeued = True
                ctx.requeue.append((m, seg))
                ctx.stats.segments_requeued += 1
            else:
                # permanently lost downlink-side: onboard-accepted counts
                # still land at Aggregate; ground-credited tiles read 0
                seg.counts_gd = np.zeros(seg.n)
                ctx.stats.segments_lost += 1
        elif seg.bytes_spent > 0.0:
            ctx.events.append((ow, p, "delivered", seg.bytes_spent))
    if r_sats:
        fleet.ledger.refund_downlink_windows(r_sats, r_spends, r_bws)


class _RecountWork:
    """One round's recount, snapshotted on the foreground when the
    round's Select and Downlink end: ``ground`` is the fleet's ground
    counter ``(params, cfg)``, ``by_thresh`` maps a score threshold to
    ``[(mission, seg, downlink)]`` (the segment's frozen downlink
    selection), ``agg`` is the ``[(mission, seg, window)]`` Aggregate
    list. A worker reads only this snapshot, never the fleet: a later
    round may re-open a re-queued segment (its flags and selection)
    while this round is queued, and the fleet may be gone. A segment is
    recounted and aggregated only in the round where it delivered or
    was permanently lost, so concurrent rounds write disjoint
    segments. ``sharding`` is the fleet's placement context."""

    __slots__ = ("ground", "by_thresh", "agg", "sharding")

    def __init__(self, ground, by_thresh, agg, sharding=None):
        self.ground = ground
        self.by_thresh = by_thresh
        self.agg = agg
        self.sharding = sharding

    @property
    def on_mesh(self) -> bool:
        return self.sharding is not None and self.sharding.on_mesh

    def device(self) -> Optional[torch.device]:
        """The device the recount runs on (None: nothing to count)."""
        for items in self.by_thresh.values():
            for m, _, _ in items:
                return m.device
        return None


def _recount_plan(fleet, jobs) -> _RecountWork:
    """Snapshot one round's recount work (foreground, at dispatch)."""
    by_thresh: Dict[float, list] = {}
    agg: list = []
    for _, _, m, window, segs in jobs:
        for seg in segs:
            if not seg.corrupted:
                by_thresh.setdefault(m.pcfg.score_thresh, []).append(
                    (m, seg, seg.selection.downlink))
            # else: the ground discarded this attempt's bytes — nothing
            # to recount (a retry re-transmits; a lost segment already
            # holds zero ground counts)
            if not seg.requeued:
                agg.append((m, seg, window))
            # else: retrying in a later round — no prediction yet
    return _RecountWork(fleet.ground, by_thresh, agg, fleet.sharding)


def _recount_launch(work: _RecountWork,
                    cancel: Optional[threading.Event] = None):
    """The launch half of a round's recount: each threshold group's
    ground tiles are made and counted in shared fixed-shape batches
    (``count_tiles_multi(..., defer=True)``), without the host copy ->
    ``[(items, resolve)]``, or None where ``cancel`` was set between
    groups. On a ``sats`` mesh each rank uploads and counts only its own
    chunks (``DTensor.from_local``, ``local_op``): nothing here is a
    collective, and each ``resolve()`` makes its group's one gather."""
    params, cfg = work.ground
    launched = []
    for thresh, items in work.by_thresh.items():
        if cancel is not None and cancel.is_set():
            return None
        launched.append((items, count_tiles_multi(params, cfg, recount_tiles(items),
                                                  score_thresh=thresh, sharding=work.sharding,
                                                  defer=True)))
    return launched


def _recount_land(work: _RecountWork, launched,
                  cancel: Optional[threading.Event] = None) -> None:
    """The landing half: resolve every threshold group's counts (the host
    copy, and on a ``sats`` mesh the gather), write each segment's ground
    counts, then Aggregate fuses predictions. ``cancel`` is checked after
    the counts land and before each Aggregate: a worker the watchdog
    abandoned writes nothing once it is set, so the synchronous recovery
    never sees a concurrent write."""
    counted = [(items, resolve()) for items, resolve in launched]
    for items, results in counted:
        if cancel is not None and cancel.is_set():
            return  # abandoned mid-count: discard, write nothing
        for (m, seg, down), (c, _) in zip(items, results):
            counts_gd = np.zeros(seg.n)
            if len(down):
                counts_gd[down] = c
            seg.counts_gd = counts_gd[seg.rep_of]
    for m, seg, window in work.agg:
        if cancel is not None and cancel.is_set():
            return
        m.contact_stages[3].run(m, seg, window)  # Aggregate


def _recount_run(work: _RecountWork,
                 cancel: Optional[threading.Event] = None) -> None:
    """A round's whole recount on one thread: the ground recounts of every
    window share fixed-shape counting batches (grouped by threshold),
    every group is counted before any is written, then Aggregate. Reads
    only the snapshot of :func:`_recount_plan` and charges nothing."""
    launched = _recount_launch(work, cancel)
    if launched is not None:
        _recount_land(work, launched, cancel)


def _recount_aggregate(fleet, jobs,
                       cancel: Optional[threading.Event] = None) -> None:
    """Plan + run in one call: the inline (depth 0) recount."""
    _recount_run(_recount_plan(fleet, jobs), cancel=cancel)


def _contact_window_faulty(m, budget_bytes, ctx: FaultContext,
                           orig_w: int) -> WindowReport:
    """``Mission.contact_window`` with the segment-granular fault hooks
    of one window: the scalar FIFO reference of the fault-aware batched
    drain (and the non-batchable-satellite path of a faulty round).
    Same stage sequence, same ledger arithmetic, same deterministic
    fault draws as the batched path, which must equal it bit for bit."""
    if m._window_is_noop():
        return m._drained_window_report()
    segs, window = m._open_window(budget_bytes)
    faults = ctx.faults
    t = faults.truncated_at(ctx.rnd, orig_w, len(segs))
    if t is not None and 0 <= t < len(segs):
        ctx.stats.windows_truncated += 1
    else:
        t = None
    select, downlink, recount, aggregate = m.contact_stages
    for p, seg in enumerate(segs):
        if t == p:
            window.remaining = 0.0
        seg.requeued = False
        seg.corrupted = False
        select.run(m, seg, window)
        downlink.run(m, seg, window)
        if len(seg.selection.downlink) and \
                faults.segment_corrupted(ctx.rnd, orig_w, p):
            seg.corrupted = True
            ctx.stats.segments_corrupted += 1
            ctx.events.append((orig_w, p, "wasted", seg.bytes_spent))
            if faults.refund_policy == "refund" and seg.bytes_spent > 0.0:
                m.bytes_ledger.spent -= seg.bytes_spent
                m.ledger.refund_downlink(seg.bytes_spent,
                                         m.pcfg.bandwidth_mbps)
                ctx.events.append((orig_w, p, "refunded", seg.bytes_spent))
            if seg.retries < faults.max_retries:
                seg.retries += 1
                seg.eligible_round = ctx.rnd + seg.retries  # linear backoff
                seg.requeued = True
                ctx.requeue.append((m, seg))
                ctx.stats.segments_requeued += 1
            else:
                seg.counts_gd = np.zeros(seg.n)
                ctx.stats.segments_lost += 1
                aggregate.run(m, seg, window)
        else:
            if seg.bytes_spent > 0.0:
                ctx.events.append((orig_w, p, "delivered", seg.bytes_spent))
            recount.run(m, seg, window)
            aggregate.run(m, seg, window)
    return m._window_report(window, segs)


def execute_plan(fleet, plan: ContactPlan, recount_inline: bool = True,
                 fault_ctx: Optional[FaultContext] = None):
    """Run one ContactPlan through the batched core. With
    ``recount_inline=False`` the recount jobs are returned instead of
    run (the :class:`GroundSegment` pipeline's path); ``fault_ctx`` makes
    it a faulty round (see :mod:`repro_torch.core.faults`).

    -> ``(out, jobs)``: ``[(sat, WindowReport), ...]`` in window order,
    and the jobs still to recount (empty when run inline).
    """
    out, jobs = _select_downlink(fleet, plan, fault_ctx)
    if recount_inline and jobs:
        _recount_aggregate(fleet, jobs)
        jobs = []
    return out, jobs


def execute_plan_reference(fleet, plan: ContactPlan,
                           fault_ctx: Optional[FaultContext] = None):
    """The FIFO-loop reference: every window drains sequentially
    through the scalar Mission stage loop (Select -> Downlink ->
    GroundRecount -> Aggregate per segment) — the pre-plan contact tier,
    kept as the parity oracle and the bench baseline the batched
    executor is gated against (max deviation 0.0). A faulty round
    (``fault_ctx``) swaps each window's drain for the fault-aware scalar
    loop, which stays the bit-exact oracle of the fault-aware batched
    path."""
    if fault_ctx is None:
        return [(int(plan.sats[w]),
                 fleet.missions[int(plan.sats[w])].contact_window(
                     plan.window_budget(w)))
                for w in range(plan.n_windows)]
    return [(int(plan.sats[w]),
             _contact_window_faulty(
                 fleet.missions[int(plan.sats[w])], plan.window_budget(w),
                 fault_ctx, int(fault_ctx.orig_windows[w])))
            for w in range(plan.n_windows)]


# ---------------------------------------------------------------------------
# the recount pipeline
# ---------------------------------------------------------------------------

def _stall(seconds: float, cancel: threading.Event) -> None:
    """An injected worker stall: hold the worker ``seconds``, or until
    the watchdog cancels its round (a cancelled worker writes nothing,
    so it need not stall on)."""
    cancel.wait(seconds)


class _InFlightRound:
    """One queued round of the recount pipeline: its dispatch-time work
    snapshot, the injected worker fault and stall, the worker's cancel
    event, thread, exception and wall time (kept per round, so an
    abandoned worker's clock is simply never read), on a CUDA device
    the worker's stream and the foreground event it waits for, and on a
    ``sats`` mesh the launch half's resolvers (``launched``) and, on a
    CUDA device, the event the worker records after its launches
    (``done``), which the foreground's gather waits for."""

    __slots__ = ("work", "fault", "stall_s", "stream", "ready", "cancel",
                 "thread", "err", "worker_s", "launched", "done")

    def __init__(self, work: _RecountWork, fault: Optional[str] = None,
                 stall_s: float = 0.0):
        self.work = work
        self.fault = fault
        self.stall_s = stall_s
        self.stream = None
        self.ready = None
        self.cancel = threading.Event()
        self.thread: Optional[threading.Thread] = None
        self.err: Optional[BaseException] = None
        self.worker_s = 0.0
        self.launched = None
        self.done = None


def _recount_step(rnd: _InFlightRound) -> None:
    """What a worker counts: off a mesh the whole recount; on a ``sats``
    mesh only the launch half, whose resolvers it leaves on the round
    for the foreground, so it issues no collective."""
    if not rnd.work.on_mesh:
        _recount_run(rnd.work, cancel=rnd.cancel)
        return
    rnd.launched = _recount_launch(rnd.work, cancel=rnd.cancel)
    if rnd.done is not None:
        rnd.done.record(rnd.stream)


def _recount_job(rnd: _InFlightRound) -> None:
    """A recount worker's body. It reads only ``rnd``: the snapshot and
    what was resolved at dispatch, never the fleet."""
    t0 = time.perf_counter()
    try:
        if rnd.fault == "crash":
            raise WorkerCrash("injected ground-worker crash")
        if rnd.fault == "stall":
            _stall(rnd.stall_s, rnd.cancel)
        if rnd.stream is None:
            _recount_step(rnd)
        else:
            # the current device and stream are per thread: set both
            with torch.cuda.device(rnd.stream.device), \
                    torch.cuda.stream(rnd.stream):
                rnd.stream.wait_event(rnd.ready)
                try:
                    _recount_step(rnd)
                finally:
                    # idle when the thread ends, even after an error
                    rnd.stream.synchronize()
    except BaseException as e:  # noqa: BLE001 - re-raised at retirement
        rnd.err = e
    finally:
        rnd.worker_s = time.perf_counter() - t0


class GroundSegment:
    """A fleet's contact executor: a bounded depth-``k`` recount pipeline.

    At ``depth=0`` :meth:`execute` runs Select and Downlink batched
    across the round's windows, then the round's recounts and Aggregate
    inline. At ``depth >= 1`` it returns after Select and Downlink (the
    reports and every budget are final) and queues the round's recount
    and Aggregate on a worker thread, so up to ``depth`` rounds' recounts
    run behind whatever the caller does next. When the queue is full the
    oldest round retires (its worker joins, its results land) before the
    new round enters. :meth:`sync` retires every queued round in order;
    ``Fleet.results()``/``finalize()``/``summary()`` call it, so no
    prediction is read while its recount is in flight. Every depth gives
    the same results: each round's work is snapshotted at dispatch
    (:func:`_recount_plan`), a recount reads only its snapshot and
    charges nothing, and concurrent rounds write disjoint segments.

    **The device.** On a CUDA device the workers launch on a
    ``torch.cuda.Stream`` the segment owns (the kernel wrappers and the
    convolutions take the thread's current stream). At dispatch the
    foreground records an event on its own stream, which the worker's
    stream waits for before its first launch, so what the foreground
    queued before the round comes first. A fleet's segments keep no
    tiles on the device: the worker makes the ground tiles it gathers
    from the segments' frames on its own stream
    (:func:`~repro_torch.core.mission.recount_tiles`), so it reads no
    tensor the foreground may free; the index vectors a worker uploads
    are its stream's own (:func:`repro_torch.core.xfer.device_constant`).
    A worker synchronizes its stream before its thread ends, so its
    stream is idle then, and off a mesh its results reached the host by
    the counting's own copies: retirement only joins the thread. On the
    CPU the same code runs without the stream steps.

    **Watchdog** (``watchdog_s``): each retirement joins with that
    timeout; a worker still alive past it is cancelled (it writes
    nothing once its event is set; a hung daemon thread is abandoned)
    and the round's recount runs again synchronously. Recounts charge
    nothing and only overwrite per-segment outputs, so the retry is
    idempotent. An injected :class:`~repro_torch.core.faults.WorkerCrash`
    recovers the same way. Any other worker exception surfaces once, at
    the retirement that finds it, with every ledger lane intact and the
    later rounds still queued.

    **A sats mesh** (the fleet's ``sharding`` on a mesh): every rank
    runs this executor alike. A worker runs only the launch half of its
    round's recount (:func:`_recount_launch`): it counts its rank's
    chunks and issues no collective. The foreground lands the round when
    it retires it: its stream waits for the worker's ``done`` event, the
    resolvers gather each threshold group on the mesh's group, in round
    order, and the ground counts and Aggregate are written there. The
    shards the resolvers hold were allocated on the worker's stream and
    stay alive until the gather's host copy has waited for it. Every
    collective is thus made by the foreground, at retirements that fall
    at the same point of the program on every rank, and the watchdog's
    branch is taken by all ranks or none (one all-reduce), so every rank
    issues the same collectives in the same order. A cancelled worker
    simply stops: nothing it does waits for another rank.

    **Lifecycle**: a clean ``with`` exit syncs; an exceptional one
    calls :meth:`close`, which cancels every queued round and joins each
    worker briefly without raising.

    **Accounting**: ``recount_s`` is the recount wall time (a worker's
    own clock when deferred, the inline time when not; a recovery
    charges the blocked join and the synchronous retry instead of the
    abandoned worker's clock), ``wait_s`` the time the foreground
    blocked on retirement, so ``wait_s <= recount_s`` for every retired
    round, and ``hidden_fraction = 1 - wait_s / recount_s``. On a mesh
    the gather and Aggregate of a retired round run on the foreground:
    they count in both, as foreground wait.
    """

    def __init__(self, fleet, overlap: bool = False,
                 watchdog_s: Optional[float] = None,
                 depth: Optional[int] = None):
        depth = (1 if overlap else 0) if depth is None else int(depth)
        if depth < 0:
            raise ValueError(
                f"GroundSegment: pipeline depth must be >= 0 "
                f"(0 = synchronous), got {depth}")
        # the fleet owns this executor: a weak reference back leaves no
        # cycle, so a dropped fleet frees its segments' device tiles at
        # once rather than at the next cycle collection
        self.fleet = weakref.proxy(fleet)
        self.depth = depth
        self.watchdog_s = watchdog_s
        self._queue: "deque[_InFlightRound]" = deque()
        self._stream = None  # the workers' CUDA stream, made at first use
        self.recount_s = 0.0
        self.wait_s = 0.0
        self.rounds_deferred = 0
        self.max_in_flight = 0

    @property
    def overlap(self) -> bool:
        """True when recounts are deferred at all (depth >= 1)."""
        return self.depth > 0

    @property
    def in_flight(self) -> int:
        """Rounds currently queued in the pipeline."""
        return len(self._queue)

    def execute(self, plan: ContactPlan,
                fault_ctx: Optional[FaultContext] = None):
        # a contact round reads segment state: a pending ingest-overlap
        # tail lands first
        self.fleet._resolve_ingest_pending()
        while self._queue and len(self._queue) >= self.depth:
            # backpressure: the oldest round retires before a new one
            # may enter the bounded pipeline
            self._retire(self._queue.popleft())
        out, jobs = execute_plan(self.fleet, plan,
                                 recount_inline=self.depth == 0,
                                 fault_ctx=fault_ctx)
        if jobs:
            self._dispatch(_recount_plan(self.fleet, jobs), fault_ctx)
        return out

    def _dispatch(self, work: _RecountWork,
                  fault_ctx: Optional[FaultContext]) -> None:
        """Queue one round's recount on a worker (foreground). The
        injected fault is counted here, where the stats are."""
        fault = fault_ctx.worker if fault_ctx is not None else None
        rnd = _InFlightRound(work, fault, fault_ctx.faults.stall_s
                             if fault_ctx is not None else 0.0)
        if fault == "crash":
            fault_ctx.stats.worker_crashes += 1
        elif fault == "stall":
            fault_ctx.stats.worker_stalls += 1
        dev = work.device()
        if dev is not None and dev.type == "cuda":
            if self._stream is None:
                self._stream = torch.cuda.Stream(dev)
            rnd.stream = self._stream
            rnd.ready = torch.cuda.Event()
            rnd.ready.record(torch.cuda.current_stream(dev))
            if work.on_mesh:
                rnd.done = torch.cuda.Event()
        rnd.thread = threading.Thread(target=_recount_job, args=(rnd,),
                                      name="ground-recount", daemon=True)
        self.rounds_deferred += 1
        self._queue.append(rnd)
        self.max_in_flight = max(self.max_in_flight, len(self._queue))
        rnd.thread.start()

    def execute_reference(self, plan: ContactPlan,
                          fault_ctx: Optional[FaultContext] = None):
        self.sync()
        return execute_plan_reference(self.fleet, plan, fault_ctx=fault_ctx)

    def sync(self) -> None:
        """Retire every queued round in order (each join bounded by the
        watchdog when one is set): recover injected crashes and
        watchdog-cancelled rounds synchronously, and raise a real worker
        exception once, leaving later rounds queued for the next sync."""
        self.fleet._resolve_ingest_pending()
        while self._queue:
            self._retire(self._queue.popleft())

    def _retire(self, rnd: _InFlightRound) -> None:
        t0 = time.perf_counter()
        rnd.thread.join(self.watchdog_s)
        waited = time.perf_counter() - t0
        alive = rnd.thread.is_alive()
        if self.watchdog_s is not None:
            # on a sats mesh every rank takes the same branch
            alive = self.fleet.sharding.agree(alive)
        if alive:
            # watchdog: cancel the worker (it writes nothing from now on)
            # and take the round over synchronously
            rnd.cancel.set()
            self._recover(rnd, waited)
            return
        if isinstance(rnd.err, WorkerCrash):
            self._recover(rnd, waited)
            return
        landed = 0.0
        if rnd.err is None and rnd.launched is not None:
            # a sats mesh: the round's gathers and write-backs, here
            t0 = time.perf_counter()
            if rnd.done is not None:
                torch.cuda.current_stream(rnd.stream.device).wait_event(rnd.done)
            _recount_land(rnd.work, rnd.launched)
            landed = time.perf_counter() - t0
        self.wait_s += waited + landed
        self.recount_s += max(rnd.worker_s, waited) + landed
        if rnd.err is not None:
            # a real failure, raised once; recounts charge nothing, so
            # every ledger lane is intact
            raise rnd.err

    def _recover(self, rnd: _InFlightRound, waited: float) -> None:
        """Recount a crashed or abandoned round again, synchronously, on
        the foreground (idempotent: recounts only write per-segment
        outputs). The whole recovery blocks, so it lands in both
        ``wait_s`` and ``recount_s``, and the worker's clock is not
        read."""
        self.fleet.fault_stats.watchdog_recoveries += 1
        t0 = time.perf_counter()
        _recount_run(rnd.work)
        blocked = waited + (time.perf_counter() - t0)
        self.wait_s += blocked
        self.recount_s += blocked

    def close(self) -> None:
        """Release every queued round without surfacing results or
        errors: cancel each, join each worker briefly (a hung daemon
        thread is abandoned), drop the work. Idempotent; never raises."""
        rounds, self._queue = list(self._queue), deque()
        for rnd in rounds:
            rnd.cancel.set()
        for rnd in rounds:
            if rnd.thread is not None and rnd.thread.is_alive():
                rnd.thread.join(
                    self.watchdog_s if self.watchdog_s is not None else 5.0)

    def __enter__(self) -> "GroundSegment":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self.sync()
        else:
            self.close()
        return False

    @property
    def hidden_fraction(self) -> float:
        """Share of the deferred recount time hidden behind foreground
        work (0.0 when nothing was deferred)."""
        if not self.rounds_deferred or self.recount_s <= 0.0:
            return 0.0
        return max(1.0 - self.wait_s / self.recount_s, 0.0)
