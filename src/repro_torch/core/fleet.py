"""Fleet engine: a constellation's Missions run as one batched program.

Counterpart of ``repro/core/fleet.py``. A :class:`Fleet` owns the
budget state of N satellites as stacked arrays (one
:class:`~repro_torch.core.energy.FleetLedger`) and runs the Mission
ingest stages for the whole constellation in shared calls:

* Capture: every satellite's frames share frame buckets
  (:func:`repro_torch.core.engine.prepare_frames_multi`);
* admission: the day-fraction grants and capture charges are one
  vectorized ledger op;
* Dedup: every satellite's clustering runs as a lane of one lane batch
  per shape bucket (:func:`repro_torch.core.dedup.dedup_multi`: one
  ``kmeanspp_seed_lanes_f32`` launch for the seeding, one
  ``kmeans_assign_lanes_f32`` launch a Lloyd step and one for the final
  assignment), with no per-satellite k-means launch;
* OnboardCount: every satellite's representatives are counted in
  shared fixed-shape batches
  (:func:`repro_torch.core.cascade.count_tiles_multi`).

RoiFilter and Select's bookkeeping stay per satellite on the host.
Contact rounds run the batched ContactPlan core
(:mod:`repro_torch.core.contact`): Select as lane-stacked
``select_batch`` calls across a round's windows, Downlink through
vectorized ledger ops, and every window's ground recount in shared
counting batches, inline or (``async_depth >= 1``) on the ground
segment's worker threads. Each lane's arithmetic is the looped
Mission's, so a Fleet equals N independent
:class:`~repro_torch.core.mission.Mission` objects (:func:`run_scenario`
with ``fleet=False``) per satellite, at every depth. A satellite on the
reference path (``use_engine=False``) leaves the lanes: it takes its
Mission's sequential ingest and scalar contact window.

A batched segment keeps no tiles on the device once its ingest ends:
its space tiles go after OnboardCount, and a recount makes the ground
tiles it gathers from the segment's frames
(:func:`~repro_torch.core.mission.recount_tiles`). The card
holds one round's working set, not the backlog of segments waiting for
a contact window, so a round that repeats the last one's shapes
allocates nothing new.

The fleet runs on one device (the reference's ``mesh`` and
``strict_parity`` options are not ported: every lane here already
equals its one-lane Mission bit for bit).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import repro_torch.core.dedup as dd
from repro_torch.core import engine, xfer
from repro_torch.core.cascade import count_tiles_multi
from repro_torch.core.contact import ContactPlan, GroundSegment
from repro_torch.core.energy import (FleetLedger, max_tiles_within_budget,
                                     max_tiles_within_budget_vec)
from repro_torch.core.faults import FaultContext, FaultPlan, FaultStats
from repro_torch.core.fleet_sharding import FleetSharding
from repro_torch.core.mission import (Capture, IngestReport, Mission, Segment,
                                      WindowReport)
from repro_torch.core.pipeline import PipelineConfig, PipelineResult
from repro_torch.device import resolve_device
from repro_torch.models import detector


class Fleet:
    """N-satellite constellation over one counter pair, on one device.

    Parameters
    ----------
    space, ground : (params, cfg) counter pairs shared by the fleet (the
        params are moved to ``device`` once and shared by every Mission).
    pcfg : one :class:`PipelineConfig` (replicated) or a sequence of N
        per-satellite configs; ``use_engine=False`` falls that satellite
        back to its Mission's sequential path, in ingest and contact.
    n_sats : fleet size when ``pcfg`` is a single config.
    energy_cfgs : as for :class:`Mission` (compute pricing), shared.
    async_ground : ``True`` overlaps each round's ground recount with
        what the caller does next (a depth-1 pipeline).
    async_depth : the recount pipeline's depth: up to ``k`` rounds'
        recounts in flight on worker threads (0 = inline; ``None``
        follows ``async_ground``). Every depth gives the same results.
    watchdog_s : optional timeout of each recount worker's retirement;
        a worker still running past it is cancelled and its round
        recounted synchronously (the same results).
    ingest_overlap : ``True`` defers each round's device-to-host fetches
        (the ROI rows, the dedup results, the counting results) and the
        ledger charges that follow them to the next resolution boundary
        (the next ``ingest``, a contact round, ``results``/``finalize``/
        ``summary``, a clean ``with`` exit), after the next round's frame
        buckets are launched. Each lane's float64 ledger sequence is the
        synchronous one, so the results are equal.
    contact_reference : ``True`` runs every contact round (the
        ``finalize`` flush too) through the FIFO reference.
    faults : optional :class:`~repro_torch.core.faults.FaultPlan`;
        ``None`` and ``FaultPlan.none()`` are bit-equal to the fault-free
        run. Blackouts key on the ingest-call counter, contact faults on
        the contact-round counter; the ``finalize`` flush is never
        faulted.
    device : "cuda" (default; raises without a card) or "cpu".
    """

    def __init__(self, space, ground, pcfg=None, n_sats: Optional[int] = None,
                 energy_cfgs=None, async_ground: bool = False,
                 contact_reference: bool = False,
                 faults: Optional[FaultPlan] = None,
                 watchdog_s: Optional[float] = None,
                 async_depth: Optional[int] = None,
                 ingest_overlap: bool = False, device="cuda"):
        if async_depth is not None and int(async_depth) < 0:
            raise ValueError(
                f"Fleet: async_depth must be >= 0 (0 = synchronous "
                f"recount, k = up to k rounds' recounts in flight), "
                f"got {async_depth}")
        if async_depth is not None and async_ground and int(async_depth) == 0:
            raise ValueError(
                "async_ground=True conflicts with async_depth=0 "
                "(a synchronous pipeline cannot overlap)")
        self.ground_segment = GroundSegment(self, overlap=async_ground,
                                            watchdog_s=watchdog_s,
                                            depth=async_depth)
        if isinstance(pcfg, (list, tuple)):
            pcfgs = list(pcfg)
            if n_sats is not None and n_sats != len(pcfgs):
                raise ValueError(
                    f"n_sats={n_sats} conflicts with {len(pcfgs)} "
                    f"per-satellite configs")
            n_sats = len(pcfgs)
        else:
            n_sats = 1 if n_sats is None else n_sats
            pcfgs = [pcfg if pcfg is not None else PipelineConfig()
                     for _ in range(n_sats)]
        if n_sats < 1:
            raise ValueError("a fleet needs at least one satellite")
        if not isinstance(ingest_overlap, bool) and ingest_overlap < 0:
            raise ValueError(
                f"Fleet: ingest_overlap must be a bool (True = defer "
                f"each round's device->host fetches behind the next "
                f"round's dispatch), got {ingest_overlap}")
        self.device = resolve_device(device)
        self.n_sats = n_sats
        self.sharding = FleetSharding()
        self.space = (detector.to_device(space[0], self.device), space[1])
        self.ground = (detector.to_device(ground[0], self.device), ground[1])
        self.missions = [Mission(self.space, self.ground, p,
                                 energy_cfgs=energy_cfgs, device=self.device)
                         for p in pcfgs]
        # every Mission's ledgers are views of a lane of ONE stacked
        # fleet ledger, so fleet-wide grants and charges are one op
        self.ledger = FleetLedger(n_sats, n_lanes=self.sharding.pad(n_sats))
        for i, m in enumerate(self.missions):
            m.ledger = self.ledger.energy_view(i)
            m.bytes_ledger = self.ledger.bytes_view(i)
        self._station = 0  # rotating contact-window pointer
        # reference-path satellites leave the lanes, ingest and contact
        self._batchable = [m.pcfg.use_engine for m in self.missions]
        self.contact_reference = bool(contact_reference)
        self.ingest_overlap = bool(ingest_overlap)
        # ingest pipeline state: at most ONE round's ledger tail and one
        # round's counting fetches are pending at any time
        self._ingest_tail = None          # (finish_fn, dispatch_time)
        self._pending_counts: List[Tuple] = []  # [(fetch_fn, dispatch_time)]
        self._ingest_rounds_deferred = 0
        # per-stage ingest timing (host clocks; host_fetch_s <=
        # device_compute_s, both 0.0 when synchronous)
        self._ingest_dispatch_s = 0.0  # foreground dispatch wall
        self._device_compute_s = 0.0   # cumulative deferred in-flight wall
        self._host_fetch_s = 0.0       # foreground wall blocked resolving
        self._ingest_s = 0.0       # cumulative ingest wall time
        self._tiles_ingested = 0   # for summary() throughput
        self._contact_s = 0.0      # cumulative contact-round wall time
        self._windows_served = 0   # across all contact rounds
        self.faults = faults
        self.fault_stats = FaultStats()
        self._faults_active = faults is not None and not faults.empty
        self._ingest_round = 0     # blackout draws key on this counter
        self._fault_round = 0      # contact-tier draws key on this one
        self._suppress_faults = False  # the finalize flush is never faulted

    # -- streaming API ------------------------------------------------------

    def ingest(self, frames_per_sat: Sequence,
               energy_budgets_j: Optional[Sequence] = None
               ) -> List[IngestReport]:
        """One orbital pass for every satellite, constellation-batched.

        ``frames_per_sat[i]`` is satellite *i*'s frame list for this
        round (may be empty); ``energy_budgets_j[i]`` optionally
        overrides its harvest grant (eclipse/sunlit profiles). Returns
        per-satellite :class:`IngestReport`\\ s identical to calling
        ``Mission.ingest`` satellite by satellite.

        With ``ingest_overlap=True`` the returned reports' deferred
        fields (``tiles_processed_space``, ``energy_remaining_j``) are
        finalized at the round's resolution boundary — the next
        ``ingest``/contact/``results`` call — while the eager fields
        (``n_tiles``, grants, entitlements) are always final on return.
        """
        t0 = time.perf_counter()
        fetch0 = self._host_fetch_s
        if len(frames_per_sat) != self.n_sats:
            raise ValueError(
                f"expected {self.n_sats} frame lists, got {len(frames_per_sat)}")
        if energy_budgets_j is None:
            energy_budgets_j = [None] * self.n_sats
        elif len(energy_budgets_j) != self.n_sats:
            raise ValueError(
                f"expected {self.n_sats} energy budgets, "
                f"got {len(energy_budgets_j)}")
        reports: List[Optional[IngestReport]] = [None] * self.n_sats

        blackouts = frozenset()
        if self._faults_active:
            blackouts = frozenset(
                i for i in range(self.n_sats)
                if self.faults.blackout(self._ingest_round, i))
            self.fault_stats.blackout_passes += len(blackouts)
        batched = [i for i in range(self.n_sats)
                   if self._batchable[i] and frames_per_sat[i]
                   and i not in blackouts]
        if self._ingest_tail is not None and len(batched) < self.n_sats:
            # some satellite takes the sequential Mission path this
            # round (empty pass, reference path, blackout): its ledger ops
            # must come AFTER the pending round's deferred charges on
            # the same lanes, so the tail resolves before the loop —
            # frame prep of fully-batched rounds still overlaps it
            self._resolve_ingest_tail()
        for i in range(self.n_sats):
            if i in blackouts:
                # satellite brownout: the pass is skipped entirely (zero
                # harvest, no segment, no capture charge)
                reports[i] = self.missions[i].ingest(
                    frames_per_sat[i], energy_budget_j=energy_budgets_j[i],
                    blackout=True)
            elif i not in batched:
                # empty passes and reference-path satellites take the
                # exact sequential Mission path
                reports[i] = self.missions[i].ingest(
                    frames_per_sat[i], energy_budget_j=energy_budgets_j[i])
        if batched:
            self._ingest_batched(batched, frames_per_sat, energy_budgets_j,
                                 reports)
        self._ingest_round += 1
        dt = time.perf_counter() - t0
        self._ingest_s += dt
        # dispatch time = this call's wall minus whatever it spent
        # blocked resolving deferred fetches (0 in synchronous mode)
        self._ingest_dispatch_s += max(
            dt - (self._host_fetch_s - fetch0), 0.0)
        self._tiles_ingested += sum(r.n_tiles for r in reports
                                    if r is not None)
        return reports  # type: ignore[return-value]

    def _ingest_batched(self, sats, frames_per_sat, energy_budgets_j,
                        reports):
        sp_size = self.space[1].input_size
        gd_size = self.ground[1].input_size
        overlap = self.ingest_overlap
        t_dispatch = time.perf_counter()

        # --- Capture.prepare: shared frame buckets across the fleet ---
        segs: Dict[int, Segment] = {}
        by_tile: Dict[int, List[int]] = {}
        for i in sats:
            by_tile.setdefault(self.missions[i].pcfg.tile_size, []).append(i)
        for tile_size, ids in by_tile.items():
            # the shared buckets compute moments/ROI stats only if some
            # satellite in the group consumes them (tiles are identical
            # either way, so bucket sharing stays exact)
            stats = any(
                (self.missions[i].pcfg.use_roi
                 and self.missions[i].policy.wants_roi)
                or (self.missions[i].pcfg.use_dedup
                    and self.missions[i].policy.wants_dedup) for i in ids)
            preps = engine.prepare_frames_multi(
                [frames_per_sat[i] for i in ids], tile_size, sp_size, gd_size,
                with_stats=stats, defer_stats=overlap, device=self.device)
            for i, prep in zip(ids, preps):
                seg = Segment(frames=list(frames_per_sat[i]),
                              energy_grant_override=energy_budgets_j[i])
                # a pending segment keeps no ground tiles on the device:
                # a recount makes those it downlinks again from the frames
                seg.hold(prep, ground=False)
                segs[i] = seg

        if overlap:
            # double-buffered round boundary: the PREVIOUS round's
            # deferred tail resolves only now — with this round's frame
            # buckets already enqueued behind its programs on the device
            # — and strictly before this round's grants, so every lane's
            # float64 ledger sequence is the synchronous one. Counting
            # fetches dispatched by that tail's predecessor drain first
            # (they touch no ledger; draining bounds pending work at one
            # round of counts + one tail).
            self._drain_count_fetches()
            self._resolve_ingest_tail()

        # --- Capture.admit, with the ledger ops lifted out: the fleet
        # grants every satellite's entitlement in one vectorized op ---
        evec = np.zeros(self.ledger.n_lanes, np.float64)
        fvec = np.zeros(self.ledger.n_lanes, np.float64)
        for i in sats:
            m, seg = self.missions[i], segs[i]
            evec[i] = Capture.entitle(m, seg)
            fvec[i] = len(seg.frames)
            Capture.init_state(m, seg)
        self.ledger.grant(evec)
        self.ledger.charge_capture(fvec)

        # --- RoiFilter: per-satellite host masks over the fused stats
        # (under overlap, roi_std is a lazy device slice — materialized
        # here only for satellites whose policy actually reads it) ---
        for i in sats:
            m, seg = self.missions[i], segs[i]
            if overlap:
                self._materialize_roi(m, seg)
            m.ingest_stages[1].run(m, seg)  # RoiFilter
        # --- Dedup: one lane batch per shape bucket ---
        dedup_fetch = nops = None
        if overlap:
            dedup_fetch, nops = self._dedup_batched(sats, segs, defer=True)
        else:
            self._dedup_batched(sats, segs)

        # --- OnboardCount: fleet-shared fixed-shape counting batches ---
        count_sats = [i for i in sats
                      if self.missions[i].policy.wants_onboard]
        if overlap:
            def finish():
                # the deferred round tail — runs at the next resolution
                # boundary. Ledger op order per lane matches the
                # synchronous path exactly: charge_aggregate lands
                # before the cap read + charge_compute, and the whole
                # tail lands before any LATER round's grant.
                if nops is not None:
                    self.ledger.charge_aggregate(nops)
                if dedup_fetch is not None:
                    dedup_fetch()  # seg.rep_of writes (no ledger)
                self._onboard_count_batched(count_sats, segs, defer=True)
                for seg in segs.values():
                    seg.tiles_sp = None  # OnboardCount was their last reader
                for i in sats:
                    m, seg = self.missions[i], segs[i]
                    reports[i].tiles_processed_space = seg.n_processed
                    reports[i].energy_remaining_j = m.ledger.remaining
            self._ingest_tail = (finish, t_dispatch)
            self._ingest_rounds_deferred += 1
        else:
            self._onboard_count_batched(count_sats, segs)
            for seg in segs.values():
                seg.tiles_sp = None  # OnboardCount was their last reader

        for i in sats:
            m, seg = self.missions[i], segs[i]
            m._segments.append(seg)
            m._pending.append(seg)
            m._finalized = False
            reports[i] = IngestReport(
                n_frames=len(seg.frames), n_tiles=seg.n,
                tiles_processed_space=seg.n_processed,
                energy_granted_j=seg.energy_granted_j,
                energy_remaining_j=m.ledger.remaining,
                byte_entitlement=seg.byte_entitlement)

    # -- ingest-overlap resolution boundaries ------------------------------

    def _resolve_ingest_tail(self):
        """Run the previous round's deferred ledger/fetch tail (no-op
        when nothing is pending). Cleared before running so a raising
        tail can never re-fire at the next boundary."""
        tail = self._ingest_tail
        if tail is None:
            return
        self._ingest_tail = None
        fn, t_disp = tail
        t1 = time.perf_counter()
        fn()
        t2 = time.perf_counter()
        self._host_fetch_s += t2 - t1
        self._device_compute_s += t2 - t_disp

    def _drain_count_fetches(self):
        """Resolve every parked counting-batch fetch. These touch no
        ledger lanes, so drain order is free — but draining before the
        tail resolves bounds pending work at one round's counts plus
        one round's tail."""
        pend, self._pending_counts = self._pending_counts, []
        for fn, t_disp in pend:
            t1 = time.perf_counter()
            fn()
            t2 = time.perf_counter()
            self._host_fetch_s += t2 - t1
            self._device_compute_s += t2 - t_disp

    def _resolve_ingest_pending(self):
        """Full resolution boundary: tail first (it dispatches this
        round's counting batches), then all parked count fetches.
        Called by GroundSegment entry points, results(), and summary()
        so no reader ever observes a half-finished round."""
        self._resolve_ingest_tail()
        self._drain_count_fetches()

    def _materialize_roi(self, m, seg):
        """Fetch a satellite's deferred ``roi_std`` device slice to host
        (overlap mode hands out lazy slices from the fused stats
        program). Only satellites whose policy actually reads ROI pay
        the copy; the blocked time counts as both host-fetch and
        device-compute wall (the fetch IS the in-flight window here)."""
        prep = getattr(seg, "prep", None)
        if prep is None or prep.roi_std is None:
            return
        if isinstance(prep.roi_std, np.ndarray):
            return
        if not (m.pcfg.use_roi and m.policy.wants_roi) or not seg.n:
            return
        t1 = time.perf_counter()
        prep.roi_std = prep.roi_std.cpu().numpy()
        t2 = time.perf_counter()
        self._host_fetch_s += t2 - t1
        self._device_compute_s += t2 - t1

    def _dedup_batched(self, sats, segs, defer=False):
        """Mission.Dedup with the per-satellite loop lifted into
        :func:`repro_torch.core.dedup.dedup_multi`: every satellite's
        padded moment gather joins one lane batch per shape bucket. Skip
        conditions, cluster counts, gathers, seeds and the aggregation
        charge are the sequential stage's.

        With ``defer=True`` the lanes are launched but the device-to-host
        fetch and the ``seg.rep_of`` writes move into a returned closure,
        and the aggregation charge is left to the caller (``nops``, the
        second return value), so the ledger op lands before the fetch
        blocks. -> ``(fetch_fn, nops)``, both None when no satellite
        deduped.
        """
        parts, ids = [], []
        nops = np.zeros(self.ledger.n_lanes, np.float64)
        for i in sats:
            m, seg = self.missions[i], segs[i]
            pcfg = m.pcfg
            if (not (pcfg.use_dedup and m.policy.wants_dedup)
                    or seg.active.sum() <= 4):
                continue
            k = pcfg.k_clusters or max(2, int(seg.active.sum()) // 2)
            idx_active = np.where(seg.active)[0]
            n_act = len(idx_active)
            idx_pad = np.zeros(dd.dedup_pad_size(n_act), np.int64)
            idx_pad[:n_act] = idx_active
            parts.append((seg.prep.moments.index_select(
                0, xfer.device_constant(idx_pad, self.device)), k, pcfg.seed, n_act))
            ids.append((i, idx_active))
            nops[i] = n_act
        if not parts:
            return (None, None) if defer else None
        results = dd.dedup_multi(parts)

        def fetch():
            for (i, idx_active), res in zip(ids, results):
                assign = res.assign.cpu().numpy()
                rep_local = res.rep_idx.cpu().numpy()
                segs[i].rep_of[idx_active] = idx_active[rep_local[assign]]
        if defer:
            return fetch, nops
        fetch()
        self.ledger.charge_aggregate(nops)
        return None

    def _onboard_count_batched(self, sats, segs, defer=False):
        """Mission.OnboardCount semantics, with every satellite's
        energy-capped representative set counted in shared batches.
        With ``defer=True`` the rep selection and compute charge still
        happen eagerly (they feed the ledger and reports), but each
        counting batch's device->host fetch is parked on
        ``self._pending_counts`` for a later resolution boundary."""
        if not sats:
            return
        # energy caps and compute spends are vectorized over the stacked
        # ledger when the fleet shares one pricing profile (lanes are
        # independent, so reading all caps before charging is exact);
        # heterogeneous hardware falls back to identical per-lane floats
        profiles = {(self.missions[i].gflops_space,
                     self.missions[i].pcfg.hardware) for i in sats}
        uniform = len(profiles) == 1
        caps = None
        if uniform:
            (gflops, hw), = profiles
            caps = max_tiles_within_budget_vec(self.ledger.remaining * 0.95,
                                               gflops, hw)
        process: Dict[int, np.ndarray] = {}
        nproc = np.zeros(self.ledger.n_lanes, np.float64)
        for i in sats:
            m, seg = self.missions[i], segs[i]
            reps = np.unique(seg.rep_of[seg.active])
            cap = (int(caps[i]) if caps is not None else
                   max_tiles_within_budget(m.ledger.remaining * 0.95,
                                           m.gflops_space, m.pcfg.hardware))
            process[i] = reps[:cap] if len(reps) > cap else reps
            seg.n_processed = len(process[i])
            nproc[i] = seg.n_processed
        if uniform:
            self.ledger.charge_compute(nproc, gflops, hw)
        else:
            for i in sats:
                m = self.missions[i]
                m.ledger.charge_compute(segs[i].n_processed, m.gflops_space,
                                        m.pcfg.hardware)

        # shared-batch forward per distinct (score_thresh,) group
        by_thresh: Dict[float, List[int]] = {}
        for i in sats:
            by_thresh.setdefault(self.missions[i].pcfg.score_thresh,
                                 []).append(i)
        params, cfg = self.space
        for thresh, ids in by_thresh.items():
            parts = [(segs[i].tiles_sp, process[i]) for i in ids]
            out = count_tiles_multi(params, cfg, parts, score_thresh=thresh,
                                    defer=defer)
            if defer:
                # `out` is the resolve closure: the batch is enqueued on
                # the device; the single host fetch + write-back parks
                # until a resolution boundary (no ledger ops inside)
                self._pending_counts.append((
                    lambda resolve=out, ids=ids, process=process:
                        self._apply_counts(ids, segs, process, resolve()),
                    time.perf_counter()))
            else:
                self._apply_counts(ids, segs, process, out)

    def _apply_counts(self, ids, segs, process, results):
        """Write one counting batch's (counts, conf) back onto its
        segments — identical to the sequential stage's scatter."""
        for i, (c, f) in zip(ids, results):
            seg = segs[i]
            counts_sp = np.zeros(seg.n)
            conf = np.full(seg.n, -1.0)
            if seg.n_processed:
                counts_sp[process[i]] = c
                conf[process[i]] = f
            seg.counts_sp = counts_sp[seg.rep_of]
            seg.conf = conf[seg.rep_of]
            seg.processed = np.isin(seg.rep_of, process[i]) & seg.active

    def _resolve_plan(self, windows, stations, budget_bytes, plan
                      ) -> ContactPlan:
        """Normalize the three contact-round input shapes into ONE
        validated :class:`~repro_torch.core.contact.ContactPlan` (malformed
        windows fail here, at plan-build time, not deep in the drain)."""
        if plan is not None:
            if windows is not None:
                raise ValueError("pass either plan= or windows=, not both")
            if plan.n_sats != self.n_sats:
                raise ValueError(
                    f"plan is for a {plan.n_sats}-satellite fleet; this "
                    f"fleet has {self.n_sats}")
            return plan
        if windows is not None:
            return ContactPlan.build(windows, self.n_sats)
        plan, self._station = ContactPlan.rotating(
            self.n_sats, stations, start=self._station,
            budget_bytes=budget_bytes)
        return plan

    # -- fault-round lifecycle ---------------------------------------------

    def _begin_fault_round(self, plan: ContactPlan):
        """Open one faulty contact round: repair the plan (drop dead
        windows, fold their budgets forward), park re-queued segments
        whose retry backoff hasn't elapsed, and build the
        :class:`~repro_torch.core.faults.FaultContext` both executors consume.
        Returns ``(plan, None)`` untouched when faults are off (a single
        cached-bool test — the <2% disabled-path overhead gate)."""
        if not self._faults_active or self._suppress_faults:
            return plan, None
        rnd = self._fault_round
        repaired = self.faults.repair(plan, rnd, self.fault_stats)
        ctx = FaultContext(
            faults=self.faults, rnd=rnd,
            orig_windows=repaired.orig_windows, stats=self.fault_stats,
            worker=(self.faults.worker_fault(rnd)
                    if self.ground_segment.overlap else None))
        for m in self.missions:
            if not m._pending:
                continue
            hold = [s for s in m._pending
                    if s.requeued and s.eligible_round > rnd]
            if hold:
                m._pending = [s for s in m._pending if not
                              (s.requeued and s.eligible_round > rnd)]
                ctx.held.append((m, hold))
        return repaired.plan, ctx

    def _end_fault_round(self, ctx: Optional[FaultContext]) -> None:
        """Close a faulty round: re-queue held + newly-failed segments at
        the FRONT of their mission's pending FIFO (they are the oldest
        data, ordered by ingest), and fold the round's byte-flow events
        into the fault counters in canonical ``(window, pos)`` order so
        summaries are executor-order independent. Runs in a ``finally``:
        a mid-round exception can never strand a parked segment, so
        ``finalize()`` stays safe afterwards."""
        if ctx is None:
            return
        per_m: Dict[int, Tuple[Mission, list]] = {}
        for m, hold in ctx.held:
            per_m.setdefault(id(m), (m, []))[1].extend(hold)
        for m, seg in ctx.requeue:
            per_m.setdefault(id(m), (m, []))[1].append(seg)
        for m, group in per_m.values():
            order = {id(s): k for k, s in enumerate(m._segments)}
            group.sort(key=lambda s: order[id(s)])
            m._pending[:0] = group
        stats = self.fault_stats
        for _, _, kind, amt in sorted(ctx.events,
                                      key=lambda e: (e[0], e[1], e[2])):
            if kind == "delivered":
                stats.bytes_delivered += amt
            elif kind == "refunded":
                stats.bytes_refunded += amt
            elif kind == "wasted":
                stats.bytes_wasted += amt
        self._fault_round += 1

    def contact_round(self, windows: Optional[Sequence[Tuple[int, float]]]
                      = None, stations: int = 1,
                      budget_bytes: Optional[float] = None, *,
                      plan: Optional[ContactPlan] = None
                      ) -> List[Tuple[int, WindowReport]]:
        """One ground-contact round, executed by the batched ContactPlan
        core (:mod:`repro_torch.core.contact`).

        Pass a declarative ``plan`` (explicit windows, a scenario
        round's contact events via
        :meth:`ContactPlan.from_contacts`, or any builder output); or
        the legacy shapes — explicit ``windows`` as
        ``[(sat, budget_bytes), ...]``, or the rotating default: the
        next ``stations`` satellites (round-robin from the rotating
        pointer) each get a window of ``budget_bytes`` (None = their
        pending entitlement; with more stations than satellites the
        rotation wraps, so a satellite can get several windows in one
        round). Each window drains that satellite's pending passes FIFO
        through its selection policy: Select runs as lane-stacked
        ``select_batch`` calls across the round's windows, Downlink
        charges through vectorized ledger ops, and the ground recounts
        share fixed-shape counting batches. Bit-equal to draining each
        window through the scalar stage loop
        (:meth:`contact_round_reference`).
        Returns ``[(sat, WindowReport), ...]`` in window order.
        """
        if self.contact_reference:  # constructor-pinned reference mode
            return self.contact_round_reference(
                windows, stations, budget_bytes, plan=plan)
        plan = self._resolve_plan(windows, stations, budget_bytes, plan)
        plan, ctx = self._begin_fault_round(plan)
        t0 = time.perf_counter()
        try:
            out = self.ground_segment.execute(plan, fault_ctx=ctx)
        finally:
            self._end_fault_round(ctx)
        self._contact_s += time.perf_counter() - t0
        self._windows_served += plan.n_windows
        return out

    def contact_round_reference(
            self, windows: Optional[Sequence[Tuple[int, float]]] = None,
            stations: int = 1, budget_bytes: Optional[float] = None, *,
            plan: Optional[ContactPlan] = None
            ) -> List[Tuple[int, WindowReport]]:
        """:meth:`contact_round` through the FIFO-loop reference path:
        every window drains sequentially through the scalar Mission
        stage loop. The parity oracle (and bench baseline) the batched
        planner is gated against at 0.0 deviation."""
        plan = self._resolve_plan(windows, stations, budget_bytes, plan)
        plan, ctx = self._begin_fault_round(plan)
        t0 = time.perf_counter()
        try:
            out = self.ground_segment.execute_reference(plan, fault_ctx=ctx)
        finally:
            self._end_fault_round(ctx)
        self._contact_s += time.perf_counter() - t0
        self._windows_served += plan.n_windows
        return out

    def finalize(self) -> List[PipelineResult]:
        """Flush every satellite's pending passes through zero-byte
        windows (onboard results land, nothing transmits) in one batched
        contact round, then aggregate per satellite.

        The flush is NEVER faulted: re-queued segments still waiting out
        their retry backoff (and everything else pending) drain here, so
        only permanently-lost transmissions end without ground credit."""
        pend = [i for i in range(self.n_sats) if self.missions[i]._pending]
        if pend:
            self._suppress_faults = True
            try:
                self.contact_round(windows=[(i, 0.0) for i in pend])
            finally:
                self._suppress_faults = False
        for m in self.missions:
            m._finalized = True
        return self.results()

    def close(self) -> None:
        """Tear down without resolving deferred work: any ingest-overlap
        tail or parked count fetch is dropped, not run, and the ground
        segment's queued rounds are cancelled
        (:meth:`GroundSegment.close`). Idempotent; never raises."""
        self._ingest_tail = None
        self._pending_counts = []
        self.ground_segment.close()

    def __enter__(self) -> "Fleet":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self.ground_segment.sync()
        else:
            self.close()
        return False

    def results(self) -> List[PipelineResult]:
        self.ground_segment.sync()  # deferred recounts land before reads
        return [m.result() for m in self.missions]

    @property
    def pending_segments(self) -> List[int]:
        return [m.pending_segments for m in self.missions]

    def summary(self) -> dict:
        """Fleet-aggregate scalars (per-satellite results summed) and the
        run's facts: whether ingest ran the batched dedup, ingest
        throughput (host wall time of :meth:`ingest` calls), the contact
        tier's wall time and window/byte throughput, the recount
        pipeline's accounting (``recount_wait_s <= recount_s``), and the
        ingest pipeline's stage
        times: ``ingest_dispatch_s`` (foreground launch time),
        ``host_fetch_s`` (foreground time blocked on deferred fetches),
        ``device_compute_s`` (the deferred work's dispatch-to-fetch wall)
        and ``ingest_hidden_frac = 1 - host_fetch_s / device_compute_s``.
        Side-effect-free: two consecutive calls return equal dicts."""
        rs = self.results()
        tps = (self._tiles_ingested / self._ingest_s
               if self._ingest_s > 0 else 0.0)
        gseg = self.ground_segment
        assert gseg.wait_s <= gseg.recount_s, (
            f"recount accounting invariant broken: wait_s={gseg.wait_s} "
            f"> recount_s={gseg.recount_s}")
        assert self._host_fetch_s <= self._device_compute_s, (
            f"ingest accounting invariant broken: host_fetch_s="
            f"{self._host_fetch_s} > device_compute_s="
            f"{self._device_compute_s}")
        hidden = (max(1.0 - self._host_fetch_s / self._device_compute_s, 0.0)
                  if self._device_compute_s > 0 else 0.0)
        bytes_spent = float(self.ledger.bytes_spent[:self.n_sats].sum())
        return {
            "n_sats": self.n_sats,
            "n_devices": self.sharding.n_devices,
            "dedup_batched": True,
            "ingest_s": self._ingest_s,
            "tiles_per_s": tps,
            "tiles_per_s_per_sat": tps / self.n_sats,
            "ingest_overlap": self.ingest_overlap,
            "ingest_rounds_deferred": self._ingest_rounds_deferred,
            "ingest_dispatch_s": self._ingest_dispatch_s,
            "device_compute_s": self._device_compute_s,
            "host_fetch_s": self._host_fetch_s,
            "ingest_hidden_frac": hidden,
            "contact_s": self._contact_s,
            "windows_served": self._windows_served,
            "windows_per_s": (self._windows_served / self._contact_s
                              if self._contact_s > 0 else 0.0),
            "bytes_downlinked_per_s": (bytes_spent / self._contact_s
                                       if self._contact_s > 0 else 0.0),
            "async_ground": gseg.overlap,
            "async_depth": gseg.depth,
            "recount_rounds_deferred": gseg.rounds_deferred,
            "recount_max_in_flight": gseg.max_in_flight,
            "recount_s": gseg.recount_s,
            "recount_wait_s": gseg.wait_s,
            "recount_hidden_frac": gseg.hidden_fraction,
            "total_true": sum(r.total_true for r in rs),
            "total_pred": sum(r.total_pred for r in rs),
            "tiles_total": sum(r.tiles_total for r in rs),
            "tiles_processed_space": sum(r.tiles_processed_space for r in rs),
            "tiles_downlinked": sum(r.tiles_downlinked for r in rs),
            "bytes_spent": bytes_spent,
            "bytes_budget": float(self.ledger.bytes_budget[:self.n_sats].sum()),
            "energy_spent_j": float(self.ledger.spent[:self.n_sats].sum()),
            "energy_budget_j": float(self.ledger.budget_j[:self.n_sats].sum()),
            "faults_active": self._faults_active,
            **self.fault_stats.as_dict(),
        }


def run_scenario(space, ground, pcfg, scenario, *, fleet: bool = True,
                 energy_cfgs=None, async_ground: bool = False,
                 contact_reference: bool = False,
                 faults: Optional[FaultPlan] = None,
                 watchdog_s: Optional[float] = None,
                 async_depth: Optional[int] = None,
                 ingest_overlap: bool = False, device="cuda"):
    """Execute a :class:`~repro_torch.data.scenarios.FleetScenario`.

    ``fleet=True`` runs the constellation-batched :class:`Fleet`, each
    round's contact events as a :class:`~repro_torch.core.contact.
    ContactPlan`; ``async_ground``/``async_depth`` run the recounts on
    the ground segment's workers (``watchdog_s`` bounds each
    retirement), ``ingest_overlap=True`` defers each round's fetches
    behind the next round's launches and ``contact_reference=True``
    swaps the batched contact tier for the FIFO reference.
    ``fleet=False`` runs the looped-Mission oracle: one Mission a
    satellite fed the same event order. -> ``(per_sat_results, driver)``,
    the driver being the Fleet or the Mission list.

    ``faults`` injects a deterministic fault schedule
    (:mod:`repro_torch.core.faults`). The oracle takes the plan-level and
    ingest-level classes (blackouts, window drops, station outages) with
    the same draws; segment-granular classes (truncation, corruption)
    need the Fleet and raise on the oracle path. ``device`` is "cuda"
    (the default; raises without a card) or "cpu".
    """
    n = scenario.spec.n_sats
    faults_active = faults is not None and not faults.empty
    if fleet:
        fl = Fleet(space, ground, pcfg, n_sats=n, energy_cfgs=energy_cfgs,
                   async_ground=async_ground,
                   contact_reference=contact_reference, faults=faults,
                   watchdog_s=watchdog_s, async_depth=async_depth,
                   ingest_overlap=ingest_overlap, device=device)
        for rnd in scenario.rounds:
            fl.ingest(rnd.frames_per_sat(n), rnd.harvest_per_sat(n))
            if rnd.contacts:
                fl.contact_round(plan=rnd.contact_plan(n))
        return fl.finalize(), fl
    if faults_active and (
            faults.truncate_rate or faults.corrupt_rate
            or faults.worker_crash_rate or faults.worker_stall_rate
            or faults.window_truncations or faults.segment_corruptions
            or faults.worker_faults):
        raise ValueError(
            "the looped-Mission oracle supports blackout/window-drop/"
            "station-outage faults only; segment-granular fault classes "
            "need the Fleet path (fleet=True)")
    pcfgs = (list(pcfg) if isinstance(pcfg, (list, tuple))
             else [pcfg] * n)
    if len(pcfgs) != n:
        raise ValueError(f"{len(pcfgs)} per-satellite configs for an "
                         f"{n}-satellite scenario")
    missions = [Mission(space, ground, p, energy_cfgs=energy_cfgs, device=device)
                for p in pcfgs]
    contact_idx = 0  # mirrors Fleet._fault_round (rounds with contacts)
    for r_i, rnd in enumerate(scenario.rounds):
        frames = rnd.frames_per_sat(n)
        harvest = rnd.harvest_per_sat(n)
        for i in range(n):
            missions[i].ingest(
                frames[i], energy_budget_j=harvest[i],
                blackout=faults_active and faults.blackout(r_i, i))
        if not rnd.contacts:
            continue
        if faults_active:
            rp = faults.repair(rnd.contact_plan(n), contact_idx)
            for w in range(rp.plan.n_windows):
                missions[int(rp.plan.sats[w])].contact_window(
                    rp.plan.window_budget(w))
            contact_idx += 1
        else:
            for c in rnd.contacts:
                missions[c.sat].contact_window(c.budget_bytes)
    return [m.finalize() for m in missions], missions
