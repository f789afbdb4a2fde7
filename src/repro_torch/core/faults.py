"""Deterministic fault injection and the degradation rules of the fleet,
ported from ``repro/core/faults.py`` as it stands (host-side numpy).

Fault classes, all described by one :class:`FaultPlan`:

* window drop / station outage: a contact window never happens; plan
  repair (:meth:`FaultPlan.repair`) removes it before execution and folds
  its explicit byte budget into the satellite's next surviving window of
  the round;
* mid-window truncation: from pending-segment position ``t`` on, the
  window's remaining budget is 0;
* corrupted downlink segment: the ground discards a transmission (no
  recount, no ground credit); the ``refund`` policy reconciles the
  ledger with the exact inverse charge, ``charge`` keeps it spent; the
  segment re-queues at the front of its mission's pending FIFO with a
  linear backoff, and is lost after ``max_retries`` failed attempts;
* satellite blackout: a (round, sat) pass is skipped
  (``Mission.ingest(blackout=True)``);
* ground-worker crash / stall: the depth >= 1 recount pipeline's
  worker of a round crashes (:class:`WorkerCrash`) or stalls for
  ``stall_s``; the ground segment's watchdog recovers either by a
  synchronous recount.

Every draw is a pure function of ``(seed, fault class, round, window or
sat, segment)`` through ``np.random.SeedSequence`` hashing, so the
batched executor and the FIFO reference see the same schedule, and a
seed replays its faults. ``FaultPlan.none()`` injects nothing and is
bit-equal to ``faults=None``.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field, replace
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

__all__ = ["FaultPlan", "FaultStats", "FaultContext", "RepairedPlan",
           "WorkerCrash", "REFUND_POLICIES", "scenario_faults"]

REFUND_POLICIES = ("refund", "charge")

# fault-class codes for the counter-based hash (never reuse/renumber:
# a seed's fault schedule is part of the reproducibility contract)
_KIND_DROP = 0
_KIND_TRUNCATE = 1
_KIND_TRUNCATE_POS = 2
_KIND_CORRUPT = 3
_KIND_BLACKOUT = 4
_KIND_WORKER = 5


class WorkerCrash(RuntimeError):
    """Injected ground-worker crash (recoverable: the watchdog retries
    the recount synchronously instead of surfacing it)."""


@dataclass
class FaultStats:
    """Mutable fault/degradation counters one Fleet accumulates
    (mirrored into ``Fleet.summary()``)."""

    windows_dropped: int = 0
    windows_truncated: int = 0
    segments_corrupted: int = 0
    segments_requeued: int = 0
    segments_lost: int = 0
    blackout_passes: int = 0
    bytes_refunded: float = 0.0
    bytes_wasted: float = 0.0      # spent on attempts the ground discarded
    bytes_delivered: float = 0.0   # spent on attempts the ground kept
    budget_folded: float = 0.0     # dead-window budget folded forward
    budget_lost: float = 0.0       # dead-window budget with no heir
    worker_crashes: int = 0
    worker_stalls: int = 0
    watchdog_recoveries: int = 0

    def as_dict(self) -> dict:
        return {f"fault_{k}": v for k, v in vars(self).items()}


@dataclass
class FaultContext:
    """Mutable state of ONE faulty contact round, threaded through the
    batched and scalar-reference executors so both consume the identical
    fault schedule and report into the same counters.

    ``orig_windows[w]`` maps surviving window ``w`` back to its index in
    the pre-repair plan (fault draws stay keyed by the original
    schedule). ``held`` carries the backoff-ineligible re-queued
    segments the fleet parked for this round; ``requeue`` collects the
    segments this round's corruptions send back to the pending FIFO;
    ``events`` records ``(orig_window, pos, kind, bytes)`` byte-flow
    facts that the fleet folds into :class:`FaultStats` in canonical
    ``(window, pos)`` order at round end — so the float accumulation
    order (and thus the summary) is identical no matter which executor
    ran the round.
    """

    faults: "FaultPlan"
    rnd: int
    orig_windows: np.ndarray
    stats: FaultStats
    worker: Optional[str] = None
    held: list = field(default_factory=list)
    requeue: list = field(default_factory=list)
    events: list = field(default_factory=list)


@dataclass(frozen=True)
class RepairedPlan:
    """The surviving plan plus each surviving window's index in the
    ORIGINAL plan (fault addressing stays keyed by the original window
    index, so repair never shifts a later window's fault schedule)."""

    plan: object                # ContactPlan
    orig_windows: np.ndarray    # (n_surviving,) int64


@dataclass(frozen=True)
class FaultPlan:
    """Seeded, fully deterministic fault schedule (see module docstring).

    Rates draw faults via counter-based hashing; the explicit
    ``window_drops`` / ``window_truncations`` / ``segment_corruptions``
    / ``sat_blackouts`` / ``worker_faults`` containers pin individual
    faults for tests and reproductions. Both forms compose (explicit
    entries are unioned with rate draws).
    """

    seed: int = 0
    # stochastic rates (0.0 = class disabled)
    drop_rate: float = 0.0          # per contact window
    truncate_rate: float = 0.0      # per contact window
    corrupt_rate: float = 0.0       # per served segment transmission
    blackout_rate: float = 0.0      # per (round, sat) pass
    worker_crash_rate: float = 0.0  # per async contact round
    worker_stall_rate: float = 0.0  # per async contact round
    # explicit injections
    window_drops: frozenset = frozenset()          # {(round, window)}
    window_truncations: Mapping[Tuple[int, int], int] = \
        field(default_factory=dict)                # (round, window) -> pos
    segment_corruptions: frozenset = frozenset()   # {(round, window, pos)}
    sat_blackouts: frozenset = frozenset()         # {(round, sat)}
    worker_faults: Mapping[int, str] = \
        field(default_factory=dict)                # round -> crash|stall
    station_outages: Tuple[Tuple[str, int, int], ...] = ()
    #   (station_name, first_round, last_round) inclusive spans
    # degradation knobs
    max_retries: int = 2            # transmissions per segment = 1 + this
    refund_policy: str = "refund"   # "refund" | "charge"
    stall_s: float = 0.2            # injected worker-stall sleep

    def __post_init__(self):
        if self.refund_policy not in REFUND_POLICIES:
            raise ValueError(
                f"FaultPlan: refund_policy {self.refund_policy!r} not in "
                f"{REFUND_POLICIES}")
        if self.max_retries < 0:
            raise ValueError("FaultPlan: max_retries must be >= 0")
        for rate_name in ("drop_rate", "truncate_rate", "corrupt_rate",
                          "blackout_rate", "worker_crash_rate",
                          "worker_stall_rate"):
            r = getattr(self, rate_name)
            if not 0.0 <= r <= 1.0:
                raise ValueError(f"FaultPlan: {rate_name}={r} not in [0, 1]")
        for span in self.station_outages:
            if len(span) != 3 or span[1] > span[2]:
                raise ValueError(
                    f"FaultPlan: station outage {span!r} must be "
                    f"(name, first_round, last_round) with first <= last")
        object.__setattr__(self, "window_drops",
                           frozenset(self.window_drops))
        object.__setattr__(self, "segment_corruptions",
                           frozenset(self.segment_corruptions))
        object.__setattr__(self, "sat_blackouts",
                           frozenset(self.sat_blackouts))
        object.__setattr__(self, "window_truncations",
                           dict(self.window_truncations))
        object.__setattr__(self, "worker_faults", dict(self.worker_faults))
        object.__setattr__(self, "station_outages",
                           tuple(tuple(s) for s in self.station_outages))

    # -- constructors -------------------------------------------------------

    @staticmethod
    def none() -> "FaultPlan":
        """The empty plan: injects nothing, and the runtime is bit-equal
        to passing ``faults=None`` (the no-fault-subsystem path)."""
        return FaultPlan()

    @property
    def empty(self) -> bool:
        """True when no fault class can ever fire (the executors use
        this single check to keep the disabled path allocation-free)."""
        return (self.drop_rate == self.truncate_rate == self.corrupt_rate
                == self.blackout_rate == self.worker_crash_rate
                == self.worker_stall_rate == 0.0
                and not self.window_drops and not self.window_truncations
                and not self.segment_corruptions and not self.sat_blackouts
                and not self.worker_faults and not self.station_outages)

    def with_retries(self, max_retries: int) -> "FaultPlan":
        """Same schedule, different retry bound (the bench's retry vs
        no-retry arms must see IDENTICAL fault draws)."""
        return replace(self, max_retries=max_retries)

    # -- deterministic draws ------------------------------------------------

    def _unit(self, kind: int, *key: int) -> float:
        """Uniform [0,1) as a pure function of (seed, kind, key) — no RNG
        state carried, so draw order can never perturb the schedule."""
        ss = np.random.SeedSequence(
            entropy=(int(self.seed) & 0xFFFFFFFF, kind)
            + tuple(int(k) & 0xFFFFFFFF for k in key))
        # one 32-bit word is plenty for a rate compare
        return float(ss.generate_state(1, np.uint32)[0]) / 2.0 ** 32

    def window_dropped(self, rnd: int, window: int, station: str = "") -> bool:
        if (rnd, window) in self.window_drops:
            return True
        if station and self.station_out(station, rnd):
            return True
        return (self.drop_rate > 0.0
                and self._unit(_KIND_DROP, rnd, window) < self.drop_rate)

    def station_out(self, station: str, rnd: int) -> bool:
        for name, first, last in self.station_outages:
            if name == station and first <= rnd <= last:
                return True
        return False

    def truncated_at(self, rnd: int, window: int,
                     n_segments: int) -> Optional[int]:
        """Pending-segment position the window's budget dies at, or
        None. Position is drawn uniformly over the segments actually
        served, so both contact paths (same pending depth) agree."""
        if (rnd, window) in self.window_truncations:
            return int(self.window_truncations[(rnd, window)])
        if n_segments <= 0 or self.truncate_rate <= 0.0:
            return None
        if self._unit(_KIND_TRUNCATE, rnd, window) >= self.truncate_rate:
            return None
        return int(self._unit(_KIND_TRUNCATE_POS, rnd, window) * n_segments)

    def segment_corrupted(self, rnd: int, window: int, pos: int) -> bool:
        if (rnd, window, pos) in self.segment_corruptions:
            return True
        return (self.corrupt_rate > 0.0
                and self._unit(_KIND_CORRUPT, rnd, window, pos)
                < self.corrupt_rate)

    def blackout(self, rnd: int, sat: int) -> bool:
        if (rnd, sat) in self.sat_blackouts:
            return True
        return (self.blackout_rate > 0.0
                and self._unit(_KIND_BLACKOUT, rnd, sat) < self.blackout_rate)

    def worker_fault(self, rnd: int) -> Optional[str]:
        """"crash" | "stall" | None for the async ground worker of one
        contact round."""
        explicit = self.worker_faults.get(rnd)
        if explicit is not None:
            if explicit not in ("crash", "stall"):
                raise ValueError(
                    f"FaultPlan: worker fault {explicit!r} for round {rnd} "
                    f"must be 'crash' or 'stall'")
            return explicit
        if (self.worker_crash_rate > 0.0
                and self._unit(_KIND_WORKER, rnd, 0) < self.worker_crash_rate):
            return "crash"
        if (self.worker_stall_rate > 0.0
                and self._unit(_KIND_WORKER, rnd, 1) < self.worker_stall_rate):
            return "stall"
        return None

    # -- plan repair --------------------------------------------------------

    def repair(self, plan, rnd: int,
               stats: Optional[FaultStats] = None) -> RepairedPlan:
        """Remove this round's dead windows (drops + station outages)
        from a :class:`~repro_torch.core.contact.ContactPlan` and fold each
        dead window's explicit byte budget into the same satellite's
        next surviving window. Returns the surviving plan plus each
        surviving window's ORIGINAL index (fault addressing for
        truncation/corruption stays keyed by the original schedule, so
        repair never shifts later windows' faults)."""
        from repro_torch.core.contact import ContactPlan

        n = plan.n_windows
        dead = np.array([self.window_dropped(rnd, w, plan.stations[w])
                         for w in range(n)], bool)
        if not dead.any():
            return RepairedPlan(plan, np.arange(n))
        budgets = plan.budgets.copy()
        for w in np.flatnonzero(dead):
            if plan.entitlement[w]:
                continue  # nothing explicit to fold
            heirs = np.flatnonzero(~dead[w + 1:]
                                   & (plan.sats[w + 1:] == plan.sats[w]))
            if heirs.size:
                budgets[w + 1 + heirs[0]] += budgets[w]
                if stats is not None:
                    stats.budget_folded += float(budgets[w])
            elif stats is not None:
                stats.budget_lost += float(budgets[w])
        keep = np.flatnonzero(~dead)
        if stats is not None:
            stats.windows_dropped += int(dead.sum())
        repaired = ContactPlan(
            sats=plan.sats[keep], budgets=budgets[keep],
            entitlement=plan.entitlement[keep],
            stations=tuple(plan.stations[int(w)] for w in keep),
            n_sats=plan.n_sats)
        return RepairedPlan(repaired, keep)


def scenario_faults(spec, seed: Optional[int] = None, *,
                    drop_rate: float = 0.0, truncate_rate: float = 0.0,
                    corrupt_rate: float = 0.0, blackout_rate: float = 0.0,
                    outage_rate: float = 0.0, max_retries: int = 2,
                    refund_policy: str = "refund",
                    worker_faults: Optional[Dict[int, str]] = None
                    ) -> FaultPlan:
    """Fault-bearing rounds for a :class:`~repro_torch.data.scenarios.
    FleetScenarioSpec`: a :class:`FaultPlan` sized to the scenario, with
    station outages drawn as round spans over the spec's real station
    names (``outage_rate`` = probability a station suffers one outage
    across the scenario; span ~ up to half the rounds). The per-event
    classes stay lazy rate draws — they need no scenario shape."""
    seed = spec.seed if seed is None else seed
    outages = []
    if outage_rate > 0.0 and spec.n_rounds > 0:
        rng = np.random.default_rng(
            np.random.SeedSequence((int(seed) & 0xFFFFFFFF, 0x5747)))
        for st in spec.stations:
            # station identity enters the draw, not tuple order
            u = rng.random(3)
            h = zlib.crc32(st.name.encode()) / 2.0 ** 32
            if (u[0] + h) % 1.0 < outage_rate:
                first = int(u[1] * spec.n_rounds)
                span = max(int(u[2] * (spec.n_rounds / 2)), 1)
                outages.append((st.name, first,
                                min(first + span - 1, spec.n_rounds - 1)))
    return FaultPlan(seed=seed, drop_rate=drop_rate,
                     truncate_rate=truncate_rate, corrupt_rate=corrupt_rate,
                     blackout_rate=blackout_rate,
                     station_outages=tuple(outages), max_retries=max_retries,
                     refund_policy=refund_policy,
                     worker_faults=worker_faults or {})
