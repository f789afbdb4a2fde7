"""Scenario generator for constellation simulations: the toy geometry.

The port's copy of ``repro/data/scenarios.py`` (numpy, the same draws
from the same seed). Deterministic multi-round fleet scenarios feed
:class:`repro_torch.core.fleet.Fleet` and its looped-Mission oracle the
same event stream:

* passes: every round every satellite images a fresh ground area (its
  scene mix, revisit frames within the pass) and harvests solar energy
  by an eclipse/sunlit orbit-phase profile, granted through
  ``Mission.ingest(..., energy_budget_j=...)``;
* contacts: ground stations rotate over the fleet round-robin; each
  window's byte budget varies with a per-pass elevation factor on the
  station bandwidth, scaled by ``window_budget_scale`` into the
  day-fraction regime of ``PipelineConfig``'s tile entitlements.

``geometry="orbital"`` takes contacts and harvest grants from the
orbital geometry engine instead (:mod:`repro_torch.orbits`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.throttle import contact_budget_bytes
from repro_torch.data.synthetic import SceneSpec, make_scene, revisit_frames

# default per-satellite ground-track scene (small: fleet workloads scale
# by satellite count, not scene size)
TRACK = SceneSpec("track", 384, (10, 20), (10, 24), cloud_fraction=0.25)


@dataclass(frozen=True)
class GroundStation:
    name: str
    bandwidth_mbps: float = 50.0
    contact_s: float = 360.0
    # (lat_deg, lon_deg) ground site; required by geometry="orbital"
    # (the toy path never looks at it, so existing specs are unchanged)
    site: Optional[Tuple[float, float]] = None


@dataclass(frozen=True)
class FleetScenarioSpec:
    """Knobs of one generated scenario (all rounds derive from ``seed``)."""

    n_sats: int = 4
    n_rounds: int = 4
    frames_per_pass: int = 2
    stations: Tuple[GroundStation, ...] = (GroundStation("gs0"),)
    scene_mix: Tuple[SceneSpec, ...] = (TRACK,)  # sat i -> mix[i % len]
    # eclipse/sunlit harvest profile
    orbit_rounds: int = 8            # rounds per orbital revolution
    eclipse_fraction: float = 0.35   # fraction of the orbit in shadow
    harvest_w: float = 3.0           # mean panel output while sunlit (W)
    pass_s: float = 600.0            # seconds of flight per round
    # per-window bandwidth variability (elevation factor range)
    elevation_range: Tuple[float, float] = (0.5, 1.0)
    # scales station windows into the simulated day-fraction regime
    # (a full 50 Mbps x 6 min window is ~2.25 GB — far beyond a slice)
    window_budget_scale: float = 1e-3
    seed: int = 0
    # geometry backend: "toy" keeps the phase-offset model above;
    # "orbital" routes through repro_torch.orbits (batched Keplerian
    # propagation, real passes, eclipse-derived harvest)
    geometry: str = "toy"
    # orbital-path knobs (ignored by the toy path)
    alt_km: float = 550.0
    inc_deg: float = 53.0
    n_planes: int = 0                # 0 = auto near-square Walker grid
    min_elev_deg: float = 10.0       # pass-extraction horizon mask
    time_step_s: float = 15.0        # propagation grid resolution

    def __post_init__(self):
        """Fail-at-build validation, same contract as ``ContactPlan``:
        a malformed spec raises here, not rounds later inside the
        generator or the energy ledger."""
        if self.geometry not in ("toy", "orbital"):
            raise ValueError(f"FleetScenarioSpec: unknown geometry "
                             f"{self.geometry!r} (expected 'toy' or "
                             f"'orbital')")
        if self.n_sats < 1 or self.n_rounds < 1:
            raise ValueError(f"FleetScenarioSpec: need n_sats >= 1 and "
                             f"n_rounds >= 1, got {self.n_sats}/"
                             f"{self.n_rounds}")
        if not self.stations:
            raise ValueError("FleetScenarioSpec: stations must be non-empty "
                             "(a fleet with no ground segment can never "
                             "downlink)")
        if not 0.0 <= self.eclipse_fraction < 1.0:
            raise ValueError(f"FleetScenarioSpec: eclipse_fraction "
                             f"{self.eclipse_fraction} outside [0, 1)")
        if self.orbit_rounds < 1:
            raise ValueError(f"FleetScenarioSpec: orbit_rounds must be >= 1, "
                             f"got {self.orbit_rounds}")
        if self.pass_s <= 0.0 or self.harvest_w <= 0.0:
            raise ValueError(f"FleetScenarioSpec: pass_s and harvest_w must "
                             f"be positive, got {self.pass_s}/"
                             f"{self.harvest_w}")
        lo, hi = self.elevation_range
        if not 0.0 <= lo <= hi <= 1.0:
            raise ValueError(f"FleetScenarioSpec: elevation_range "
                             f"({lo}, {hi}) must satisfy 0 <= lo <= hi <= 1 "
                             f"(it is a bandwidth factor range)")
        if self.alt_km <= 0.0 or self.time_step_s <= 0.0:
            raise ValueError(f"FleetScenarioSpec: alt_km and time_step_s "
                             f"must be positive, got {self.alt_km}/"
                             f"{self.time_step_s}")
        if not 0.0 <= self.min_elev_deg < 90.0:
            raise ValueError(f"FleetScenarioSpec: min_elev_deg "
                             f"{self.min_elev_deg} outside [0, 90)")
        if self.n_planes < 0:
            raise ValueError(f"FleetScenarioSpec: n_planes must be >= 0 "
                             f"(0 = auto), got {self.n_planes}")

    def fault_plan(self, seed: Optional[int] = None, **knobs):
        """Fault-bearing rounds for this scenario: a deterministic
        :class:`~repro_torch.core.faults.FaultPlan` sized to the spec —
        station outages are drawn as round spans over the spec's real
        station names; the per-event classes stay lazy rate draws.
        ``knobs`` are :func:`repro_torch.core.faults.scenario_faults` rates
        (``drop_rate``, ``truncate_rate``, ``corrupt_rate``,
        ``blackout_rate``, ``outage_rate``, ``max_retries``,
        ``refund_policy``, ``worker_faults``)."""
        from repro_torch.core.faults import scenario_faults
        return scenario_faults(self, seed, **knobs)


@dataclass
class PassEvent:
    sat: int
    frames: list
    harvest_j: float
    sunlit: bool


@dataclass
class ContactEvent:
    sat: int
    station: GroundStation
    bandwidth_mbps: float     # elevation-degraded effective bandwidth
    budget_bytes: float


@dataclass
class Round:
    index: int
    passes: List[PassEvent] = field(default_factory=list)
    contacts: List[ContactEvent] = field(default_factory=list)

    def frames_per_sat(self, n_sats: int) -> list:
        out = [[] for _ in range(n_sats)]
        for p in self.passes:
            out[p.sat] = p.frames
        return out

    def harvest_per_sat(self, n_sats: int) -> list:
        out: list = [None] * n_sats
        for p in self.passes:
            out[p.sat] = p.harvest_j
        return out

    def contact_plan(self, n_sats: int):
        """This round's contact events as a declarative, validated
        :class:`~repro_torch.core.contact.ContactPlan` — the scenario
        generator's schedule drives ``Fleet.contact_round(plan=...)``
        directly (budgets/stations land in the plan's lane arrays)."""
        from repro_torch.core.contact import ContactPlan
        return ContactPlan.from_contacts(self.contacts, n_sats)


@dataclass
class FleetScenario:
    spec: FleetScenarioSpec
    rounds: List[Round]

    @property
    def n_frames(self) -> int:
        return sum(len(p.frames) for r in self.rounds for p in r.passes)


def elevation_bandwidth(elev_deg: float, station: GroundStation, *,
                        factor: Optional[float] = None) -> float:
    """Elevation-dependent effective bandwidth (Mbps) for one window.

    The ONE scaling rule both geometry paths share: effective bandwidth
    is the station bandwidth times a factor in [0, 1]. The orbital path
    passes a real elevation (degrees), mapped through ``sin`` — the
    slant-range/air-mass shape that makes horizon grazes slow and
    overhead passes full-rate. The toy path draws its factor directly
    from ``elevation_range`` and passes it via ``factor``; the clamp is
    an exact no-op on [0, 1], keeping the toy path bit-identical to the
    pre-helper inline scaling.
    """
    if factor is None:
        factor = float(np.sin(np.radians(np.clip(elev_deg, 0.0, 90.0))))
    return station.bandwidth_mbps * min(max(float(factor), 0.0), 1.0)


def orbit_phase(spec: FleetScenarioSpec, rnd: int, sat: int) -> float:
    """[0, 1) orbital phase: satellites are phase-staggered along the
    ring; phase advances by 1/orbit_rounds per round."""
    return (rnd / max(spec.orbit_rounds, 1) + sat / max(spec.n_sats, 1)) % 1.0


def harvest_profile(spec: FleetScenarioSpec, rnd: int, sat: int
                    ) -> Tuple[float, bool]:
    """-> (harvest_j, sunlit) for one pass.

    Phase below ``eclipse_fraction`` is Earth-shadowed (zero harvest);
    the sunlit arc ramps sinusoidally with sun elevation, so grants vary
    smoothly instead of toggling between two constants.
    """
    p = orbit_phase(spec, rnd, sat)
    if p < spec.eclipse_fraction:
        return 0.0, False
    arc = (p - spec.eclipse_fraction) / max(1.0 - spec.eclipse_fraction, 1e-9)
    power = spec.harvest_w * (0.6 + 0.4 * float(np.sin(np.pi * arc)))
    return power * spec.pass_s, True


def generate_scenario(spec: FleetScenarioSpec, device="cuda") -> FleetScenario:
    """Deterministically expand a spec into concrete rounds.

    Scene content is drawn per satellite from independent seeded
    generators, so two scenarios with the same seed are byte-identical
    regardless of consumption order.

    ``geometry="orbital"`` routes through the orbital geometry engine
    (lazy import: :mod:`repro_torch.orbits` depends on this module),
    which propagates on ``device`` ("cuda", the default, raises without
    a card; or "cpu"). The toy geometry runs on the host and ignores
    ``device``.
    """
    if spec.geometry == "orbital":
        from repro_torch.orbits.schedule import generate_orbital_scenario
        return generate_orbital_scenario(spec, device=device)
    rngs = [np.random.default_rng(10_000 * spec.seed + s)
            for s in range(spec.n_sats)]
    contact_rng = np.random.default_rng(10_000 * spec.seed + 9999)
    rounds = []
    for r in range(spec.n_rounds):
        rnd = Round(index=r)
        for s in range(spec.n_sats):
            scene = spec.scene_mix[s % len(spec.scene_mix)]
            img, b, c = make_scene(rngs[s], scene)
            frames = revisit_frames(rngs[s], img, b, c, spec.frames_per_pass)
            harvest_j, sunlit = harvest_profile(spec, r, s)
            rnd.passes.append(PassEvent(sat=s, frames=frames,
                                        harvest_j=harvest_j, sunlit=sunlit))
        for k, station in enumerate(spec.stations):
            sat = (r * len(spec.stations) + k) % spec.n_sats
            lo, hi = spec.elevation_range
            elev = float(contact_rng.uniform(lo, hi))
            bw = elevation_bandwidth(0.0, station, factor=elev)
            budget = (contact_budget_bytes(bw, station.contact_s)
                      * spec.window_budget_scale)
            rnd.contacts.append(ContactEvent(sat=sat, station=station,
                                             bandwidth_mbps=bw,
                                             budget_bytes=budget))
        rounds.append(rnd)
    return FleetScenario(spec=spec, rounds=rounds)
