"""Scenario bridge: propagated geometry -> fleet rounds.

Counterpart of ``repro/orbits/schedule.py``. A
``FleetScenarioSpec(geometry="orbital")`` expands into the same
:class:`~repro_torch.data.scenarios.FleetScenario` of rounds as the toy
geometry, so ``run_scenario`` and the looped-Mission oracle consume it
unchanged; what changes is where the numbers come from:

* contacts are passes extracted from the elevation grid over the
  stations' sites; each window's bandwidth follows its pass's maximum
  elevation through :func:`~repro_torch.data.scenarios.elevation_bandwidth`
  and its byte budget integrates that bandwidth over the pass;
* harvest grants follow the Earth-shadow eclipse fraction of each
  round's window.

One propagation on the device covers the whole horizon; the elevation
grid and the eclipse mask come to the host once each. Frame content is
drawn from the same per-satellite seeded generators as the toy path.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.core.throttle import contact_budget_bytes
from repro_torch.data.scenarios import (ContactEvent, FleetScenario,
                                        FleetScenarioSpec, PassEvent, Round,
                                        elevation_bandwidth)
from repro_torch.data.synthetic import make_scene, revisit_frames
from repro_torch.orbits.elements import OrbitalElements, walker_delta
from repro_torch.orbits.propagation import propagate
from repro_torch.orbits.visibility import (PassSet, eclipse_fractions, eclipse_mask,
                                           elevation_deg, extract_passes,
                                           station_ecef, sun_direction)

__all__ = ["default_sites", "spec_elements", "pass_contacts",
           "generate_orbital_scenario"]

# Mid/high-latitude mix typical of commercial ground networks; longitudes
# spread by the golden angle so any prefix of sites is globally dispersed.
_SITE_LATS = (5.0, 40.0, -33.0, 64.0, -12.0, 52.0, -45.0, 21.0)


def default_sites(n: int) -> Tuple[Tuple[float, float], ...]:
    """``n`` deterministic, globally dispersed ``(lat_deg, lon_deg)``
    sites for examples/benchmarks that don't care where their stations
    are, only that they are spread out."""
    return tuple((_SITE_LATS[k % len(_SITE_LATS)],
                  ((137.50776 * k + 10.0) % 360.0) - 180.0)
                 for k in range(int(n)))


def spec_elements(spec: FleetScenarioSpec) -> OrbitalElements:
    """The spec's constellation as a Walker-delta catalog.

    ``n_planes=0`` auto-picks the largest divisor of ``n_sats`` at most
    ``sqrt(n_sats)`` — a near-square Walker grid that degrades cleanly
    to a single plane for primes and tiny fleets.
    """
    planes = int(spec.n_planes)
    if planes == 0:
        planes = max(d for d in range(1, int(np.sqrt(spec.n_sats)) + 1)
                     if spec.n_sats % d == 0)
    return walker_delta(spec.n_sats, planes, spec.inc_deg, spec.alt_km,
                        phasing=1 if planes > 1 else 0)


def pass_contacts(spec: FleetScenarioSpec, passes: PassSet,
                  n_stations: int) -> List[List[ContactEvent]]:
    """Price extracted passes into per-round :class:`ContactEvent` lists.

    Each pass becomes one window: bandwidth from its max elevation via
    the shared :func:`elevation_bandwidth` rule, byte budget from that
    bandwidth over the pass duration (scaled by ``window_budget_scale``
    like the toy path). A pass lands in the round containing its rise
    time (clamped to the horizon); within a round, windows execute in
    rise-time order.
    """
    per_round: List[List[ContactEvent]] = [[] for _ in range(spec.n_rounds)]
    if passes.n_passes == 0:
        return per_round
    sta_i, sat_i = np.unravel_index(passes.row, (n_stations, spec.n_sats))
    for p in np.argsort(passes.t_rise, kind="stable"):
        station = spec.stations[int(sta_i[p])]
        bw = elevation_bandwidth(float(passes.max_elev_deg[p]), station)
        budget = (contact_budget_bytes(bw, float(passes.duration_s[p]))
                  * spec.window_budget_scale)
        rnd = min(int(passes.t_rise[p] // spec.pass_s), spec.n_rounds - 1)
        per_round[rnd].append(ContactEvent(sat=int(sat_i[p]), station=station,
                                           bandwidth_mbps=bw,
                                           budget_bytes=budget))
    return per_round


def generate_orbital_scenario(spec: FleetScenarioSpec,
                              device="cuda") -> FleetScenario:
    """Expand a ``geometry="orbital"`` spec into concrete rounds.

    One batched propagation on ``device`` ("cuda", the default, raises
    without a card; or "cpu") covers the whole horizon (``n_rounds x
    pass_s`` at ``time_step_s`` resolution); visibility, pass
    extraction and eclipse fractions all derive from that one position
    batch. Deterministic for a given spec.
    """
    missing = [st.name for st in spec.stations if st.site is None]
    if missing:
        raise ValueError(
            f"generate_orbital_scenario: stations {missing} have no site "
            f"(lat_deg, lon_deg); geometry='orbital' needs real locations — "
            f"see repro_torch.orbits.default_sites")
    dt = spec.time_step_s
    n_steps = max(int(round(spec.n_rounds * spec.pass_s / dt)), spec.n_rounds)
    times = np.arange(n_steps, dtype=np.float64) * dt

    pos = propagate(spec_elements(spec), times, device=device)
    sites = np.stack([station_ecef(*st.site) for st in spec.stations])
    passes = extract_passes(elevation_deg(pos, times, sites), times,
                            spec.min_elev_deg)
    shadow = eclipse_mask(pos, sun_direction(times, device=pos.device))
    bounds = np.clip(np.round(np.arange(spec.n_rounds + 1) * spec.pass_s / dt)
                     .astype(np.int64), 0, n_steps)
    frac = eclipse_fractions(shadow, bounds)              # (S, n_rounds)
    contacts = pass_contacts(spec, passes, len(spec.stations))

    rngs = [np.random.default_rng(10_000 * spec.seed + s)
            for s in range(spec.n_sats)]
    rounds = []
    for r in range(spec.n_rounds):
        rnd = Round(index=r, contacts=contacts[r])
        for s in range(spec.n_sats):
            scene = spec.scene_mix[s % len(spec.scene_mix)]
            img, b, c = make_scene(rngs[s], scene)
            frames = revisit_frames(rngs[s], img, b, c, spec.frames_per_pass)
            f = float(frac[s, r])
            rnd.passes.append(PassEvent(
                sat=s, frames=frames,
                harvest_j=spec.harvest_w * (1.0 - f) * spec.pass_s,
                sunlit=f < 0.5))
        rounds.append(rnd)
    return FleetScenario(spec=spec, rounds=rounds)
