"""The orbital geometry engine, in PyTorch.

Counterpart of ``repro/orbits``: stacked Keplerian element arrays
(:mod:`~repro_torch.orbits.elements`), a batched two-body propagator on
the device (:mod:`~repro_torch.orbits.propagation`), ground-station
elevation grids, pass extraction and the Earth-shadow eclipse model
(:mod:`~repro_torch.orbits.visibility`), and the bridge from passes and
eclipse fractions to a fleet scenario's contacts and harvest grants
(:mod:`~repro_torch.orbits.schedule`).
``FleetScenarioSpec(geometry="orbital")`` routes
:func:`repro_torch.data.scenarios.generate_scenario` through it.
"""
from repro_torch.orbits.elements import OrbitalElements, shell, walker_delta
from repro_torch.orbits.propagation import (MU_EARTH_M3_S2, OMEGA_EARTH_RAD_S,
                                            R_EARTH_M, eci_to_ecef, orbital_period_s,
                                            propagate)
from repro_torch.orbits.schedule import (default_sites, generate_orbital_scenario,
                                         pass_contacts, spec_elements)
from repro_torch.orbits.visibility import (PassSet, eclipse_fractions, eclipse_mask,
                                           elevation_deg, extract_passes,
                                           station_ecef, sun_direction)

__all__ = [
    "OrbitalElements", "walker_delta", "shell",
    "propagate", "orbital_period_s", "eci_to_ecef",
    "MU_EARTH_M3_S2", "R_EARTH_M", "OMEGA_EARTH_RAD_S",
    "station_ecef", "elevation_deg", "extract_passes", "PassSet",
    "sun_direction", "eclipse_mask", "eclipse_fractions",
    "pass_contacts", "generate_orbital_scenario", "default_sites",
    "spec_elements",
]
