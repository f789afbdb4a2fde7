"""Stacked orbital-element arrays and constellation constructors.

The port's copy of ``repro/orbits/elements.py`` (numpy only).

One :class:`OrbitalElements` instance holds a WHOLE catalog as aligned
``(n_sats,)`` float64 arrays — the stacked-array layout the batched
propagator consumes directly (no per-satellite objects, no Python loop
between the catalog and the compiled program). Construct through
:func:`walker_delta` (the Walker-delta pattern behind Starlink-style
shells), :func:`shell` (a seeded scattered single-altitude shell), or
the validating constructor itself; malformed catalogs — a perigee below
the atmosphere floor, an inclination outside ``[0, pi]``, misaligned
arrays — raise ``ValueError`` at build time, the same fail-at-build
contract as :class:`~repro_torch.core.contact.ContactPlan`.

Angles are radians internally (constructors take degrees where noted);
lengths are meters. Eccentricity is capped well below parabolic so the
fixed-iteration Kepler solve in :mod:`repro_torch.orbits.propagation` is
uniformly convergent over any valid catalog.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.orbits.propagation import R_EARTH_M

__all__ = ["OrbitalElements", "walker_delta", "shell", "ECC_MAX",
           "MIN_PERIGEE_ALT_M"]

ECC_MAX = 0.25            # Newton-on-Kepler converges in 8 steps below this
MIN_PERIGEE_ALT_M = 80e3  # below ~80 km an orbit is re-entry, not a catalog


@dataclass(frozen=True)
class OrbitalElements:
    """A catalog of ``n_sats`` Keplerian element sets as stacked arrays.

    ``a_m`` semi-major axis (m), ``ecc`` eccentricity, ``inc_rad``
    inclination, ``raan_rad`` right ascension of the ascending node,
    ``argp_rad`` argument of perigee, ``m0_rad`` mean anomaly at epoch.
    All ``(n_sats,)`` float64, validated and stored contiguous.
    """

    a_m: np.ndarray
    ecc: np.ndarray
    inc_rad: np.ndarray
    raan_rad: np.ndarray
    argp_rad: np.ndarray
    m0_rad: np.ndarray

    _FIELDS = ("a_m", "ecc", "inc_rad", "raan_rad", "argp_rad", "m0_rad")

    def __post_init__(self):
        arrays = {}
        shape = None
        for f in self._FIELDS:
            v = np.ascontiguousarray(getattr(self, f), np.float64)
            if v.ndim != 1:
                raise ValueError(
                    f"OrbitalElements: {f} must be 1-D (n_sats,), got "
                    f"shape {v.shape}")
            if shape is None:
                shape = v.shape
            elif v.shape != shape:
                raise ValueError(
                    f"OrbitalElements: {f} has shape {v.shape}, expected "
                    f"{shape} (all element arrays must be aligned)")
            if not np.isfinite(v).all():
                raise ValueError(f"OrbitalElements: {f} contains non-finite "
                                 f"entries")
            arrays[f] = v
        if shape[0] < 1:
            raise ValueError("OrbitalElements: a catalog needs at least one "
                             "satellite")
        bad = arrays["ecc"] < 0.0
        bad |= arrays["ecc"] >= ECC_MAX
        if bad.any():
            i = int(np.flatnonzero(bad)[0])
            raise ValueError(
                f"OrbitalElements: satellite {i} has eccentricity "
                f"{arrays['ecc'][i]}, outside [0, {ECC_MAX}) (the fixed-"
                f"iteration Kepler solve's convergence envelope)")
        perigee = arrays["a_m"] * (1.0 - arrays["ecc"])
        bad = perigee < R_EARTH_M + MIN_PERIGEE_ALT_M
        if bad.any():
            i = int(np.flatnonzero(bad)[0])
            raise ValueError(
                f"OrbitalElements: satellite {i} has perigee altitude "
                f"{(perigee[i] - R_EARTH_M) / 1e3:.1f} km, below the "
                f"{MIN_PERIGEE_ALT_M / 1e3:.0f} km floor")
        bad = (arrays["inc_rad"] < 0.0) | (arrays["inc_rad"] > np.pi)
        if bad.any():
            i = int(np.flatnonzero(bad)[0])
            raise ValueError(
                f"OrbitalElements: satellite {i} has inclination "
                f"{arrays['inc_rad'][i]} rad, outside [0, pi]")
        for f, v in arrays.items():
            object.__setattr__(self, f, v)

    @property
    def n_sats(self) -> int:
        return int(self.a_m.shape[0])

    def arrays(self):
        """The stacked arrays in propagator order."""
        return (self.a_m, self.ecc, self.inc_rad, self.raan_rad,
                self.argp_rad, self.m0_rad)


def walker_delta(n_sats: int, n_planes: int, inc_deg: float, alt_km: float,
                 phasing: int = 1, raan0_deg: float = 0.0,
                 ecc: float = 0.0) -> OrbitalElements:
    """Walker-delta pattern ``i: n_sats / n_planes / phasing``.

    ``n_planes`` equally-spaced RAAN planes of ``n_sats / n_planes``
    satellites each (``n_sats`` must divide evenly); the relative
    in-plane phase between adjacent planes advances by
    ``phasing * 360 / n_sats`` degrees — the standard Walker phasing
    parameter ``f in [0, n_planes)``.
    """
    n_sats, n_planes = int(n_sats), int(n_planes)
    if n_sats < 1 or n_planes < 1:
        raise ValueError(f"walker_delta: need n_sats >= 1 and n_planes >= 1, "
                         f"got {n_sats}/{n_planes}")
    if n_sats % n_planes:
        raise ValueError(f"walker_delta: {n_planes} planes do not divide "
                         f"{n_sats} satellites evenly")
    if not 0 <= int(phasing) < n_planes:
        raise ValueError(f"walker_delta: phasing {phasing} outside "
                         f"[0, {n_planes})")
    per_plane = n_sats // n_planes
    plane = np.repeat(np.arange(n_planes), per_plane)
    slot = np.tile(np.arange(per_plane), n_planes)
    raan = np.radians(raan0_deg) + 2.0 * np.pi * plane / n_planes
    m0 = (2.0 * np.pi * slot / per_plane
          + 2.0 * np.pi * int(phasing) * plane / n_sats)
    n = np.full(n_sats, np.nan)
    return OrbitalElements(
        a_m=np.full_like(n, R_EARTH_M + float(alt_km) * 1e3),
        ecc=np.full_like(n, float(ecc)),
        inc_rad=np.full_like(n, np.radians(float(inc_deg))),
        raan_rad=raan % (2.0 * np.pi),
        argp_rad=np.zeros_like(n),
        m0_rad=m0 % (2.0 * np.pi))


def shell(n_sats: int, inc_deg: float, alt_km: float, seed: int = 0,
          ecc_max: float = 0.02) -> OrbitalElements:
    """A seeded scattered shell: one altitude/inclination, RAAN and
    anomaly drawn uniformly (small random eccentricities below
    ``ecc_max``) — the catalog shape of a debris belt or a mixed
    operator shell, for stress-testing at sizes with no Walker
    structure."""
    n_sats = int(n_sats)
    if n_sats < 1:
        raise ValueError(f"shell: need n_sats >= 1, got {n_sats}")
    if not 0.0 <= float(ecc_max) < ECC_MAX:
        raise ValueError(f"shell: ecc_max {ecc_max} outside [0, {ECC_MAX})")
    rng = np.random.default_rng(seed)
    return OrbitalElements(
        a_m=np.full(n_sats, R_EARTH_M + float(alt_km) * 1e3),
        ecc=rng.uniform(0.0, float(ecc_max), n_sats),
        inc_rad=np.full(n_sats, np.radians(float(inc_deg))),
        raan_rad=rng.uniform(0.0, 2.0 * np.pi, n_sats),
        argp_rad=rng.uniform(0.0, 2.0 * np.pi, n_sats),
        m0_rad=rng.uniform(0.0, 2.0 * np.pi, n_sats))
