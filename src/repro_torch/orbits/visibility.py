"""Ground-station visibility and eclipse geometry over propagated
position batches.

Counterpart of ``repro/orbits/visibility.py``:

* on the device, in float32 as the reference runs them: the
  ``(n_stations, n_sats, n_times)`` elevation grid
  (:func:`elevation_deg`; stations rotate into ECI by the sidereal
  angle), the sun direction (:func:`sun_direction`) and the cylindrical
  Earth-shadow mask (:func:`eclipse_mask`);
* on the host, in numpy, as the reference has them: the segment-scan
  pass extraction (:func:`extract_passes`, one copy of the elevation
  grid to the host) and the per-window eclipse fractions
  (:func:`eclipse_fractions`).

The products and sums are fused where the reference's XLA CPU program
fuses them, and the sines and cosines are glibc's
(:mod:`repro_torch.orbits.propagation`). Two steps of the reference's
elevation cannot be reproduced bit for bit: XLA turns ``x / norm(d)``
into ``x * rsqrt(|d|^2)`` with the CPU's approximate reciprocal square
root and a Newton step, and computes ``arcsin`` through ``atan2``. The
port divides by the norm and takes the arcsine in float64, rounding the
elevation once to float32, so it is the more exact of the two; they
differ by a few float32 ulps of the sine (tests/test_torch_orbits.py
states the bound and the pass-edge rule that follows from it).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.orbits.propagation import (OMEGA_EARTH_RAD_S, R_EARTH_M, _f32, _fma,
                                            cosf, sinf)
from repro_torch.device import resolve_device

__all__ = ["station_ecef", "elevation_deg", "extract_passes", "PassSet",
           "sun_direction", "eclipse_mask", "eclipse_fractions",
           "YEAR_S", "OBLIQUITY_RAD"]

YEAR_S = 365.25 * 86_400.0
OBLIQUITY_RAD = float(np.radians(23.439))


def station_ecef(lat_deg: float, lon_deg: float,
                 alt_m: float = 0.0) -> np.ndarray:
    """Geodetic site -> ECEF vector (m), spherical Earth model."""
    lat, lon = np.radians(float(lat_deg)), np.radians(float(lon_deg))
    r = R_EARTH_M + float(alt_m)
    return np.array([r * np.cos(lat) * np.cos(lon),
                     r * np.cos(lat) * np.sin(lon),
                     r * np.sin(lat)], np.float64)


def _dot3(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (3) of ``u * v`` as XLA's reduction loop
    runs it: one fused multiply-add a term."""
    return _fma(u[..., 2], v[..., 2], _fma(u[..., 1], v[..., 1], u[..., 0] * v[..., 0]))


def elevation_deg(pos_eci: torch.Tensor, times_s, stations_ecef,
                  gmst0_rad: float = 0.0,
                  omega_rad_s: float = OMEGA_EARTH_RAD_S) -> torch.Tensor:
    """Elevation grid ``(n_stations, n_sats, n_times)`` in degrees
    (float32, on ``pos_eci``'s device). ``omega_rad_s=0.0`` freezes
    Earth rotation."""
    dev = pos_eci.device
    t = _f32(times_s, dev)
    sites = _f32(np.atleast_2d(np.asarray(stations_ecef, np.float64)), dev)
    g = _fma(torch.full_like(t, omega_rad_s), t, torch.full_like(t, gmst0_rad))
    cg, sg = cosf(g)[None, :], sinf(g)[None, :]                # (1, T)
    sx, sy, sz = sites[:, 0:1], sites[:, 1:2], sites[:, 2:3]   # (N, 1)
    st = torch.stack([_fma(cg, sx, -(sg * sy)),
                      _fma(sg, sx, cg * sy),
                      sz.expand(-1, t.shape[0])], dim=-1)      # (N, T, 3)
    up = st / torch.sqrt(_dot3(st, st))[..., None]
    d = pos_eci[None, :, :, :] - st[:, None, :, :]            # (N, S, T, 3)
    sin_el = (_dot3(d, up[:, None]).double()
              / torch.sqrt(_dot3(d, d).double()))
    return torch.rad2deg(torch.asin(sin_el.clamp(-1.0, 1.0))).float()


@dataclass(frozen=True)
class PassSet:
    """Extracted contact passes over flattened elevation rows.

    ``row[p]`` indexes the flattened leading axes of the elevation grid
    the passes came from (unravel with ``np.unravel_index(row,
    grid.shape[:-1])`` to recover (station, sat)); ``start``/``stop``
    are the [inclusive, exclusive) time-grid indices of the maximal
    above-mask run. Times are seconds on the caller's grid;
    ``duration_s`` counts each above-mask sample at its grid step.
    """

    row: np.ndarray          # (n_passes,) int64
    start: np.ndarray        # (n_passes,) int64, inclusive
    stop: np.ndarray         # (n_passes,) int64, exclusive
    t_rise: np.ndarray       # (n_passes,) f64 seconds
    t_set: np.ndarray        # (n_passes,) f64 seconds (last sample)
    duration_s: np.ndarray   # (n_passes,) f64
    max_elev_deg: np.ndarray  # (n_passes,) f64
    t_culminate: np.ndarray  # (n_passes,) f64 seconds (first max sample)

    @property
    def n_passes(self) -> int:
        return int(self.row.shape[0])


def extract_passes(elev_deg, times_s, min_elev_deg: float) -> PassSet:
    """Pass extraction over ``(..., n_times)`` elevation rows (a host
    array or a tensor, copied to the host once): a zero-padded ``diff``
    finds every rise and set edge, a cumulative count of rises labels
    each above-mask sample with its pass, and ``np.maximum.at`` /
    ``np.minimum.at`` reduce each pass's maximum and culmination."""
    if isinstance(elev_deg, torch.Tensor):
        elev_deg = elev_deg.cpu().numpy()
    elev = np.asarray(elev_deg, np.float64)
    times = np.asarray(times_s, np.float64)
    T = elev.shape[-1]
    if times.shape != (T,):
        raise ValueError(f"extract_passes: {times.shape[0] if times.ndim else 0}"
                         f"-point time grid for {T}-sample elevation rows")
    rows = elev.reshape(-1, T)
    mask = rows >= float(min_elev_deg)

    padded = np.zeros((rows.shape[0], T + 2), np.int8)
    padded[:, 1:-1] = mask
    edges = np.diff(padded, axis=1)            # (R, T+1): +1 rise, -1 set
    r_rise, t_rise_i = np.nonzero(edges == 1)  # row-major -> passes pair up
    r_set, t_set_i = np.nonzero(edges == -1)   # t_set_i is EXCLUSIVE stop
    n = r_rise.shape[0]
    if r_set.shape[0] != n or not (r_rise == r_set).all():
        raise AssertionError("extract_passes: unpaired rise/set edges")

    # per-sample pass ids: cumulative rise count over the flat grid
    marks = np.zeros((rows.shape[0], T), bool)
    marks[r_rise, t_rise_i] = True
    pid = np.cumsum(marks.ravel()) - 1
    fm = mask.ravel()
    pid_m, val_m = pid[fm], rows.ravel()[fm]

    max_elev = np.full(n, -np.inf)
    np.maximum.at(max_elev, pid_m, val_m)
    # culmination = FIRST sample attaining the pass max
    flat_idx = np.flatnonzero(fm)
    at_max = val_m == max_elev[pid_m]
    culm_flat = np.full(n, rows.size, np.int64)
    np.minimum.at(culm_flat, pid_m[at_max], flat_idx[at_max])
    culm_t = culm_flat % T

    # duration: each sample counts one grid step (last step extrapolated)
    if T > 1:
        steps = np.append(np.diff(times), times[-1] - times[-2])
    else:
        steps = np.zeros(1)
    edges_t = np.append(times, times[-1] + steps[-1])
    return PassSet(
        row=r_rise.astype(np.int64),
        start=t_rise_i.astype(np.int64),
        stop=t_set_i.astype(np.int64),
        t_rise=times[t_rise_i],
        t_set=times[t_set_i - 1],
        duration_s=edges_t[t_set_i] - times[t_rise_i],
        max_elev_deg=max_elev,
        t_culminate=times[culm_t] if n else np.zeros(0))


def sun_direction(times_s, sun_lon0_rad: float = 0.0, device="cuda") -> torch.Tensor:
    """(n_times, 3) float32 unit sun direction on ``device``: circular
    ecliptic model (mean motion over :data:`YEAR_S`, obliquity tilt)."""
    t = _f32(times_s, resolve_device(device))
    lam = sun_lon0_rad + (np.float32(2.0 * np.pi) * t) / np.float32(YEAR_S)
    ce, se = np.float32(np.cos(OBLIQUITY_RAD)), np.float32(np.sin(OBLIQUITY_RAD))
    s = sinf(lam)
    return torch.stack([cosf(lam), s * ce, s * se], dim=-1)


def eclipse_mask(pos_eci: torch.Tensor, sun_dir: torch.Tensor) -> torch.Tensor:
    """Cylindrical Earth-shadow test: ``(n_sats, n_times)`` True where
    the satellite is behind the terminator plane AND inside the shadow
    cylinder of radius ``R_EARTH`` around the anti-sun axis."""
    proj = _dot3(pos_eci, sun_dir[None, :, :])                 # (S, T)
    rho2 = _fma(-proj, proj, _dot3(pos_eci, pos_eci))
    return (proj < 0.0) & (rho2 < np.float32(R_EARTH_M * R_EARTH_M))


def eclipse_fractions(mask, bounds) -> np.ndarray:
    """Fold an eclipse mask (a host array or a tensor) into per-window
    shadow fractions: ``bounds`` ``(n_windows + 1,)`` time-grid indices
    (window ``w`` is ``[bounds[w], bounds[w+1])``) -> ``(n_sats,
    n_windows)`` fractions in [0, 1]; an empty window is fully sunlit."""
    if isinstance(mask, torch.Tensor):
        mask = mask.cpu().numpy()
    m = np.asarray(mask, np.float64)
    bounds = np.asarray(bounds, np.int64)
    sums = np.concatenate([np.zeros((m.shape[0], 1)), np.cumsum(m, axis=1)],
                          axis=1)
    width = np.maximum(np.diff(bounds), 1)[None, :]
    return (sums[:, bounds[1:]] - sums[:, bounds[:-1]]) / width
