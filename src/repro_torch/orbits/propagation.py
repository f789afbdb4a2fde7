"""Batched Keplerian propagation: element arrays x a time grid -> ECI
positions, elementwise over the ``(n_sats, n_times)`` grid on the device.

Counterpart of ``repro/orbits/propagation.py``: two-body motion, a fixed
``KEPLER_ITERS`` Newton steps on Kepler's equation (shape-stable and
branch-free), perifocal coordinates and the RAAN / inclination /
argument-of-perigee rotation, all in float32 as the reference runs them,
the time grid included.

The positions are the reference's bit for bit (its XLA CPU program),
because the port does its float32 arithmetic the same way:

* XLA's CPU code generator contracts a product and a sum into one fused
  multiply-add where LLVM's rules allow it. :func:`_fma` makes each such
  one: the float64 product of two float32 values is exact, and the sum
  is rounded once to float32 (a double rounding differs from the true
  fma only at a tie, about 2**-29 of the time). Which operations fuse
  was read off the compiled program: ``m0 + n t``, the Newton step's
  ``E - e sin E`` and ``1 - e cos E``, ``1 - e e``, the rotation's
  column entries and each ECI component.
* XLA's CPU ``sin`` and ``cos`` are calls to glibc's ``sinf`` and
  ``cosf``, which evaluate in double precision and round once; they
  differ from a correctly rounded float32 result in about 1% of the
  samples. :func:`sinf` and :func:`cosf` are that algorithm (the same
  reduction by pi/2 and the same polynomials) in float64 torch ops, so
  they give glibc's float32 results on any device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["MU_EARTH_M3_S2", "R_EARTH_M", "OMEGA_EARTH_RAD_S",
           "KEPLER_ITERS", "orbital_period_s", "propagate", "gmst_rad",
           "eci_to_ecef"]

MU_EARTH_M3_S2 = 3.986004418e14   # standard gravitational parameter
R_EARTH_M = 6_371_000.0           # mean (spherical-model) Earth radius
OMEGA_EARTH_RAD_S = 7.2921159e-5  # sidereal rotation rate
KEPLER_ITERS = 8                  # fixed Newton steps


def orbital_period_s(a_m) -> np.ndarray:
    """Keplerian period T = 2 pi sqrt(a^3 / mu)."""
    a = np.asarray(a_m, np.float64)
    return 2.0 * np.pi * np.sqrt(a ** 3 / MU_EARTH_M3_S2)


# glibc's sinf/cosf (sysdeps/ieee754/flt-32: s_sinf.c, s_cosf.c,
# sincosf.h, sincosf_data.c): pi/2 and 2/pi * 2**24 as it holds them, the
# cosine polynomial c0..c4 and the sine polynomial s1..s3
_HPI = float.fromhex("0x1.921fb54442d18p0")
_HPI_INV_2_24 = float.fromhex("0x1.45f306dc9c883p+23")
_C = (1.0, float.fromhex("-0x1.ffffffd0c621cp-2"), float.fromhex("0x1.55553e1068f19p-5"),
      float.fromhex("-0x1.6c087e89a359dp-10"), float.fromhex("0x1.99343027bf8c3p-16"))
_S = (float.fromhex("-0x1.555545995a603p-3"), float.fromhex("0x1.1107605230bc4p-7"),
      float.fromhex("-0x1.994eb3774cf24p-13"))
# _HPI in two parts, the first with 45 bits so that n * _HPI_HI is exact
# for the quadrant counts below 120 rad: x - n _HPI rounds once, as
# glibc's fused multiply-add does
_HPI_HI = float((np.array(_HPI).view(np.int64) & ~np.int64(0xFF)).view(np.float64))
_HPI_LO = _HPI - _HPI_HI
# pi/2 to 158 bits (fdlibm's split): glibc reduces |x| >= 120 against a
# 192-bit 2/pi, which this matches
_PIO2 = tuple(float.fromhex(h) for h in ("0x1.921fb544p+0", "0x1.0b4611a6p-34",
                                         "0x1.3198a2ep-69", "0x1.c1cd129024e08p-106"))


def _sincosf(y: torch.Tensor, cos: bool) -> torch.Tensor:
    """glibc's ``sinf`` (``cos=False``) or ``cosf`` of float32 ``y``."""
    x = y.double()
    ay = y.abs()
    big = ay >= 120.0
    n = torch.where(big, torch.round(x * (2.0 / np.pi)),
                    torch.floor((torch.trunc(x * _HPI_INV_2_24) + 0x800000) / 0x1000000))
    r = torch.where(big, (((x - n * _PIO2[0]) - n * _PIO2[1]) - n * _PIO2[2]) - n * _PIO2[3],
                    (x - n * _HPI_HI) - n * _HPI_LO)
    small = ay < 0.75
    r = torch.where(small, x, r)
    q = torch.where(small, 0.0, n).long() & 3
    sign = torch.where((q == 1) | (q == 2), -1.0, 1.0).to(x.dtype)
    neg = torch.where(q >= 2, -1.0, 1.0).to(x.dtype)  # the cosine table's sign
    r2 = r * r
    # the sine polynomial at r * sign
    rs = r * sign
    r3 = rs * r2
    sp = (rs + r3 * _S[0]) + (r3 * r2) * (_S[1] + r2 * _S[2])
    # the cosine polynomial, negated in quadrants 2 and 3
    r4 = r2 * r2
    cp = ((neg * _C[0] + r2 * (neg * _C[1])) + r4 * (neg * _C[2])) \
        + (r4 * r2) * (neg * _C[3] + r2 * (neg * _C[4]))
    odd = (q & 1) == (0 if cos else 1)
    out = torch.where(odd, cp, sp).float()
    tiny = ay < 2.0 ** -12
    return torch.where(tiny, torch.ones_like(y) if cos else y, out)


def sinf(y: torch.Tensor) -> torch.Tensor:
    """float32 sine, glibc's ``sinf`` bit for bit (the reference's)."""
    return _sincosf(y, cos=False)


def cosf(y: torch.Tensor) -> torch.Tensor:
    """float32 cosine, glibc's ``cosf`` bit for bit (the reference's)."""
    return _sincosf(y, cos=True)


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add."""
    return (a.double() * b.double() + c.double()).float()


def _kepler(mean_anom, ecc):
    """Eccentric anomaly from mean anomaly: ``KEPLER_ITERS`` Newton
    steps on ``E - e sin E = M``."""
    E = mean_anom
    one = torch.ones_like(E)
    for _ in range(KEPLER_ITERS):
        E = E - (_fma(-ecc, sinf(E), E) - mean_anom) / _fma(-ecc, cosf(E), one)
    return E


def _propagate(a, ecc, inc, raan, argp, m0, times_s):
    """(n_sats,) float32 elements x (n_times,) float32 seconds ->
    (n_sats, n_times, 3) float32 ECI positions in meters."""
    n = torch.sqrt(MU_EARTH_M3_S2 / (a * a * a))            # (S,)
    M = _fma(n[:, None], times_s[None, :], m0[:, None])    # (S, T)
    e = ecc[:, None].expand_as(M)
    E = _kepler(M, e)
    cosE, sinE = cosf(E), sinf(E)
    # perifocal coordinates (z = 0)
    b_over_a = torch.sqrt(_fma(-e, e, torch.ones_like(e)))
    xp = a[:, None] * (cosE - e)
    yp = a[:, None] * b_over_a * sinE
    # perifocal -> ECI: R3(-raan) R1(-inc) R3(-argp), as its two basis
    # columns p and q
    cO, sO = cosf(raan)[:, None], sinf(raan)[:, None]
    ci, si = cosf(inc)[:, None], sinf(inc)[:, None]
    cw, sw = cosf(argp)[:, None], sinf(argp)[:, None]
    px = _fma(cO, cw, -(sO * sw * ci))
    py = _fma(sO, cw, cO * sw * ci)
    pz = sw * si
    qx = _fma(-cO, sw, -(sO * cw * ci))
    qy = _fma(cO * cw, ci, -sO * sw)
    qz = cw * si
    return torch.stack([_fma(yp, qx, xp * px),
                        _fma(yp, qy, xp * py),
                        _fma(yp, qz, xp * pz)], dim=-1)


def _f32(values, device) -> torch.Tensor:
    """A host array as float32 on ``device`` (rounded on the host, as the
    reference's float64 -> float32 conversion rounds)."""
    return torch.from_numpy(np.asarray(values, np.float64).astype(np.float32)).to(device)


def propagate(elements, times_s, device="cuda") -> torch.Tensor:
    """Batch-propagate a catalog over a time grid.

    ``elements``: :class:`~repro_torch.orbits.elements.OrbitalElements`;
    ``times_s``: ``(n_times,)`` seconds past epoch. -> ``(n_sats,
    n_times, 3)`` float32 ECI positions (meters) on ``device`` ("cuda",
    the default, raises without a card; or "cpu").
    """
    dev = resolve_device(device)
    return _propagate(*[_f32(v, dev) for v in elements.arrays()], _f32(times_s, dev))


def gmst_rad(times_s: torch.Tensor, gmst0_rad: float = 0.0) -> torch.Tensor:
    """Greenwich mean sidereal angle over a float32 time grid (linear
    model: scenario epochs are arbitrary)."""
    return _fma(torch.full_like(times_s, OMEGA_EARTH_RAD_S), times_s,
                torch.full_like(times_s, gmst0_rad))


def eci_to_ecef(pos_eci: torch.Tensor, times_s, gmst0_rad: float = 0.0) -> torch.Tensor:
    """Rotate ``(..., n_times, 3)`` ECI positions into the rotating
    Earth-fixed frame (R3 by the sidereal angle), on ``pos_eci``'s
    device."""
    g = gmst_rad(_f32(times_s, pos_eci.device), gmst0_rad)
    cg, sg = cosf(g), sinf(g)
    x, y, z = pos_eci[..., 0], pos_eci[..., 1], pos_eci[..., 2]
    return torch.stack([_fma(cg, x, sg * y), _fma(cg, y, -sg * x), z], dim=-1)
