"""Energy budget model (paper §III-A-1), calibrated to published numbers.

The port's copy of ``repro/core/energy.py``: the single-satellite
ledgers and the fleet's stacked :class:`FleetLedger` (host-side float64
numpy arithmetic, unchanged).

Real-world anchors from the paper / Baoyun satellite:
  - daily solar harvest <= 260 KJ; ~150 KJ allocable to computing
  - COTS tiers: Raspberry Pi 4B (6 W) and Atlas 200 DK (13 W);
    RPi processes ~2x more tiles per joule (Fig. 8: '~50% energy saved')
  - measured downlink 30-50 Mbps; contact window <= ~6 min
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class DeviceProfile:
    name: str
    power_w: float
    effective_gflops: float  # sustained DNN throughput

    @property
    def joules_per_gflop(self) -> float:
        return self.power_w / self.effective_gflops


# Calibrated so RPI4 ~ 0.83 GFLOPS/W vs Atlas ~ 0.42 GFLOPS/W (the paper's
# observed ~2x J/tile gap), with absolute rates in the RPi4-for-CNN range.
RPI4 = DeviceProfile("rpi4", power_w=6.0, effective_gflops=5.0)
ATLAS = DeviceProfile("atlas", power_w=13.0, effective_gflops=5.4)

RADIO_POWER_W = 8.0


@dataclass
class EnergyLedger:
    """Tracks the four activity classes of §III-A-1."""

    budget_j: float
    e_cap: float = 0.0
    e_com: float = 0.0
    e_agg: float = 0.0
    e_down: float = 0.0

    @property
    def spent(self) -> float:
        return self.e_cap + self.e_com + self.e_agg + self.e_down

    @property
    def remaining(self) -> float:
        return max(self.budget_j - self.spent, 0.0)

    def grant(self, j: float):
        """Add harvested energy to the budget (each ingested slice's
        day-fraction entitlement)."""
        self.budget_j += j

    def charge_capture(self, n_images: int, j_per_image: float = 0.05):
        self.e_cap += n_images * j_per_image

    def charge_compute(self, n_tiles: int, gflops_per_tile: float,
                       profile: DeviceProfile):
        self.e_com += n_tiles * gflops_per_tile * profile.joules_per_gflop

    def charge_aggregate(self, n_ops: int = 1000, j_per_op: float = 1e-6):
        self.e_agg += n_ops * j_per_op

    def charge_downlink(self, n_bytes: float, bandwidth_mbps: float):
        seconds = n_bytes * 8.0 / (bandwidth_mbps * 1e6)
        self.e_down += seconds * RADIO_POWER_W

    def refund_downlink(self, n_bytes: float, bandwidth_mbps: float):
        """Undo one :meth:`charge_downlink` (a transmission the ground
        discarded, under the faults' ``refund`` policy): the same float64
        arithmetic, subtracted."""
        seconds = n_bytes * 8.0 / (bandwidth_mbps * 1e6)
        self.e_down -= seconds * RADIO_POWER_W


@dataclass
class ByteLedger:
    """Downlink byte accounting of one satellite: bytes offered across
    contact windows, bytes the policies asked to transmit, and bytes
    actually charged (capped by each window's budget)."""

    budget: float = 0.0
    requested: float = 0.0
    spent: float = 0.0


def _energy_lane(field):
    def fget(self):
        return float(getattr(self._ledger, field)[self._sat])
    return property(fget)


def _byte_lane(field):
    def fget(self):
        return float(getattr(self._ledger, field)[self._sat])

    def fset(self, v):
        getattr(self._ledger, field)[self._sat] = v
    return property(fget, fset)


class SatEnergyView:
    """EnergyLedger-compatible view of one lane of a :class:`FleetLedger`:
    scalar charges write into the stacked arrays with EnergyLedger's
    float64 arithmetic, so a Mission on a view equals one on its own
    ledger."""

    __slots__ = ("_ledger", "_sat")

    def __init__(self, ledger: "FleetLedger", sat: int):
        self._ledger = ledger
        self._sat = sat

    budget_j = _energy_lane("budget_j")
    e_cap = _energy_lane("e_cap")
    e_com = _energy_lane("e_com")
    e_agg = _energy_lane("e_agg")
    e_down = _energy_lane("e_down")

    @property
    def spent(self) -> float:
        return self.e_cap + self.e_com + self.e_agg + self.e_down

    @property
    def remaining(self) -> float:
        return max(self.budget_j - self.spent, 0.0)

    def grant(self, j: float):
        self._ledger.budget_j[self._sat] += j

    def charge_capture(self, n_images: int, j_per_image: float = 0.05):
        self._ledger.e_cap[self._sat] += n_images * j_per_image

    def charge_compute(self, n_tiles: int, gflops_per_tile: float,
                       profile: DeviceProfile):
        self._ledger.e_com[self._sat] += (
            n_tiles * gflops_per_tile * profile.joules_per_gflop)

    def charge_aggregate(self, n_ops: int = 1000, j_per_op: float = 1e-6):
        self._ledger.e_agg[self._sat] += n_ops * j_per_op

    def charge_downlink(self, n_bytes: float, bandwidth_mbps: float):
        seconds = n_bytes * 8.0 / (bandwidth_mbps * 1e6)
        self._ledger.e_down[self._sat] += seconds * RADIO_POWER_W

    def refund_downlink(self, n_bytes: float, bandwidth_mbps: float):
        seconds = n_bytes * 8.0 / (bandwidth_mbps * 1e6)
        self._ledger.e_down[self._sat] -= seconds * RADIO_POWER_W


class SatBytesView:
    """ByteLedger-compatible view of one lane of a :class:`FleetLedger`."""

    __slots__ = ("_ledger", "_sat")

    def __init__(self, ledger: "FleetLedger", sat: int):
        self._ledger = ledger
        self._sat = sat

    budget = _byte_lane("bytes_budget")
    requested = _byte_lane("bytes_requested")
    spent = _byte_lane("bytes_spent")


class FleetLedger:
    """Stacked per-satellite budget state of a constellation.

    One (n_lanes,) float64 array per activity class instead of N scalar
    ledgers: fleet-wide grants and charges are single vectorized ops, and
    each lane sees the float64 operations a scalar :class:`EnergyLedger`
    would, so a fleet equals looped Missions. The byte ledgers ride in
    the same object; :meth:`energy_view` / :meth:`bytes_view` give a
    Mission a scalar view of its lane. ``n_lanes`` (>= ``n_sats``) pads
    the arrays with lanes no view points at; they stay zero.
    """

    def __init__(self, n_sats: int, n_lanes: Optional[int] = None):
        self.n_sats = int(n_sats)
        self.n_lanes = self.n_sats if n_lanes is None else int(n_lanes)
        if self.n_lanes < self.n_sats:
            raise ValueError(f"n_lanes={self.n_lanes} < n_sats={self.n_sats}")
        z = lambda: np.zeros(self.n_lanes, np.float64)  # noqa: E731
        self.budget_j = z()
        self.e_cap = z()
        self.e_com = z()
        self.e_agg = z()
        self.e_down = z()
        self.bytes_budget = z()
        self.bytes_requested = z()
        self.bytes_spent = z()

    @property
    def spent(self) -> np.ndarray:
        return self.e_cap + self.e_com + self.e_agg + self.e_down

    @property
    def remaining(self) -> np.ndarray:
        return np.maximum(self.budget_j - self.spent, 0.0)

    def grant(self, j):
        """Add per-satellite harvested energy (``j``: scalar or (n_lanes,))."""
        self.budget_j += j

    def charge_capture(self, n_images, j_per_image: float = 0.05):
        self.e_cap += np.asarray(n_images, np.float64) * j_per_image

    def charge_compute(self, n_tiles, gflops_per_tile: float,
                       profile: DeviceProfile):
        self.e_com += (np.asarray(n_tiles, np.float64) * gflops_per_tile
                       * profile.joules_per_gflop)

    def charge_aggregate(self, n_ops, j_per_op: float = 1e-6):
        self.e_agg += np.asarray(n_ops, np.float64) * j_per_op

    def charge_downlink(self, n_bytes, bandwidth_mbps: float):
        seconds = np.asarray(n_bytes, np.float64) * 8.0 / (bandwidth_mbps * 1e6)
        self.e_down += seconds * RADIO_POWER_W

    # contact-window ops index by WINDOW, and ``sats`` may repeat a lane
    # (one satellite, several windows in a round): ``np.add.at`` applies
    # unbuffered in index order, so a repeated lane sees the scalar
    # per-window float64 sequence

    def accrue_window_budgets(self, sats, budgets):
        """Offer one round's window byte budgets (plan order)."""
        np.add.at(self.bytes_budget, np.asarray(sats, np.int64),
                  np.asarray(budgets, np.float64))

    def charge_downlink_windows(self, sats, requested, spends, bandwidth_mbps):
        """One drain step's Downlink charges for every serving lane:
        requested and spent bytes and the radio energy, with the scalar
        :meth:`EnergyLedger.charge_downlink` arithmetic a lane."""
        sats = np.asarray(sats, np.int64)
        spends = np.asarray(spends, np.float64)
        np.add.at(self.bytes_requested, sats, np.asarray(requested, np.float64))
        np.add.at(self.bytes_spent, sats, spends)
        seconds = spends * 8.0 / (np.asarray(bandwidth_mbps, np.float64) * 1e6)
        np.add.at(self.e_down, sats, seconds * RADIO_POWER_W)

    def refund_downlink_windows(self, sats, spends, bandwidth_mbps):
        """Undo one drain step's Downlink charges for the lanes whose
        transmission the ground discarded (the ``refund`` policy): the
        exact values :meth:`charge_downlink_windows` added, subtracted.
        Requested bytes stay: the policy did ask for them."""
        sats = np.asarray(sats, np.int64)
        spends = np.asarray(spends, np.float64)
        np.add.at(self.bytes_spent, sats, -spends)
        seconds = spends * 8.0 / (np.asarray(bandwidth_mbps, np.float64) * 1e6)
        np.add.at(self.e_down, sats, -(seconds * RADIO_POWER_W))

    def energy_view(self, sat: int) -> SatEnergyView:
        if not 0 <= sat < self.n_sats:
            raise IndexError(f"sat {sat} out of range (pad lanes have no view)")
        return SatEnergyView(self, sat)

    def bytes_view(self, sat: int) -> SatBytesView:
        if not 0 <= sat < self.n_sats:
            raise IndexError(f"sat {sat} out of range (pad lanes have no view)")
        return SatBytesView(self, sat)


def max_tiles_within_budget_vec(budget_j, gflops_per_tile: float,
                                profile: DeviceProfile) -> np.ndarray:
    """Vectorized :func:`max_tiles_within_budget` over stacked budgets.
    Quotients are clamped below 2**62 before the integer cast, so an
    enormous grant gives an enormous cap, not a wrapped negative one."""
    budget_j = np.asarray(budget_j, np.float64)
    if gflops_per_tile <= 0:
        return np.zeros(budget_j.shape, np.int64)
    q = budget_j / (gflops_per_tile * profile.joules_per_gflop)
    return np.minimum(q, np.float64(2 ** 62)).astype(np.int64)


def max_tiles_within_budget(budget_j: float, gflops_per_tile: float,
                            profile: DeviceProfile) -> int:
    """How many tiles the onboard counter may process (computational
    bottleneck: the paper's '22% of observable images' phenomenon)."""
    if gflops_per_tile <= 0:
        return 0
    return int(budget_j / (gflops_per_tile * profile.joules_per_gflop))


def detector_gflops(cfg, tile_px: int = None) -> float:
    """Rough fwd FLOPs of a detector counter on one tile (GFLOP).

    Conv stages at stride-2: sum over stages of H*W*K*K*Cin*Cout*2.
    """
    px = tile_px or cfg.input_size
    total = 0.0
    h = px
    c_in = 3
    total += h * h * 9 * c_in * cfg.widths[0] * 2
    c_in = cfg.widths[0]
    for w in cfg.widths[1:]:
        h = h // 2
        total += h * h * 9 * c_in * w * 2
        total += (cfg.n_blocks_per_stage - 1) * h * h * 9 * w * w * 2
        c_in = w
    total += h * h * c_in * cfg.n_anchors * (5 + cfg.n_classes) * 2
    return total / 1e9
