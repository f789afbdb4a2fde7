"""Bandwidth-aware downlinking throttling (paper §III-D, Algorithm 2).

Counterpart of ``repro/core/throttle.py``. Two-threshold selection on
the onboard counter's confidence:
  conf <  conf_p              -> discard tile
  conf >  conf_q              -> accept the space count
  conf in [conf_p, conf_q]    -> downlink candidate
Candidates fill the window's byte budget in the policy's order (Fig. 6):
low_conf_first, fixed_conf, dynamic_conf.

The reference runs in JAX without 64-bit types, so confidences, sizes,
thresholds and the budget are float32 here too, and the sort is stable.
The throttle runs where ``conf`` lies: on the CPU for the Mission's few
hundred host values, on the card inside ``launch.steps``' onboard serve
cell, where it makes no host sync.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.sharding.local import is_dtensor, local_op, refill, replicated

POLICIES = ("low_conf_first", "fixed_conf", "dynamic_conf")


class ThrottleResult(NamedTuple):
    discard: torch.Tensor     # (N,) bool  conf < conf_p
    space: torch.Tensor       # (N,) bool  counted onboard
    downlink: torch.Tensor    # (N,) bool  transmitted to ground
    dropped: torch.Tensor     # (N,) bool  middle tiles lost (fixed_conf)
    bytes_used: torch.Tensor  # scalar f32


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def throttle(conf, sizes, budget_bytes, conf_p: float, conf_q: float,
             policy: str = "dynamic_conf", active=None) -> ThrottleResult:
    """conf (N,), sizes (N,) bytes, scalar budget -> masks (Algorithm 2).

    ``active``: optional (N,) bool — tiles that exist at all (padding is
    False and takes no budget). All float inputs are taken as float32.
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}")
    if any(is_dtensor(t) for t in (conf, sizes, active)):
        # the budget fill ranks every tile: it runs on the whole (N,) arrays
        mesh = next(t for t in (conf, sizes, active) if is_dtensor(t)).device_mesh
        r = replicated(mesh)
        tensors = [t for t in (conf, sizes, active) if isinstance(t, torch.Tensor)]

        def whole(*ts):
            c, s, a = refill(ts, (conf, sizes, active))
            return tuple(throttle(c, s, budget_bytes, conf_p, conf_q, policy, a))
        return ThrottleResult(*local_op(whole, tensors, mesh, (r,) * len(tensors), (r,) * 5))
    conf, sizes = _f32(conf), _f32(sizes)
    budget, conf_p, conf_q = _f32(budget_bytes), _f32(conf_p), _f32(conf_q)
    n = conf.shape[0]
    dev = conf.device
    active = (torch.ones(n, dtype=torch.bool, device=dev) if active is None
              else torch.as_tensor(active, dtype=torch.bool, device=dev))
    conf = torch.where(active, conf, -1.0)

    discard = active & (conf < conf_p)
    high = active & (conf > conf_q)
    middle = active & ~discard & ~high

    # --- budget fill over middle tiles (Algorithm 2 lines 12-18) ---
    key = torch.where(middle, conf if policy == "low_conf_first" else -conf,
                      torch.inf)
    order = torch.argsort(key, stable=True)              # middles first
    sz = torch.where(middle, sizes, 0.0)[order]
    fits = (torch.cumsum(sz, 0) <= budget) & middle[order]
    downlink = torch.zeros(n, dtype=torch.bool, device=dev)
    downlink[order] = fits
    bytes_used = torch.where(downlink, sizes, 0.0).sum()

    leftover = middle & ~downlink
    if policy == "fixed_conf":
        dropped = leftover                               # conf <= conf_q by construction
        space = high
    else:
        dropped = torch.zeros(n, dtype=torch.bool, device=dev)
        space = high | leftover
    return ThrottleResult(discard, space, downlink, dropped, bytes_used)


def throttle_padded(conf, tile_bytes: float, budget_bytes, conf_p: float,
                    conf_q: float, policy: str = "dynamic_conf",
                    n_pad: int = None):
    """Host-facing wrapper: pads ``conf`` (host array, (n,)) to ``n_pad``
    inactive slots, as the reference's shape-stable call does, and
    returns host ``(space, downlink)`` boolean masks over the real slots.
    """
    n = int(np.shape(conf)[0])
    n_pad = n_pad if n_pad is not None else n
    if n_pad < n:
        raise ValueError(
            f"throttle_padded: n_pad={n_pad} < n={n} would drop real tiles; "
            f"pass a bucket >= n (n_pad == n is the no-padding boundary)")
    conf_pad = np.full(n_pad, -1.0)
    conf_pad[:n] = conf
    act = np.zeros(n_pad, bool)
    act[:n] = True
    tr = throttle(conf_pad, np.full(n_pad, tile_bytes), float(budget_bytes),
                  conf_p, conf_q, policy, active=act)
    return tr.space.numpy()[:n], tr.downlink.numpy()[:n]


def _throttle_lanes(conf, sizes, budgets, conf_p, conf_q, active, policy: str):
    """:func:`throttle` over a leading lane axis: conf, sizes, active
    (L, N); budgets, conf_p, conf_q (L,) -> (space, downlink) (L, N) bool.
    Each row takes the one-lane arithmetic (float32, a stable sort and a
    cumulative sum along the row), so a lane's masks equal
    :func:`throttle` on that lane's row."""
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}")
    conf, sizes = _f32(conf), _f32(sizes)
    budget = _f32(budgets)[:, None]
    conf_p, conf_q = _f32(conf_p)[:, None], _f32(conf_q)[:, None]
    active = torch.as_tensor(active, dtype=torch.bool)
    conf = torch.where(active, conf, -1.0)

    discard = active & (conf < conf_p)
    high = active & (conf > conf_q)
    middle = active & ~discard & ~high

    key = torch.where(middle, conf if policy == "low_conf_first" else -conf,
                      torch.inf)
    order = torch.argsort(key, dim=1, stable=True)       # middles first
    sz = torch.where(middle, sizes, 0.0).gather(1, order)
    fits = (torch.cumsum(sz, 1) <= budget) & middle.gather(1, order)
    downlink = torch.zeros_like(active).scatter(1, order, fits)
    leftover = middle & ~downlink
    space = high if policy == "fixed_conf" else high | leftover
    return space, downlink


def throttle_padded_batch(conf, tile_bytes, budgets, conf_p, conf_q,
                          policy: str = "dynamic_conf", n_pad: int = None):
    """Lane-stacked :func:`throttle_padded`: the candidate sets of L
    contact windows in one call.

    Counterpart of ``repro/core/throttle.py``'s ``throttle_padded_batch``.
    ``conf``: L host (n_l,) confidence vectors (ragged); ``tile_bytes``,
    ``budgets``, ``conf_p``, ``conf_q``: (L,) per-lane scalars. Every lane
    is padded to ``n_pad`` inactive slots (default: the longest lane), so
    its masks equal the one-lane call's whatever its own bucket. The
    reference also pads the lane count to a power of two to bound its
    compiles; nothing compiles here, so it does not.

    -> ``[(space, downlink), ...]`` host bool masks over each lane's real
    slots.
    """
    ns = [int(np.shape(c)[0]) for c in conf]
    if not ns:
        return []
    n_pad = max(ns + [1]) if n_pad is None else int(n_pad)
    if n_pad < max(ns):
        raise ValueError(
            f"throttle_padded_batch: n_pad={n_pad} < max lane length "
            f"{max(ns)} would drop real tiles")
    conf_pad = np.full((len(ns), n_pad), -1.0)
    act = np.zeros((len(ns), n_pad), bool)
    for i, (c, n) in enumerate(zip(conf, ns)):
        conf_pad[i, :n] = c
        act[i, :n] = True
    sizes = np.broadcast_to(np.asarray(tile_bytes, np.float64)[:, None],
                            conf_pad.shape)
    space, down = _throttle_lanes(conf_pad, np.ascontiguousarray(sizes),
                                  np.asarray(budgets, np.float64),
                                  np.asarray(conf_p, np.float64),
                                  np.asarray(conf_q, np.float64), act, policy)
    space, down = space.numpy(), down.numpy()
    return [(space[i, :n], down[i, :n]) for i, n in enumerate(ns)]


_BUDGET_TINY = float(np.finfo(np.float64).tiny)


def clamp_budget_bytes(n_bytes: float) -> float:
    """Clamp a window byte budget to exact 0.0 when it is negative or has
    underflowed to a denormal; normal positive budgets pass unchanged."""
    n_bytes = float(n_bytes)
    return n_bytes if n_bytes >= _BUDGET_TINY else 0.0


def contact_budget_bytes(bandwidth_mbps: float, contact_s: float) -> float:
    """Contact-window byte budget (paper §IV-A3: e.g. 100 Mbps x 6 min);
    zero for a degenerate window (each operand is clamped at 0)."""
    return max(bandwidth_mbps, 0.0) * 1e6 / 8.0 * max(contact_s, 0.0)


def bandwidth_efficiency(err_baseline: float, err_system: float,
                         bytes_baseline: float, bytes_system: float) -> float:
    """Error reduction per downlinked byte against a baseline (the
    paper's '9.6x bandwidth efficiency' metric); ``bytes_baseline`` is
    taken for the reference's signature and not used."""
    return max(err_baseline - err_system, 0.0) / max(bytes_system, 1.0)
