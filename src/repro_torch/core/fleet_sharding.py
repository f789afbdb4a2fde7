"""The fleet's placement context, off the mesh: one card.

Counterpart of ``repro/core/fleet_sharding.py``, whose ``FleetSharding``
places the fleet's stacked lanes along a ``sats`` device mesh. The port
runs a fleet on one card, so only the off-mesh case exists: ``pad`` is
the identity on lane counts and ``device_put`` returns its input. A
mesh is not ported and raises.
"""
from __future__ import annotations


class FleetSharding:
    """Placement context for the ``sats`` axis; only ``mesh=None``."""

    __slots__ = ()

    def __init__(self, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "a sats device mesh is not ported: the port runs a fleet on "
                "one card (ROADMAP queue 1)")

    on_mesh = False
    n_devices = 1

    def pad(self, n: int) -> int:
        """Smallest device multiple >= n: ``n`` on one device."""
        return int(n)

    def device_put(self, arr):
        return arr
