"""Roofline terms of a dry-run cell, and the collectives that a traced
step sends.

Counterpart of ``repro/launch/roofline.py``. Three terms per (arch x
shape x mesh), in seconds:

  compute    = FLOPs per device / the card's peak bf16 rate
  memory     = HBM bytes per device / the card's HBM rate
  collective = collective bytes per device / the link's rate

The FLOPs and HBM bytes are what ``launch.dryrun`` counts over the
step's local (per-rank) ops; the collective bytes are what
:func:`count_collectives` sums over the functional collectives that
DTensor's redistributions send, each result's bytes times the reference's
ring factor (an all-reduce moves ~2x its payload, the others ~1x).

The hardware is the NVIDIA H100 SXM's data sheet: 989e12 bf16 FLOP/s
dense on the tensor cores, 3.35e12 B/s of HBM3; NVLink 4 at 450e9 B/s a
direction between the 8 cards of one node, and for a mesh larger than a
node one 400 Gb/s NIC a card (50e9 B/s). These are data-sheet rates, not
measurements.

The reference also subtracts the bf16 <-> float32 converts that XLA's
CPU backend inserts around every bf16 product (``convert_elems``,
``convert_bytes``): an artifact of that backend, which a TPU compile
would not contain. The port's dry run traces PyTorch's own ops, which
insert no such converts, so there is nothing to subtract and the two
terms are gone.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

PEAK_FLOPS = 989e12      # bf16 dense, per card
HBM_BW = 3.35e12         # bytes/s per card
NVLINK_BW = 450e9        # bytes/s per direction, within an 8-card node
NIC_BW = 50e9            # bytes/s per card across nodes (400 Gb/s)
NODE = 8                 # cards in an NVLink node


def link_bw(n_chips: int) -> float:
    """The collective rate of a mesh of ``n_chips``: NVLink within a
    node, the NIC beyond."""
    return NVLINK_BW if n_chips <= NODE else NIC_BW


COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_FACTOR = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
           "all-to-all": 1.0, "collective-permute": 1.0}

# the functional collectives (torch.ops._c10d_functional) by kind
_KIND = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}


def _nbytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_nbytes(o) for o in out)
    return 0


def collective_kind(func):
    """The reference's kind of a functional collective op, or None."""
    ns = func.namespace if hasattr(func, "namespace") else ""
    if ns not in ("_c10d_functional", "_c10d_functional_autograd"):
        return None
    return _KIND.get(func.overloadpacket.__name__)


class CollectiveCounts:
    """Bytes by kind (result bytes times the ring factor), ``counts`` by
    kind and ``total``, as the reference's ``parse_collectives``."""

    def __init__(self):
        self.bytes = {k: 0.0 for k in COLLECTIVES}
        self.counts = {k: 0 for k in COLLECTIVES}

    def add(self, kind: str, result_bytes: int):
        self.bytes[kind] += result_bytes * _FACTOR[kind]
        self.counts[kind] += 1

    def as_dict(self) -> Dict:
        out = dict(self.bytes)
        out["counts"] = dict(self.counts)
        out["total"] = float(sum(self.bytes.values()))
        return out


class CollectiveMode(FakeTensorMode):
    """A ``FakeTensorMode`` that counts, in ``collectives``, the
    functional collectives run inside it on local (fake) tensors. An op
    on DTensors is left to DTensor (the fake mode returns
    ``NotImplemented``), whose redistributions then run their
    collectives on the shards inside the mode, where they are counted:
    the explicit ``redistribute`` calls and those that DTensor's own
    dispatch inserts alike. ``launch.dryrun``'s counting mode is a
    subclass."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.collectives = CollectiveCounts()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs or {})
        kind = collective_kind(func)
        if kind is not None and out is not NotImplemented:
            self.collectives.add(kind, _nbytes(out))
        return out


def count_collectives():
    """A fake mode that counts the functional collectives sent inside it
    -> (mode, counts): ``with mode: ...``, then ``counts.as_dict()``."""
    mode = CollectiveMode(allow_non_fake_inputs=True)
    return mode, mode.collectives


@dataclass
class Roofline:
    flops: float               # per device
    bytes_hbm: float           # per device
    bytes_coll: float          # per device
    n_chips: int
    model_flops_total: float = 0.0
    min_bytes: float = 0.0     # floor: one pass over the arguments and outputs
    compute_s: float = field(init=False)
    memory_s: float = field(init=False)
    collective_s: float = field(init=False)

    def __post_init__(self):
        # traffic floored at one pass over the step's arguments and
        # outputs (parameters and activations move at least once)
        self.bytes_hbm = max(self.bytes_hbm, self.min_bytes)
        self.compute_s = self.flops / PEAK_FLOPS
        self.memory_s = self.bytes_hbm / HBM_BW
        self.collective_s = self.bytes_coll / link_bw(self.n_chips)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / all devices' counted FLOPs (remat and redundancy
        waste)."""
        total = self.flops * self.n_chips
        return self.model_flops_total / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """The share of the compute roofline reached if the cell runs at
        its bound: useful FLOP time over the bound."""
        useful_s = (self.model_flops_total / self.n_chips) / PEAK_FLOPS
        return useful_s / self.bound_s if self.bound_s else 0.0

    def as_dict(self):
        return {
            "flops_per_dev": self.flops,
            "hbm_bytes_per_dev": self.bytes_hbm,
            "coll_bytes_per_dev": self.bytes_coll,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops_total,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "n_chips": self.n_chips,
        }
