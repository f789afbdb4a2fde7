"""Runtime steady-state guard for the port's rounds.

Counterpart of ``repro/analysis/jitguard.py``. JAX's silent-and-slow
failure is a recompile per round. The port compiles nothing per round,
but its own three have the same shape (correct results, a slow round):
a round that builds and loads a kernel library, a round that grows the
caching allocator with new ``cudaMalloc`` segments (a tensor rebuilt at
a new size each round, a stream hold that keeps blocks from reuse), and
a round that adds host syncs. :class:`LaunchGuard` counts them inside a
``with`` block:

    with LaunchGuard("fleet round 3") as g:
        fleet.ingest(frames)                # round >= 3, fixed sizes
    g.assert_steady_state()                 # raises on a build or a segment

- ``builds``: kernel libraries loaded inside the block (a
  :class:`~repro_torch.kernels._build.CudaKernel` whose ``_lib`` went
  from ``None`` to loaded; a first load builds with ``nvcc`` when the
  library is not on disk), named in ``loaded``;
- ``new_segments``: the delta of the allocator's
  ``segment.all.allocated`` on the current device;
- ``launches``: launches by entry, the deltas of each kernel's
  ``symbol_launches`` (entries that launched only);
- ``syncs``: synchronizing calls, the warnings that
  ``torch.cuda.set_sync_debug_mode("warn")`` raises while the block runs
  (copies to the host, ``.item()``, stream and device synchronizes, and
  the implicit ones the static lint cannot see: ``nonzero``, boolean
  masks), and ``sync_sites``, the same count by call site: the
  ``file:line`` of the innermost frame outside torch that made the call.
  The mode and the warning hook are process-wide, so only the outermost
  guard counts them (``counts_syncs``); a nested guard leaves ``syncs``
  at 0. Warnings from worker threads are counted too.

The guard reads deltas only: it never resets a kernel's counters, so
totals that others keep over the same kernels stay whole.

``mode``: ``"cuda"`` with a card (every count); ``"kernels"`` without
one when the caller passes its own ``kernels`` (loads and launches);
``"unsupported"`` without a card otherwise, where the port's kernels
cannot launch: then :meth:`assert_steady_state` returns, as JitGuard's
does without a compile-count source.
"""
from __future__ import annotations

import collections
import os
import sys
import threading
import warnings
from typing import Dict, List, Optional, Sequence

import torch

_SYNC_WARNING = "called a synchronizing CUDA operation"
_TORCH_DIR = os.path.dirname(torch.__file__) + os.sep


def _call_site() -> str:
    """``file:line`` of the innermost caller outside torch and the
    warnings machinery (the port's files from ``repro_torch/`` on)."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if not (fn.startswith(_TORCH_DIR) or fn == __file__
                or os.path.basename(fn) == "warnings.py"):
            key = "repro_torch" + os.sep
            name = fn[fn.rindex(key):] if key in fn else os.path.basename(fn)
            return f"{name}:{f.f_lineno}"
        f = f.f_back
    return "?"


class LaunchGuard:
    """Context manager counting kernel loads, new allocator segments,
    launches by entry and synchronizing calls in its dynamic extent."""

    _lock = threading.Lock()
    _sync_owner: Optional["LaunchGuard"] = None  # the guard counting syncs

    def __init__(self, label: str = "", kernels: Optional[Sequence] = None):
        self.label = label
        self.kernels = kernels
        self.mode: str = "inactive"
        self.builds = 0
        self.loaded: List[str] = []
        self.new_segments = 0
        self.launches: Dict[str, int] = {}
        self.syncs = 0
        self.sync_sites: Dict[str, int] = {}
        self.counts_syncs = False
        self._kernels: Sequence = ()
        self._loaded0: Dict[str, bool] = {}
        self._entries0: Dict[tuple, int] = {}
        self._seg0 = 0
        self._dev = None
        self._warn_ctx = None
        self._sites: collections.Counter = collections.Counter()
        self._sync_mode0 = None

    @staticmethod
    def _entries(kernels) -> Dict[tuple, int]:
        out = {}
        for k in kernels:
            with k._lock:
                out.update({(k.name, s): n for s, n in k.symbol_launches.items()})
        return out

    def __enter__(self) -> "LaunchGuard":
        self.builds, self.loaded, self.new_segments = 0, [], 0
        self.launches, self.syncs, self.sync_sites = {}, 0, {}
        self.counts_syncs = False
        if torch.cuda.is_available():
            self.mode = "cuda"
        elif self.kernels is not None:
            self.mode = "kernels"
        else:
            self.mode = "unsupported"
            return self
        if self.kernels is None:
            from repro_torch.kernels import ops
            self._kernels = ops.KERNELS
        else:
            self._kernels = tuple(self.kernels)
        self._loaded0 = {k.name: k._lib is not None for k in self._kernels}
        self._entries0 = self._entries(self._kernels)
        if self.mode == "cuda":
            self._dev = torch.device("cuda", torch.cuda.current_device())
            self._seg0 = torch.cuda.memory_stats(self._dev).get("segment.all.allocated", 0)
            with LaunchGuard._lock:
                if LaunchGuard._sync_owner is None:
                    LaunchGuard._sync_owner = self
                    self.counts_syncs = True
            if self.counts_syncs:
                self._sites = collections.Counter()
                self._warn_ctx = warnings.catch_warnings()
                self._warn_ctx.__enter__()
                warnings.filterwarnings("always", message=_SYNC_WARNING)
                shown = warnings.showwarning

                def show(message, category, filename, lineno, file=None, line=None):
                    if _SYNC_WARNING not in str(message):
                        # other warnings of the block go on as usual
                        return shown(message, category, filename, lineno, file, line)
                    site = _call_site()
                    with LaunchGuard._lock:
                        self._sites[site] += 1
                warnings.showwarning = show
                self._sync_mode0 = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc) -> bool:
        if self.mode not in ("cuda", "kernels"):
            return False
        if self.counts_syncs:
            torch.cuda.set_sync_debug_mode(self._sync_mode0)
            self._warn_ctx.__exit__(None, None, None)
            self._warn_ctx = None
            with LaunchGuard._lock:
                LaunchGuard._sync_owner = None
                self.sync_sites = dict(self._sites.most_common())
            self.syncs = sum(self.sync_sites.values())
        if self.mode == "cuda":
            seg = torch.cuda.memory_stats(self._dev).get("segment.all.allocated", 0)
            self.new_segments = max(0, seg - self._seg0)
        self.loaded = [k.name for k in self._kernels
                       if k._lib is not None and not self._loaded0.get(k.name, False)]
        self.builds = len(self.loaded)
        after = self._entries(self._kernels)
        self.launches = {sym: n - self._entries0.get((name, sym), 0)
                         for (name, sym), n in after.items()
                         if n != self._entries0.get((name, sym), 0)}
        return False

    @property
    def supported(self) -> bool:
        return self.mode in ("cuda", "kernels")

    def assert_steady_state(self, what: str = "") -> None:
        """Raise if the guarded block loaded a kernel library or grew the
        caching allocator; launches and syncs are reported, not gated."""
        if not self.supported:
            return
        if self.builds or self.new_segments:
            label = what or self.label or "guarded block"
            raise AssertionError(
                f"launchguard: {label} loaded {self.builds} kernel "
                f"librar{'y' if self.builds == 1 else 'ies'} {self.loaded} and "
                f"allocated {self.new_segments} new allocator segment(s); "
                f"steady-state rounds must reuse loaded kernels and cached "
                f"memory (a tensor rebuilt at a new size each round, or a "
                f"stream hold that keeps blocks from reuse) "
                f"[launches {self.launches}, syncs {self.syncs}]")
