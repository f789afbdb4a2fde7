"""Thread-ownership race checker for the port's recount pipeline.

Counterpart of ``repro/analysis/rules_threads.py``, pointed at
``repro_torch/core/contact.py``. The ground segment's recount pipeline
runs worker threads spawned via ``threading.Thread(target=...)``. The
contract that keeps depth-k pipelining bit-exact is ownership: a worker
may read immutable config and its own per-round snapshot, write only its
round's slots and per-segment outputs, and must check its round's
``cancel`` event before every write-back group: a worker abandoned by
the watchdog writes NOTHING. This rule makes that contract a build
failure.

The ownership map below is *declarative* and name-based: ``self`` in a
mapped class resolves by class name, other receivers resolve by the
repo's parameter-naming conventions (``fleet``/``work``/``rnd``/``seg``/
``stats``/``m``). Every function reachable from a thread entry point is
checked; foreground-only functions (``execute``/``_retire``/``sync``)
are deliberately out of scope: they run under foreground ownership.

On a CUDA device the port's worker runs on the segment's own stream: it
reads its round's ``stream`` and ``ready`` event, makes its stream wait
for the event (``wait_event``, which only orders the two streams) and
synchronizes the stream when it ends. A ``synchronize`` waits on device
work, as a count does, so it is a barrier: a cancel check made before
it is stale after it. Neither is a write-back.

Findings:

- ``thread-ownership/foreground`` - worker code reads or writes a
  foreground-owned attribute (e.g. the ``recount_s``/``wait_s``
  accumulators, the pipeline deque, the segment's stream).
- ``thread-ownership/cancel`` - a write-back (guarded attribute write or
  Aggregate-stage call) not covered by a ``cancel.is_set()`` check since
  the last compute barrier / loop round.
- ``thread-ownership/undeclared`` - worker code writes an attribute of a
  mapped role that the ownership map does not permit.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.engine import (Finding, ModuleContext, call_name,
                                         enclosing_class, register)

ANY = "*"


@dataclass(frozen=True)
class Role:
    """Worker-visible ownership contract for one object kind."""

    read: object = frozenset()        # attrs the worker may read (or ANY)
    write: object = frozenset()       # attrs the worker may write (or ANY)
    guarded: frozenset = frozenset()  # writes permitted only under cancel
    foreground: frozenset = frozenset()  # attrs the worker must not touch


OWNERSHIP: Dict[str, Role] = {
    # the dispatcher: workers may read its config, never its accounting
    "GroundSegment": Role(
        read=frozenset({"fleet", "watchdog_s", "depth"}),
        foreground=frozenset({"recount_s", "wait_s", "rounds_deferred",
                              "max_in_flight", "_queue", "_stream"})),
    # shared engine/config handles are read-only; every ingest/contact
    # accumulator is foreground-owned (the worker charges nothing)
    "Fleet": Role(
        read=frozenset({"ground", "space", "pcfg", "sharding", "missions",
                        "fault_stats", "n_sats"}),
        foreground=frozenset({"ledger", "_ingest_s", "_contact_s",
                              "_ingest_tail", "_pending_counts",
                              "_ingest_dispatch_s", "_host_fetch_s",
                              "_device_compute_s", "_windows_served"})),
    # the worker's own per-round object: the injected fault and stall,
    # the stream and ready event set at dispatch are its to read; the
    # err/clock slots are its to write; the foreground reads them only
    # after join()
    "_InFlightRound": Role(read=frozenset({"work", "cancel", "thread", "fault",
                                           "stall_s", "stream", "ready"}),
                           write=frozenset({"err", "worker_s"})),
    # the dispatch-time snapshot (the ground counter included) is frozen:
    # read-only
    "_RecountWork": Role(read=frozenset({"ground", "by_thresh", "agg"})),
    # per-segment recount output: pure write of this round's own
    # segments, legal only behind a fresh cancel check
    "Segment": Role(read=ANY, guarded=frozenset({"counts_gd"})),
    # GIL-atomic int event counters, incremented from either side
    "FaultStats": Role(read=ANY, write=ANY),
    # stage graph handle: the Aggregate write-back routes through it
    "Mission": Role(read=frozenset({"contact_stages"}),
                    foreground=frozenset({"ledger", "_pending"})),
}

# receiver-name -> role, the repo's parameter naming convention
PARAM_ROLES: Dict[str, str] = {
    "fleet": "Fleet", "work": "_RecountWork", "rnd": "_InFlightRound",
    "seg": "Segment", "stats": "FaultStats", "m": "Mission",
}
# attribute-chain hops: self.fleet on GroundSegment is a Fleet
ATTR_ROLES: Dict[Tuple[str, str], str] = {("GroundSegment", "fleet"): "Fleet"}

# device-compute calls, and a stream's synchronize that waits on them: a
# cancel check goes stale once one runs (the watchdog may fire during the
# batch). A stream's wait_event / record_stream only order the streams
BARRIER_CALLS = frozenset({"count_tiles_multi", "count_tiles",
                           "count_tiles_batched", "_recount_plan", "synchronize"})
# calls that ARE a write-back group (Aggregate stage dispatch)
GUARDED_CALL_MARKER = "contact_stages"
CANCEL_NAMES = frozenset({"cancel"})


def _collect_functions(tree: ast.Module):
    """All defs: by bare name (module level preferred) and (class, name)."""
    by_name: Dict[str, ast.AST] = {}
    methods: Dict[Tuple[str, str], ast.AST] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            cls = enclosing_class(node)
            if cls is not None:
                methods[(cls.name, node.name)] = node
            else:
                by_name.setdefault(node.name, node)
    return by_name, methods


def _thread_entries(tree, by_name, methods) -> List[Tuple[str, ast.AST]]:
    """(owner_class_or_None, fn) for each Thread(target=...) expression."""
    entries = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and call_name(node).endswith("Thread")):
            continue
        for kw in node.keywords:
            if kw.arg != "target":
                continue
            t = kw.value
            if (isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                cls = enclosing_class(node)
                fn = methods.get((cls.name, t.attr)) if cls else None
                if fn is not None:
                    entries.append((cls.name, fn))
            elif isinstance(t, ast.Name) and t.id in by_name:
                entries.append((None, by_name[t.id]))
    return entries


def _reachable(entries, by_name, methods):
    """Closure over same-module calls: f(), self.m() with static names."""
    seen: List[Tuple[Optional[str], ast.AST]] = []
    work = list(entries)
    while work:
        cls, fn = work.pop()
        if any(f is fn for _, f in seen):
            continue
        seen.append((cls, fn))
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Name) and f.id in by_name:
                work.append((None, by_name[f.id]))
            elif (isinstance(f, ast.Attribute)
                  and isinstance(f.value, ast.Name) and f.value.id == "self"
                  and cls is not None and (cls, f.attr) in methods):
                work.append((cls, methods[(cls, f.attr)]))
    return seen


def _resolve_role(expr: ast.AST, self_class: Optional[str]) -> Optional[str]:
    """Role name for a receiver expression, else None."""
    if isinstance(expr, ast.Name):
        if expr.id == "self":
            return self_class if self_class in OWNERSHIP else None
        return PARAM_ROLES.get(expr.id)
    if isinstance(expr, ast.Attribute):
        base = _resolve_role(expr.value, self_class)
        if base is not None:
            return ATTR_ROLES.get((base, expr.attr))
    return None


def _is_cancel_guard(stmt: ast.If) -> bool:
    """`if cancel is not None and cancel.is_set(): return/continue/...`"""
    has_check = any(
        isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
        and n.func.attr == "is_set"
        and _mentions_cancel(n.func.value)
        for n in ast.walk(stmt.test))
    exits = any(isinstance(s, (ast.Return, ast.Raise, ast.Continue,
                               ast.Break)) for s in stmt.body)
    return has_check and exits


def _mentions_cancel(expr: ast.AST) -> bool:
    for n in ast.walk(expr):
        if isinstance(n, ast.Name) and n.id in CANCEL_NAMES:
            return True
        if isinstance(n, ast.Attribute) and n.attr in CANCEL_NAMES:
            return True
    return False


def _has_barrier_or_guarded_call(stmts) -> bool:
    for s in stmts:
        for n in ast.walk(s):
            if isinstance(n, ast.Call):
                name = call_name(n)
                if name.rsplit(".", 1)[-1] in BARRIER_CALLS:
                    return True
                if GUARDED_CALL_MARKER in name:
                    return True
    return False


@dataclass
class _FnChecker:
    ctx: ModuleContext
    self_class: Optional[str]
    fn: ast.AST
    findings: List[Finding] = field(default_factory=list)
    cancel_ok: bool = False

    def run(self) -> List[Finding]:
        self.cancel_ok = False
        self._stmts(self.fn.body)
        return self.findings

    # -- statement walk with cancel-freshness state -------------------

    def _stmts(self, stmts) -> None:
        for stmt in stmts:
            if isinstance(stmt, ast.If):
                if _is_cancel_guard(stmt):
                    self._stmts(stmt.orelse)
                    self.cancel_ok = True
                    continue
                before = self.cancel_ok
                self._stmts(stmt.body)
                after_body = self.cancel_ok
                self.cancel_ok = before
                self._stmts(stmt.orelse)
                self.cancel_ok = self.cancel_ok and after_body
            elif isinstance(stmt, (ast.For, ast.While)):
                head = stmt.iter if isinstance(stmt, ast.For) else stmt.test
                self._scan(head)
                round_loop = _has_barrier_or_guarded_call(stmt.body)
                if round_loop:
                    # iterations 2..n re-enter after a barrier/group: a
                    # pre-loop check does not cover them
                    self.cancel_ok = False
                self._stmts(stmt.body)
                self._stmts(stmt.orelse)
                if round_loop:
                    self.cancel_ok = False
            elif isinstance(stmt, ast.Try):
                self._stmts(stmt.body)
                for h in stmt.handlers:
                    self._stmts(h.body)
                self._stmts(stmt.orelse)
                self._stmts(stmt.finalbody)
            elif isinstance(stmt, ast.With):
                for item in stmt.items:
                    self._scan(item.context_expr)
                self._stmts(stmt.body)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._stmts(stmt.body)  # nested def runs on this thread
            else:
                self._scan(stmt)

    # -- per-statement attribute/call checks --------------------------

    def _scan(self, node: ast.AST) -> None:
        if node is None:
            return
        stale = False
        for n in ast.walk(node):
            if isinstance(n, ast.Attribute):
                self._attr(n)
            elif isinstance(n, ast.Call):
                name = call_name(n)
                if name.rsplit(".", 1)[-1] in BARRIER_CALLS:
                    stale = True
                if GUARDED_CALL_MARKER in name:
                    if not self.cancel_ok:
                        self.findings.append(self.ctx.finding(
                            "thread-ownership/cancel", n,
                            f"worker write-back `{name}(...)` without a "
                            f"cancel check since the last barrier/group — "
                            f"an abandoned worker must write nothing"))
                    stale = True
        if stale:
            self.cancel_ok = False

    def _attr(self, n: ast.Attribute) -> None:
        role_name = _resolve_role(n.value, self.self_class)
        if role_name is None:
            return
        role = OWNERSHIP[role_name]
        recv = ast.unparse(n.value)
        is_write = isinstance(n.ctx, (ast.Store, ast.Del))
        if n.attr in role.foreground:
            self.findings.append(self.ctx.finding(
                "thread-ownership/foreground", n,
                f"worker thread {'writes' if is_write else 'reads'} "
                f"foreground-owned attribute `{recv}.{n.attr}` "
                f"({role_name} ownership map)"))
            return
        if not is_write:
            return
        if role.write == ANY or n.attr in role.write:
            return
        if n.attr in role.guarded:
            if not self.cancel_ok:
                self.findings.append(self.ctx.finding(
                    "thread-ownership/cancel", n,
                    f"worker write-back `{recv}.{n.attr}` without a cancel "
                    f"check since the last barrier — an abandoned worker "
                    f"must write nothing"))
            return
        self.findings.append(self.ctx.finding(
            "thread-ownership/undeclared", n,
            f"worker thread writes `{recv}.{n.attr}`, which the "
            f"{role_name} ownership map does not declare worker-writable"))


@register
def thread_ownership_rule(ctx: ModuleContext) -> List[Finding]:
    if "threading" not in ctx.source:
        return []
    by_name, methods = _collect_functions(ctx.tree)
    entries = _thread_entries(ctx.tree, by_name, methods)
    if not entries:
        return []
    findings: List[Finding] = []
    seen_fns: Set[int] = set()
    for cls, fn in _reachable(entries, by_name, methods):
        if id(fn) in seen_fns:
            continue
        seen_fns.add(id(fn))
        findings.extend(_FnChecker(ctx, cls, fn).run())
    return findings
