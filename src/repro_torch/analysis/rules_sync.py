"""Host-sync-in-hot-path lint for the port.

Counterpart of ``repro/analysis/rules_sync.py``. Inside the hot modules
device values stay on the device until their designed transfer point:
a stray ``.item()`` / ``.cpu()`` / ``float()`` on a CUDA tensor blocks
the host until the card has drained its queue and copies the value back,
once a call, which is the per-round churn the engine's batching exists
to avoid.

The rule runs only over the hot scopes (``core/engine.py``, the
``cascade`` count paths, ``core/dedup.py``, ``orbits/propagation.py``)
and flags only syncs whose operand is *device-tainted*. Taint starts
where a tensor is made or moved on the device:

- a torch factory with a ``device=`` other than ``"cpu"``
  (``torch.arange(n, device=dev)``), ``.to(<device>)`` and ``.cuda()``;
- the port's kernels, ``ops.*`` / ``kops.*``;
- a function that returns a tainted value (a module-level fixpoint
  infers those, as the reference's does), and the cross-module ones in
  :data:`EXTERNAL_PRODUCERS`.

It flows through assignments, method chains, subscripts and operators,
and through calls: a call with a tainted argument returns a tainted
value (torch ops compute on their inputs' device), save builtins that
return host values and numpy. A parameter is tainted where a call in the
same module passes it a tainted argument. A host tensor
(``torch.as_tensor(np_array)``, ``torch.from_numpy``, a factory with no
device) is not a device value, and neither is a tensor's metadata
(``.shape``, ``.device``, ``.dtype``, ``.size()``, ``.numel()``).

Findings:

- ``host-sync/asarray`` - ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
  ``np.asarray`` / ``np.array`` on a device value
- ``host-sync/item``    - ``.item()`` on a device value
- ``host-sync/tolist``  - ``.tolist()`` on a device value
- ``host-sync/float``, ``host-sync/int``, ``host-sync/bool`` -
  ``float()`` / ``int()`` / ``bool()`` on a device value
- ``host-sync/block``   - any ``torch.cuda.synchronize()`` or
  ``Stream``/``Event.synchronize()`` in a hot scope

The designed single-copy transfer points carry explicit ``# analysis:
waive(host-sync): <reason>`` comments; everything else is a finding.

Implicit syncs are not seen here: a branch on a device tensor
(``if t:``), ``torch.nonzero`` and boolean-mask indexing (their output
size is data-dependent), and indexing with a 0-d integer tensor all
wait for the card without a call the AST can name. The runtime guard
(:class:`~repro_torch.analysis.launchguard.LaunchGuard`) counts those,
through ``torch.cuda.set_sync_debug_mode``.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from repro_torch.analysis.engine import (Finding, ModuleContext, call_name,
                                         register)

# hot scopes: path suffix -> top-level function allowlist (None = whole
# module). cascade is scoped to its count paths: training and the
# reference path's count_tiles_batched_ref are host code by design.
HOT_SCOPES: Dict[str, Optional[frozenset]] = {
    "repro_torch/core/engine.py": None,
    "repro_torch/core/cascade.py": frozenset({
        "count_tiles", "_tier_batch", "_count_forward", "count_tiles_batched",
        "_count_tiles_chunks", "_count_forward_device", "count_tiles_multi"}),
    "repro_torch/core/dedup.py": None,
    "repro_torch/orbits/propagation.py": None,
}

# cross-module device producers: functions of other port modules that
# return device tensors whatever their arguments
EXTERNAL_PRODUCERS = frozenset({
    "count_tiles", "_count_tiles_chunks", "_count_forward_device",
    "device_constant", "propagate", "eci_to_ecef",
})
_KERNEL_ROOTS = ("ops.", "kops.")
# torch calls that make host tensors unless given a device
_FACTORIES = frozenset({
    "zeros", "ones", "full", "empty", "arange", "linspace", "logspace", "eye",
    "tensor", "as_tensor", "from_numpy", "rand", "randn", "randint", "randperm"})
# torch names that are no tensor at all
_TORCH_NON_TENSOR = ("torch.device", "torch.Generator", "torch.cuda.", "torch.backends.",
                     "torch.no_grad", "torch.inference_mode", "torch.enable_grad",
                     "torch.set_", "torch.get_", "torch.manual_seed", "torch.is_",
                     "torch.finfo", "torch.iinfo", "torch.dtype")
# builtins whose result is a host value whatever they are given
_HOST_CALLS = frozenset({
    "len", "isinstance", "issubclass", "hasattr", "callable", "id", "type", "range",
    "print", "str", "repr", "format", "hash", "int", "float", "bool"})
# tensor attributes and methods that give host metadata or a host copy
_HOST_ATTRS = frozenset({"shape", "device", "dtype", "ndim", "is_cuda", "layout"})
_HOST_METHODS = frozenset({
    "size", "dim", "numel", "nelement", "stride", "element_size", "data_ptr",
    "is_contiguous", "get_device", "item", "tolist", "cpu", "numpy"})
_DTYPE_NAMES = frozenset({
    "float16", "float32", "float64", "bfloat16", "half", "float", "double",
    "int8", "uint8", "int16", "int32", "int64", "long", "int", "bool"})


def _scope_functions(rel: str) -> Optional[frozenset]:
    for suffix, fns in HOT_SCOPES.items():
        if rel.endswith(suffix):
            return fns if fns is not None else frozenset({"*"})
    return None


def _is_cpu_literal(expr: Optional[ast.AST]) -> bool:
    return (isinstance(expr, ast.Constant) and isinstance(expr.value, str)
            and expr.value.split(":")[0] == "cpu")


def _device_kw(call: ast.Call) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == "device":
            return kw.value
    return None


def _to_target(call: ast.Call) -> str:
    """What ``x.to(...)`` does: "cpu", "device" (a move) or "cast"."""
    dev = _device_kw(call)
    if dev is not None:
        return "cpu" if _is_cpu_literal(dev) else "device"
    if not call.args:
        return "cast"
    a = call.args[0]
    if _is_cpu_literal(a):
        return "cpu"
    if isinstance(a, ast.Constant):
        return "device"  # "cuda", "cuda:0"
    if isinstance(a, ast.Attribute) and (
            a.attr == "dtype" or (a.attr in _DTYPE_NAMES
                                  and ast.unparse(a.value) == "torch")):
        return "cast"
    if isinstance(a, ast.Name) and "dtype" in a.id:
        return "cast"
    return "device"  # a device, or another tensor (its device)


def _args_tainted(call: ast.Call, taint: Set[str], producers: Set[str]) -> bool:
    return (any(_tainted(a, taint, producers) for a in call.args)
            or any(_tainted(kw.value, taint, producers) for kw in call.keywords))


def _call_tainted(expr: ast.Call, taint: Set[str], producers: Set[str]) -> bool:
    name = call_name(expr)
    short = name.rsplit(".", 1)[-1]
    method = isinstance(expr.func, ast.Attribute)
    recv = expr.func.value if method else None
    if method and short in _HOST_METHODS:
        return False
    if method and short == "cuda":
        return True
    if method and short == "to":
        target = _to_target(expr)
        if target == "cast":
            return _tainted(recv, taint, producers)
        return target == "device"
    if name.startswith(_TORCH_NON_TENSOR):
        return False
    if name.startswith("torch.") and short in _FACTORIES:
        dev = _device_kw(expr)
        return dev is not None and not _is_cpu_literal(dev)
    if name.startswith(_KERNEL_ROOTS) or short in producers:
        return True
    if name in _HOST_CALLS or name.startswith(("np.", "numpy.", "math.")):
        return False
    if _args_tainted(expr, taint, producers):
        return True
    # method chains on tainted receivers: x.sum(), x.index_select(0, i)
    return method and _tainted(recv, taint, producers)


def _tainted(expr: ast.AST, taint: Set[str], producers: Set[str]) -> bool:
    """Conservative device-value test for an expression."""
    if isinstance(expr, ast.Name):
        return expr.id in taint
    if isinstance(expr, ast.Call):
        return _call_tainted(expr, taint, producers)
    if isinstance(expr, ast.Attribute):
        return expr.attr not in _HOST_ATTRS and _tainted(expr.value, taint, producers)
    if isinstance(expr, ast.Subscript):
        return _tainted(expr.value, taint, producers)
    if isinstance(expr, ast.BinOp):
        return (_tainted(expr.left, taint, producers)
                or _tainted(expr.right, taint, producers))
    if isinstance(expr, ast.UnaryOp):
        return _tainted(expr.operand, taint, producers)
    if isinstance(expr, ast.Compare):
        return (_tainted(expr.left, taint, producers)
                or any(_tainted(c, taint, producers)
                       for c in expr.comparators))
    if isinstance(expr, ast.IfExp):
        return (_tainted(expr.body, taint, producers)
                or _tainted(expr.orelse, taint, producers))
    if isinstance(expr, (ast.Tuple, ast.List)):
        return any(_tainted(e, taint, producers) for e in expr.elts)
    if isinstance(expr, (ast.ListComp, ast.GeneratorExp, ast.SetComp)):
        return (_tainted(expr.elt, taint, producers)
                or any(_tainted(g.iter, taint, producers)
                       for g in expr.generators))
    if isinstance(expr, ast.Starred):
        return _tainted(expr.value, taint, producers)
    return False


def _bound_names(target: ast.AST) -> List[str]:
    return [n.id for n in ast.walk(target) if isinstance(n, ast.Name)]


_GROWERS = frozenset({"append", "extend", "insert", "add"})


def _propagate(stmts, taint: Set[str], producers: Set[str]) -> None:
    """One in-order pass growing the tainted-name set."""
    for stmt in stmts:
        if isinstance(stmt, ast.Assign):
            if _tainted(stmt.value, taint, producers):
                for t in stmt.targets:
                    taint.update(_bound_names(t))
        elif isinstance(stmt, ast.AugAssign):
            if (_tainted(stmt.value, taint, producers)
                    or _tainted(stmt.target, taint, producers)):
                taint.update(_bound_names(stmt.target))
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None and _tainted(stmt.value, taint,
                                                   producers):
                taint.update(_bound_names(stmt.target))
        elif isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            # out.append(device_value) makes `out` a list of device values
            f = stmt.value.func
            if (isinstance(f, ast.Attribute) and f.attr in _GROWERS
                    and isinstance(f.value, ast.Name)
                    and _args_tainted(stmt.value, taint, producers)):
                taint.add(f.value.id)
        elif isinstance(stmt, ast.For):
            if _tainted(stmt.iter, taint, producers):
                taint.update(_bound_names(stmt.target))
            _propagate(stmt.body, taint, producers)
            _propagate(stmt.orelse, taint, producers)
        elif isinstance(stmt, (ast.While, ast.If)):
            _propagate(stmt.body, taint, producers)
            _propagate(stmt.orelse, taint, producers)
        elif isinstance(stmt, ast.With):
            for item in stmt.items:
                if (item.optional_vars is not None
                        and _tainted(item.context_expr, taint, producers)):
                    taint.update(_bound_names(item.optional_vars))
            _propagate(stmt.body, taint, producers)
        elif isinstance(stmt, ast.Try):
            _propagate(stmt.body, taint, producers)
            for h in stmt.handlers:
                _propagate(h.body, taint, producers)
            _propagate(stmt.orelse, taint, producers)
            _propagate(stmt.finalbody, taint, producers)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # closures see the enclosing taint minus their own params;
            # their locals do not leak back out
            inner = taint - _params(stmt)
            _propagate(stmt.body, inner, producers)


def _params(fn) -> Set[str]:
    a = fn.args
    return {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}


def _function_taint(fn, producers: Set[str], seed: Optional[Set[str]] = None,
                    params: Set[str] = frozenset()) -> Set[str]:
    """Two propagation passes ~ fixpoint for straight-line hot code.
    ``params``: this function's parameters that a caller passes device
    values."""
    taint: Set[str] = (set(seed or ()) - _params(fn)) | set(params)
    _propagate(fn.body, taint, producers)
    _propagate(fn.body, taint, producers)
    return taint


def _returns_tainted(fn, taint: Set[str], producers: Set[str]) -> bool:
    return any(isinstance(n, ast.Return) and n.value is not None
               and _tainted(n.value, taint, producers) for n in ast.walk(fn))


def _local_producers(fn, producers: Set[str], taint: Set[str]) -> Set[str]:
    """Nested defs whose returns are tainted (closures over the enclosing
    function's ``taint`` included) count as producers too."""
    out = set(producers)
    for node in ast.walk(fn):
        if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node is not fn and node.name not in out):
            if _returns_tainted(node, _function_taint(node, out, seed=taint), out):
                out.add(node.name)
    return out


def _analyze_function(fn, producers: Set[str], seed: Set[str], params: Set[str]):
    """-> (taint, local producers) of one top-level function: its taint
    and its nested producers depend on each other, so two rounds."""
    local = set(producers)
    taint = _function_taint(fn, local, seed, params)
    for _ in range(2):
        local = _local_producers(fn, producers, taint)
        taint = _function_taint(fn, local, seed, params)
    return taint, local


def _module_analysis(tree: ast.Module, module_taint: Set[str]):
    """Fixpoint over the module's top-level functions -> (producers,
    {function name: (taint, local producers)}). Producers: jit-free
    counterpart of the reference's, functions whose returns are tainted.
    Parameters: tainted where a call in the module passes a tainted
    argument."""
    producers: Set[str] = set(EXTERNAL_PRODUCERS)
    fns = {n.name: n for n in tree.body
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    params: Dict[str, Set[str]] = {name: set() for name in fns}
    state: Dict[str, tuple] = {}
    for _ in range(8):
        grew = False
        for name, fn in fns.items():
            taint, local = _analyze_function(fn, producers, module_taint, params[name])
            state[name] = (taint, local)
            if name not in producers and _returns_tainted(fn, taint, local):
                producers.add(name)
                grew = True
            for call in (n for n in ast.walk(fn) if isinstance(n, ast.Call)):
                callee = fns.get(call.func.id) if isinstance(call.func, ast.Name) else None
                if callee is None:
                    continue
                pos = [p.arg for p in callee.args.posonlyargs + callee.args.args]
                hit = {pos[i] for i, a in enumerate(call.args)
                       if i < len(pos) and not isinstance(a, ast.Starred)
                       and _tainted(a, taint, local)}
                hit |= {kw.arg for kw in call.keywords
                        if kw.arg is not None and _tainted(kw.value, taint, local)}
                if not hit <= params[callee.name]:
                    params[callee.name] |= hit
                    grew = True
        if not grew:
            break
    return producers, state


def _check_scope(ctx: ModuleContext, body, taint: Set[str],
                 producers: Set[str], findings: List[Finding]) -> None:
    for node in (n for s in body for n in ast.walk(s)):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        short = name.rsplit(".", 1)[-1]
        method = isinstance(node.func, ast.Attribute)
        recv_tainted = method and _tainted(node.func.value, taint, producers)
        if short == "synchronize":
            findings.append(ctx.finding(
                "host-sync/block", node,
                f"{name}() in a hot scope blocks the host on the card: "
                f"route the fetch through the designated transfer point or "
                f"waive with a reason"))
        elif recv_tainted and (short in ("cpu", "numpy")
                               or (short == "to" and _to_target(node) == "cpu")):
            findings.append(ctx.finding(
                "host-sync/asarray", node,
                f".{short}() on a device value blocks on a device->host "
                f"copy in a hot scope: defer it to the designated transfer "
                f"point or waive with a reason"))
        elif (name in ("np.asarray", "np.array", "numpy.asarray",
                       "numpy.array") and node.args
              and _tainted(node.args[0], taint, producers)):
            findings.append(ctx.finding(
                "host-sync/asarray", node,
                f"{name} on a device value blocks on a device->host "
                f"copy in a hot scope: defer it to the designated transfer "
                f"point or waive with a reason"))
        elif (name in ("float", "int", "bool") and node.args
              and _tainted(node.args[0], taint, producers)):
            findings.append(ctx.finding(
                f"host-sync/{name}", node,
                f"{name}() on a device value forces a blocking host sync "
                f"in a hot scope"))
        elif recv_tainted and short in ("item", "tolist"):
            findings.append(ctx.finding(
                f"host-sync/{short}", node,
                f".{short}() on a device value forces a blocking host sync "
                f"in a hot scope"))


@register
def host_sync_rule(ctx: ModuleContext) -> List[Finding]:
    scope = _scope_functions(ctx.rel)
    if scope is None:
        return []
    findings: List[Finding] = []
    whole_module = "*" in scope
    # module-level taint accumulates across the whole module body
    module_taint: Set[str] = set()
    module_stmts = [n for n in ctx.tree.body
                    if not isinstance(n, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.ClassDef))]
    _propagate(module_stmts, module_taint, set(EXTERNAL_PRODUCERS))
    producers, state = _module_analysis(ctx.tree, module_taint)
    for node in ctx.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not whole_module and node.name not in scope:
                continue
            taint, local = state[node.name]
            _check_scope(ctx, node.body, taint, local | producers, findings)
        elif whole_module and not isinstance(node, ast.ClassDef):
            _check_scope(ctx, [node], module_taint, producers, findings)
    return findings
