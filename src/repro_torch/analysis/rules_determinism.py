"""Determinism lints for the port.

Counterpart of ``repro/analysis/rules_determinism.py``. The fault
subsystem's replay contract is that every random draw routes through a
counter-hashed ``np.random.SeedSequence`` keyed by (seed, kind, site),
order-independent and bit-replayable, and that every other source of
nondeterminism (process-global RNG state, wall-clock reads) stays out
of ``repro_torch/core/`` and ``repro_torch/orbits/``. There these lints
ban the reference's footguns:

- ``determinism/global-rng``   - ``np.random.seed(...)`` (process-global
  state: one call anywhere silently reorders every later draw)
- ``determinism/unseeded-rng`` - argless ``np.random.default_rng()`` /
  ``np.random.SeedSequence()`` (fresh OS entropy per call)
- ``determinism/random-module`` - the stdlib ``random`` module (global
  Mersenne state; use a seeded numpy Generator). The port's own
  ``repro_torch.random`` (JAX's threefry in numpy, stateless) is not it.
- ``determinism/wall-clock``   - ``time.time()`` (timing accumulators
  use ``time.perf_counter``; wall-clock reads leak host time into
  results; waive with a reason if one is genuinely wanted)
- ``determinism/frozen-setattr`` - ``object.__setattr__`` on frozen
  dataclasses outside ``__post_init__`` (tree-wide: a frozen plan is
  frozen no matter which package mutates it)

Unlike JAX, whose draws all take an explicit key, torch keeps
process-global generators (one for the CPU, one a card). The port's
counterpart of the explicit-key discipline is an explicit
``torch.Generator`` for every draw (``detector.init(gen, ...)``,
``fit_counter(..., gen, ...)``), so these hold tree-wide as well:

- ``determinism/global-rng`` - ``torch.manual_seed``,
  ``torch.cuda.manual_seed[_all]``, ``torch.seed`` (they reseed the
  global generators every later unkeyed draw reads)
- ``determinism/unseeded-rng`` - a torch sampler without
  ``generator=``: ``torch.rand*``, ``randint``, ``randperm``,
  ``multinomial``, ``normal``, ``bernoulli``, ``poisson`` and the
  in-place ``Tensor.uniform_`` / ``normal_`` family
- ``determinism/cudnn-benchmark`` - ``torch.backends.cudnn.benchmark =
  True`` (cuDNN then times its algorithms per shape and may pick
  another one in another run)

Seeded constructors (``default_rng(0)``, ``torch.Generator().
manual_seed(k)``, ``repro_torch.random.randint(seed, n)``) are fine: the
ban is on unseeded or global state, not on randomness.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.engine import (Finding, ModuleContext, call_name,
                                         enclosing_function, register)

_SCOPES = ("repro_torch/core/", "repro_torch/orbits/")

_TORCH_GLOBAL_SEED = frozenset({
    "torch.manual_seed", "torch.seed", "torch.random.manual_seed",
    "torch.random.seed", "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
    "torch.cuda.seed", "torch.cuda.seed_all"})
_TORCH_SAMPLERS = frozenset({
    "torch.rand", "torch.rand_like", "torch.randn", "torch.randn_like",
    "torch.randint", "torch.randint_like", "torch.randperm",
    "torch.multinomial", "torch.normal", "torch.bernoulli", "torch.poisson"})
_INPLACE_SAMPLERS = frozenset({
    "uniform_", "normal_", "bernoulli_", "random_", "exponential_",
    "geometric_", "log_normal_", "cauchy_"})


def _in_scope(rel: str) -> bool:
    return any(s in rel for s in _SCOPES)


def _is_random_module_import(node: ast.AST) -> bool:
    if isinstance(node, ast.Import):
        return any(a.name == "random" for a in node.names)
    # `from random import x`, or `from numpy import random`; the port's
    # own stateless `repro_torch.random` is exempt
    if node.module == "random":
        return True
    port = node.level > 0 or (node.module or "").split(".")[0] == "repro_torch"
    return not port and any(a.name == "random" for a in node.names)


@register
def determinism_rule(ctx: ModuleContext) -> List[Finding]:
    findings: List[Finding] = []
    in_scope = _in_scope(ctx.rel)
    for node in ast.walk(ctx.tree):
        if in_scope and isinstance(node, (ast.Import, ast.ImportFrom)):
            if _is_random_module_import(node):
                findings.append(ctx.finding(
                    "determinism/random-module", node,
                    "stdlib `random` uses process-global Mersenne state; "
                    "use the counter-hashed SeedSequence discipline "
                    "(repro_torch.core.faults) or a seeded np.random "
                    "Generator"))
            continue
        if isinstance(node, ast.Assign):
            findings.extend(_check_cudnn_benchmark(ctx, node))
            continue
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        # tree-wide: frozen plans and torch's global generators
        if name == "object.__setattr__":
            findings.extend(_check_setattr(ctx, node))
            continue
        torch_finding = _check_torch_rng(ctx, node, name)
        if torch_finding is not None:
            findings.append(torch_finding)
            continue
        if not in_scope:
            continue
        if name in ("np.random.seed", "numpy.random.seed"):
            findings.append(ctx.finding(
                "determinism/global-rng", node,
                "np.random.seed mutates process-global RNG state and "
                "silently reorders every later draw; use a seeded "
                "Generator or the faults.py SeedSequence discipline"))
        elif (name in ("np.random.default_rng", "numpy.random.default_rng",
                       "default_rng", "np.random.SeedSequence",
                       "numpy.random.SeedSequence", "SeedSequence")
              and not node.args and not node.keywords):
            findings.append(ctx.finding(
                "determinism/unseeded-rng", node,
                f"argless {name}() draws fresh OS entropy per call — "
                f"unreplayable; pass an explicit seed/entropy"))
        elif name == "time.time":
            findings.append(ctx.finding(
                "determinism/wall-clock", node,
                "time.time() leaks wall-clock into core results; timing "
                "accumulators use time.perf_counter() — waive with a "
                "reason if wall-clock is genuinely required"))
    return findings


def _check_torch_rng(ctx: ModuleContext, node: ast.Call, name: str):
    if name in _TORCH_GLOBAL_SEED:
        return ctx.finding(
            "determinism/global-rng", node,
            f"{name} reseeds torch's process-global generator, which every "
            f"later draw without a generator reads; pass a seeded "
            f"torch.Generator to the draw instead")
    has_gen = any(kw.arg == "generator" for kw in node.keywords)
    if has_gen:
        return None
    inplace = (isinstance(node.func, ast.Attribute)
               and node.func.attr in _INPLACE_SAMPLERS)
    if name in _TORCH_SAMPLERS or inplace:
        return ctx.finding(
            "determinism/unseeded-rng", node,
            f"{name}() without generator= draws from torch's process-global "
            f"generator — unreplayable; pass a seeded torch.Generator")
    return None


def _check_cudnn_benchmark(ctx: ModuleContext, node: ast.Assign) -> List[Finding]:
    if not (isinstance(node.value, ast.Constant) and node.value.value is True):
        return []
    out = []
    for t in node.targets:
        if isinstance(t, ast.Attribute) and ast.unparse(t).endswith("cudnn.benchmark"):
            out.append(ctx.finding(
                "determinism/cudnn-benchmark", node,
                "cudnn.benchmark = True lets cuDNN time its algorithms per "
                "shape and pick another one in another run; keep the "
                "default choice"))
    return out


def _check_setattr(ctx: ModuleContext, node: ast.Call) -> List[Finding]:
    fn = enclosing_function(node)
    if fn is not None and fn.name == "__post_init__":
        return []
    where = f"in `{fn.name}`" if fn is not None else "at module level"
    return [ctx.finding(
        "determinism/frozen-setattr", node,
        f"object.__setattr__ {where}: frozen dataclasses may only be "
        f"written during __post_init__ — post-construction mutation "
        f"bypasses build-time validation")]
