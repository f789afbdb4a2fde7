"""AST-based static-analysis engine for the port (``src/repro_torch``).

Counterpart of ``repro/analysis/engine.py``, framework-free like it; the
port keeps its own copy. The invariants the port runs on (recount
workers that touch only worker-owned state, hot paths that copy device
values to the host only at their designed transfer points, seeded
draws that replay bit for bit) are checked mechanically: rules walk each
module's AST and emit :class:`Finding` records, a waiver comment with a
mandatory reason silences a deliberate exception in place, and a
baseline file lets pre-existing findings ratchet down instead of
blocking.

Rule modules self-register via :func:`register`; :func:`load_rules`
imports them all. Run the whole thing with ``python -m
repro_torch.analysis`` (see ``__main__.py`` for the CLI contract).

Waiver syntax (trailing comment on the flagged line)::

    x = t.cpu().numpy()  # analysis: waive(host-sync): the one designed copy

The rule id may be a family prefix (``host-sync`` waives
``host-sync/asarray``). A waiver with an empty reason is itself a
finding (``waiver/missing-reason``): exceptions must say why.
"""
from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

REPO_ROOT = Path(__file__).resolve().parents[3]
DEFAULT_TARGET = REPO_ROOT / "src" / "repro_torch"
DEFAULT_BASELINE = REPO_ROOT / "analysis_baseline_torch.json"


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str       # e.g. "thread-ownership/foreground"
    path: str       # repo-relative posix path
    line: int
    message: str

    @property
    def key(self) -> str:
        # line numbers drift under unrelated edits, so baseline keys are
        # (rule, file, message) with an occurrence count
        return f"{self.rule}::{self.path}::{self.message}"

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class ModuleContext:
    """Everything a rule needs about one parsed module."""

    path: Path                  # absolute
    rel: str                    # repo-relative posix path
    tree: ast.Module
    source: str

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        return Finding(rule, self.rel, getattr(node, "lineno", 0), message)


Rule = Callable[[ModuleContext], List[Finding]]
_REGISTRY: List[Rule] = []


def register(rule: Rule) -> Rule:
    _REGISTRY.append(rule)
    return rule


def load_rules() -> List[Rule]:
    """Import every rule module (idempotent) and return the registry."""
    from repro_torch.analysis import rules_determinism  # noqa: F401
    from repro_torch.analysis import rules_sync  # noqa: F401
    from repro_torch.analysis import rules_threads  # noqa: F401
    return list(_REGISTRY)


# -- AST helpers shared by the rule modules -------------------------------

def annotate_parents(tree: ast.Module) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._analysis_parent = node  # type: ignore[attr-defined]


def enclosing_function(node: ast.AST) -> Optional[ast.AST]:
    cur = getattr(node, "_analysis_parent", None)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = getattr(cur, "_analysis_parent", None)
    return None


def enclosing_class(node: ast.AST) -> Optional[ast.ClassDef]:
    cur = getattr(node, "_analysis_parent", None)
    while cur is not None:
        if isinstance(cur, ast.ClassDef):
            return cur
        cur = getattr(cur, "_analysis_parent", None)
    return None


def call_name(node: ast.Call) -> str:
    """Dotted name of a call target ('' when not a plain name/attr)."""
    try:
        return ast.unparse(node.func)
    except Exception:
        return ""


# -- waivers --------------------------------------------------------------

_WAIVER_RE = re.compile(r"#\s*analysis:\s*waive\(([^)]*)\)\s*:?\s*(.*)")


def collect_waivers(source: str, rel: str
                    ) -> Tuple[Dict[int, List[Tuple[str, str]]],
                               List[Finding]]:
    """Per-line waivers plus findings for malformed ones.

    A trailing waiver covers its own line; a waiver on a comment-only
    line covers the next code line (for sites too long to annotate
    inline)."""
    lines = source.splitlines()
    waivers: Dict[int, List[Tuple[str, str]]] = {}
    bad: List[Finding] = []
    for lineno, text in enumerate(lines, start=1):
        m = _WAIVER_RE.search(text)
        if not m:
            continue
        rule = m.group(1).strip()
        reason = m.group(2).strip()
        if not rule or not reason:
            bad.append(Finding(
                "waiver/missing-reason", rel, lineno,
                "waiver must name a rule and give a non-empty reason: "
                "# analysis: waive(<rule>): <why this exception is safe>"))
            continue
        target = lineno
        if text[:m.start()].strip() == "":  # standalone comment line
            for nxt in range(lineno, len(lines)):
                code = lines[nxt].strip()
                if code and not code.startswith("#"):
                    target = nxt + 1
                    break
        waivers.setdefault(target, []).append((rule, reason))
    return waivers, bad


def _waived(finding: Finding,
            waivers: Dict[int, List[Tuple[str, str]]]) -> bool:
    for rule, _reason in waivers.get(finding.line, ()):
        if finding.rule == rule or finding.rule.startswith(rule + "/"):
            return True
    return False


# -- running the rules -------------------------------------------------

def iter_py_files(paths: Sequence[Path]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            out.extend(sorted(q for q in p.rglob("*.py")
                              if "__pycache__" not in q.parts))
        elif p.suffix == ".py":
            out.append(p)
    return out


def _relpath(path: Path, repo_root: Path) -> str:
    try:
        return path.resolve().relative_to(repo_root).as_posix()
    except ValueError:
        return path.as_posix()


def analyze(paths: Sequence[Path],
            repo_root: Path = REPO_ROOT,
            rules: Optional[Sequence[Rule]] = None,
            ) -> Tuple[List[Finding], List[Finding]]:
    """Run every rule over every file.

    Returns ``(findings, waived)``: unwaived findings (including
    malformed-waiver findings, which are never suppressible) and the
    list a waiver comment silenced (for ``--verbose`` reporting).
    """
    rules = list(rules) if rules is not None else load_rules()
    findings: List[Finding] = []
    waived: List[Finding] = []
    for path in iter_py_files(paths):
        source = path.read_text()
        rel = _relpath(path, repo_root)
        try:
            tree = ast.parse(source, filename=str(path))
        except SyntaxError as e:
            findings.append(Finding("parse/error", rel, e.lineno or 0,
                                    f"syntax error: {e.msg}"))
            continue
        annotate_parents(tree)
        waivers, bad_waivers = collect_waivers(source, rel)
        findings.extend(bad_waivers)
        ctx = ModuleContext(path=path, rel=rel, tree=tree, source=source)
        for rule in rules:
            for f in rule(ctx):
                (waived if _waived(f, waivers) else findings).append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings, waived


# -- baseline (ratchet) ---------------------------------------------------

def baseline_counts(findings: Sequence[Finding]) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.key] = counts.get(f.key, 0) + 1
    return counts


def load_baseline(path: Path) -> Dict[str, int]:
    if not Path(path).exists():
        return {}
    text = Path(path).read_text()
    if not text.strip():
        return {}
    data = json.loads(text)
    raw = data.get("findings", data) if isinstance(data, dict) else {}
    return {str(k): int(v) for k, v in raw.items()
            if not str(k).startswith("_")}


def write_baseline(findings: Sequence[Finding], path: Path) -> None:
    payload = {
        "_comment": (
            "repro_torch.analysis suppression baseline: known findings, "
            "keyed rule::path::message -> count. The CLI fails only on "
            "findings NOT covered here, so this file may only shrink "
            "(ratchet): fix or waive a finding, then `python -m "
            "repro_torch.analysis --update-baseline` to drop its entry."),
        "findings": dict(sorted(baseline_counts(findings).items())),
    }
    Path(path).write_text(json.dumps(payload, indent=2) + "\n")


def apply_baseline(findings: Sequence[Finding], baseline: Dict[str, int]
                   ) -> Tuple[List[Finding], List[Finding], List[str]]:
    """Split findings into (new, baselined); also return stale keys:
    baseline entries no longer matched, i.e. ratchet progress."""
    remaining = dict(baseline)
    new: List[Finding] = []
    old: List[Finding] = []
    for f in findings:
        if remaining.get(f.key, 0) > 0:
            remaining[f.key] -= 1
            old.append(f)
        else:
            new.append(f)
    stale = sorted(k for k, v in remaining.items() if v > 0)
    return new, old, stale
