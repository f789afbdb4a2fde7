"""The port's static analysis (``repro_torch.analysis``) against the
reference's (``repro.analysis``), its torch rules, and ``LaunchGuard``.

Everything here is AST work or a stub kernel: no card code runs. The
reference's fixture trees (``tests/fixtures/analysis``) are copied into
``tmp_path/.../repro_torch/core/``, where the port's scopes see them, and
the port's engine must give the reference's ``(rule, line)`` multiset
and messages on them for the families both share (thread ownership,
determinism, waivers); the reference's host-sync fixtures are JAX code,
which the port's lint does not read. The torch fixtures are strings in
this file, written into ``tmp_path``.
"""
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

from repro.analysis import analyze as janalyze
from repro.analysis import engine as jengine
from repro_torch.analysis import LaunchGuard, analyze
from repro_torch.analysis import engine as tengine
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.kernels import _build, ops

FIXTURES = Path(__file__).parent / "fixtures" / "analysis"
BAD = FIXTURES / "bad_tree"
GOOD = FIXTURES / "good_tree"
SRC = tengine.REPO_ROOT / "src" / "repro_torch"
SHARED = ("thread-ownership/", "determinism/", "waiver/")

MISSING_REASON = (
    "import jax\nimport numpy as np\n"
    "f = jax.jit(lambda x: x)\n"
    "# analysis: waive(host-sync):\n"
    "y = np.asarray(f(1.0))\n")


def _port_copy(tmp_path, tree: Path) -> Path:
    """``<tree>/repro/core`` copied to ``tmp_path/<tree>/repro_torch/core``."""
    dst = tmp_path / tree.name / "repro_torch" / "core"
    shutil.copytree(tree / "repro" / "core", dst)
    return dst


def _shared(findings):
    """(rule, line, message) of the shared families; the port names its
    own package where the reference names ``repro``."""
    return sorted((f.rule, f.line, f.message.replace("repro_torch.", "repro."))
                  for f in findings if f.rule.startswith(SHARED))


def _write(tmp_path, rel: str, text: str) -> Path:
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(text)
    return p


def _rules(findings):
    return sorted(f.rule for f in findings)


# ---------------------------------------------------------------------------
# the port's engine and rules against the reference's, on its fixtures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tree, name", [
    (BAD, "contact_pre_pr8.py"), (BAD, "engine.py"), (BAD, "rng.py"),
    (GOOD, "engine.py"), (None, "missing_reason.py")])
def test_port_matches_reference_on_fixtures(tmp_path, tree, name):
    if tree is None:
        want_path = _write(tmp_path / "j", f"repro/core/{name}", MISSING_REASON)
        got_path = _write(tmp_path / "t", f"repro_torch/core/{name}", MISSING_REASON)
    else:
        want_path = tree / "repro" / "core" / name
        got_path = _port_copy(tmp_path, tree) / name
    want, _ = janalyze([want_path])
    got, _ = analyze([got_path])
    assert _shared(got) == _shared(want)
    assert _shared(want) or name == "engine.py"


def test_baseline_split_matches_reference():
    """Both ``apply_baseline``s split the same findings the same way
    under one baseline: some keys covered in part, one stale."""
    found, _ = janalyze([BAD])
    assert len(found) >= 6
    keys = sorted({f.key for f in found})
    baseline = {k: 1 for k in keys[::2]}
    baseline["determinism/global-rng::gone.py::fixed"] = 2
    j_new, j_old, j_stale = jengine.apply_baseline(found, baseline)
    t_found = [tengine.Finding(f.rule, f.path, f.line, f.message) for f in found]
    t_new, t_old, t_stale = tengine.apply_baseline(t_found, baseline)
    as_tuples = lambda fs: [(f.rule, f.path, f.line, f.message) for f in fs]  # noqa: E731
    assert as_tuples(t_new) == as_tuples(j_new) and j_new
    assert as_tuples(t_old) == as_tuples(j_old) and j_old
    assert t_stale == j_stale == ["determinism/global-rng::gone.py::fixed"]
    assert tengine.baseline_counts(t_found) == jengine.baseline_counts(found)


# ---------------------------------------------------------------------------
# CLI: exit codes, baseline ratchet
# ---------------------------------------------------------------------------

def test_cli_bad_tree_exits_nonzero(tmp_path):
    bad = _port_copy(tmp_path, BAD)
    assert analysis_main([str(bad), "--baseline", str(tmp_path / "bl.json")]) == 1


def test_cli_shipped_tree_is_clean():
    """`python -m repro_torch.analysis` over src/repro_torch: exit 0 with
    the checked-in baseline, which is empty."""
    data = json.loads((tengine.REPO_ROOT / "analysis_baseline_torch.json").read_text())
    assert data["findings"] == {}
    assert tengine.DEFAULT_BASELINE.name == "analysis_baseline_torch.json"
    assert analysis_main([]) == 0


def test_baseline_ratchet(tmp_path):
    bad, good = _port_copy(tmp_path, BAD), _port_copy(tmp_path, GOOD)
    bl = tmp_path / "baseline.json"
    # --update-baseline swallows the current findings and exits 0 ...
    assert analysis_main([str(bad), "--baseline", str(bl), "--update-baseline"]) == 0
    assert analysis_main([str(bad), "--baseline", str(bl)]) == 0
    assert len(json.loads(bl.read_text())["findings"]) > 0
    # ... but a NEW finding is never masked by old entries ...
    extra = _write(tmp_path, "fresh/repro_torch/core/fresh.py",
                   "import torch\ntorch.manual_seed(0)\n")
    assert analysis_main([str(bad), str(extra.parent), "--baseline", str(bl)]) == 1
    # ... and fixing findings leaves stale keys that --update drops
    assert analysis_main([str(good), "--baseline", str(bl), "--update-baseline"]) == 0
    assert json.loads(bl.read_text())["findings"] == {}


# ---------------------------------------------------------------------------
# torch determinism rules
# ---------------------------------------------------------------------------

TORCH_RNG = """\
import torch


def draw(n, gen):
    torch.manual_seed(0)
    a = torch.rand(n)
    b = torch.rand(n, generator=gen)
    c = torch.empty(n).uniform_(0.0, 1.0, generator=gen)
    g = torch.Generator().manual_seed(3)
    d = torch.randn(n, generator=torch.Generator().manual_seed(4))
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.benchmark = False
    return a, b, c, d, g
"""


def test_torch_determinism_rules_each_fire_once(tmp_path):
    findings, _ = analyze([_write(tmp_path, "repro_torch/core/rng.py", TORCH_RNG)])
    assert [(f.rule, f.line) for f in findings] == [
        ("determinism/global-rng", 5), ("determinism/unseeded-rng", 6),
        ("determinism/cudnn-benchmark", 11)]


@pytest.mark.parametrize("call", [
    "torch.manual_seed(1)", "torch.seed()", "torch.cuda.manual_seed(1)",
    "torch.cuda.manual_seed_all(1)"])
def test_torch_global_seed_is_global_rng(tmp_path, call):
    findings, _ = analyze([_write(tmp_path, "repro_torch/launch/x.py",
                                  f"import torch\n{call}\n")])
    assert _rules(findings) == ["determinism/global-rng"]


@pytest.mark.parametrize("call", [
    "torch.rand(3)", "torch.randn(3)", "torch.randint(0, 5, (3,))", "torch.randperm(3)",
    "torch.multinomial(w, 2)", "torch.normal(w, 1.0)", "torch.bernoulli(w)",
    "w.uniform_()", "w.normal_(0.0, 1.0)"])
def test_torch_sampler_needs_a_generator(tmp_path, call):
    src = f"import torch\nw = torch.ones(3)\nx = {call}\n"
    findings, _ = analyze([_write(tmp_path, "repro_torch/models/x.py", src)])
    assert [(f.rule, f.line) for f in findings] == [("determinism/unseeded-rng", 3)]
    seeded = call[:-1] + (", " if call[-2] != "(" else "") + "generator=gen)"
    findings, _ = analyze([_write(tmp_path, "repro_torch/models/y.py",
                                  src.replace(call, seeded))])
    assert findings == []


def test_port_random_module_is_not_stdlib_random(tmp_path):
    src = ("from repro_torch import random as jrandom\nfrom numpy import random\n"
           "import random as r\n")
    findings, _ = analyze([_write(tmp_path, "repro_torch/core/x.py", src)])
    assert [(f.rule, f.line) for f in findings] == [
        ("determinism/random-module", 2), ("determinism/random-module", 3)]


# ---------------------------------------------------------------------------
# host-sync lint on torch code
# ---------------------------------------------------------------------------

HOT = """\
import numpy as np
import torch

from repro_torch.kernels import ops as kops


def _moments(t):
    return kops.tile_moments(t)


def prepare_frames(frames, dev):
    x = torch.ones(4, device=dev)
    {line}
"""

FLAGGED = [
    ("a = x.sum().item()", "host-sync/item"),
    ("b = (x * 2).cpu().numpy()", "host-sync/asarray"),
    ("c = float(x.max())", "host-sync/float"),
    ("d = int(x.argmax())", "host-sync/int"),
    ("e = bool((x > 0).all())", "host-sync/bool"),
    ("f = x.tolist()", "host-sync/tolist"),
    ("g = x.to('cpu')", "host-sync/asarray"),
    ("h = np.asarray(_moments(frames))", "host-sync/asarray"),
    ("i = torch.from_numpy(frames).to(dev).mean().item()", "host-sync/item"),
    ("torch.cuda.synchronize()", "host-sync/block"),
]
CLEAN = [
    "a = np.asarray([1.0, 2.0])",
    "b = torch.as_tensor(np.asarray(frames)).sum().item()",
    "c = int(x.shape[0]) + x.numel() + float(len(frames))",
    "d = torch.zeros(3).tolist()",
    "e = torch.zeros(2).to(torch.float64).sum().item()",
]


@pytest.mark.parametrize("line, rule", FLAGGED, ids=[r for _, r in FLAGGED])
def test_host_sync_flags_device_value(tmp_path, line, rule):
    path = _write(tmp_path, "repro_torch/core/engine.py", HOT.format(line=line))
    findings, _ = analyze([path])
    assert [(f.rule, f.line) for f in findings] == [(rule, 13)]


@pytest.mark.parametrize("line", CLEAN)
def test_host_sync_leaves_host_values(tmp_path, line):
    findings, _ = analyze([_write(tmp_path, "repro_torch/core/engine.py",
                                  HOT.format(line=line))])
    assert findings == []


@pytest.mark.parametrize("line, rule", FLAGGED[:3], ids=[r for _, r in FLAGGED[:3]])
def test_host_sync_waiver(tmp_path, line, rule):
    """With a reason the finding is waived; without one the waiver is a
    finding of its own and waives nothing."""
    waived = HOT.format(line=line + "  # analysis: waive(host-sync): the designed copy")
    findings, silenced = analyze([_write(tmp_path, "a/repro_torch/core/engine.py", waived)])
    assert findings == [] and [f.rule for f in silenced] == [rule]
    bare = HOT.format(line=line + "  # analysis: waive(host-sync):")
    findings, _ = analyze([_write(tmp_path, "b/repro_torch/core/engine.py", bare)])
    assert _rules(findings) == sorted([rule, "waiver/missing-reason"])


def test_host_sync_follows_parameters_and_returns(tmp_path):
    """A parameter is tainted where a caller passes a device value; a
    function returning one is a producer; cold modules are not read."""
    src = ("import torch\n\n\ndef _copy(t):\n    return t.cpu().numpy()\n\n\n"
           "def _make(dev):\n    return torch.zeros(2, device=dev)\n\n\n"
           "def prepare_frames(dev):\n    return _copy(_make(dev) + 1)\n\n\n"
           "def host(a):\n    return a.cpu().numpy()\n")
    findings, _ = analyze([_write(tmp_path, "repro_torch/core/engine.py", src)])
    assert [(f.rule, f.line) for f in findings] == [("host-sync/asarray", 5)]
    findings, _ = analyze([_write(tmp_path, "repro_torch/core/mission.py", src)])
    assert findings == []


# ---------------------------------------------------------------------------
# thread ownership on the port's recount pipeline
# ---------------------------------------------------------------------------

CONTACT = SRC / "core" / "contact.py"


def test_thread_rule_clean_on_port_contact():
    findings, _ = analyze([CONTACT])
    assert findings == []
    src = CONTACT.read_text()
    # the worker still runs _recount_run inside its stream block
    assert "torch.cuda.stream(rnd.stream)" in src and "def _recount_job(rnd" in src


@pytest.mark.parametrize("check, what", [
    ("            return  # abandoned mid-count: discard, write nothing\n", "counts_gd"),
    ("    for m, seg, window in work.agg:\n        if cancel is not None and cancel.is_set():\n"
     "            return\n", "contact_stages")])
def test_thread_rule_sees_a_removed_cancel_check(tmp_path, check, what):
    src = CONTACT.read_text()
    assert src.count(check) == 1
    if "abandoned" in check:
        cut = src.replace("        if cancel is not None and cancel.is_set():\n" + check, "")
    else:
        cut = src.replace(check, "    for m, seg, window in work.agg:\n")
    assert cut != src
    findings, _ = analyze([_write(tmp_path, "repro_torch/core/contact.py", cut)])
    assert [f.rule for f in findings] == ["thread-ownership/cancel"]
    assert what in findings[0].message


# ---------------------------------------------------------------------------
# the shipped tree
# ---------------------------------------------------------------------------

def test_shipped_tree_waivers_are_the_designed_copies():
    findings, waived = analyze([SRC])
    assert findings == []
    assert sorted((f.path, f.rule) for f in waived) == sorted(
        [("src/repro_torch/core/cascade.py", "host-sync/asarray")] * 2
        + [("src/repro_torch/core/engine.py", "host-sync/asarray")] * 3)


# ---------------------------------------------------------------------------
# LaunchGuard
# ---------------------------------------------------------------------------

class _FakeLib:
    @staticmethod
    def entry_a(*args):
        return 0

    @staticmethod
    def entry_b(*args):
        return 0


class _StubKernel(_build.CudaKernel):
    """A CudaKernel whose load hands back a fake library (no nvcc)."""

    def load(self):
        with self._lock:
            if self._lib is None:
                self._lib = _FakeLib()
            return self._lib


def test_launchguard_unsupported_on_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the guard counts there")
    with LaunchGuard("cpu round") as g:
        ops.tile_moments(torch.rand(2, 4, 4, 3, generator=torch.Generator().manual_seed(0)))
    assert g.mode == "unsupported" and not g.supported
    assert (g.builds, g.new_segments, g.launches, g.syncs, g.sync_sites) == (0, 0, {}, 0, {})
    g.assert_steady_state("cpu round")


def test_launchguard_names_a_sync_by_the_callers_line():
    """A sync is counted at the innermost frame outside torch: the line
    that called the op, not torch's own Python."""
    from repro_torch.analysis import launchguard

    def caller():
        return launchguard._call_site(), sys._getframe().f_lineno
    site, line = caller()
    assert site == f"{Path(__file__).name}:{line}"


def test_launchguard_counts_a_load_and_launch_deltas():
    stub = _StubKernel("stub", {"entry_a": [], "entry_b": []})
    stub.launches, stub.symbol_launches["entry_a"] = 5, 5  # earlier totals
    with LaunchGuard("cold round", kernels=[stub]) as cold:
        stub.launch("entry_a")
        stub.launch("entry_a")
        stub.launch("entry_b")
    assert cold.supported and cold.builds == 1 and cold.loaded == ["stub"]
    assert cold.launches == {"entry_a": 2, "entry_b": 1}
    # the guard reads deltas: the kernel's own counts go on
    assert stub.launches == 8 and stub.symbol_launches == {"entry_a": 7, "entry_b": 1}
    with pytest.raises(AssertionError, match="cold round"):
        cold.assert_steady_state()
    with LaunchGuard(kernels=[stub]) as warm:
        stub.launch("entry_b")
    assert warm.builds == 0 and warm.launches == {"entry_b": 1}
    warm.assert_steady_state("warm round")
    assert stub.launches == 9
