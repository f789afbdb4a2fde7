"""The port's evaluation functions, supervisor and example drivers against
the reference, on the CPU.

- ``metrics.ap50``: the cases of tests/test_core.py and seeded boxes,
  equal to ``repro``'s to 1e-12 (the IoU is float32 on both sides, one
  ``ops.iou_matrix`` call an image; the matching and the AP are the
  same float64 numpy code).
- ``tiling.optimal_tile_size`` (Algorithm 1): the same ``s_best`` and the
  same cache of evaluated sizes; ``n_tiles``, ``untile_counts`` and
  ``throttle.bandwidth_efficiency`` exact; ``xfer.record_transfer``.
- ``runtime.supervisor``: a checkpoint restart gives the uninterrupted
  run's state and the reference's losses; a NaN step is rejected;
  ``DeadlineBatcher`` with a fake clock; ``reshard_state`` raises.
- ``examples/*_torch.py``: each ``main`` with ``--device cpu`` at its
  smallest flags, with ``get_counters`` giving the session counters'
  bridged weights; the quickstart's lines equal the reference
  example's up to the clustering policy's numbers.

All uses of the session ``counters`` fixture stay in this file.
"""
import contextlib
import io
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as jmetrics
from repro.core import throttle as jthrottle
from repro.core import tiling as jtiling
from repro.runtime import supervisor as jsup
from repro_torch.configs import get_config, reduced
from repro_torch.core import metrics, throttle, tiling, xfer
from repro_torch.core.policies import available_policies
from repro_torch.models.detector import params_from_jax
from repro_torch.runtime import supervisor

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
sys.path.insert(0, EXAMPLES)

import constellation_sim_torch  # noqa: E402
import quickstart_torch  # noqa: E402
import serve_collaborative_torch  # noqa: E402

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# ap50
# ---------------------------------------------------------------------------

def _ap_both(pred, scores, gt, **kw):
    want = jmetrics.ap50(pred, scores, gt, **kw)
    got = metrics.ap50(pred, scores, gt, device="cpu", **kw)
    assert abs(got - want) <= 1e-12, (got, want)
    return got


def test_ap50_perfect_and_empty():
    gt = [np.array([[0, 0, 10, 10], [20, 20, 30, 30]], np.float32)]
    pred = [gt[0].copy()]
    scores = [np.array([0.9, 0.8], np.float32)]
    assert _ap_both(pred, scores, gt) > 0.95
    assert _ap_both([np.zeros((0, 4))], [np.zeros(0)], gt) == 0.0
    assert _ap_both(pred, scores, [np.zeros((0, 4), np.float32)]) == 0.0


def _boxes(rng, n, scale=400.0):
    xy = rng.random((n, 2)) * scale
    wh = 8 + rng.random((n, 2)) * 40
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_ap50_matches_repro_on_seeded_boxes(seed):
    """Images of jittered ground truth plus false positives, an image
    without predictions, one without ground truth, duplicate detections
    and tied scores; at IoU thresholds 0.5 and 0.3."""
    rng = np.random.default_rng(seed)
    pred, scores, gt = [], [], []
    for i in range(6):
        g = _boxes(rng, int(rng.integers(1, 12)))
        hits = g[rng.random(len(g)) < 0.7]
        p = np.concatenate([hits + rng.normal(0, 3, hits.shape).astype(np.float32),
                            hits[:2], _boxes(rng, int(rng.integers(0, 5)))])
        s = np.round(rng.random(len(p)), 1)  # ties
        if i == 2:
            p, s = np.zeros((0, 4), np.float32), np.zeros(0)
        if i == 4:
            g = np.zeros((0, 4), np.float32)
        pred.append(p)
        scores.append(s)
        gt.append(g)
    for thr in (0.5, 0.3):
        ap = _ap_both(pred, scores, gt, iou_thresh=thr)
        assert 0.0 < ap < 1.0


def test_ap50_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        metrics.ap50([], [], [])


# ---------------------------------------------------------------------------
# Algorithm 1 and the small functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt", (80, 151, 300, 479))
def test_optimal_tile_size_matches_repro(opt):
    """tests/test_core.py's unimodal curve: the same s_best and cache."""
    f = lambda s: -abs(s - opt) / 100.0  # noqa: E731
    got = tiling.optimal_tile_size(f, 64, 512, eps=16)
    assert got == jtiling.optimal_tile_size(f, 64, 512, eps=16)
    assert abs(got[0] - opt) <= 24 and len(got[1]) < 25


def test_optimal_tile_size_monotone_edge_and_fig4_sizes():
    f = lambda s: s / 512  # noqa: E731
    got = tiling.optimal_tile_size(f, 64, 512, eps=8)
    assert got == jtiling.optimal_tile_size(f, 64, 512, eps=8) and got[0] > 480
    curve = {32: 0.1, 64: 0.4, 128: 0.7, 192: 0.75, 256: 0.6, 384: 0.3}
    g = lambda s: float(np.interp(s, list(curve), list(curve.values())))  # noqa: E731
    assert tiling.optimal_tile_size(g, 32, 384, eps=48) == \
        jtiling.optimal_tile_size(g, 32, 384, eps=48)


def test_n_tiles_and_untile_counts():
    for hw in ((1024, 1024), (1000, 700), (128, 129), (1, 1)):
        for ts in (32, 128, 300):
            assert tiling.n_tiles(hw, ts) == jtiling.n_tiles(hw, ts)
            img = torch.zeros((*hw, 3))
            assert tiling.tile_image(img, ts).shape[0] == tiling.n_tiles(hw, ts)
    c = np.random.default_rng(0).integers(0, 20, 81).astype(np.float32)
    got = tiling.untile_counts(torch.from_numpy(c))
    assert float(got) == float(jtiling.untile_counts(jnp.asarray(c))) == c.sum()
    assert float(tiling.untile_counts(c)) == c.sum()


def test_bandwidth_efficiency_matches_repro():
    for args in ((0.5, 0.1, 1e9, 2e8), (0.1, 0.5, 1e9, 2e8), (0.3, 0.3, 0.0, 0.0),
                 (1.0, 0.25, 5e8, 0.5)):
        assert throttle.bandwidth_efficiency(*args) == jthrottle.bandwidth_efficiency(*args)


def test_record_transfer_counts_uploads():
    xfer.reset_transfer_stats()
    xfer.record_transfer()
    xfer.record_transfer(3)
    assert xfer.transfer_stats() == {"device_puts": 4, "cache_reuses": 0}
    xfer.device_constant(np.zeros(1 << 14, np.int64), "cpu")  # above the cap
    assert xfer.transfer_stats()["device_puts"] == 5
    xfer.reset_transfer_stats()


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------

def _toy(mod):
    """tests/test_substrates.py's toy problem on one side: each step
    scales the weights by 0.9; the loss is their sum."""
    if mod is jsup:
        return ({"w": jnp.full((2,), 100.0)},
                lambda st, b: ((nw := jax.tree_util.tree_map(lambda p: p * 0.9, st)),
                               jnp.sum(nw["w"])))
    return ({"w": torch.full((2,), 100.0)},
            lambda st, b: ((nw := {"w": st["w"] * 0.9}), nw["w"].sum()))


def test_supervisor_checkpoint_restart_equals_the_uninterrupted_run(tmp_path):
    reports = {}
    for name, mod in (("port", supervisor), ("ref", jsup)):
        state, step_fn = _toy(mod)
        d = str(tmp_path / name)
        cfg = mod.SupervisorConfig(ckpt_dir=d, ckpt_every=5, max_steps=20,
                                   async_save=False, fail_at_step=12)
        with pytest.raises(mod.SimulatedFailure):
            mod.run_training(state, step_fn, lambda s: None, cfg)
        cfg2 = mod.SupervisorConfig(ckpt_dir=d, ckpt_every=5, max_steps=20, async_save=True)
        final, report = mod.run_training(state, step_fn, lambda s: None, cfg2)
        reports[name] = (np.asarray(final["w"]), report)
    (got, rp), (want, rj) = reports["port"], reports["ref"]
    assert rp.resumed_from == rj.resumed_from == 10
    assert rp.steps_run == rj.steps_run == 10
    np.testing.assert_array_equal(got, want)
    assert rp.losses == rj.losses
    # the uninterrupted run
    state, step_fn = _toy(supervisor)
    full, rf = supervisor.run_training(
        state, step_fn, lambda s: None,
        supervisor.SupervisorConfig(ckpt_dir=str(tmp_path / "full"), ckpt_every=5,
                                    max_steps=20, async_save=False))
    np.testing.assert_array_equal(full["w"].numpy(), got)
    assert rf.losses[10:] == rp.losses
    np.testing.assert_allclose(got, 100.0 * 0.9 ** 20, rtol=1e-5)


def test_supervisor_rejects_nan_steps(tmp_path):
    calls = {"n": 0}

    def step_fn(state, batch):
        calls["n"] += 1
        if calls["n"] == 3:
            return state, torch.tensor(float("nan"))
        return {"w": state["w"] - 1.0}, torch.tensor(1.0)

    cfg = supervisor.SupervisorConfig(ckpt_dir=str(tmp_path), ckpt_every=100,
                                      max_steps=5, async_save=False)
    final, report = supervisor.run_training({"w": torch.zeros(1)}, step_fn,
                                            lambda s: None, cfg)
    assert report.rejected_steps == 1 and report.steps_run == 5
    assert report.losses == [1.0] * 4
    np.testing.assert_allclose(final["w"].numpy(), -4.0)  # 4 good steps applied


def test_deadline_batcher_drops_stragglers():
    for mod in (supervisor, jsup):
        clock = {"t": 0.0}

        def work(item):
            clock["t"] += 1.0  # each item takes 1 s
            return item * 2

        b = mod.DeadlineBatcher(deadline_s=2.5, clock=lambda: clock["t"])
        assert b.run([1, 2, 3, 4, 5], work) == ([2, 4, 6], [4, 5])


def test_reshard_state_raises_naming_the_roadmap():
    """``reshard_state`` is ported (its round trip on four ranks is in
    ``test_torch_mesh_ranks.py``); without a device mesh it raises."""
    with pytest.raises(ValueError, match="DeviceMesh"):
        supervisor.reshard_state({"w": torch.zeros(2)}, None, lambda s: s)


# ---------------------------------------------------------------------------
# the example drivers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bridged(counters):
    (sp, _), (gd, _) = counters
    return ((params_from_jax(sp), reduced(get_config("targetfuse-space"))),
            (params_from_jax(gd), reduced(get_config("targetfuse-ground"))))


def _run(module, argv, pair, monkeypatch):
    seen = []
    monkeypatch.setattr(module, "get_counters", lambda **kw: seen.append(kw) or pair)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        module.main(argv)
    assert seen == [{"device": "cpu"}]
    return out.getvalue().splitlines()


def test_quickstart_torch(bridged, counters, monkeypatch):
    """The port's quickstart prints the reference example's lines; the
    space-only CMAE, which no clustering touches, is equal (targetfuse's
    numbers follow its representatives, which may differ at ties)."""
    import quickstart
    got = _run(quickstart_torch, ["--device", "cpu"], bridged, monkeypatch)
    monkeypatch.setattr(quickstart, "get_counters", lambda: counters)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        quickstart.main()
    want = out.getvalue().splitlines()
    assert len(got) == len(want) == 7
    assert got[:2] == want[:2]
    # the registries: other test files may register extra policies in
    # repro's, so the port's line names the port's own
    assert got[2] == "registered selection policies: " + ", ".join(available_policies())
    assert [re.split("[:=]", g)[0] for g in got] == [re.split("[:=]", w)[0] for w in want]
    assert got[-1].split("(")[0] == want[-1].split("(")[0]  # the space-only CMAE


@pytest.mark.parametrize("argv", (["--passes", "1"], ["--passes", "2", "--depth", "2"]))
def test_serve_collaborative_torch(argv, bridged, monkeypatch):
    got = _run(serve_collaborative_torch, ["--device", "cpu"] + argv, bridged, monkeypatch)
    passes = int(argv[1])
    assert got[0].startswith(f"== collaborative serving: {passes} orbital passes")
    assert [ln.split(":")[0].strip() for ln in got[1:1 + passes]] == \
        [f"pass {i}" for i in range(passes)]
    assert got[-2].startswith("aggregate: CMAE=") and "nan" not in got[-2]
    assert got[-1].startswith(f"ground segment: {passes} windows")
    assert ("depth-2 recount pipeline" in got[-1]) == ("--depth" in argv)


@pytest.mark.parametrize("argv", (
    ["--check"],
    ["--check", "--oracle"],
    ["--check", "--faults", "3"],
    ["--check", "--async-depth", "2", "--ingest-overlap"],
    ["--check", "--geometry", "orbital"],
), ids=("fleet", "oracle", "faults", "depth", "orbital"))
def test_constellation_sim_torch(argv, bridged, monkeypatch):
    got = _run(constellation_sim_torch, ["--device", "cpu", "--sats", "2", "--rounds", "2"]
               + argv, bridged, monkeypatch)
    assert any(ln.startswith("parity check: fleet == ") for ln in got)
    assert got[-1].startswith("constellation aggregate count: pred=")
    assert sum(ln.startswith("  sat") for ln in got) == 2


def test_constellation_sim_torch_refuses_a_mesh(bridged, monkeypatch):
    """``--devices 2`` on the CPU starts two ``gloo`` ranks, which run the
    fleet on a two-rank sats mesh; the parent prints rank 0's report, in
    which ``--check`` holds the sharded fleet to the looped Missions."""
    got = _run(constellation_sim_torch, ["--device", "cpu", "--devices", "2", "--sats", "3",
                                         "--rounds", "2", "--check"], bridged, monkeypatch)
    assert "parity check: sharded fleet (2 devices) == looped Missions (exact)" in got
    assert any(ln.startswith("fleet runtime: 2 device(s)") for ln in got)
    assert got[-1].startswith("constellation aggregate count: pred=")
    assert sum(ln.startswith("  sat") for ln in got) == 3
