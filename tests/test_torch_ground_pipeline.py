"""The port's ground-segment recount pipeline at depth >= 1, on the CPU.

``Fleet(async_depth=k)`` runs each contact round's ground recount and
Aggregate on a worker thread, up to ``k`` rounds in flight. Every depth
must give depth 0's per-tile predictions, summaries and ledger lanes,
and the FIFO reference's, bit for bit, for all five policies; the port
at depth 2 must give the reference's Fleet at depth 2 (kodan and
targetfuse replay the reference's dedup representatives after the
port's own clustering has been checked for the same partition, as in
tests/test_torch_fleet.py). Injected worker crashes and stalls recover
through the watchdog to the same results.

No test here depends on wall-clock time. A stalled worker waits on its
round's cancel event, which only the watchdog sets, so the watchdog
fires whatever the load; a slow worker waits on an event the test sets
after the watchdog has fired. ``watchdog_s`` is never compared with an
elapsed time. Where other rounds share a run with a stall, a loaded
machine may let their joins time out too; that recovers to the same
results, so those tests ask for at least one recovery.
"""
import threading

import numpy as np
import pytest
import torch

from repro.core.fleet import run_scenario as jrun_scenario
from repro.core.pipeline import PipelineConfig as JConfig
from repro.data import scenarios as jscenarios
from repro.data.synthetic import SceneSpec as JSceneSpec
from repro_torch.configs import get_config, reduced
from repro_torch.core import contact, fleet
from repro_torch.core.faults import FaultPlan
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.data import scenarios
from repro_torch.data.synthetic import SceneSpec, make_scene, revisit_frames
from repro_torch.models.detector import params_from_jax
from test_torch_fleet import (TIMING, ReplayFleet, _same_ledgers, _same_partitions,
                              _same_results)

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

METHODS = ("space_only", "ground_only", "tiansuan", "kodan", "targetfuse")
CLUSTERING = ("kodan", "targetfuse")
SCENE = dict(name="pipeline", scene_px=384, objects_per_scene=(10, 18),
             object_px=(10, 24), cloud_fraction=0.25)
# the pipeline's own facts in Fleet.summary()
PIPELINE = ("async_ground", "async_depth", "recount_rounds_deferred", "recount_max_in_flight")
WAIT_S = 60.0  # bound of every wait in a test; reached only if a test fails


def _spec(mod, scene):
    """5 satellites, 2 stations, 4 rounds: every round has contacts."""
    return mod.FleetScenarioSpec(
        n_sats=5, n_rounds=4, frames_per_pass=1,
        stations=(mod.GroundStation("gs0"),
                  mod.GroundStation("gs1", bandwidth_mbps=30.0, contact_s=240.0)),
        scene_mix=(scene,), seed=11)


@pytest.fixture(scope="module")
def port(counters):
    (sp, sp_cfg), (gd, gd_cfg) = counters
    return ((params_from_jax(sp), reduced(get_config("targetfuse-space"))),
            (params_from_jax(gd), reduced(get_config("targetfuse-ground"))))


@pytest.fixture(scope="module")
def scenario():
    return scenarios.generate_scenario(_spec(scenarios, SceneSpec(**SCENE)))


@pytest.fixture(scope="module")
def run(port, scenario):
    """run(method, **options) -> (results, fleet) of the port's
    run_scenario on the CPU, cached."""
    cache = {}

    def go(method, **kw):
        key = (method, repr(sorted(kw.items())))
        if key not in cache:
            cache[key] = fleet.run_scenario(
                *port, PipelineConfig(method=method, score_thresh=0.25), scenario,
                device="cpu", **kw)
        return cache[key]
    return go


def _frames(seed, n=1):
    rng = np.random.default_rng(seed)
    img, b, c = make_scene(rng, SceneSpec(**SCENE))
    return revisit_frames(rng, img, b, c, n)


def _facts(fl):
    """summary() without its clocks and the pipeline's own counters."""
    s = fl.summary()
    for k in TIMING + PIPELINE:
        s.pop(k)
    return s


def _block_stalls(monkeypatch):
    """An injected stall waits until the watchdog cancels its round ->
    the list of stalled worker threads."""
    stalled = []

    def stall(seconds, cancel):
        stalled.append(threading.current_thread())
        cancel.wait(WAIT_S)
    monkeypatch.setattr(contact, "_stall", stall)
    return stalled


def _joined(threads):
    for t in threads:
        t.join(WAIT_S)
    return not any(t.is_alive() for t in threads)


# ---------------------------------------------------------------------------
# every depth == depth 0 == the FIFO reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
def test_every_depth_equals_depth0_and_fifo_reference(method, run):
    want, f0 = run(method)
    fifo, ff = run(method, contact_reference=True)
    for i, (a, b) in enumerate(zip(fifo, want)):
        _same_results(a, b, f"{method} fifo sat{i}")
    _same_ledgers(ff, f0, f"{method} fifo")
    assert f0.summary()["recount_rounds_deferred"] == 0
    for depth in (1, 2, 3):
        got, fd = run(method, async_depth=depth)
        for i, (a, b) in enumerate(zip(got, want)):
            _same_results(a, b, f"{method} depth={depth} sat{i}")
        _same_ledgers(fd, f0, f"{method} depth={depth}")
        assert _facts(fd) == _facts(f0)
        s = fd.summary()
        assert s["async_depth"] == depth and s["async_ground"] is True
        # the queue is left only by retirement: it fills to the depth
        assert s["recount_rounds_deferred"] >= 4  # every round, maybe the flush
        assert s["recount_max_in_flight"] == min(depth, s["recount_rounds_deferred"])
        assert s["recount_wait_s"] <= s["recount_s"]
        assert 0.0 <= s["recount_hidden_frac"] <= 1.0
    got, fa = run(method, async_ground=True)
    for i, (a, b) in enumerate(zip(got, want)):
        _same_results(a, b, f"{method} async_ground sat{i}")
    assert fa.summary()["async_depth"] == 1


def test_backpressure_bounds_in_flight(port):
    """Rounds retire oldest first once the queue holds ``depth``."""
    pcfg = PipelineConfig(method="ground_only", score_thresh=0.25)
    fl = fleet.Fleet(*port, pcfg, n_sats=1, async_depth=2, device="cpu")
    seen = []
    for k in range(4):
        fl.ingest([_frames(70 + k)])
        fl.contact_round(windows=[(0, 4e6)])
        seen.append(fl.ground_segment.in_flight)
    assert seen == [1, 2, 2, 2]
    assert fl.summary()["recount_max_in_flight"] == 2
    assert fl.ground_segment.in_flight == 0  # summary() synced


def test_results_wait_for_the_recount(port, monkeypatch):
    pcfg = PipelineConfig(method="ground_only", score_thresh=0.25)
    fl = fleet.Fleet(*port, pcfg, n_sats=1, async_ground=True, device="cpu")
    sync = fleet.Fleet(*port, pcfg, n_sats=1, device="cpu")
    release, real = threading.Event(), contact._recount_run

    def held(work, cancel=None):
        if threading.current_thread() is not threading.main_thread():
            release.wait(WAIT_S)
        return real(work, cancel)
    monkeypatch.setattr(contact, "_recount_run", held)
    for f in (fl, sync):
        f.ingest([_frames(5, 2)])
        f.contact_round(windows=[(0, 4e6)])
    assert fl.missions[0]._segments[0].pred is None  # still counting
    release.set()
    _same_results(fl.results()[0], sync.results()[0], "async results")


def test_worker_exception_surfaces_once_at_sync(port):
    pcfg = PipelineConfig(method="ground_only", score_thresh=0.25)
    fl = fleet.Fleet(*port, pcfg, n_sats=1, async_ground=True, device="cpu")
    fl.ingest([_frames(6)])

    def boom(*a, **k):
        raise RuntimeError("recount exploded")

    fl.missions[0].contact_stages[3].run = boom  # Aggregate
    fl.contact_round(windows=[(0, 2e6)])
    with pytest.raises(RuntimeError, match="recount exploded"):
        fl.ground_segment.sync()
    fl.ground_segment.sync()  # consumed: the segment is usable again
    assert fl.ground_segment.in_flight == 0


@pytest.mark.parametrize("kw", [dict(async_depth=-1), dict(async_ground=True, async_depth=0)])
def test_depth_validation(kw):
    with pytest.raises(ValueError):
        fleet.Fleet(None, None, PipelineConfig(), n_sats=1, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the port at depth 2 == the reference's Fleet at depth 2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
def test_depth2_matches_reference_depth2(method, counters, port, scenario, run):
    jsc = jscenarios.generate_scenario(_spec(jscenarios, JSceneSpec(**SCENE)))
    want, jf = jrun_scenario(*counters, JConfig(method=method, score_thresh=0.25), jsc,
                             async_depth=2)
    if method in CLUSTERING:
        tf = ReplayFleet(*port, PipelineConfig(method=method, score_thresh=0.25),
                         n_sats=5, async_depth=2, device="cpu", reference=jf)
        n = scenario.spec.n_sats
        for rnd in scenario.rounds:
            tf.ingest(rnd.frames_per_sat(n), rnd.harvest_per_sat(n))
            tf.contact_round(plan=rnd.contact_plan(n))
        got = tf.finalize()
        _same_partitions(tf.own)
    else:
        got, tf = run(method, async_depth=2)
    for i, (a, b) in enumerate(zip(got, want)):
        _same_results(a, b, f"{method} sat{i}")
    _same_ledgers(tf, jf, method)
    s, js = tf.summary(), jf.summary()
    for k in TIMING:
        s.pop(k)
        js.pop(k)
    assert s == js


# ---------------------------------------------------------------------------
# worker faults and the watchdog
# ---------------------------------------------------------------------------

def test_injected_crash_recovers_bit_exact(run):
    fp = FaultPlan(worker_faults={0: "crash"})
    want, fs = run("targetfuse", faults=fp)
    got, fa = run("targetfuse", faults=fp, async_ground=True)
    for i, (a, b) in enumerate(zip(got, want)):
        _same_results(a, b, f"crash sat{i}")
    _same_ledgers(fa, fs, "crash")
    s = fa.summary()
    assert s["fault_worker_crashes"] == 1 and s["fault_watchdog_recoveries"] == 1
    assert fs.summary()["fault_worker_crashes"] == 0  # depth 0 has no worker


def test_stalled_worker_recovers_bit_exact(run, monkeypatch):
    stalled = _block_stalls(monkeypatch)
    fp = FaultPlan(worker_faults={1: "stall"}, stall_s=WAIT_S)
    want, fs = run("targetfuse", faults=fp)
    got, fa = run("targetfuse", faults=fp, async_ground=True, watchdog_s=0.05)
    for i, (a, b) in enumerate(zip(got, want)):
        _same_results(a, b, f"stall sat{i}")
    _same_ledgers(fa, fs, "stall")
    s = fa.summary()
    assert s["fault_worker_stalls"] == 1 and s["fault_watchdog_recoveries"] >= 1
    assert len(stalled) == 1 and _joined(stalled)


def test_recovery_at_depth2(run, monkeypatch):
    stalled = _block_stalls(monkeypatch)
    fp = FaultPlan(worker_faults={0: "crash", 1: "stall"}, stall_s=WAIT_S)
    want, fs = run("tiansuan", faults=fp)
    got, fa = run("tiansuan", faults=fp, async_depth=2, watchdog_s=0.05)
    for i, (a, b) in enumerate(zip(got, want)):
        _same_results(a, b, f"depth2 recovery sat{i}")
    _same_ledgers(fa, fs, "depth2 recovery")
    s = fa.summary()
    assert s["fault_worker_crashes"] == 1 and s["fault_worker_stalls"] == 1
    assert s["fault_watchdog_recoveries"] >= 2
    assert s["recount_max_in_flight"] == 2
    assert _joined(stalled)


def test_abandoned_worker_writes_nothing(port, monkeypatch):
    """A slow worker the watchdog abandons mid-count returns garbage
    after the recovery: none of it may land."""
    pcfg = PipelineConfig(method="ground_only", score_thresh=0.25)
    slow = fleet.Fleet(*port, pcfg, n_sats=1, async_ground=True, watchdog_s=0.05,
                       device="cpu")
    sync = fleet.Fleet(*port, pcfg, n_sats=1, device="cpu")
    real, release, workers = contact.count_tiles_multi, threading.Event(), []

    def slow_garbage_off_main(params, cfg, parts, **kw):
        res = real(params, cfg, parts, **kw)
        if threading.current_thread() is threading.main_thread():
            return res
        workers.append(threading.current_thread())
        release.wait(WAIT_S)  # set only after the watchdog has fired
        return [(c + 100.0, aux) for c, aux in res]

    monkeypatch.setattr(contact, "count_tiles_multi", slow_garbage_off_main)
    for fl in (slow, sync):
        fl.ingest([_frames(91, 2)])
        fl.contact_round(windows=[(0, 4e6)])
    slow.ground_segment.sync()  # the watchdog fires: synchronous recovery
    assert slow.fault_stats.watchdog_recoveries == 1
    release.set()
    assert len(workers) == 1 and _joined(workers)
    _same_results(slow.results()[0], sync.results()[0], "abandoned worker")
    np.testing.assert_array_equal(slow.missions[0]._segments[0].counts_gd,
                                  sync.missions[0]._segments[0].counts_gd)


def test_stall_recovery_is_accounted_once(port, monkeypatch):
    """A recovered round charges its blocked time to both clocks and
    never the abandoned worker's: recount_s == wait_s, hides nothing."""
    stalled = _block_stalls(monkeypatch)
    fl = fleet.Fleet(*port, PipelineConfig(method="ground_only", score_thresh=0.25),
                     n_sats=1, async_ground=True, watchdog_s=0.05,
                     faults=FaultPlan(worker_faults={0: "stall"}, stall_s=WAIT_S), device="cpu")
    fl.ingest([_frames(92, 2)])
    fl.contact_round(windows=[(0, 4e6)])
    fl.ground_segment.sync()
    assert _joined(stalled)  # the abandoned worker ended after the recovery
    gseg = fl.ground_segment
    assert fl.summary()["fault_watchdog_recoveries"] == 1
    assert gseg.recount_s == gseg.wait_s > 0.0
    assert gseg.hidden_fraction == 0.0


def test_crash_recovery_hides_nothing(port):
    fl = fleet.Fleet(*port, PipelineConfig(method="ground_only", score_thresh=0.25),
                     n_sats=1, async_ground=True,
                     faults=FaultPlan(worker_faults={0: "crash"}), device="cpu")
    fl.ingest([_frames(93, 2)])
    fl.contact_round(windows=[(0, 4e6)])
    fl.ground_segment.sync()
    gseg = fl.ground_segment
    assert fl.summary()["fault_watchdog_recoveries"] == 1
    assert gseg.recount_s == gseg.wait_s and gseg.hidden_fraction == 0.0


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------

def test_clean_exit_syncs(port):
    fl = fleet.Fleet(*port, PipelineConfig(method="ground_only", score_thresh=0.25),
                     n_sats=1, async_ground=True, device="cpu")
    with fl:
        fl.ingest([_frames(81, 2)])
        fl.contact_round(windows=[(0, 4e6)])
        assert fl.ground_segment.rounds_deferred == 1
    assert fl.ground_segment.in_flight == 0
    assert fl.missions[0]._segments[0].pred is not None


def test_close_with_several_rounds_in_flight(port, monkeypatch):
    """An exceptional exit with two stalled rounds queued at depth 3
    cancels both and returns without raising; close is idempotent."""
    stalled = _block_stalls(monkeypatch)
    fl = fleet.Fleet(*port, PipelineConfig(method="ground_only", score_thresh=0.25),
                     n_sats=1, async_depth=3, watchdog_s=WAIT_S,
                     faults=FaultPlan(worker_faults={0: "stall", 1: "stall"},
                                      stall_s=WAIT_S), device="cpu")
    with pytest.raises(RuntimeError, match="user error"):
        with fl:
            for k in range(2):
                fl.ingest([_frames(94 + k)])
                fl.contact_round(windows=[(0, 2e6)])
            assert fl.ground_segment.in_flight == 2
            raise RuntimeError("user error")
    assert fl.ground_segment.in_flight == 0
    assert fl.ground_segment.max_in_flight == 2
    assert _joined(stalled) and len(stalled) == 2
    assert all(s.pred is None for s in fl.missions[0]._segments)  # nothing landed
    fl.close()
    fl.close()


def test_finalize_after_a_worker_exception(port):
    """A real worker failure surfaces once at sync with every ledger
    lane intact (recounts charge nothing), and the fleet finalizes."""
    pcfg = PipelineConfig(method="ground_only", score_thresh=0.25)
    broken = fleet.Fleet(*port, pcfg, n_sats=1, async_ground=True, device="cpu")
    clean = fleet.Fleet(*port, pcfg, n_sats=1, device="cpu")
    for fl in (broken, clean):
        fl.ingest([_frames(83, 2)])

    def boom(*a, **k):
        raise RuntimeError("recount exploded")

    broken.missions[0].contact_stages[3].run = boom  # Aggregate
    broken.contact_round(windows=[(0, 4e6)])
    clean.contact_round(windows=[(0, 4e6)])
    with pytest.raises(RuntimeError, match="recount exploded"):
        broken.ground_segment.sync()
    _same_ledgers(broken, clean, "after the exception")
    del broken.missions[0].contact_stages[3].run  # heal the stage
    assert len(broken.finalize()) == 1
    assert broken.pending_segments == [0]
