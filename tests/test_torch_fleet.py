"""The constellation path of the port against the reference, on the CPU:
``Fleet``, ``ContactPlan`` at ground-segment depth 0, ``FaultPlan`` and
the toy scenario generator (the recount pipeline at depth >= 1 is
tests/test_torch_ground_pipeline.py, the orbital geometry
tests/test_torch_orbits.py).

A 4-satellite scenario with 2 stations over 3 rounds (one frame a pass)
runs through the reference's ``Fleet`` and the port's, with the
session's trained reduced counters carried over by ``params_from_jax``,
for all five policies. The port's Fleet must give, satellite by
satellite, the reference's per-tile predictions, summaries and ledger
lanes (tolerance 0: the ledgers are the same float64 numpy operations).
kodan and targetfuse cluster first: their representatives may differ
from the reference's only at exact ties (ROADMAP queue 3,
tests/test_torch_mission.py), so those runs take the reference's
representatives after the port's own clustering has run and been
checked for the same partition. Within the port, the Fleet must equal
looped Missions, the batched ContactPlan the FIFO reference,
``FaultPlan.none()`` no plan, and ``ingest_overlap`` on off, all bit for
bit.

All uses of the session ``counters`` fixture in this file share one
module-scoped cache of runs.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core import faults as jfaults
from repro.core.contact import ContactPlan as JContactPlan
from repro.core.fleet import run_scenario as jrun_scenario
from repro.core.pipeline import PipelineConfig as JConfig
from repro.data import scenarios as jscenarios
from repro.data.synthetic import SceneSpec as JSceneSpec
from repro_torch.configs import get_config, reduced
from repro_torch.core import faults, fleet, xfer
from repro_torch.core.contact import ContactPlan
from repro_torch.core.fleet_sharding import FleetSharding, sats_mesh
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.data import scenarios
from repro_torch.data.synthetic import SceneSpec
from repro_torch.models import detector
from repro_torch.models.detector import params_from_jax

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

METHODS = ("space_only", "ground_only", "tiansuan", "kodan", "targetfuse")
CLUSTERING = ("kodan", "targetfuse")
SCENE = dict(name="fleet", scene_px=384, objects_per_scene=(10, 18), object_px=(10, 24),
             cloud_fraction=0.25)
LEDGER = ("budget_j", "e_cap", "e_com", "e_agg", "e_down", "bytes_budget",
          "bytes_requested", "bytes_spent")
# wall-clock fields of Fleet.summary()
TIMING = ("ingest_s", "tiles_per_s", "tiles_per_s_per_sat", "contact_s", "windows_per_s",
          "bytes_downlinked_per_s", "recount_s", "recount_wait_s", "recount_hidden_frac",
          "ingest_dispatch_s", "device_compute_s", "host_fetch_s", "ingest_hidden_frac")
# every fault class of a seeded scenario plan fires in this scenario
FAULTS = dict(seed=4, drop_rate=0.25, truncate_rate=0.4, corrupt_rate=0.4,
              blackout_rate=0.2, outage_rate=0.5)


def _spec(mod, scene, **kw):
    return mod.FleetScenarioSpec(
        n_sats=4, n_rounds=3, frames_per_pass=1,
        stations=(mod.GroundStation("gs0"),
                  mod.GroundStation("gs1", bandwidth_mbps=30.0, contact_s=240.0)),
        scene_mix=(scene,), seed=5, **kw)


@pytest.fixture(scope="module")
def specs():
    return (_spec(jscenarios, JSceneSpec(**SCENE)), _spec(scenarios, SceneSpec(**SCENE)))


class ReplayFleet(fleet.Fleet):
    """The port's Fleet, whose batched Dedup runs (and is kept), after
    which each segment takes the reference run's representatives."""

    def __init__(self, *args, reference, **kw):
        super().__init__(*args, **kw)
        self.reference, self.own = reference, []

    def _dedup_batched(self, sats, segs, defer=False):
        out = super()._dedup_batched(sats, segs, defer)
        for i in sats:
            ref_seg = self.reference.missions[i]._segments[len(self.missions[i]._segments)]
            self.own.append((segs[i], segs[i].rep_of.copy(), ref_seg.rep_of))
            segs[i].rep_of = ref_seg.rep_of.copy()
        return out


def _drive(fl, sc):
    """run_scenario's Fleet loop, for a Fleet built here."""
    n = sc.spec.n_sats
    for rnd in sc.rounds:
        fl.ingest(rnd.frames_per_sat(n), rnd.harvest_per_sat(n))
        if rnd.contacts:
            fl.contact_round(plan=rnd.contact_plan(n))
    return fl.finalize()


@pytest.fixture(scope="module")
def run(counters, specs):
    """run(side, method, faults_plan, **options) -> (results, driver),
    cached: faults_plan is None, "none" or "seeded"; side is
    "ref" (the reference's run_scenario), "port" (the port's), or
    "replay" (the port's Fleet on the reference's representatives)."""
    (sp, _), (gd, _) = counters
    port = ((params_from_jax(sp), reduced(get_config("targetfuse-space"))),
            (params_from_jax(gd), reduced(get_config("targetfuse-ground"))))
    jsc, tsc = (jscenarios.generate_scenario(specs[0]), scenarios.generate_scenario(specs[1]))
    cache = {}

    def go(side, method, faults_plan=None, **kw):
        key = (side, method, faults_plan, tuple(sorted(kw.items())))
        if key in cache:
            return cache[key]
        if side == "ref":
            fp = {None: None, "none": jfaults.FaultPlan.none(),
                  "seeded": jfaults.scenario_faults(specs[0], **FAULTS)}[faults_plan]
            cache[key] = jrun_scenario(*counters, JConfig(method=method, score_thresh=0.25),
                                       jsc, faults=fp, **kw)
            return cache[key]
        fp = {None: None, "none": faults.FaultPlan.none(),
              "seeded": faults.scenario_faults(specs[1], **FAULTS)}[faults_plan]
        pcfg = PipelineConfig(method=method, score_thresh=0.25)
        if side == "replay":
            fl = ReplayFleet(*port, pcfg, n_sats=tsc.spec.n_sats, faults=fp, device="cpu",
                             reference=go("ref", method, faults_plan, **kw)[1], **kw)
            cache[key] = (_drive(fl, tsc), fl)
        else:
            cache[key] = fleet.run_scenario(*port, pcfg, tsc, faults=fp, device="cpu", **kw)
        return cache[key]
    return go


def _same_results(got, want, ctx):
    np.testing.assert_array_equal(got.per_tile_pred, want.per_tile_pred, err_msg=ctx)
    np.testing.assert_array_equal(got.per_tile_true, want.per_tile_true, err_msg=ctx)
    assert got.summary() == want.summary(), ctx


def _same_ledgers(a, b, ctx):
    for f in LEDGER:
        np.testing.assert_array_equal(getattr(a.ledger, f)[:a.n_sats],
                                      getattr(b.ledger, f)[:b.n_sats], err_msg=f"{ctx} {f}")


def _summary(fl):
    s = fl.summary()
    for k in TIMING:
        s.pop(k)
    return s


def _same_partitions(own):
    """The port's own clustering of each segment: the reference's
    clusters, a different representative only at a tie (same distance
    from the cluster's mean, float64 normalized moments, atol 1e-6)."""
    for seg, mine, theirs in own:
        act = np.where(seg.active)[0]
        pairs = set(zip(mine[act].tolist(), theirs[act].tolist()))
        assert len(pairs) == len(set(mine[act].tolist())) == len(set(theirs[act].tolist()))
        m = seg.prep.moments.numpy()[act].astype(np.float64)
        x = (m - m.mean(0)) / (m.std() + 1e-6)
        for a, b in pairs:
            if a != b:
                c = x[theirs[act] == b].mean(0)
                da, db = (((x[np.searchsorted(act, i)] - c) ** 2).sum() for i in (a, b))
                assert da == pytest.approx(db, rel=1e-5, abs=1e-6), (a, b)


# ---------------------------------------------------------------------------
# the scenario and the plan: pure host code
# ---------------------------------------------------------------------------

def test_scenario_generator_matches_reference(specs):
    jsc, tsc = (jscenarios.generate_scenario(specs[0]), scenarios.generate_scenario(specs[1]))
    assert len(jsc.rounds) == len(tsc.rounds) == 3 and tsc.n_frames == jsc.n_frames == 12
    for jr, tr in zip(jsc.rounds, tsc.rounds):
        for jp, tp in zip(jr.passes, tr.passes):
            assert (jp.sat, jp.harvest_j, jp.sunlit) == (tp.sat, tp.harvest_j, tp.sunlit)
            for (ji, jb, jc), (ti, tb, tc) in zip(jp.frames, tp.frames):
                np.testing.assert_array_equal(ji, ti)
                np.testing.assert_array_equal(jb, tb)
                np.testing.assert_array_equal(jc, tc)
        jpl, tpl = jr.contact_plan(4), tr.contact_plan(4)
        np.testing.assert_array_equal(jpl.sats, tpl.sats)
        np.testing.assert_array_equal(jpl.budgets, tpl.budgets)
        assert jpl.stations == tpl.stations == ("gs0", "gs1")
    with pytest.raises(ValueError, match="site"):  # as test_orbital_requires_sites
        scenarios.generate_scenario(scenarios.FleetScenarioSpec(geometry="orbital"),
                                    device="cpu")
    with pytest.raises(ValueError):
        scenarios.FleetScenarioSpec(n_sats=0)


def test_contact_plan_builders_match_reference():
    for mod in (ContactPlan, JContactPlan):
        assert mod.build([], 3).n_windows == 0
    wins = [(0, 1e6), (2, None), (0, 0.0)]
    for got, want in [(ContactPlan.build(wins, 3), JContactPlan.build(wins, 3)),
                      (ContactPlan.rotating(3, 5, start=2, budget_bytes=7.0)[0],
                       JContactPlan.rotating(3, 5, start=2, budget_bytes=7.0)[0])]:
        for f in ("sats", "budgets", "entitlement"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert got.stations == want.stations and got.n_sats == want.n_sats
        assert [got.window_budget(w) for w in range(got.n_windows)] == \
            [want.window_budget(w) for w in range(want.n_windows)]
    assert ContactPlan.rotating(3, 5, start=2)[1] == JContactPlan.rotating(3, 5, start=2)[1] == 1
    for bad in (dict(sats=np.array([0.5])), dict(stations=("a", "b"))):
        kw = dict(sats=np.array([0]), budgets=np.array([1.0]), entitlement=np.array([False]),
                  stations=("a",), n_sats=2) | bad
        with pytest.raises(ValueError) as want:
            JContactPlan(**kw)
        with pytest.raises(ValueError) as got:
            ContactPlan(**kw)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("windows", [
    [(3, 1e6)], [(-1, 1e6)], [(0, float("nan"))], [(0, float("inf"))], [(0, -1.0)],
])
def test_malformed_plans_raise_at_build_time_as_the_reference(windows):
    with pytest.raises(ValueError) as want:
        JContactPlan.build(windows, 3)
    with pytest.raises(ValueError) as got:
        ContactPlan.build(windows, 3)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        ContactPlan.rotating(0, 2)


def test_fault_draws_and_repair_match_reference(specs):
    kw = dict(seed=7, drop_rate=0.3, truncate_rate=0.5, corrupt_rate=0.4, blackout_rate=0.3,
              worker_crash_rate=0.2, worker_stall_rate=0.2,
              station_outages=(("gs1", 1, 2),), window_drops=frozenset({(0, 1)}))
    got, want = faults.FaultPlan(**kw), jfaults.FaultPlan(**kw)
    for r in range(4):
        for w in range(6):
            assert got.window_dropped(r, w, "gs1") == want.window_dropped(r, w, "gs1")
            assert got.truncated_at(r, w, 5) == want.truncated_at(r, w, 5)
            for p in range(3):
                assert got.segment_corrupted(r, w, p) == want.segment_corrupted(r, w, p)
            assert got.blackout(r, w) == want.blackout(r, w)
        assert got.worker_fault(r) == want.worker_fault(r)
        plan, jplan = (ContactPlan.build([(0, 1e6), (1, 2e6), (0, 3e6), (1, None)], 2,
                                         stations=("gs0", "gs1", "gs1", "gs0")),
                       JContactPlan.build([(0, 1e6), (1, 2e6), (0, 3e6), (1, None)], 2,
                                          stations=("gs0", "gs1", "gs1", "gs0")))
        stats, jstats = faults.FaultStats(), jfaults.FaultStats()
        rp, jrp = got.repair(plan, r, stats), want.repair(jplan, r, jstats)
        np.testing.assert_array_equal(rp.orig_windows, jrp.orig_windows)
        np.testing.assert_array_equal(rp.plan.budgets, jrp.plan.budgets)
        assert stats.as_dict() == jstats.as_dict()
    assert vars(faults.scenario_faults(specs[1], **FAULTS)) == \
        vars(jfaults.scenario_faults(specs[0], **FAULTS))
    assert faults.FaultPlan.none().empty and not got.empty
    with pytest.raises(ValueError):
        faults.FaultPlan(refund_policy="keep")


def test_unported_options_raise_naming_the_roadmap():
    """The recount pipeline's options construct and report their depth
    (tests/test_torch_ground_pipeline.py runs them), and a bad depth
    raises. Off a mesh the fleet's placement context is the identity, as
    the reference's (tests/test_fleet.py's test_off_mesh_sharding_is_noop);
    a mesh of more than one device needs a process group (the sats mesh
    runs on four ranks in tests/test_torch_fleet_mesh.py)."""
    cfg = reduced(get_config("targetfuse-space"))
    counter = (detector.init(torch.Generator().manual_seed(0), cfg, device="cpu"), cfg)
    for kw, depth in ((dict(async_ground=True), 1), (dict(async_depth=1), 1),
                      (dict(async_depth=3), 3), (dict(watchdog_s=0.5), 0),
                      (dict(async_ground=True, async_depth=2, watchdog_s=0.5), 2)):
        fl = fleet.Fleet(counter, counter, PipelineConfig(), n_sats=2, device="cpu", **kw)
        s = fl.summary()
        assert (s["async_depth"], s["async_ground"]) == (depth, depth > 0), kw
        assert fl.ground_segment.watchdog_s == kw.get("watchdog_s")
    sh = FleetSharding(None)
    assert not sh.on_mesh and sh.n_devices == 1 and sh.pad(5) == 5
    arr = np.arange(6.0)
    assert sh.shard(arr) is arr and sh.device_put(arr) is arr
    assert sats_mesh(1) is None and sats_mesh(1, device_type="cpu") is None
    with pytest.raises(RuntimeError, match="process group"):
        sats_mesh(2, device_type="cpu")
    with pytest.raises(ValueError, match="depth"):
        fleet.Fleet(None, None, PipelineConfig(), n_sats=2, device="cpu", async_depth=-1)


@pytest.mark.parametrize("kw", [dict(async_depth=1), dict(async_ground=True)],
                         ids=["async_depth", "async_ground"])
def test_recount_pipeline_refused_on_a_multi_card_cuda_mesh(kw):
    """The recount pipeline is no longer refused on a CUDA mesh of more
    than one rank (its workers issue no collective; the foreground
    gathers): a pipelined Fleet on a two-rank CUDA mesh gets exactly as
    far as a depth-0 one, where the missing card (or, on a card, the
    stand-in mesh) stops both alike."""
    mesh = SimpleNamespace(device_type="cuda", size=lambda: 2)

    def stopped(**opts):
        with pytest.raises(Exception) as e:
            fleet.Fleet(None, None, PipelineConfig(), n_sats=2, mesh=mesh, **opts)
        return type(e.value), str(e.value)
    got = stopped(**kw)
    assert got == stopped() and "recount pipeline" not in got[1]


def test_transfer_cache_reuses_repeated_index_vectors():
    xfer.clear_cache()
    xfer.reset_transfer_stats()
    idx = np.arange(16, dtype=np.int64)
    a = xfer.device_constant(idx, "cpu")
    b = xfer.device_constant(idx.copy(), "cpu")
    assert a is b and torch.equal(a, torch.arange(16))
    xfer.device_constant(np.zeros(1 << 14, np.int64), "cpu")  # above the cap: uploaded
    assert xfer.transfer_stats() == {"device_puts": 2, "cache_reuses": 1}
    assert xfer.cache_size() == 1


# ---------------------------------------------------------------------------
# the Fleet against the reference and against itself
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
def test_fleet_matches_reference_per_satellite(method, run):
    want, jf = run("ref", method)
    got, tf = run("replay" if method in CLUSTERING else "port", method)
    assert len(got) == len(want) == 4
    for i, (a, b) in enumerate(zip(got, want)):
        _same_results(a, b, f"{method} sat{i}")
    _same_ledgers(tf, jf, method)
    assert _summary(tf) == _summary(jf)
    if method in CLUSTERING:
        assert len(tf.own) == 12
        _same_partitions(tf.own)
    assert sum(r.total_pred for r in got) > 0


@pytest.mark.parametrize("method", METHODS)
def test_fleet_equals_looped_missions(method, run):
    got, fl = run("port", method)
    want, missions = run("port", method, fleet=False)
    for i, (a, b, m) in enumerate(zip(got, want, missions)):
        _same_results(a, b, f"{method} sat{i}")
        assert fl.ledger.spent[i] == m.ledger.spent and fl.ledger.e_com[i] == m.ledger.e_com
        assert fl.ledger.bytes_spent[i] == m.bytes_spent
    assert fl.summary()["dedup_batched"] and fl.summary()["windows_served"] > 0


def test_fleet_segments_keep_no_device_tiles(run):
    """A fleet's segments drop their space tiles after OnboardCount and
    keep no ground tiles: the recount makes those again from the frames
    (the results above equal the reference's and the looped Missions')."""
    _, fl = run("port", "targetfuse")
    segs = [s for m in fl.missions for s in m._segments]
    assert len(segs) == 12 and sum(len(s.selection.downlink) for s in segs) > 0
    assert all(s.tiles_sp is None and s.tiles_gd is None and s.prep.tiles_sp is None
               and s.prep.tiles_gd is None and s.prep.moments is not None for s in segs)


@pytest.mark.parametrize("method", METHODS)
def test_batched_contact_plan_equals_fifo_reference(method, run):
    got, fl = run("port", method)
    want, ref = run("port", method, contact_reference=True)
    for i, (a, b) in enumerate(zip(got, want)):
        _same_results(a, b, f"{method} sat{i}")
    _same_ledgers(fl, ref, method)
    assert _summary(fl) == _summary(ref)


@pytest.mark.parametrize("method", METHODS)
def test_none_fault_plan_is_bit_equal(method, run):
    got, fl = run("port", method)
    want, fz = run("port", method, "none")
    for i, (a, b) in enumerate(zip(got, want)):
        _same_results(a, b, f"{method} sat{i}")
    _same_ledgers(fl, fz, method)
    assert _summary(fl) == _summary(fz)
    assert fz.summary()["faults_active"] is False
    assert all(v == 0 for v in vars(fz.fault_stats).values())


@pytest.mark.parametrize("method", METHODS)
def test_ingest_overlap_on_and_off_are_equal(method, run):
    got, fl = run("port", method)
    want, fo = run("port", method, ingest_overlap=True)
    for i, (a, b) in enumerate(zip(got, want)):
        _same_results(a, b, f"{method} sat{i}")
    _same_ledgers(fl, fo, method)
    assert fo.summary()["ingest_rounds_deferred"] == 3


@pytest.mark.parametrize("method", ["tiansuan", "targetfuse"])
def test_seeded_faults_match_reference(method, run):
    """A seeded scenario_faults plan: the reference's FaultStats (every
    class fired), results and ledgers, on both contact paths."""
    want, jf = run("ref", method, "seeded")
    got, tf = run("replay" if method in CLUSTERING else "port", method, "seeded")
    fifo, tr = run("port", method, "seeded", contact_reference=True)
    stats = tf.fault_stats.as_dict()
    assert stats == jf.fault_stats.as_dict()
    for k in ("windows_dropped", "windows_truncated", "segments_corrupted",
              "segments_requeued", "blackout_passes"):
        assert stats[f"fault_{k}"] > 0, k
    for i, (a, b) in enumerate(zip(got, want)):
        _same_results(a, b, f"{method} sat{i}")
    _same_ledgers(tf, jf, method)
    if method not in CLUSTERING:
        for a, b in zip(fifo, got):
            _same_results(a, b, f"{method} fifo")
        assert tr.fault_stats.as_dict() == stats
