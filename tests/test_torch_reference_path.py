"""The port's reference path (``PipelineConfig(use_engine=False)``) against
the reference's, on the CPU, with the session's trained reduced counters
carried over by ``params_from_jax``.

The reference path is the seed's host-orchestrated execution of the
Mission: frames tiled and resized one by one, tiles kept on the host,
the ROI statistic taken from the tiles, the active tiles clustered from
their own moments (the unpadded ``dedup``) and counted in host slices
(``count_tiles_batched_ref``). The reference holds its engine to it
(``BENCH_pipeline.json`` ``max_pred_dev == 0.0``); so does the port.

- ``Mission(use_engine=False)`` against ``repro``'s, five policies:
  per-tile predictions, summaries and window reports equal. kodan and
  targetfuse cluster first; their representatives may differ from the
  reference's only at exact ties (ROADMAP queue 3,
  tests/test_torch_mission.py), so after the port's own clustering has
  run and been checked for the reference's partition, those runs take
  the reference's representatives.
- Within the port, the reference path equals the engine path, free
  running, bit for bit.
- The unpadded ``dedup``, ``features`` (1e-6) and ``kmeans``
  (assignments equal, representatives and picks equal but at exact
  ties), and ``count_tiles_batched_ref`` (counts equal, confidences
  1e-6, as tests/test_torch_counter.py) against ``repro``'s.
- A ``Fleet`` whose every other satellite is on the reference path:
  equal to looped Missions and, per satellite, to ``repro``'s Fleet.

All uses of the session ``counters`` fixture stay in this file.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.dedup as jdd
from repro.core import cascade as jcascade
from repro.core.fleet import Fleet as JFleet
from repro.core.mission import Mission as JMission
from repro.core.pipeline import PipelineConfig as JConfig
from repro.data import scenarios as jscenarios
from repro.data.synthetic import SceneSpec as JSceneSpec
from repro.data.synthetic import make_scene, revisit_frames
import repro_torch.core.dedup as dd
from repro_torch.configs import get_config, reduced
from repro_torch.core import cascade, fleet, faults, tiling
from repro_torch.core import mission as tmission
from repro_torch.core.pipeline import PipelineConfig, run_pipeline
from repro_torch.core.policies import PolicyContextBatch, get_policy
from repro_torch.data import scenarios
from repro_torch.data.synthetic import SceneSpec
from repro_torch.models.detector import params_from_jax

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

METHODS = ("space_only", "ground_only", "tiansuan", "kodan", "targetfuse")
CLUSTERING = ("kodan", "targetfuse")
SPEC = JSceneSpec("golden", 384, (12, 18), (10, 24), cloud_fraction=0.2)
SCENE = dict(name="fleet", scene_px=384, objects_per_scene=(10, 18), object_px=(10, 24),
             cloud_fraction=0.25)
REF = dict(score_thresh=0.25, use_engine=False)


def _frames(seed=42, n_rev=3):
    rng = np.random.default_rng(seed)
    img, b, c = make_scene(rng, SPEC)
    return revisit_frames(rng, img, b, c, n_rev)


@pytest.fixture(scope="module")
def port_counters(counters):
    (sp, _), (gd, _) = counters
    return ((params_from_jax(sp), reduced(get_config("targetfuse-space"))),
            (params_from_jax(gd), reduced(get_config("targetfuse-ground"))))


class ReplayDedup(tmission.Dedup):
    """The port's Dedup stage, after which each segment takes another
    run's representatives: ``ref_rep_of(mission)`` gives them for the
    segment being ingested. ``own`` keeps (mission, the segment's index
    in it, the segment, its own rep_of)."""

    def __init__(self, ref_rep_of):
        self.ref_rep_of, self.own = ref_rep_of, []

    def run(self, mission, seg, window=None):
        super().run(mission, seg, window)
        self.own.append((mission, len(mission._segments), seg, seg.rep_of.copy()))
        seg.rep_of = self.ref_rep_of(mission).copy()


def _same_partition(seg, mine, theirs):
    """Same clusters; where the representative differs, a tie: both at
    the same distance from their cluster's mean (float64 normalized
    moments of the active tiles, atol 1e-6)."""
    act = np.where(seg.active)[0]
    pairs = set(zip(mine[act].tolist(), theirs[act].tolist()))
    assert len(pairs) == len(set(mine[act].tolist())) == len(set(theirs[act].tolist())), \
        "the port's clusters differ from the reference's"
    tiles = seg.tiles_sp if isinstance(seg.tiles_sp, np.ndarray) else seg.tiles_sp.numpy()
    x = _moments64(tiles[act])
    for a, b in pairs:
        if a != b:
            c = x[theirs[act] == b].mean(0)
            da, db = (((x[np.searchsorted(act, i)] - c) ** 2).sum() for i in (a, b))
            assert da == pytest.approx(db, rel=1e-5, abs=1e-6), (a, b)


def _moments64(tiles):
    """Normalized color moments of (N, H, W, C) tiles in float64."""
    t = tiles.astype(np.float64)
    mu = t.mean((1, 2))
    d = t - mu[:, None, None]
    m = np.concatenate([mu, np.sqrt((d ** 2).mean((1, 2)) + 1e-12),
                        np.cbrt((d ** 3).mean((1, 2)))], axis=1)
    return (m - m.mean(0)) / (m.std() + 1e-6)


def _same_results(got, want, ctx=""):
    np.testing.assert_array_equal(got.per_tile_pred, want.per_tile_pred, err_msg=ctx)
    np.testing.assert_array_equal(got.per_tile_true, want.per_tile_true, err_msg=ctx)
    ws, gs = want.summary(), got.summary()
    assert set(gs) == set(ws), ctx
    for k, v in ws.items():
        if isinstance(v, (int, np.integer)):
            assert gs[k] == v, (ctx, k)
        else:
            assert gs[k] == pytest.approx(v, rel=1e-12, abs=1e-12), (ctx, k)


def _drive(mission, passes):
    """passes: list of (frames, window budget) -> (result, window reports)."""
    reports = []
    for frames, budget in passes:
        mission.ingest(frames)
        reports.append(mission.contact_window(budget))
    return mission.finalize(), reports


# ---------------------------------------------------------------------------
# the Mission on the reference path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
def test_reference_path_mission_matches_repro(method, counters, port_counters):
    passes = [(_frames(42, 2), 2e6), (_frames(7, 3), None)]
    jm = JMission(*counters, JConfig(method=method, **REF))
    want, want_rep = _drive(jm, passes)
    replay, stages = None, None
    if method in CLUSTERING:
        replay = ReplayDedup(lambda m: jm._segments[len(m._segments)].rep_of)
        stages = [tmission.Capture(), tmission.RoiFilter(), replay, tmission.OnboardCount()]
    tm = tmission.Mission(*port_counters, PipelineConfig(method=method, **REF),
                          ingest_stages=stages, device="cpu")
    got, got_rep = _drive(tm, passes)
    _same_results(got, want, method)
    assert got_rep == [tmission.WindowReport(**vars(r)) for r in want_rep]
    assert got.tiles_total == 45
    for seg in tm._segments:
        assert isinstance(seg.tiles_sp, np.ndarray) and seg.prep is None
    if replay is not None:
        assert len(replay.own) == 2
        for (_, _, seg, mine), jseg in zip(replay.own, jm._segments):
            np.testing.assert_array_equal(seg.active, jseg.active)
            _same_partition(seg, mine, jseg.rep_of)
        assert got.tiles_processed_space > 0
    if method != "space_only":
        assert got.tiles_downlinked > 0


@pytest.mark.parametrize("method", METHODS)
def test_reference_path_equals_engine_path(method, port_counters):
    """The port's two paths, free running (the port's own dedup on both):
    per-tile predictions, summaries, ROI masks and representatives equal."""
    passes = [(_frames(42, 2), 2e6), (_frames(7, 3), None)]
    runs = []
    for use_engine in (True, False):
        m = tmission.Mission(*port_counters,
                             PipelineConfig(method=method, score_thresh=0.25,
                                            use_engine=use_engine), device="cpu")
        runs.append((_drive(m, passes), m))
    ((eng, eng_rep), me), ((ref, ref_rep), mr) = runs
    _same_results(ref, eng, method)
    assert ref_rep == eng_rep
    for se, sr in zip(me._segments, mr._segments):
        np.testing.assert_array_equal(sr.active, se.active)
        np.testing.assert_array_equal(sr.rep_of, se.rep_of)
        np.testing.assert_array_equal(sr.tiles_sp, se.tiles_sp[:se.n].numpy())
        np.testing.assert_array_equal(sr.tiles_gd, se.tiles_gd[:se.n].numpy())


def test_run_pipeline_on_the_reference_path(port_counters):
    pcfg = PipelineConfig(method="targetfuse", **REF)
    got = run_pipeline(_frames(), *port_counters, pcfg, device="cpu")
    want = tmission.Mission(*port_counters, pcfg, device="cpu").run(_frames())
    _same_results(got, want)
    assert got.tiles_total == 27


@pytest.mark.parametrize("method", METHODS)
def test_empty_frames_on_the_reference_path(method, counters, port_counters):
    want = JMission(*counters, JConfig(method=method, use_engine=False)).run([])
    m = tmission.Mission(*port_counters, PipelineConfig(method=method, use_engine=False),
                         device="cpu")
    got = m.run([])
    _same_results(got, want, method)
    assert got.tiles_total == 0 and got.per_tile_pred.shape == (0,)
    assert m._segments[0].tiles_sp.shape == (0, 64, 64, 3)


@pytest.mark.parametrize("credit", (False, True))
def test_tiansuan_unprocessed_downlink_credit_on_the_reference_path(credit, counters,
                                                                    port_counters):
    """As tests/test_mission.py's audit: a tiny energy budget leaves tiles
    unprocessed and ample bandwidth downlinks them; they are credited only
    with ``tiansuan_credit_unprocessed``."""
    kw = dict(method="tiansuan", score_thresh=0.25, energy_budget_j=8_000.0,
              bandwidth_mbps=500.0, use_engine=False, tiansuan_credit_unprocessed=credit)
    frames = _frames(7, 3)
    want = JMission(*counters, JConfig(**kw)).run(frames)
    m = tmission.Mission(*port_counters, PipelineConfig(**kw), device="cpu")
    got = m.run(frames)
    _same_results(got, want)
    seg = m._segments[0]
    down = seg.selection.downlink
    unproc_down = down[~seg.processed[down]]
    assert len(unproc_down) > 0, "the scenario must exercise the energy cap"
    assert seg.bytes_requested >= len(down) * m.tile_bytes - 1e-6
    if credit:
        np.testing.assert_array_equal(got.per_tile_pred[unproc_down],
                                      seg.counts_gd[unproc_down])
    else:
        assert np.all(got.per_tile_pred[unproc_down] == 0.0)


def test_roi_mask_matches_repro(counters, port_counters):
    """RoiFilter on the reference path: the population std over H and W,
    then the mean over the channels, in float32 (within 2e-6 relative of
    the reference's). At a threshold that splits the tiles, between two
    neighbouring statistics, the masks are equal: no statistic is within
    4 float32 ulps of it."""
    frames = _frames(42, 3)
    jm = JMission(*counters, JConfig(method="targetfuse", **REF))
    jm.ingest(frames)
    sd = np.sort(np.asarray(jnp.mean(jnp.std(jnp.asarray(jm._segments[0].tiles_sp),
                                             axis=(1, 2)), axis=-1)))
    thresh = float((sd[len(sd) // 2] + sd[len(sd) // 2 + 1]) / 2)
    assert (np.abs(sd - np.float32(thresh)) > 4 * np.spacing(np.float32(thresh))).all()
    kw = dict(method="targetfuse", roi_std_thresh=thresh, **REF)
    jm = JMission(*counters, JConfig(**kw))
    jm.ingest(frames)
    tm = tmission.Mission(*port_counters, PipelineConfig(**kw), device="cpu")
    tm.ingest(frames)
    jseg, tseg = jm._segments[0], tm._segments[0]
    t = torch.from_numpy(tseg.tiles_sp)
    got = ((t - t.mean((1, 2), keepdim=True)).square().sum((1, 2)) / (64 * 64)).sqrt().mean(-1)
    want = np.asarray(jnp.mean(jnp.std(jnp.asarray(jseg.tiles_sp), axis=(1, 2)), axis=-1))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6)
    np.testing.assert_array_equal(tseg.active, jseg.active)
    assert tseg.active.sum() == tseg.n - len(sd) // 2 - 1


# ---------------------------------------------------------------------------
# the reference path's primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", (10, 64, 100), ids=("n<batch", "n=batch", "n>batch"))
def test_count_tiles_batched_ref_matches_repro(n, counters, port_counters, monkeypatch):
    """Seed batching: one ``count_tiles`` a slice of 64, padded only when
    n > 64 (so 1, 1 and 2 slices, the last padded to 64)."""
    (sp, _), _ = counters
    tiles = np.random.default_rng(n).random((n, 64, 64, 3), dtype=np.float32)
    jc, jf = jcascade.count_tiles_batched_ref(sp, reduced(get_config("targetfuse-space")),
                                              tiles, score_thresh=0.25)
    shapes = []
    count = cascade.count_tiles
    monkeypatch.setattr(cascade, "count_tiles",
                        lambda p, c, t, *a: shapes.append(t.shape[0]) or count(p, c, t, *a))
    tc, tf = cascade.count_tiles_batched_ref(*port_counters[0], tiles, score_thresh=0.25)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(tf, jf, atol=1e-6)
    assert tc.shape == tf.shape == (n,) and tc.dtype == np.float32
    assert shapes == {10: [10], 64: [64], 100: [64, 64]}[n]


def _scene_tiles(n_frames, seed):
    """The space counter's input tiles of revisits of one scene (9 tiles a
    frame, 64 px), as the reference path's Capture makes them."""
    return np.concatenate([
        tiling.resize_tiles(tiling.tile_image(torch.from_numpy(img), 128), 64).numpy()
        for img, _, _ in _frames(seed, n_frames)])


def _feature_atol(tiles):
    """The reference's moments are float32 sums, within 1e-5 of the
    port's float64 ones (tests/test_torch_capture.py); normalized
    features carry that error over the global scale."""
    from repro.kernels import ops as jops
    return 1e-5 / float(np.std(np.asarray(jops.tile_moments(jnp.asarray(tiles)))))


def _same_clustering(got, want, x, cents):
    """Assignments equal; representatives equal but at ties (both in the
    cluster, at the same distance from its centroid, atol 1e-6)."""
    a = got[0].numpy()
    np.testing.assert_array_equal(a, np.asarray(want[0]))
    for j, (rt, rj) in enumerate(zip(got[1].numpy(), np.asarray(want[1]))):
        if rt != rj:
            assert a[rt] == j and a[rj] == j, (j, rt, rj)
            dt, dj = (((x[r] - cents[j]) ** 2).sum() for r in (rt, rj))
            assert dt == pytest.approx(dj, rel=1e-5, abs=1e-6), (j, rt, rj)


@pytest.mark.parametrize("n_frames,k,seed", [(2, 9, 42), (5, 20, 7), (10, 7, 3)])
def test_unpadded_dedup_matches_repro(n_frames, k, seed):
    """``dedup(tiles, k, seed)``: the tiles' moments, then the core the
    engine path enters. Assignments and sizes equal, representatives
    equal but at ties, centroids within the features' tolerance."""
    tiles = _scene_tiles(n_frames, seed)
    want = jdd.dedup(jnp.asarray(tiles), k, jax.random.PRNGKey(seed))
    got = dd.dedup(torch.from_numpy(tiles), k, seed)
    x = np.asarray(jdd.features(jnp.asarray(tiles)), np.float64)
    _same_clustering((got.assign, got.rep_idx), (want.assign, want.rep_idx), x,
                     np.asarray(want.centroids, np.float64))
    np.testing.assert_array_equal(got.cluster_sizes.numpy(), np.asarray(want.cluster_sizes))
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(want.centroids),
                               atol=_feature_atol(tiles))


@pytest.mark.parametrize("n_frames,seed", [(1, 42), (10, 7)])
def test_features_and_normalize_moments_match_repro(n_frames, seed):
    """``normalize_moments`` of the same raw moments within 1e-6;
    ``features`` of the same tiles within the moments' 1e-5 carried over
    the global scale (:func:`_feature_atol`)."""
    tiles = _scene_tiles(n_frames, seed)
    np.testing.assert_allclose(dd.features(torch.from_numpy(tiles)).numpy(),
                               np.asarray(jdd.features(jnp.asarray(tiles))),
                               atol=_feature_atol(tiles))
    m = np.random.default_rng(seed).random((9 * n_frames, 9)).astype(np.float32)
    np.testing.assert_allclose(dd.normalize_moments(torch.from_numpy(m)).numpy(),
                               np.asarray(jdd.normalize_moments(jnp.asarray(m))), atol=1e-6)


@pytest.mark.parametrize("n_frames,k,seed", [(3, 5, 0), (5, 16, 4), (10, 12, 9)])
def test_kmeans_matches_repro(n_frames, k, seed):
    """The unpadded k-means (one ``kmeans_assign`` a k-means++ pick, the
    one-hot Lloyd update) on the same features: the seeding's centroids
    and the assignments equal, the final centroids and distances within
    1e-5."""
    x = np.array(jdd.features(jnp.asarray(_scene_tiles(n_frames, seed))))
    ja, jc, jd2 = jdd.kmeans(jnp.asarray(x), k, jax.random.PRNGKey(seed))
    ta, tc, td2 = dd.kmeans(torch.from_numpy(x), k, seed)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(td2.numpy(), np.asarray(jd2), atol=1e-5)
    np.testing.assert_array_equal(
        dd._kmeanspp_init(torch.from_numpy(x), k, seed).numpy(),
        np.asarray(jdd._kmeanspp_init(jnp.asarray(x), k, jax.random.PRNGKey(seed))))


def test_select_batch_sends_reference_lanes_to_the_scalar_policy(port_counters):
    """A drain step holding a reference-path lane selects lane by lane
    with the unpadded throttle; each lane equals its scalar select."""
    missions = [tmission.Mission(*port_counters,
                                 PipelineConfig(method="targetfuse", score_thresh=0.25,
                                                use_engine=e), device="cpu")
                for e in (True, False)]
    ctxs = []
    for m, seed in zip(missions, (42, 7)):
        m.ingest(_frames(seed, 2))
        ctxs.append(tmission.policy_context(m, m._segments[0]))
    policy = get_policy("targetfuse")
    batch = PolicyContextBatch.stack(ctxs, policies=[m.policy for m in missions])
    sb = policy.select_batch(batch, np.array([2e6, 2e6]))
    for sel, ctx in zip(sb.selections, ctxs):
        want = policy.select(ctx, 2e6)
        np.testing.assert_array_equal(sel.downlink, want.downlink)
        np.testing.assert_array_equal(sel.accept_space, want.accept_space)
        np.testing.assert_array_equal(sel.ground_credit, want.ground_credit)
        assert sel.bytes_requested == want.bytes_requested
    assert len(sb.selections[1].downlink) > 0


# ---------------------------------------------------------------------------
# a Fleet with satellites on both paths
# ---------------------------------------------------------------------------

def _spec(mod, scene):
    return mod.FleetScenarioSpec(
        n_sats=4, n_rounds=3, frames_per_pass=1,
        stations=(mod.GroundStation("gs0"),
                  mod.GroundStation("gs1", bandwidth_mbps=30.0, contact_s=240.0)),
        scene_mix=(scene,), seed=5)


def _mixed(cfg, method, **kw):
    """Every other satellite (0 and 2) on the reference path."""
    return [cfg(method=method, score_thresh=0.25, use_engine=i % 2 == 1, **kw)
            for i in range(4)]


class ReplayFleet(fleet.Fleet):
    """The port's Fleet on a reference run's representatives: the batched
    dedup's lanes and the reference-path satellites' Dedup stages run
    and are kept, then each segment takes the reference's."""

    def __init__(self, *args, reference, **kw):
        super().__init__(*args, **kw)
        self.own = []

        def ref_rep_of(m):
            i = next(i for i, mi in enumerate(self.missions) if mi is m)
            return reference.missions[i]._segments[len(m._segments)].rep_of
        self._ref_rep_of = ref_rep_of
        for m in self.missions:
            if not m.pcfg.use_engine:
                m.ingest_stages[2] = ReplayDedup(ref_rep_of)

    def _dedup_batched(self, sats, segs, defer=False):
        out = super()._dedup_batched(sats, segs, defer)
        for i in sats:
            m = self.missions[i]
            self.own.append((m, len(m._segments), segs[i], segs[i].rep_of.copy()))
            segs[i].rep_of = self._ref_rep_of(m).copy()
        return out


def _drive_fleet(fl, sc):
    n = sc.spec.n_sats
    for rnd in sc.rounds:
        fl.ingest(rnd.frames_per_sat(n), rnd.harvest_per_sat(n))
        if rnd.contacts:
            fl.contact_round(plan=rnd.contact_plan(n))
    return fl.finalize()


@pytest.fixture(scope="module")
def scenes():
    return (jscenarios.generate_scenario(_spec(jscenarios, JSceneSpec(**SCENE))),
            scenarios.generate_scenario(_spec(scenarios, SceneSpec(**SCENE))))


@pytest.mark.parametrize("method", METHODS)
def test_mixed_fleet_equals_looped_missions(method, port_counters, scenes):
    _, sc = scenes
    pcfgs = _mixed(PipelineConfig, method)
    got, fl = fleet.run_scenario(*port_counters, pcfgs, sc, device="cpu")
    want, missions = fleet.run_scenario(*port_counters, pcfgs, sc, fleet=False, device="cpu")
    assert fl._batchable == [False, True, False, True]
    for i, (a, b, m) in enumerate(zip(got, want, missions)):
        _same_results(a, b, f"{method} sat{i}")
        assert fl.ledger.spent[i] == m.ledger.spent
        assert fl.ledger.bytes_spent[i] == m.bytes_spent
    for i in (0, 2):
        assert all(s.prep is None for s in fl.missions[i]._segments)
    assert all(s.prep is not None for s in fl.missions[1]._segments)
    assert sum(r.total_pred for r in got) > 0


@pytest.mark.parametrize("method", METHODS)
def test_mixed_fleet_matches_repro(method, counters, port_counters, scenes):
    jsc, tsc = scenes
    jf = JFleet(*counters, _mixed(JConfig, method), n_sats=4)
    want = _drive_fleet(jf, jsc)
    if method in CLUSTERING:
        fl = ReplayFleet(*port_counters, _mixed(PipelineConfig, method), device="cpu",
                         reference=jf)
        got = _drive_fleet(fl, tsc)
        own = fl.own + [o for m in fl.missions if not m.pcfg.use_engine
                        for o in m.ingest_stages[2].own]
        assert len(own) == 12
        for m, k, seg, mine in own:
            i = next(i for i, mi in enumerate(fl.missions) if mi is m)
            _same_partition(seg, mine, jf.missions[i]._segments[k].rep_of)
    else:
        got, fl = fleet.run_scenario(*port_counters, _mixed(PipelineConfig, method), tsc,
                                     device="cpu")
    for i, (a, b) in enumerate(zip(got, want)):
        _same_results(a, b, f"{method} sat{i}")
    for f in ("budget_j", "e_cap", "e_com", "e_agg", "e_down", "bytes_budget",
              "bytes_requested", "bytes_spent"):
        np.testing.assert_array_equal(getattr(fl.ledger, f)[:4], getattr(jf.ledger, f)[:4],
                                      err_msg=f)


def test_mixed_fleet_under_faults_equals_the_fifo_reference(port_counters, scenes):
    """A seeded fault plan: the reference-path satellites' windows take the
    scalar fault drain inside the batched round, and the round equals the
    FIFO reference executor, results and fault counters."""
    _, sc = scenes
    plan = faults.scenario_faults(sc.spec, seed=4, drop_rate=0.25, truncate_rate=0.4,
                                  corrupt_rate=0.4, blackout_rate=0.2, outage_rate=0.5)
    pcfgs = _mixed(PipelineConfig, "tiansuan")
    got, fl = fleet.run_scenario(*port_counters, pcfgs, sc, faults=plan, device="cpu")
    want, ref = fleet.run_scenario(*port_counters, pcfgs, sc, faults=plan,
                                   contact_reference=True, device="cpu")
    for i, (a, b) in enumerate(zip(got, want)):
        _same_results(a, b, f"sat{i}")
    assert fl.fault_stats.as_dict() == ref.fault_stats.as_dict()
    assert fl.fault_stats.segments_corrupted > 0
