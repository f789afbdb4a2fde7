"""The whole slice: the port's Mission against the reference's, on the
CPU, with the reference's trained counters carried over by
``params_from_jax``, on the scenario of tests/test_golden.py.

Every policy that does not cluster (space_only, ground_only, tiansuan)
must give per-tile predictions and summaries equal to the reference's.

kodan and targetfuse cluster the tiles first. The port's clustering
must give the reference's partition, with representatives equal up to
ties (see tests/test_torch_dedup.py): a two-member cluster's members are
equidistant from its centroid, and the last float32 bit that decides
between them is not reproducible across the frameworks (XLA's CPU sqrt
and cbrt are not the IEEE/libm ones). A different representative is
counted in its cluster's place, so the predictions are then compared
with the reference's representatives replayed into the port's Mission
(its own clustering still runs and is charged): from there on every
stage must give equal predictions and summaries.

All uses of the session ``counters`` fixture stay in this file: under
``--dist loadfile`` every file that uses it trains it again.
"""
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt
from repro.core.mission import Mission as JMission
from repro.core.pipeline import PipelineConfig as JConfig
from repro.data.synthetic import SceneSpec, make_scene, revisit_frames
from repro_torch.configs import get_config, reduced
from repro_torch.core import mission as tmission
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.launch import serve
from repro_torch.models.detector import params_from_jax

# one intra-op thread: the suite runs in parallel worker processes,
# and torch's default pool (one thread per core) in each of them would
# starve the timing-sensitive tests of other files
torch.set_num_threads(1)

METHODS = ("space_only", "ground_only", "tiansuan", "kodan", "targetfuse")
CLUSTERING = ("kodan", "targetfuse")
SPEC = SceneSpec("golden", 384, (12, 18), (10, 24), cloud_fraction=0.2)


def _frames(seed=42, n_rev=3):
    rng = np.random.default_rng(seed)
    img, b, c = make_scene(rng, SPEC)
    return revisit_frames(rng, img, b, c, n_rev)


class ReplayDedup(tmission.Dedup):
    """The port's Dedup stage, after which each segment takes the
    reference's representatives (one ``rep_of`` array per ingest)."""

    def __init__(self, rep_ofs):
        self.rep_ofs = list(rep_ofs)
        self.own = []

    def run(self, mission, seg, window=None):
        super().run(mission, seg, window)
        self.own.append(seg.rep_of.copy())
        seg.rep_of = self.rep_ofs.pop(0).copy()


def _port_counters(counters):
    (sp, _), (gd, _) = counters
    return ((params_from_jax(sp), reduced(get_config("targetfuse-space"))),
            (params_from_jax(gd), reduced(get_config("targetfuse-ground"))))


def _drive(mission, passes):
    """passes: list of (frames, window budget) -> (result, window reports)."""
    reports = []
    for frames, budget in passes:
        mission.ingest(frames)
        reports.append(mission.contact_window(budget))
    return mission.finalize(), reports


def _run_both(method, counters, passes):
    jm = JMission(*counters, JConfig(method=method, score_thresh=0.25, seed=0))
    want, want_reports = _drive(jm, passes)
    ref_rep_ofs = [s.rep_of for s in jm._segments]
    stages = None
    replay = None
    if method in CLUSTERING:
        replay = ReplayDedup(ref_rep_ofs)
        stages = [tmission.Capture(), tmission.RoiFilter(), replay,
                  tmission.OnboardCount()]
    tm = tmission.Mission(*_port_counters(counters),
                          PipelineConfig(method=method, score_thresh=0.25, seed=0),
                          ingest_stages=stages, device="cpu")
    got, got_reports = _drive(tm, passes)
    return want, want_reports, got, got_reports, ref_rep_ofs, replay, tm


def _assert_same_partition(own, ref, moments):
    """Same clusters; where the representative differs, a tie: both are
    at the same distance from their cluster's mean (normalized moments,
    float64; atol 1e-6 for float32 features of unit scale)."""
    assert own.shape == ref.shape
    pairs = {(a, b) for a, b in zip(own.tolist(), ref.tolist())}
    assert len(pairs) == len(set(own.tolist())) == len(set(ref.tolist())), \
        "the port's clusters differ from the reference's"
    m = moments.astype(np.float64)
    x = (m - m.mean(0)) / (m.std() + 1e-6)
    for a, b in pairs:
        if a == b:
            continue
        members = np.where(ref == b)[0]
        c = x[members].mean(0)
        da, db = (((x[i] - c) ** 2).sum() for i in (a, b))
        assert da == pytest.approx(db, rel=1e-5, abs=1e-6), (a, b, members)


def _assert_equal_results(want, got):
    np.testing.assert_array_equal(got.per_tile_pred, want.per_tile_pred)
    np.testing.assert_array_equal(got.per_tile_true, want.per_tile_true)
    ws, gs = want.summary(), got.summary()
    assert set(gs) == set(ws)
    for k, v in ws.items():
        if isinstance(v, (int, np.integer)):
            assert gs[k] == v, k
        else:
            assert gs[k] == pytest.approx(v, rel=1e-12, abs=1e-12), k


@pytest.mark.parametrize("method", METHODS)
def test_mission_matches_reference_on_golden_scenario(method, counters):
    passes = [(_frames(), 3e6)]
    want, want_rep, got, got_rep, ref_rep_ofs, replay, tm = _run_both(method, counters, passes)
    _assert_equal_results(want, got)
    assert got_rep == [tmission.WindowReport(**vars(r)) for r in want_rep]
    assert got.tiles_total == 27
    if replay is not None:
        seg = tm._segments[0]
        active = np.where(seg.active)[0]
        moments = seg.prep.moments.numpy()[active]
        _assert_same_partition(replay.own[0][active], ref_rep_ofs[0][active], moments)
        assert got.tiles_processed_space > 0
    if method != "space_only":
        assert got.tiles_downlinked > 0


@pytest.mark.parametrize("method", ["tiansuan", "targetfuse"])
def test_mission_streams_two_passes_and_two_windows(method, counters):
    """Budgets carry across passes: two ingests of different scenes, each
    followed by its own contact window (a fixed budget, then the pending
    entitlement), then finalize."""
    passes = [(_frames(42, 2), 2e6), (_frames(7, 3), None)]
    want, want_rep, got, got_rep, _, _, tm = _run_both(method, counters, passes)
    _assert_equal_results(want, got)
    assert got_rep == [tmission.WindowReport(**vars(r)) for r in want_rep]
    assert len(tm._segments) == 2 and tm.pending_segments == 0
    assert got.tiles_total == 45
    # finalize is idempotent and a window after it is a no-op
    assert tm.contact_window(1e6).segments == 0
    _assert_equal_results(want, tm.finalize())


def test_serve_reads_reference_checkpoints_and_prints_the_table(counters, tmp_path, capsys):
    """The port's serve CLI on the reference's cached counters."""
    with pytest.raises(FileNotFoundError, match="repro.launch.serve"):
        serve.get_counters(str(tmp_path))
    (sp, _), (gd, _) = counters
    ckpt.save(str(tmp_path / "space"), 150, sp)
    ckpt.save(str(tmp_path / "ground"), 300, gd)
    serve.main(["--counters", str(tmp_path), "--device", "cpu",
                "--frames", "1", "--revisits", "2"])
    rows = capsys.readouterr().out.strip().splitlines()
    assert rows[0].startswith("2 frames, 16 tiles each")
    assert [r.split()[0] for r in rows[2:]] == sorted(METHODS)
