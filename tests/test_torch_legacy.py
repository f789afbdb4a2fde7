"""The port's frozen monolith (``repro_torch.core._legacy``) on the CPU:
bit for bit the port's Mission (the counterpart of
``tests/test_mission.py``'s parity test), and equal to the reference's
own ``run_pipeline_legacy`` on the same frames and bridged counters.

kodan and targetfuse cluster first. Two-member clusters are exact ties
that the last float bit decides, differently across the frameworks (see
``tests/test_torch_mission.py``): the port's clustering must give the
reference's partition, with representatives that differ only at a tie,
and the results are compared with the reference's assignments and
representatives replayed into the port's monolith.

All uses of the ``counters`` fixture (trained once a process) stay in
this file.
"""
import numpy as np
import pytest
import torch

import repro.core._legacy as jlegacy
import repro.core.dedup as jdd
import repro_torch.core._legacy as tlegacy
import repro_torch.core.dedup as tdd
from repro.core.pipeline import PipelineConfig as JConfig
from repro.data.synthetic import SceneSpec, make_scene, revisit_frames
from repro_torch.core.mission import Mission
from repro_torch.core.pipeline import PipelineConfig
from test_torch_mission import _assert_equal_results, _port_counters
from test_torch_reference_path import _moments64

METHODS = ("space_only", "ground_only", "tiansuan", "kodan", "targetfuse")
SPEC = SceneSpec("mini", 384, (12, 18), (10, 24), cloud_fraction=0.2)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(7)
    img, b, c = make_scene(rng, SPEC)
    return revisit_frames(rng, img, b, c, 3)


@pytest.fixture(scope="module")
def port_counters(counters):
    return _port_counters(counters)


def _assert_bit_identical(a, b):
    np.testing.assert_array_equal(a.per_tile_pred, b.per_tile_pred)
    np.testing.assert_array_equal(a.per_tile_true, b.per_tile_true)
    assert a.summary() == b.summary()


@pytest.mark.parametrize("use_engine", (True, False), ids=("engine", "reference"))
@pytest.mark.parametrize("method", METHODS)
def test_port_mission_bit_identical_to_port_legacy(method, use_engine, frames,
                                                   port_counters):
    pcfg = PipelineConfig(method=method, score_thresh=0.25, use_engine=use_engine)
    got = Mission(*port_counters, pcfg, device="cpu").run(frames)
    want = tlegacy.run_pipeline_legacy(frames, *port_counters, pcfg, device="cpu")
    _assert_bit_identical(got, want)


@pytest.mark.parametrize("n_tiles", (0, 27, 576, 100_000))
def test_budgets_for_legacy_match_reference(n_tiles):
    for kw in ({}, dict(bandwidth_mbps=33.0, contact_s=271.0, real_tile_px=128,
                        energy_budget_j=12_345.6, tiles_per_day=777.0)):
        assert (tlegacy.budgets_for_legacy(PipelineConfig(**kw), n_tiles)
                == jlegacy.budgets_for_legacy(JConfig(**kw), n_tiles))


class _Recorder:
    """The reference's dedup module for its monolith, keeping each
    result."""

    def __init__(self):
        self.results = []

    def __getattr__(self, name):
        return getattr(jdd, name)

    def dedup_from_moments(self, *args, **kwargs):
        self.results.append(jdd.dedup_from_moments(*args, **kwargs))
        return self.results[-1]

    def dedup(self, *args, **kwargs):
        self.results.append(jdd.dedup(*args, **kwargs))
        return self.results[-1]


class _Replay:
    """The port's dedup module for its monolith: the port's clustering
    runs and is kept with its features (float64 normalized moments),
    then the reference's assignments and representatives go on."""

    def __init__(self, ref_results):
        self.ref, self.own = list(ref_results), []

    def __getattr__(self, name):
        return getattr(tdd, name)

    def _replay(self, res, x):
        self.own.append((res, x))
        ref = self.ref.pop(0)
        return res._replace(assign=torch.from_numpy(np.array(ref.assign)),
                            rep_idx=torch.from_numpy(np.array(ref.rep_idx)))

    def dedup_from_moments(self, moments, k, seed, iters=10, n=None):
        m = moments[:n].double().numpy()
        return self._replay(tdd.dedup_from_moments(moments, k, seed, iters, n),
                            (m - m.mean(0)) / (m.std() + 1e-6))

    def dedup(self, tiles, k, seed, iters=10):
        return self._replay(tdd.dedup(tiles, k, seed, iters), _moments64(tiles.numpy()))


def _assert_same_partition(own, ref, x):
    """Same clusters of the active tiles; where the representative
    differs, a tie: both at the same distance from their cluster's mean."""
    mine = own.rep_idx.numpy()[own.assign.numpy()]
    theirs = np.asarray(ref.rep_idx)[np.asarray(ref.assign)]
    pairs = set(zip(mine.tolist(), theirs.tolist()))
    assert len(pairs) == len(set(mine.tolist())) == len(set(theirs.tolist())), \
        "the port's clusters differ from the reference's"
    for a, b in pairs:
        if a != b:
            c = x[theirs == b].mean(0)
            da, db = (((x[i] - c) ** 2).sum() for i in (a, b))
            assert da == pytest.approx(db, rel=1e-5, abs=1e-6), (a, b)


@pytest.mark.parametrize("use_engine", (True, False), ids=("engine", "reference"))
@pytest.mark.parametrize("method", METHODS)
def test_port_legacy_matches_reference_legacy(method, use_engine, frames, counters,
                                              port_counters, monkeypatch):
    recorder = _Recorder()
    monkeypatch.setattr(jlegacy, "dd", recorder)
    want = jlegacy.run_pipeline_legacy(
        frames, *counters, JConfig(method=method, score_thresh=0.25, use_engine=use_engine))
    replay = _Replay(recorder.results)
    monkeypatch.setattr(tlegacy, "dd", replay)
    got = tlegacy.run_pipeline_legacy(
        frames, *port_counters,
        PipelineConfig(method=method, score_thresh=0.25, use_engine=use_engine), device="cpu")
    assert len(replay.own) == len(recorder.results) == (method in ("kodan", "targetfuse"))
    for (own, x), ref in zip(replay.own, recorder.results):
        _assert_same_partition(own, ref, x)
    _assert_equal_results(want, got)
