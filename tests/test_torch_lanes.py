"""The port's lane-batched primitives against the reference's batched
functions, and each lane against the port's own one-lane function, on
the CPU (plain versions of the kernels).

Each primitive batches one fleet stage across satellites or contact
windows: ``engine.prepare_frames_multi`` (shared frame buckets),
``cascade.count_tiles_multi`` (shared counting batches),
``dedup.dedup_multi`` (one lane batch a shape bucket, through
``ops.kmeanspp_seed_lanes`` and ``ops.kmeans_assign_lanes``),
``throttle.throttle_padded_batch`` and the policies' ``select_batch``,
and the stacked ``energy.FleetLedger``.

Discrete outputs (tile order, ROI masks, counts, assignments, keep and
throttle masks) must equal the reference's; dedup representatives may
differ from the reference's only at exact ties (ROADMAP queue 3, and
tests/test_torch_dedup.py). Every lane must equal the port's one-lane
function bit for bit, and the plain lane kernels must equal a loop of
the one-lane plain versions bit for bit, ragged lanes included.

The counter here is a seeded random reduced counter, the same weights
on both sides: the counts only need to agree, and the session's trained
counters would cost this file a training run of its own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.dedup as jdd
import repro_torch.core.dedup as dd
from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core import cascade as jcascade
from repro.core import engine as jengine
from repro.core import energy as jenergy
from repro.core import policies as jpolicies
from repro.core import throttle as jthrottle
from repro.core.pipeline import PipelineConfig as JConfig
from repro.data.synthetic import SceneSpec, make_scene, revisit_frames
from repro_torch.configs import get_config, reduced
from repro_torch.core import cascade, energy, engine, policies, throttle
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.kernels import kmeans_assign, ops, ref
from repro_torch.models import detector

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

SCENE = SceneSpec("lanes", 384, (10, 18), (10, 24), cloud_fraction=0.25)
SMALL = SceneSpec("lanes_small", 256, (6, 12), (10, 20), cloud_fraction=0.2)


def _frames(seed, n, spec=SCENE):
    rng = np.random.default_rng(seed)
    img, b, c = make_scene(rng, spec)
    return revisit_frames(rng, img, b, c, n)


@pytest.fixture(scope="module")
def space():
    """Seeded random reduced space counter, port and reference: the
    head's objectness and class-0 biases raised so tiles have boxes, its
    weights widened so confidences spread."""
    cfg = reduced(get_config("targetfuse-space"))
    p = detector.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    p["head_w"] = p["head_w"] * 30.0
    hb = p["head_b"].view(cfg.n_anchors, 5 + cfg.n_classes)
    hb[:, 4] = 2.0
    hb[:, 5] = 2.0

    def to_jax(tree):
        if isinstance(tree, dict):
            return {k: to_jax(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_jax(v) for v in tree]
        return jnp.asarray(tree.numpy())
    return (to_jax(p), jreduced(jget_config("targetfuse-space"))), (p, cfg)


# ---------------------------------------------------------------------------
# the lane kernels' plain versions and dispatch
# ---------------------------------------------------------------------------

def _lanes(n_pad, ns, d=9, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((len(ns), n_pad, d)).astype(np.float32)
    for i, n in enumerate(ns):
        x[i, n:] = 0.0
        x[i, 3] = x[i, 1]    # a duplicate row: ties in the seeding
    return torch.from_numpy(x)


@pytest.mark.parametrize("n_pad,ns,ks,k_pad", [
    (128, [128, 100, 37, 5], [64, 50, 18, 2], 64),   # ragged n and k in one bucket
    (256, [256], [128], 128),                        # one lane
    (128, [90, 90, 90], [45, 64, 70], 64),           # k past k_pad
])
def test_plain_lane_kernels_equal_a_loop_of_one_lane_versions(n_pad, ns, ks, k_pad):
    x = _lanes(n_pad, ns)
    firsts = [(7 * i + 3) % n for i, n in enumerate(ns)]
    cents, picks = ops.kmeanspp_seed_lanes(x, ns, firsts, ks, k_pad)
    assert cents.shape == (len(ns), k_pad, 9) and picks.dtype == torch.int32
    assign, d2 = ops.kmeans_assign_lanes(x, cents)
    for i in range(len(ns)):
        c1, p1 = ref.kmeanspp_seed(x[i].contiguous(), ns[i], firsts[i], ks[i], k_pad)
        assert torch.equal(cents[i], c1) and torch.equal(picks[i], p1)
        a1, e1 = ref.kmeans_assign(x[i].contiguous(), cents[i].contiguous())
        assert torch.equal(assign[i], a1) and torch.equal(d2[i], e1)
    assert kmeans_assign.KERNEL.launches == 0 and kmeans_assign.KERNEL._lib is None


@pytest.mark.parametrize("call", [
    lambda: kmeans_assign.kmeans_assign_lanes(torch.zeros(2, 64, 9), torch.zeros(2, 33, 9)),
    lambda: kmeans_assign.kmeanspp_seed_lanes(torch.zeros(2, 128, 9), [100, 50], [3, 0],
                                              [10, 10], 64),
])
def test_lane_wrappers_refuse_cpu_tensors(call):
    """A lane wrapper launches its kernel or raises; it never computes on
    the CPU, and refusing builds nothing."""
    with pytest.raises(ValueError, match="CUDA"):
        call()
    assert kmeans_assign.KERNEL._lib is None


# ---------------------------------------------------------------------------
# capture: shared frame buckets
# ---------------------------------------------------------------------------

def test_prepare_frames_multi_matches_reference_and_one_lane():
    """Four workloads (one empty, one of two resolutions mixed in a
    second fleet) through shared buckets: tile order, truth, ROI masks
    and tiles equal the reference's; every workload equals the port's
    own prepare_frames on it alone, bit for bit."""
    a, b, c = _frames(1, 2), _frames(2, 3), _frames(3, 1)
    small = _frames(4, 2, SMALL)
    for workloads in ([a, [], b, c], [a, small, c]):
        got = engine.prepare_frames_multi(workloads, 128, 64, 64, device="cpu")
        want = jengine.prepare_frames_multi(workloads, 128, 64, 64)
        assert len(got) == len(want) == len(workloads)
        for w, g, j in zip(workloads, got, want):
            assert g.n == j.n and g.tiles_sp.shape == j.tiles_sp.shape
            np.testing.assert_array_equal(g.true, j.true)
            # 128 -> 64 px is a downsample: bit-equal to jax.image.resize
            np.testing.assert_array_equal(g.tiles_sp.numpy(), np.asarray(j.tiles_sp))
            np.testing.assert_array_equal(g.tiles_gd.numpy(), np.asarray(j.tiles_gd))
            np.testing.assert_array_equal(g.roi_std > 0.02, np.asarray(j.roi_std) > 0.02)
            np.testing.assert_allclose(g.moments.numpy(), np.asarray(j.moments),
                                       rtol=1e-5, atol=1e-5)
            # real rows: a pad frame's tiles are zeros either way, but
            # their moments differ from zero padding (std is 1e-6)
            one = engine.prepare_frames(w, 128, 64, 64, device="cpu")
            assert one.n == g.n
            for f in ("tiles_sp", "tiles_gd", "moments"):
                assert torch.equal(getattr(one, f)[:g.n], getattr(g, f)[:g.n]), f
            np.testing.assert_array_equal(one.roi_std, g.roi_std)
            np.testing.assert_array_equal(one.true, g.true)


def test_prepare_frames_multi_defers_the_roi_copy():
    workloads = [_frames(1, 2), _frames(2, 1)]
    eager = engine.prepare_frames_multi(workloads, 128, 64, 64, device="cpu")
    lazy = engine.prepare_frames_multi(workloads, 128, 64, 64, defer_stats=True,
                                       device="cpu")
    for e, d in zip(eager, lazy):
        assert isinstance(e.roi_std, np.ndarray) and isinstance(d.roi_std, torch.Tensor)
        np.testing.assert_array_equal(d.roi_std.numpy(), e.roi_std)
    none = engine.prepare_frames_multi([[], []], 128, 64, 64, with_stats=False,
                                       device="cpu")
    assert [p.n for p in none] == [0, 0] and none[0].moments is None


# ---------------------------------------------------------------------------
# counting: shared counting batches
# ---------------------------------------------------------------------------

def test_count_tiles_multi_matches_reference_and_one_lane(space):
    (jp, jcfg), (tp, tcfg) = space
    preps = engine.prepare_frames_multi([_frames(5, 2), _frames(6, 3), _frames(7, 1)],
                                        128, 64, 64, device="cpu")
    rng = np.random.default_rng(0)
    idxs = [np.sort(rng.choice(p.n, size=k, replace=False))
            for p, k in zip(preps, (7, 0, 9))]
    parts = [(p.tiles_sp, i) for p, i in zip(preps, idxs)]
    got = cascade.count_tiles_multi(tp, tcfg, parts, score_thresh=0.25)
    want = jcascade.count_tiles_multi(
        jp, jcfg, [(jnp.asarray(p.tiles_sp.numpy()), i) for p, i in zip(preps, idxs)],
        score_thresh=0.25)
    resolve = cascade.count_tiles_multi(tp, tcfg, parts, score_thresh=0.25, defer=True)
    assert callable(resolve)
    for (c, f), (jc, jf), (dc, df), (tiles, idx) in zip(got, want, resolve(), parts):
        np.testing.assert_array_equal(c, np.asarray(jc))      # counts
        np.testing.assert_allclose(f, np.asarray(jf), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(c, dc)
        np.testing.assert_array_equal(f, df)
        oc, of = cascade.count_tiles_batched(tp, tcfg, tiles, idx=idx, score_thresh=0.25)
        np.testing.assert_array_equal(c, oc)
        np.testing.assert_array_equal(f, of)
    assert sum(len(c) for c, _ in got) == 16 and any(c.sum() > 0 for c, _ in got)
    empty = cascade.count_tiles_multi(tp, tcfg, [(preps[0].tiles_sp, [])])
    assert empty[0][0].shape == (0,)


# ---------------------------------------------------------------------------
# dedup: one lane batch a shape bucket
# ---------------------------------------------------------------------------

def _moments(n, seed):
    """Revisit-like raw moments: jittered near-duplicates of a few bases."""
    rng = np.random.default_rng(seed)
    bases = rng.random((max(2, n // 4), 9)).astype(np.float32)
    m = bases[rng.integers(0, len(bases), n)]
    return (m + 0.01 * rng.standard_normal((n, 9))).astype(np.float32)


def _same_clustering(got, want, m):
    """Equal assignments and sizes; a different representative only at
    an exact tie: both members of the cluster, at distances from its
    centroid equal within float32 rounding of unit-scale features."""
    a = got.assign.numpy()
    np.testing.assert_array_equal(a, np.asarray(want.assign))
    np.testing.assert_array_equal(got.cluster_sizes.numpy(), np.asarray(want.cluster_sizes))
    x = m.astype(np.float64)
    x = (x - x.mean(0, keepdims=True)) / (x.std() + 1e-6)
    cents = np.asarray(want.centroids, np.float64)
    for j, (rt, rj) in enumerate(zip(got.rep_idx.numpy(), np.asarray(want.rep_idx))):
        if rt != rj:
            assert a[rt] == j and a[rj] == j, (j, rt, rj)
            dt, dj = (((x[r] - cents[j]) ** 2).sum() for r in (rt, rj))
            assert dt == pytest.approx(dj, rel=1e-5, abs=1e-6), (j, rt, rj)


def test_dedup_multi_matches_reference_and_one_lane():
    """Seven satellites in three buckets: ragged n and k in one bucket,
    an explicit odd k, padded gathers with junk in the pad rows."""
    specs = [(40, None, 0), (100, None, 1), (27, 9, 2), (64, None, 3),
             (300, None, 4), (129, 77, 5), (5, None, 6)]
    parts_t, parts_j, raw = [], [], []
    rng = np.random.default_rng(9)
    for n, k, seed in specs:
        m = _moments(n, seed)
        k = k if k is not None else max(2, n // 2)
        m_pad = rng.random((dd.dedup_pad_size(n), 9)).astype(np.float32)
        m_pad[:n] = m
        parts_t.append((torch.from_numpy(m_pad), k, seed, n))
        parts_j.append((jnp.asarray(m_pad), k, jax.random.PRNGKey(seed), n))
        raw.append(m)
    assert len({dd._buckets_for(n, k) for _, k, _, n in parts_t}) == 3
    got = dd.dedup_multi(parts_t)
    want = jdd.dedup_multi(parts_j)
    for g, w, m, (m_pad, k, seed, n) in zip(got, want, raw, parts_t):
        _same_clustering(g, w, m)
        one = dd.dedup_from_moments(m_pad, k, seed, n=n)
        for f in one._fields:
            assert torch.equal(getattr(g, f), getattr(one, f)), f


# ---------------------------------------------------------------------------
# selection: the lane-stacked throttle and select_batch
# ---------------------------------------------------------------------------

def test_throttle_padded_batch_matches_reference_and_one_lane():
    rng = np.random.default_rng(7)
    lanes = [rng.random(n) for n in (17, 1, 0, 64, 33)]
    tile_bytes = [519168.0] * 5
    budgets = np.array([3 * 519168.0, 0.0, 1e18, 40 * 519168.0, 5e5])
    for policy in throttle.POLICIES:
        args = (lanes, tile_bytes, budgets, [0.10] * 5, [0.55] * 5, policy)
        got = throttle.throttle_padded_batch(*args, n_pad=64)
        want = jthrottle.throttle_padded_batch(*args, n_pad=64)
        for (sp, dn), (jsp, jdn), conf, budget in zip(got, want, lanes, budgets):
            np.testing.assert_array_equal(sp, jsp)
            np.testing.assert_array_equal(dn, jdn)
            osp, odn = throttle.throttle_padded(conf, 519168.0, np.float64(budget), 0.10,
                                                0.55, policy, n_pad=max(len(conf), 1))
            np.testing.assert_array_equal(sp, osp)
            np.testing.assert_array_equal(dn, odn)
    with pytest.raises(ValueError, match="n_pad"):
        throttle.throttle_padded_batch(lanes, tile_bytes, budgets, [0.1] * 5, [0.5] * 5,
                                       n_pad=8)
    assert throttle.throttle_padded_batch([], [], [], [], []) == []


def _contexts(mod, pcfg):
    """Four segments' selection state (one empty) for ``mod``'s
    PolicyContext, from one seed."""
    rng = np.random.default_rng(11)
    ctxs = []
    for n in (23, 0, 40, 9):
        rep_of = np.arange(n)
        if n:
            dup = rng.random(n) < 0.3
            rep_of[dup] = rng.integers(0, n, dup.sum())
            rep_of = rep_of[rep_of]           # reps point at reps
        ctxs.append(mod.PolicyContext(
            n=n, active=rng.random(n) > 0.2, rep_of=rep_of,
            conf=np.where(rng.random(n) > 0.2, rng.random(n), -1.0),
            counts_sp=np.floor(rng.random(n) * 5), processed=rng.random(n) > 0.25,
            tile_bytes=519168.0, pcfg=pcfg))
    return ctxs


@pytest.mark.parametrize("method", ["space_only", "ground_only", "tiansuan", "kodan",
                                    "targetfuse"])
def test_select_batch_matches_reference_and_scalar_select(method):
    budgets = np.array([4 * 519168.0, 2e6, 0.0, 1e7])
    pcfg, jpcfg = PipelineConfig(method=method), JConfig(method=method)
    pol, jpol = policies.get_policy(method), jpolicies.get_policy(method)
    ctxs, jctxs = _contexts(policies, pcfg), _contexts(jpolicies, jpcfg)
    batch = policies.PolicyContextBatch.stack(ctxs, [pol] * 4)
    for i, c in enumerate(ctxs):
        lane = batch.lane(i)
        for f in ("active", "rep_of", "conf", "counts_sp", "processed"):
            np.testing.assert_array_equal(getattr(lane, f), getattr(c, f))
    got = pol.select_batch(batch, budgets)
    want = jpol.select_batch(jpolicies.PolicyContextBatch.stack(jctxs, [jpol] * 4), budgets)
    np.testing.assert_array_equal(got.bytes_requested, want.bytes_requested)
    for g, w, c, b in zip(got.selections, want.selections, ctxs, budgets):
        one = pol.select(c, float(b))
        for s in (w, one):
            np.testing.assert_array_equal(g.accept_space, s.accept_space)
            np.testing.assert_array_equal(g.downlink, s.downlink)
            np.testing.assert_array_equal(g.ground_credit, s.ground_credit)
            assert g.bytes_requested == s.bytes_requested
    assert any(len(s.downlink) for s in got.selections) or method == "space_only"


# ---------------------------------------------------------------------------
# ledgers: the stacked fleet ledger
# ---------------------------------------------------------------------------

def test_fleet_ledger_matches_reference_and_scalar_ledgers():
    """The same grants and charges, vectorized and through the views:
    every float64 lane equal to the reference's FleetLedger and to a
    scalar EnergyLedger taking that lane's charges."""
    got, want = energy.FleetLedger(3, n_lanes=4), jenergy.FleetLedger(3, n_lanes=4)
    scalars = [energy.EnergyLedger(0.0) for _ in range(3)]
    hw = energy.RPI4
    for led in (got, want):
        led.grant(np.array([1.5e3, 7.0, 0.1, 0.0]))
        led.charge_capture(np.array([2, 3, 1, 0]))
        led.charge_compute(np.array([10, 0, 3, 0]), 0.37, hw)
        led.charge_aggregate(np.array([40, 9, 0, 0]))
        led.accrue_window_budgets([0, 2, 0], [1e6, 3e5, 2.5e5])
        led.charge_downlink_windows([0, 2, 0], [4e5, 1e5, 9e5], [4e5, 1e5, 2.5e5],
                                    [50.0, 30.0, 50.0])
        led.refund_downlink_windows([0], [2.5e5], [50.0])
        v = led.energy_view(1)
        v.charge_downlink(3e5, 35.0)
        v.refund_downlink(3e5, 35.0)
        led.bytes_view(2).requested += 5.0
    for i, s in enumerate(scalars):
        s.grant([1.5e3, 7.0, 0.1][i])
        s.charge_capture([2, 3, 1][i])
        s.charge_compute([10, 0, 3][i], 0.37, hw)
        s.charge_aggregate([40, 9, 0][i])
    for f in ("budget_j", "e_cap", "e_com", "e_agg", "e_down", "bytes_budget",
              "bytes_requested", "bytes_spent"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    for i, s in enumerate(scalars):
        for f in ("budget_j", "e_cap", "e_com", "e_agg"):
            assert getattr(got.energy_view(i), f) == getattr(s, f)
    np.testing.assert_array_equal(got.remaining, want.remaining)
    assert got.e_down[1] == 0.0 and got.e_down[3] == 0.0
    with pytest.raises(IndexError):
        got.energy_view(3)
    budgets = np.array([0.0, 1.0, 1e3, 1e300, 7.77])
    np.testing.assert_array_equal(energy.max_tiles_within_budget_vec(budgets, 0.37, hw),
                                  jenergy.max_tiles_within_budget_vec(budgets, 0.37, hw))
    assert energy.max_tiles_within_budget_vec(budgets, 0.37, hw)[2] == \
        energy.max_tiles_within_budget(1e3, 0.37, hw)
