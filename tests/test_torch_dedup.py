"""The port's dedup against the reference's, on the CPU: the same raw
moments through ``dedup_from_moments`` on both sides, for workloads of 5
to 300 tiles, the default k and odd explicit k.

Assignments and cluster sizes must be equal. Representatives must be
equal except where the reference's choice is a tie: a cluster whose two
members sit at the same distance from its centroid in exact arithmetic
(every two-member cluster does, since its centroid is their mean) is
decided by the last bit of float32 rounding. That bit is not
reproducible across the two frameworks: XLA's CPU sqrt differs from the
IEEE sqrt in the last bit for ~2% of inputs, and the normalization
divides by such a sqrt. So where the two pick different tiles, both
must be members of the cluster at distances from its centroid that
agree within float32 rounding of unit-scale features (atol 1e-6, rtol
1e-5); distinct jittered tiles differ by 1e-4 or more.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.dedup as jdd
import repro_torch.core.dedup as dd

# one intra-op thread: the suite runs in parallel worker processes,
# and torch's default pool (one thread per core) in each of them would
# starve the timing-sensitive tests of other files
torch.set_num_threads(1)


def _moments(n, seed):
    """Revisit-like moments: groups of jittered near-duplicates around a
    few bases, plus some exact duplicate rows."""
    rng = np.random.default_rng(seed)
    bases = rng.random((max(2, n // 4), 9)).astype(np.float32)
    m = bases[rng.integers(0, len(bases), n)]
    m = (m + 0.01 * rng.standard_normal((n, 9))).astype(np.float32)
    if n > 8:
        m[n // 2] = m[1]
    return m


def _normalized(m):
    mu = m.mean(0, keepdims=True)
    return (m - mu) / (m.std() + 1e-6)


def assert_same_clustering(got, want, m):
    """Equal assignments and sizes; representatives equal up to ties."""
    a = got.assign.numpy()
    np.testing.assert_array_equal(a, np.asarray(want.assign))
    np.testing.assert_array_equal(got.cluster_sizes.numpy(), np.asarray(want.cluster_sizes))
    x = _normalized(m.astype(np.float64))
    cents = np.asarray(want.centroids, np.float64)
    ties = 0
    for j, (rt, rj) in enumerate(zip(got.rep_idx.numpy(), np.asarray(want.rep_idx))):
        if rt == rj:
            continue
        assert a[rt] == j and a[rj] == j, (j, rt, rj)
        dt, dj = (((x[r] - cents[j]) ** 2).sum() for r in (rt, rj))
        assert dt == pytest.approx(dj, rel=1e-5, abs=1e-6), (j, rt, rj, dt, dj)
        ties += 1
    np.testing.assert_array_equal(got.rep_mask.numpy().nonzero()[0],
                                  np.unique(got.rep_idx.numpy()[got.cluster_sizes.numpy() > 0]))
    return ties


CASES = [(n, None) for n in (5, 6, 7, 12, 27, 64, 65, 100, 128, 129, 200, 255, 300)]
CASES += [(100, 7), (100, 77), (30, 3), (300, 151), (9, 9)]


@pytest.mark.parametrize("n,k", CASES)
def test_dedup_from_moments_matches_reference(n, k):
    m = _moments(n, seed=n + (k or 0))
    k = k if k is not None else max(2, n // 2)
    want = jdd.dedup_from_moments(jnp.asarray(m), k, jax.random.PRNGKey(0))
    got = dd.dedup_from_moments(torch.from_numpy(m), k, 0)
    assert_same_clustering(got, want, m)
    assert got.assign.dtype == torch.int32 and got.rep_idx.dtype == torch.int32


@pytest.mark.parametrize("seed", [0, 3])
def test_dedup_from_a_padded_gather_matches_reference(seed):
    """The Mission passes moments already gathered into the n_pad bucket,
    with junk in the pad rows, and the real count ``n``."""
    n = 40
    m = _moments(n, seed)
    m_pad = np.random.default_rng(99).random((dd.dedup_pad_size(n), 9)).astype(np.float32)
    m_pad[:n] = m
    want = jdd.dedup_from_moments(jnp.asarray(m_pad), n // 2, jax.random.PRNGKey(seed), n=n)
    got = dd.dedup_from_moments(torch.from_numpy(m_pad), n // 2, seed, n=n)
    assert_same_clustering(got, want, m)


def test_buckets_and_expanded_counts():
    for n, k in [(5, 2), (100, 50), (100, 77), (300, 150), (1000, 500)]:
        assert dd._buckets_for(n, k) == jdd._buckets_for(n, k)
        assert dd.dedup_pad_size(n) == jdd.dedup_pad_size(n)
    m = _moments(20, 1)
    res = dd.dedup_from_moments(torch.from_numpy(m), 10, 0)
    rep_counts = torch.arange(20, dtype=torch.float32) * 2   # per tile
    want = rep_counts.numpy()[res.rep_idx.numpy()][res.assign.numpy()]
    np.testing.assert_array_equal(dd.expanded_counts(rep_counts, res).numpy(), want)
