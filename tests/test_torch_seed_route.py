"""The dedup's k-means++ seeding and ``int8_matmul``'s routes, on the CPU.

The seeding kernel (``kmeanspp_seed_f32`` in ``csrc/kmeans_assign.cu``)
and the s8 tensor-core kernel (``int8_matmul_s8_sm90`` in
``csrc/int8_matmul.cu``) run only on a card; ``chip_smoke.py`` holds
them against their plain versions there, bit for bit. Here:

- ``ref.kmeanspp_seed`` against the reference's seeding, the scan of
  greedy farthest-point picks in ``repro.core.dedup._dedup_padded_core``
  with ``iters=0``, on the same raw moments. The centroids agree within
  1e-6, not exactly: they are rows of the normalized features, and torch
  and XLA normalize in another order (XLA's CPU sqrt also differs from
  the IEEE one in the last bit, see ``tests/test_torch_dedup.py``). A
  pick may differ only where it is a tie in exact arithmetic, decided by
  the last float32 bit as the dedup's representatives are (ROADMAP queue
  3): with (9, 9), once the eight distinct rows are picked every d2 is 0
  and the reference's rounding leaves one row a residual. There both
  picks must reach the exact maximum; the picks after it are not
  compared.
- the tie rule (the first index, as ``jnp.argmax``) on features whose
  arithmetic is exact, against a plain numpy loop;
- the dedup's calls: one seeding call a dedup, then the Lloyd steps and
  the final assignment, no call a pick;
- the int8 route rule on the shapes ``chip_smoke.py`` phase 2 uses, and
  the wrappers' refusal of CPU tensors and of a forced route a shape
  cannot take.
Inputs are made from a seed with numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.dedup as jdd
import repro_torch.core.dedup as dd
from repro_torch import random as jrandom
from repro_torch.kernels import int8_matmul, kmeans_assign, ops, ref

# one intra-op thread, as in the other port tests run by parallel workers
torch.set_num_threads(1)


def _moments(n, seed):
    """Revisit-like moments, as tests/test_torch_dedup.py makes them."""
    rng = np.random.default_rng(seed)
    bases = rng.random((max(2, n // 4), 9)).astype(np.float32)
    m = bases[rng.integers(0, len(bases), n)]
    m = (m + 0.01 * rng.standard_normal((n, 9))).astype(np.float32)
    if n > 8:
        m[n // 2] = m[1]
    return m


def _seed_both(m_pad, n, k, seed):
    """-> (the reference's seeded centroids, the port's x, centroids and
    picks) for padded raw moments."""
    n_pad, k_pad = dd._buckets_for(n, k)
    assert m_pad.shape[0] == n_pad
    _, want = jdd._dedup_padded_core(jnp.asarray(m_pad), jnp.int32(n), jnp.int32(k),
                                     jax.random.PRNGKey(seed), k_pad=k_pad, iters=0)
    x, cents = dd._dedup_core(torch.from_numpy(m_pad), n, k, seed, k_pad=k_pad, iters=0)
    got, picks = ref.kmeanspp_seed(x, n, jrandom.randint(seed, n), k, k_pad)
    assert torch.equal(got, cents)  # the dedup seeds through the same function
    return np.asarray(want), x, got, picks


SEED_CASES = [(n, max(2, n // 2)) for n in (5, 7, 27, 64, 65, 100, 129, 300)]
SEED_CASES += [(100, 7), (100, 77), (300, 151), (9, 9)]


def assert_same_seeding(got, want, x, picks, n, k):
    """Centroids within 1e-6 up to the first pick that is an exact tie;
    -> the number of rows compared."""
    off = np.abs(got.numpy() - want).max(1) > 1e-6
    i = int(np.argmax(off)) if off.any() else len(off)
    np.testing.assert_allclose(got.numpy()[:i], want[:i], rtol=0, atol=1e-6)
    if i < min(k, len(off)):
        x64 = x[:n].double().numpy()
        d2 = np.min([((x64 - x64[picks[j]]) ** 2).sum(1) for j in range(i)], 0)
        theirs = int(np.argmin(((x64 - want[i]) ** 2).sum(1)))
        for row in (int(picks[i]), theirs):
            assert d2[row] == pytest.approx(d2.max(), abs=1e-6), (i, row, d2[row], d2.max())
    return i


@pytest.mark.parametrize("n,k", SEED_CASES)
def test_kmeanspp_seed_matches_reference(n, k):
    m = _moments(n, seed=n + k)
    m_pad = np.zeros((dd.dedup_pad_size(n), 9), np.float32)
    m_pad[:n] = m
    want, x, got, picks = _seed_both(m_pad, n, k, seed=0)
    compared = assert_same_seeding(got, want, x, picks, n, k)
    assert compared >= k - 1  # at most the last pick is a tie in these cases
    k_pad = got.shape[0]
    p = picks.numpy()
    assert (p[:k] >= 0).all() and (p[:k] < n).all() and (p[k:] == -1).all()
    assert torch.equal(got[:k], x[picks[:k].long()])
    assert (got[k:] == ref.FAR).all() and k <= k_pad


@pytest.mark.parametrize("seed", [0, 3])
def test_kmeanspp_seed_from_a_padded_gather_matches_reference(seed):
    """Junk in the pad rows, as the Mission's gather leaves them: the
    normalization zeroes them and no pick lands there."""
    n = 40
    m_pad = np.random.default_rng(99).random((dd.dedup_pad_size(n), 9)).astype(np.float32)
    m_pad[:n] = _moments(n, seed)
    want, x, got, picks = _seed_both(m_pad, n, n // 2, seed)
    assert assert_same_seeding(got, want, x, picks, n, n // 2) == len(want)
    assert (picks.numpy()[:n // 2] < n).all() and not x[n:].any()


def _numpy_seed(x, n, first, k):
    """The greedy picks in float64 numpy, ties to the first index."""
    d2 = np.full(len(x), np.inf)
    picks, nxt = [first], first
    for _ in range(1, k):
        d2 = np.minimum(d2, ((x - x[nxt]) ** 2).sum(1))
        nxt = int(np.argmax(np.where(np.arange(len(x)) < n, d2, -np.inf)))
        picks.append(nxt)
    return picks


@pytest.mark.parametrize("distinct,n,k", [(6, 60, 16), (20, 120, 32), (64, 64, 64)])
def test_kmeanspp_seed_breaks_ties_to_the_first_index(distinct, n, k):
    """Small integer features: every distance is exact in float32, so the
    picks must equal a float64 loop's, ties (duplicate rows, and all d2 0
    once every distinct row is picked) included."""
    rng = np.random.default_rng(distinct)
    rows = rng.integers(-4, 5, (distinct, 9)).astype(np.float32)
    x = np.zeros((128, 9), np.float32)
    x[:n] = rows[rng.integers(0, distinct, n)]
    first = int(rng.integers(0, n))
    cents, picks = ref.kmeanspp_seed(torch.from_numpy(x), n, first, k, 64)
    assert picks.tolist()[:k] == _numpy_seed(x.astype(np.float64), n, first, k)
    assert (picks[k:] == -1).all() and (cents[k:] == ref.FAR).all()
    if k > distinct:
        assert picks.tolist()[distinct:k] == [0] * (k - distinct)


def test_kmeanspp_seed_edges():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((8, 3)).astype(np.float32))
    cents, picks = ref.kmeanspp_seed(x, 8, 5, 1, 4)
    assert picks.tolist() == [5, -1, -1, -1] and torch.equal(cents[0], x[5])
    cents, picks = ref.kmeanspp_seed(x, 8, 5, 0, 2)
    assert picks.tolist() == [-1, -1] and (cents == ref.FAR).all()
    assert ref.kmeanspp_seed(x, 8, 5, 3, 0)[0].shape == (0, 3)


def test_dedup_seeds_in_one_call(monkeypatch):
    """One seeding call a dedup, then ``iters`` Lloyd steps and the final
    assignment: on the card, one launch of each."""
    calls = {"kmeanspp_seed": 0, "kmeans_assign": 0}

    def counted(name):
        fn = getattr(ops, name)

        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call
    for name in calls:
        monkeypatch.setattr(ops, name, counted(name))
    res = dd.dedup_from_moments(torch.from_numpy(_moments(100, 1)), 50, 0, iters=7)
    assert calls == {"kmeanspp_seed": 1, "kmeans_assign": 8}
    assert res.centroids.shape == (50, 9)


# ---------------------------------------------------------------------------
# int8_matmul's routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,route", [
    ((4096, 4096, 12288), "tensor_core"), ((256, 512, 256), "tensor_core"),
    ((128, 128, 128), "tensor_core"), ((256, 512, 384), "tensor_core"),
    ((100, 208, 144), "tensor_core"), ((3, 4096, 16), "tensor_core"),
    ((1, 16, 16), "tensor_core"),
    ((100, 200, 150), "cuda_core"), ((1, 64, 1), "cuda_core"), ((3, 4096, 2), "cuda_core"),
    ((16, 8, 16), "cuda_core"), ((16, 0, 16), "cuda_core"), ((16, 16, 8), "cuda_core"),
])
def test_int8_choose_route(shape, route):
    assert int8_matmul.choose_route(*shape) == route
    assert int8_matmul.SYMBOLS[route] in int8_matmul.KERNEL.symbols


def test_int8_routes_are_entries_of_one_library():
    assert int8_matmul.SYMBOLS == {"tensor_core": "int8_matmul_s8_sm90",
                                   "cuda_core": "int8_matmul_s8"}
    assert set(int8_matmul.KERNEL.symbols) == set(int8_matmul.SYMBOLS.values())
    assert int8_matmul.KERNEL.source.name == "int8_matmul.cu"


def test_kmeans_library_has_both_entries():
    assert set(kmeans_assign.KERNEL.symbols) == {"kmeans_assign_f32", "kmeanspp_seed_f32",
                                                "kmeans_assign_lanes_f32",
                                                "kmeanspp_seed_lanes_f32"}
    assert kmeans_assign.KERNEL.source.name == "kmeans_assign.cu"
    assert len(ops.KERNELS) == 7 and kmeans_assign.KERNEL in ops.KERNELS
    assert int8_matmul.KERNEL in ops.KERNELS
    for k in ops.KERNELS:
        assert set(k.symbol_launches) == set(k.symbols)


def _int8(m, k, n):
    rng = np.random.default_rng(0)
    return (torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8)),
            torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8)),
            torch.ones(m), torch.ones(n))


@pytest.mark.parametrize("call", [
    lambda: kmeans_assign.kmeanspp_seed(torch.zeros(128, 9), 100, 3, 10, 64),
    lambda: int8_matmul.int8_matmul(*_int8(4, 32, 16), route="tensor_core"),
    lambda: int8_matmul.int8_matmul(*_int8(4, 30, 16), route="cuda_core"),
])
def test_new_wrappers_refuse_cpu_tensors(call):
    """A wrapper launches its kernel or raises: it never computes on the CPU."""
    with pytest.raises(ValueError, match="CUDA"):
        call()
    assert kmeans_assign.KERNEL._lib is None and int8_matmul.KERNEL._lib is None


def test_ops_seeds_cpu_tensors_with_the_plain_version():
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((128, 9)).astype(np.float32))
    got = ops.kmeanspp_seed(x, 100, 7, 30, 64)
    want = ref.kmeanspp_seed(x, 100, 7, 30, 64)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kmeans_assign.KERNEL.launches == 0 and kmeans_assign.KERNEL._lib is None
