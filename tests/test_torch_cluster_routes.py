"""The thread-block-cluster ``tile_moments`` and the warp-a-row
``kmeans_assign_f32``, emulated on the CPU.

Both kernels (``csrc/tile_moments.cu``, ``csrc/kmeans_assign.cu``) run
only on a card, where ``chip_smoke.py`` holds them against their plain
versions. Here a plain emulation of each kernel's split of the work and
of its order of merging is held against the plain version, so that the
index arithmetic (slabs, channels of a float4's lanes, partial float4s
at an unaligned tile's ends, lanes of a warp over the centroids) and the
merge are checked without a card:

- ``tile_moments``: the per-lane float64 shifted sums of each CTA of a
  cluster of 1, 2, 4 or 8 (whatever cluster size the kernel picks, it is
  one of these), the CTA's warp-shuffle or shared-memory reduction and
  the leader's merge in rank order, then the kernel's closing formulas
  with the plain version's roundings (sqrt of the float32 variance plus
  1e-12, the float64 cube root). Equal to ``ref.tile_moments`` bit for
  bit. The emulation rounds y*y before adding it where the kernel fuses
  the multiply-add in float64; the two differ in the last bits of a
  double, which no float32 output here shows.
- ``kmeans_assign``: each lane's first best (d2, index) over centroids
  lane, lane + 32, ..., then the warp's lexicographic minimum by xor
  butterfly. Equal to ``ref.kmeans_assign`` bit for bit, to the
  sequential first-index scan on hand-made distances (-0 against +0,
  negative values, +inf, NaN), and in its assignments to ``repro``'s
  Pallas kernel in interpret mode.

Also: the wrappers refuse CPU tensors, the libraries' entry sets are
unchanged, and the emulations' constants are the sources'. Inputs are
made from a seed with numpy.
"""
import re

import numpy as np
import pytest
import torch

from repro.kernels.kmeans_assign import kmeans_assign as pallas_kmeans
from repro_torch.kernels import kmeans_assign, ops, ref, tile_moments

# one intra-op thread, as in the other port tests run by parallel workers
torch.set_num_threads(1)

# csrc/tile_moments.cu's kThreads, kWarps and kBatch
THREADS, WARPS, BATCH = 256, 8, 4
INT_MAX = 2 ** 31 - 1


def _constants(source, names):
    text = source.read_text()
    return [int(re.search(rf"constexpr int {n} = (\d+);", text).group(1)) for n in names]


def test_emulations_use_the_kernels_constants():
    assert _constants(tile_moments.KERNEL.source, ["kThreads", "kBatch", "kMaxCluster"]) \
        == [THREADS, BATCH, 8]
    assert _constants(kmeans_assign.KERNEL.source, ["kAssignWarps"]) == [8]


# ---------------------------------------------------------------------------
# tile_moments: clusters of CTAs, each a slab of float4s
# ---------------------------------------------------------------------------

def _period(c):
    return c // 4 if c % 4 == 0 else c // 2 if c % 2 == 0 else c


def _butterfly(v, lanes=32):
    """Lane 0 of ``v += shfl_xor(v, off)`` for off 16 .. 1 over the
    lanes axis (axis 1 of (..., lanes, ...))."""
    for off in (16, 8, 4, 2, 1):
        v = v + v[:, torch.arange(lanes) ^ off]
    return v[:, 0]


def _cta_sums(f, hwc, c, h0, nq, rank, cs):
    """One CTA's (c, 3) float64 sums of y, y^2, y^3 by channel, in the
    kernel's order."""
    period = _period(c)
    act = THREADS // period * period
    q0, q1 = nq * rank // cs, nq * (rank + 1) // cs
    base = (h0 + 4 * (q0 % c)) % c
    t = torch.arange(THREADS)[:, None]
    j = torch.arange(4)[None, :]
    shift = f[(base + 4 * t + j) % c]
    sums = torch.zeros((3, THREADS, 4), dtype=torch.float64)

    def add(first, mask):  # lane j of thread t takes float first[t] + j
        i = first + j
        mask = mask & (i >= 0) & (i < hwc)
        y = f[i.clamp(0, hwc - 1)] - shift
        for m, term in enumerate((y, y * y, y * y * y)):
            sums[m] = torch.where(mask, sums[m] + term, sums[m])

    if rank == 0:  # the floats before the first 16-byte boundary
        add(torch.full_like(t, h0 - 4), t == act - 1)
    for it in range(max(0, -(-(q1 - q0) // act))):
        q = q0 + t + it * act
        add(h0 + 4 * q, (t < act) & (q < q1))
    if rank == cs - 1:  # the floats past the last whole float4
        add(torch.full_like(t, h0 + 4 * nq), t == (nq - q0) % act)

    ch = (base + 4 * t + j) % c  # (THREADS, 4)
    if c <= 4:
        r = torch.zeros((THREADS, 4, 3), dtype=torch.float64)
        for jj in range(4):  # fold the lanes into channel slots, lane by lane
            for s in range(4):
                hit = (ch[:, jj] == s)[:, None]
                r[:, s] = torch.where(hit, r[:, s] + sums[:, :, jj].T, r[:, s])
        warp = _butterfly(r.view(WARPS, 32, 4, 3))  # (WARPS, 4, 3)
        pad = torch.zeros((1, 32, 4, 3), dtype=torch.float64)
        pad[0, :WARPS] = warp
        return _butterfly(pad)[0, :c]
    classes = 4 * period
    lanes = sums.permute(1, 2, 0).reshape(THREADS * 4, 3)  # lane 4t + j
    cls = torch.zeros((classes, 3), dtype=torch.float64)
    for k in range(0, act * 4, classes):
        cls = cls + lanes[k:k + classes]
    part = torch.zeros((c, 3), dtype=torch.float64)
    for ch0 in range(c):
        for k in range((ch0 - base) % c, classes, c):
            part[ch0] = part[ch0] + cls[k]
    return part


def emulate_tile_moments(tiles: np.ndarray, cs: int, align: int = 0) -> torch.Tensor:
    """The kernel's arithmetic for clusters of ``cs`` CTAs, the tiles
    starting ``align`` floats past a 16-byte boundary -> (N, 3C) float32."""
    n, h, w, c = tiles.shape
    hwc = h * w * c
    flat = torch.from_numpy(tiles.reshape(n, hwc)).double()
    out = torch.empty((n, 3 * c), dtype=torch.float32)
    for b in range(n):
        f = flat[b]
        h0 = (4 - (align + b * hwc) % 4) % 4
        nq = (hwc - h0) // 4 if hwc > h0 else 0
        a = torch.zeros((c, 3), dtype=torch.float64)
        for rank in range(cs):  # the leader adds the CTAs' sums in rank order
            a = a + _cta_sums(f, hwc, c, h0, nq, rank, cs)
        my, e2, e3 = (a[:, m] / (h * w) for m in range(3))
        m2 = torch.clamp(e2 - my * my, min=0.0)
        m3 = e3 - 3.0 * my * e2 + 2.0 * my * my * my
        out[b, :c] = (f[:c] + my).float()
        out[b, c:2 * c] = torch.sqrt(m2.float() + 1e-12)
        out[b, 2 * c:] = (torch.sign(m3) * torch.abs(m3).pow(1.0 / 3.0)).float()
    return out


def _tiles(shape, data, seed):
    rng = np.random.default_rng(seed)
    n, h, w, c = shape
    if data == "constant":
        return np.broadcast_to(rng.random((n, 1, 1, c), dtype=np.float32), shape).copy()
    t = rng.random(shape, dtype=np.float32)
    return t + np.float32(1e3) if data == "offset" else t


TILE_CASES = [
    # the main path's tile (416 x 416 x 3) at a reduced N, every cluster size
    ((2, 416, 416, 3), "uniform", 1, 0), ((2, 416, 416, 3), "uniform", 2, 0),
    ((2, 416, 416, 3), "uniform", 4, 0), ((2, 416, 416, 3), "uniform", 8, 0),
    # C 1 and C 64 (the shared-memory route), and C 5
    ((3, 40, 40, 1), "uniform", 4, 0), ((3, 24, 24, 64), "uniform", 2, 0),
    ((3, 24, 24, 64), "uniform", 8, 0), ((4, 11, 13, 5), "uniform", 2, 1),
    # ragged H*W (tiles off the boundary by turns) and a misaligned start
    ((5, 33, 17, 3), "uniform", 2, 0), ((5, 33, 17, 3), "uniform", 8, 3),
    ((3, 30, 30, 3), "uniform", 4, 2),
    # fewer float4s than the cluster has CTAs, at every alignment (three
    # pixels: two have m3 = 0 exactly, whose cube root shows only the
    # last-bit noise of either formula, ~1e-6 for sums of ~1e-18)
    ((3, 1, 3, 3), "uniform", 8, 0), ((3, 1, 3, 3), "uniform", 8, 1),
    ((3, 1, 3, 3), "uniform", 8, 2), ((3, 1, 3, 3), "uniform", 8, 3),
    ((2, 1, 1, 3), "uniform", 4, 1), ((2, 3, 3, 64), "uniform", 8, 1),
    # constant tiles (m2 = m3 = 0) and the skew of data offset by 1e3
    ((2, 64, 64, 3), "constant", 4, 0), ((2, 128, 128, 3), "offset", 2, 0),
    ((2, 128, 128, 3), "offset", 8, 1),
]


@pytest.mark.parametrize("shape,data,cs,align", TILE_CASES)
def test_tile_moments_cluster_split_equals_plain_version(shape, data, cs, align):
    tiles = _tiles(shape, data, seed=sum(shape) + cs + align)
    got = emulate_tile_moments(tiles, cs, align)
    want = ref.tile_moments(torch.from_numpy(tiles))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), (got - want).abs().max()
    if data == "constant":
        c = shape[-1]
        assert torch.equal(got[:, 2 * c:], torch.zeros_like(got[:, 2 * c:]))


# ---------------------------------------------------------------------------
# kmeans_assign_f32: a warp a row, its lanes over the centroids
# ---------------------------------------------------------------------------

def warp_argmin(d2: torch.Tensor):
    """(N, K) float32 distances -> (index (N,) int32, d2 at it (N,)):
    lane l scans centroids l, l + 32, ... with a strict <, then the warp
    takes the least (d2, index) by xor butterfly."""
    n, k = d2.shape
    lane = torch.arange(32)
    best = torch.full((n, 32), float("inf"), dtype=torch.float32)
    idx = torch.full((n, 32), INT_MAX, dtype=torch.int64)
    for s in range(-(-k // 32)):
        i = lane + 32 * s
        v = d2[:, i.clamp(max=k - 1)]
        take = (i < k)[None, :] & (v < best)
        best, idx = torch.where(take, v, best), torch.where(take, i[None, :], idx)
    for off in (16, 8, 4, 2, 1):
        ov, oi = best[:, lane ^ off], idx[:, lane ^ off]
        take = (ov < best) | (~(best < ov) & (oi < idx))
        best, idx = torch.where(take, ov, best), torch.where(take, oi, idx)
    return torch.where(idx[:, 0] == INT_MAX, 0, idx[:, 0]).to(torch.int32), best[:, 0]


def emulate_kmeans_assign(x: torch.Tensor, c: torch.Tensor):
    """The kernel's distances (the reference's fma chains, then
    x2 - 2 dot + c2 rounded step by step) and its warp reduction."""
    x2 = ref._fma_dot(x, x)[:, None]
    c2 = ref._fma_dot(c, c)[None, :]
    dot = ref._fma_dot(x[:, None, :], c[None, :, :])
    a, best = warp_argmin((x2 - 2.0 * dot) + c2)
    return a, torch.clamp(best, min=0.0)


def sequential_scan(d2: np.ndarray):
    """The one-thread-a-row scan: best = +inf, replace on d2 < best."""
    out_i, out_v = [], []
    for row in d2:
        best, best_j = np.float32(np.inf), 0
        for j, v in enumerate(row):
            if v < best:
                best, best_j = v, j
        out_i.append(best_j)
        out_v.append(best)
    return np.array(out_i, np.int32), np.array(out_v, np.float32)


def _planted(n, k, d, seed):
    """As chip_smoke.kmeans_args: duplicate rows and centroids, an exact
    hit, and a -0 row against +0 and -0 centroids."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    c = rng.standard_normal((k, d)).astype(np.float32)
    if k > 1:
        c[k // 2] = c[0]
        c[-1] = x[3]
    if k > 8:
        c[1] = 0.0
        c[2] = -0.0
    x[5] = x[3]
    x[7] = -0.0
    return x, c


KMEANS_CASES = [(1024, 512, 9), (1000, 512, 9), (128, 64, 9), (1024, 33, 9), (300, 45, 9),
                (64, 1, 9), (100, 5, 9), (200, 32, 9), (120, 1000, 9), (500, 45, 16),
                (64, 100, 128)]


@pytest.mark.parametrize("n,k,d", KMEANS_CASES)
def test_kmeans_lane_split_equals_plain_version_and_pallas(n, k, d):
    x, c = _planted(n, k, d, seed=n + k + d)
    got = emulate_kmeans_assign(torch.from_numpy(x), torch.from_numpy(c))
    want = ref.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if k > 8:
        assert got[0][7] == 1  # the -0 row ties the +0 and -0 centroids: the first
    pa, pd = pallas_kmeans(x, c, interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(pa))
    # XLA's CPU dot rounds as the fma chains at D = 9 with K > 32, the
    # dedup's Lloyd shapes (bit-equal); at K <= 32, D 16 or D 128 it takes
    # another order (within the reference's own kernel tolerance)
    if d == 9 and k > 32:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(pd))
    else:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(pd), atol=1e-4, rtol=1e-4)


def _hand_made_d2(n, k, seed, nan=False):
    """Distances full of ties: values from a small set with both zeros,
    negatives (rounding leaves them) and +inf; NaN if asked."""
    rng = np.random.default_rng(seed)
    pool = np.array([0.0, -0.0, -1e-7, 1e-7, 0.5, -0.5, 2.0, np.inf], np.float32)
    if nan:
        pool = np.append(pool, np.float32(np.nan))
    d2 = pool[rng.integers(0, len(pool), (n, k))]
    d2[0] = -0.0                  # every centroid at -0 ...
    d2[1] = 0.0
    d2[1, 1::2] = -0.0            # ... and +0 / -0 alternating: index 0, value +0
    d2[2] = np.inf                # nothing below +inf: index 0
    d2[3, k // 2:] = -0.5         # the minimum only past the first half
    return d2


@pytest.mark.parametrize("k", [1, 2, 31, 32, 33, 64, 100, 512])
@pytest.mark.parametrize("nan", [False, True])
def test_warp_argmin_is_the_sequential_first_index_scan(k, nan):
    d2 = _hand_made_d2(64, k, seed=k + nan, nan=nan)
    idx, val = warp_argmin(torch.from_numpy(d2))
    want_i, want_v = sequential_scan(d2)
    np.testing.assert_array_equal(idx.numpy(), want_i)
    # the same value bits, the sign of a zero included
    np.testing.assert_array_equal(val.numpy().view(np.int32), want_v.view(np.int32))
    if not nan:  # and as torch.min, the plain version's argmin
        mn, a = torch.min(torch.from_numpy(d2), dim=-1)
        assert torch.equal(idx, a.to(torch.int32))
        np.testing.assert_array_equal(val.numpy().view(np.int32), mn.numpy().view(np.int32))


# ---------------------------------------------------------------------------
# wrappers and libraries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", [
    lambda: tile_moments.tile_moments(torch.zeros(2, 8, 8, 3)),
    lambda: kmeans_assign.kmeans_assign(torch.zeros(64, 9), torch.zeros(33, 9)),
])
def test_redesigned_wrappers_refuse_cpu_tensors(call):
    with pytest.raises(ValueError, match="CUDA"):
        call()
    assert tile_moments.KERNEL._lib is None and kmeans_assign.KERNEL._lib is None


def test_entry_sets_and_one_symbol_a_call_are_unchanged():
    assert set(tile_moments.KERNEL.symbols) == {"tile_moments_f32"}
    assert set(kmeans_assign.KERNEL.symbols) == {"kmeans_assign_f32", "kmeanspp_seed_f32",
                                                "kmeans_assign_lanes_f32",
                                                "kmeanspp_seed_lanes_f32"}
    for kernel in (tile_moments.KERNEL, kmeans_assign.KERNEL):
        text = kernel.source.read_text()
        assert set(re.findall(r'extern "C" int (\w+)\(', text)) == set(kernel.symbols)
        assert kernel in ops.KERNELS


def test_ops_sends_cpu_tensors_to_the_plain_versions():
    rng = np.random.default_rng(5)
    t = torch.from_numpy(rng.random((3, 20, 20, 3), dtype=np.float32))
    x = torch.from_numpy(rng.standard_normal((50, 9)).astype(np.float32))
    assert torch.equal(ops.tile_moments(t), ref.tile_moments(t))
    for got, want in zip(ops.kmeans_assign(x, x[:33]), ref.kmeans_assign(x, x[:33])):
        assert torch.equal(got, want)
    assert tile_moments.KERNEL.launches == 0 and kmeans_assign.KERNEL.launches == 0
