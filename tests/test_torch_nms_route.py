"""The one-launch NMS (``nms_keep_f32``) emulated on the CPU, and the IoU
with NaN boxes.

``csrc/iou.cu``'s ``nms_keep_f32`` runs only on a card, where
``chip_smoke.py`` holds it against its plain version. Here a plain
emulation of its steps is held against the plain loop
(``ref.nms_keep``, through ``detector.nms_keep`` on the CPU) and against
``repro``'s ``nms_keep`` (jitted), keep masks equal:

- the gather of the top-k boxes;
- the keep words: lane l of word w is candidate 32 w + l, set where its
  score is above the threshold rounded to float32 (``__ballot_sync``);
- the overlap bitmask, computed only for rows that start kept and, in a
  row i, only from i's own word on: bit j is ``iou(i, j) > iou_thr`` and
  ``j > i``, the IoU by the kernel's device function (float32, min and
  max that carry NaN);
- the greedy scan: lane w holds keep word w; the words are walked in
  order, each kept candidate i found by ``__ffs``, then ``keep &=
  ~mask[i]`` on the lanes from i's word on, and the word's candidates
  still to visit cleared by i's own mask word;
- the scatter of the keep flags to the image's mask, zeroed first.

Cases: the main path's shape (64 images of 507 candidates, k = 128),
N < 128, k not a multiple of 32, k at the kernel's limit of 1024, no
score above the threshold, every box identical, zero-area and all-zero
boxes (a chunk's zero-padded rows), equal scores and values exactly at
both thresholds, and a NaN box, which suppresses nothing. The IoU
function itself is held bit-equal to the plain version and to
``repro``'s with NaN boxes, where ``fminf``/``fmaxf`` (the kernel's
earlier min and max) are not. Inputs are made from fixed seeds with
numpy.
"""
import re

import jax
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.iou import iou_matrix as pallas_iou
from repro.models import detector as jdet
from repro_torch.kernels import iou, ops, ref
from repro_torch.models import detector

# one intra-op thread, as in the other port tests run by parallel workers
torch.set_num_threads(1)

_jit_nms = jax.jit(jdet.nms_keep, static_argnums=(2, 3, 4))

MAX_K = 1024  # csrc/iou.cu's kMaxK
MASK32 = 0xFFFFFFFF


def test_emulation_uses_the_kernels_constants():
    text = iou.KERNEL.source.read_text()
    assert int(re.search(r"constexpr int kMaxK = (\d+);", text).group(1)) == MAX_K == iou.MAX_K
    # one keep word a lane of the scan warp, (k + 31) / 32 words a row
    assert "constexpr int kMaxWords = kMaxK / 32;" in text and MAX_K // 32 == 32
    assert "const int words = (k + 31) / 32;" in text


def test_library_has_both_entries():
    assert set(iou.KERNEL.symbols) == {"iou_matrix_f32", "nms_keep_f32"}
    text = iou.KERNEL.source.read_text()
    assert set(re.findall(r'extern "C" int (\w+)\(', text)) == set(iou.KERNEL.symbols)
    assert iou.KERNEL in ops.KERNELS and set(iou.KERNEL.symbol_launches) == set(iou.KERNEL.symbols)
    assert "fminf(" not in text and "fmaxf(" not in text


# ---------------------------------------------------------------------------
# the IoU device function, NaN included
# ---------------------------------------------------------------------------

def _box_iou(a, b, mn=np.minimum, mx=np.maximum):
    """The kernel's ``box_iou`` of every pair of rows of a (N, 4) and b
    (M, 4), float32 numpy: min and max as given (``np.minimum`` /
    ``np.maximum`` carry NaN as ``min.NaN.f32`` / ``max.NaN.f32`` do;
    ``np.fmin`` / ``np.fmax`` are ``fminf`` / ``fmaxf``)."""
    a, b = a[:, None, :], b[None, :, :]
    zero, eps = np.float32(0), np.float32(1e-9)

    def area(x):
        return mx(x[..., 2] - x[..., 0], zero) * mx(x[..., 3] - x[..., 1], zero)

    ix = mx(mn(a[..., 2], b[..., 2]) - mx(a[..., 0], b[..., 0]), zero)
    iy = mx(mn(a[..., 3], b[..., 3]) - mx(a[..., 1], b[..., 1]), zero)
    inter = ix * iy
    uni = (area(a) + area(b)) - inter
    with np.errstate(invalid="ignore", divide="ignore"):
        return inter / mx(uni, eps)


def _nan_boxes(seed):
    rng = np.random.default_rng(seed)
    b = _decode_like(rng, 1, 40)[0][0]
    b[3, 2] = np.nan                       # one coordinate
    b[17] = np.nan                         # a whole box
    b[25, 0] = np.inf                      # x1 = inf: inf - inf
    return np.concatenate([np.array([[0, 0, np.nan, 10], [0, 0, 10, 10]], np.float32), b])


def test_iou_with_nan_boxes_matches_reference():
    """The port's plain ``iou_matrix`` and the kernel's device function
    (emulated) equal ``repro``'s plain version and its Pallas kernel
    (interpret, within 1e-5) on NaN boxes, NaNs in the same places; an ``fminf`` /
    ``fmaxf`` IoU would not."""
    b = _nan_boxes(0)
    port = ref.iou_matrix(torch.from_numpy(b), torch.from_numpy(b)).numpy()
    want = np.asarray(jref.iou_matrix(b, b))
    np.testing.assert_array_equal(port, want)                 # NaN where NaN
    np.testing.assert_array_equal(_box_iou(b, b), want)
    # the Pallas kernel in interpret mode rounds a few IoUs one ulp off
    # (XLA's CPU code); 1e-5, the port's IoU tolerance in test_torch_kernels
    np.testing.assert_allclose(np.asarray(pallas_iou(b, b, interpret=True)), want, atol=1e-5,
                               rtol=0, equal_nan=True)
    assert np.isnan(want[:2, :2]).tolist() == [[True, True], [True, False]] and want[1, 1] == 1
    # the kernel's earlier fminf / fmaxf: [[0, 1e11], [1e11, 1]] (the
    # union 0, clamped at 1e-9), so the NaN box would have suppressed the
    # good one
    fmin = _box_iou(b[:2], b[:2], np.fmin, np.fmax)
    big = np.float32(100) / np.float32(1e-9)
    np.testing.assert_array_equal(fmin, np.array([[0, big], [big, 1]], np.float32))


def test_iou_device_function_is_the_plain_arithmetic():
    rng = np.random.default_rng(1)
    a = _decode_like(rng, 1, 300)[0][0]
    a[::7, 2] = a[::7, 0]                  # zero width
    a[::11] = 0.0                          # all-zero boxes
    a[::13, 3] = a[::13, 1] - 5            # negative height: area clamped at 0
    b = a[::-1].copy()
    want = ref.iou_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(_box_iou(a, b), want)


# ---------------------------------------------------------------------------
# the kernel's NMS, emulated
# ---------------------------------------------------------------------------

def _ballot(pred) -> int:
    return int(sum(int(bool(p)) << lane for lane, p in enumerate(pred)))


def _ffs(x: int) -> int:
    return (x & -x).bit_length()


def emulate_nms(boxes, top_i, top_s, iou_thr, score_thr):
    """``nms_keep_f32``'s steps, one image a CTA: boxes (B, N, 4), top_i
    and top_s (B, k) numpy -> keep (B, N) bool."""
    bsz, n = boxes.shape[:2]
    k = top_i.shape[-1]
    assert 0 <= k <= min(n, MAX_K)
    words = (k + 31) // 32
    thr_i, thr_s = np.float32(iou_thr), np.float32(score_thr)
    lanes = np.arange(32)
    out = np.zeros((bsz, n), bool)               # the row zeroed first
    for b in range(bsz):
        idx, s = top_i[b], top_s[b]
        box = boxes[b][idx]                          # the gather
        skeep = []
        for w in range(words):
            t = w * 32 + lanes
            skeep.append(_ballot((t < k) & (s[np.minimum(t, k - 1)] > thr_s)))
        mask = {}
        for i in range(k):
            if not (skeep[i >> 5] >> (i & 31)) & 1:
                continue
            for w in range(i >> 5, words):
                j = w * 32 + lanes
                jj = np.minimum(j, k - 1)
                over = (j > i) & (j < k) & (_box_iou(box[i:i + 1], box[jj])[0] > thr_i)
                mask[i, w] = _ballot(over)
        kw = list(skeep)                             # lane w holds word w
        for w in range(words):
            cur = kw[w]
            while cur:
                bit = _ffs(cur) - 1
                i = w * 32 + bit
                for lane in range(w, words):
                    kw[lane] &= ~mask[i, lane] & MASK32
                cur &= ~mask[i, w] & ~((2 << bit) - 1) & MASK32
        out[b, idx] = [(kw[t >> 5] >> (t & 31)) & 1 for t in range(k)]
    return out


def _decode_like(rng, b, n, size=416.0, max_wh=128.0):
    """(b, n, 4) xyxy boxes and (b, n) scores shaped like the counters'
    decode: centres across a 416 px tile, sides up to 4 cells."""
    c = rng.random((b, n, 2)) * size
    wh = rng.random((b, n, 2)) * max_wh
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    return boxes, (rng.random((b, n)) * 0.6).astype(np.float32)


def _case(name):
    """-> (boxes (B, N, 4), scores (B, N), iou_thresh, score_thresh,
    max_det); the Mission counts at 0.25 / 0.25 with max_det 128."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "main":
        return (*_decode_like(rng, 64, 507), 0.25, 0.25, 128)
    if name == "default_thresholds":
        return (*_decode_like(rng, 16, 507), 0.5, 0.3, 128)
    if name == "n_37":
        return (*_decode_like(rng, 8, 37), 0.25, 0.25, 128)
    if name == "k_100":
        return (*_decode_like(rng, 8, 507), 0.25, 0.25, 100)
    if name == "k_1024":
        return (*_decode_like(rng, 2, 1100, max_wh=48.0), 0.25, 0.1, 1024)
    if name == "none_above":
        b, s = _decode_like(rng, 8, 507)
        return b, s * np.float32(0.4), 0.25, 0.25, 128
    if name == "identical":
        b, s = _decode_like(rng, 4, 200)
        b[:] = b[:, :1]
        return b, s, 0.25, 0.25, 128
    if name == "zero_area":
        b, s = _decode_like(rng, 8, 150)
        b[:, ::3, 2] = b[:, ::3, 0]            # zero width
        b[:, 1::5] = 0.0                        # all-zero boxes, as padded tiles may give
        b[4:] = 0.0                             # whole images of them
        return b, s + np.float32(0.3), 0.25, 0.25, 128
    if name == "ties":
        b, s = _decode_like(rng, 8, 300)
        s = np.round(s * 4) / 4                 # four score values, many ties
        s[:, ::9] = 0.3                         # at the score threshold, in float32
        s = s.astype(np.float32)
        b[:, 0] = [0, 0, 10, 10]
        b[:, 1] = [0, 0, 10, 20]                # iou exactly 0.5 with box 0
        s[:, :2] = 0.9
        return b, s, 0.5, 0.3, 128
    if name == "nan_box":
        b, s = _decode_like(rng, 8, 507)
        b[:, 5] = [np.nan, 10, 200, 300]
        b[:, 6, 3] = np.nan
        s[:, 5:7] = 0.59                        # among the first candidates
        return b, s, 0.25, 0.25, 128
    raise KeyError(name)


CASES = ["main", "default_thresholds", "n_37", "k_100", "k_1024", "none_above", "identical",
         "zero_area", "ties", "nan_box"]


def _sorted_top(scores, k):
    top_s, top_i = torch.sort(torch.from_numpy(scores), dim=-1, descending=True, stable=True)
    return top_i[..., :k], top_s[..., :k]


@pytest.mark.parametrize("name", CASES)
def test_emulated_kernel_matches_plain_loop_and_reference(name):
    boxes, scores, thr_i, thr_s, max_det = _case(name)
    k = min(max_det, boxes.shape[1])
    top_i, top_s = _sorted_top(scores, k)
    plain = detector.nms_keep(torch.from_numpy(boxes), torch.from_numpy(scores), thr_i, thr_s,
                              max_det).numpy()
    assert np.array_equal(plain, ref.nms_keep(torch.from_numpy(boxes), top_i, top_s,
                                              thr_i, thr_s).numpy())
    got = emulate_nms(boxes, top_i.numpy(), top_s.numpy(), thr_i, thr_s)
    np.testing.assert_array_equal(got, plain)
    for b in range(boxes.shape[0]):
        np.testing.assert_array_equal(
            plain[b], np.asarray(_jit_nms(boxes[b], scores[b], thr_i, thr_s, max_det)))
    above = (scores > np.float32(thr_s)).sum(-1)
    kept = plain.sum(-1)
    assert (kept <= above).all()
    if name in ("main", "default_thresholds", "k_100", "k_1024"):
        assert (kept > 0).all() and (kept < np.minimum(above, k)).any()   # NMS suppressed
    elif name == "none_above":
        assert kept.sum() == 0
    elif name == "identical":
        assert (kept == 1).all()
    elif name == "ties":
        assert plain[:, 0].all() and plain[:, 1].all()   # iou 0.5 is not above 0.5
        assert not plain[:, ::9][scores[:, ::9] == np.float32(0.3)].any()


def test_nan_box_suppresses_nothing():
    """A NaN box is neither suppressed nor suppresses: the other boxes keep
    what they keep with the NaN box moved far from every box."""
    boxes, scores, thr_i, thr_s, max_det = _case("nan_box")
    far = boxes.copy()
    far[:, 5] = [1e6, 1e6, 1e6 + 10, 1e6 + 10]
    far[:, 6] = [2e6, 2e6, 2e6 + 10, 2e6 + 10]
    got = detector.nms_keep(torch.from_numpy(boxes), torch.from_numpy(scores), thr_i, thr_s,
                            max_det).numpy()
    want = detector.nms_keep(torch.from_numpy(far), torch.from_numpy(scores), thr_i, thr_s,
                             max_det).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:, 5].all() and got[:, 6].all()


def test_unbatched_boxes_take_the_same_route():
    boxes, scores, thr_i, thr_s, max_det = _case("n_37")
    got = detector.nms_keep(torch.from_numpy(boxes[3]), torch.from_numpy(scores[3]), thr_i,
                            thr_s, max_det).numpy()
    top_i, top_s = _sorted_top(scores[3:4], 37)
    np.testing.assert_array_equal(got, emulate_nms(boxes[3:4], top_i.numpy(), top_s.numpy(),
                                                   thr_i, thr_s)[0])
    np.testing.assert_array_equal(got, np.asarray(_jit_nms(boxes[3], scores[3], thr_i, thr_s,
                                                           max_det)))


def test_ops_nms_keep_sends_cpu_tensors_to_the_plain_loop():
    boxes, scores, thr_i, thr_s, _ = _case("n_37")
    top_i, top_s = _sorted_top(scores, 37)
    b = torch.from_numpy(boxes)
    before = (iou.KERNEL.launches, iou.KERNEL._lib)
    assert torch.equal(ops.nms_keep(b, top_i, top_s, thr_i, thr_s),
                       ref.nms_keep(b, top_i, top_s, thr_i, thr_s))
    assert (iou.KERNEL.launches, iou.KERNEL._lib) == before == (0, None)


def test_nms_wrapper_refuses_cpu_tensors():
    """The wrapper launches its kernel or raises: it never runs the loop."""
    boxes, scores, thr_i, thr_s, _ = _case("n_37")
    top_i, top_s = _sorted_top(scores, 37)
    with pytest.raises(ValueError, match="CUDA"):
        iou.nms_keep(torch.from_numpy(boxes), top_i, top_s, thr_i, thr_s)
    assert iou.KERNEL._lib is None
