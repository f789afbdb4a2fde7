"""Capture in the port against the reference, on the CPU: tiling, the
bilinear resize (down to the reduced counters' 64 px and up to the full
counters' 416 px) and ``prepare_frames`` (tiles, moments, ROI statistic,
ground truth) for one-resolution and mixed-resolution frame lists."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import tiling as jtiling
from repro.data.synthetic import SceneSpec, make_scene, revisit_frames
from repro_torch.core import engine, tiling

# one intra-op thread: the suite runs in parallel worker processes,
# and torch's default pool (one thread per core) in each of them would
# starve the timing-sensitive tests of other files
torch.set_num_threads(1)


@pytest.mark.parametrize("h,w", [(384, 384), (300, 200)])
def test_tile_image_matches_reference(h, w):
    img = np.random.default_rng(h).random((h, w, 3), dtype=np.float32)
    got = tiling.tile_image(torch.from_numpy(img), 128).numpy()
    np.testing.assert_array_equal(got, np.asarray(jtiling.tile_image(jnp.asarray(img), 128)))


def test_tile_image_frame_batch_is_frames_in_order():
    imgs = np.random.default_rng(0).random((3, 256, 256, 3), dtype=np.float32)
    got = tiling.tile_image(torch.from_numpy(imgs), 128).numpy()
    want = np.concatenate([np.asarray(jtiling.tile_image(jnp.asarray(im), 128))
                           for im in imgs])
    np.testing.assert_array_equal(got, want)


def test_resize_down_to_64_is_bit_equal():
    """Same weights, same contraction order (H then W): the reference's
    downsampling is reproduced exactly."""
    t = np.random.default_rng(0).random((8, 128, 128, 3), dtype=np.float32)
    got = tiling.resize_tiles(torch.from_numpy(t), 64).numpy()
    np.testing.assert_array_equal(got, np.asarray(jtiling.resize_tiles(jnp.asarray(t), 64)))


def test_resize_up_to_416():
    """Upsampling for the full-width counters: atol 2e-6. XLA's CPU matrix
    product for this shape is itself 1.4e-6 from the exact (float64)
    result; the port's is within 1.2e-7 of it."""
    t = np.random.default_rng(1).random((4, 128, 128, 3), dtype=np.float32)
    got = tiling.resize_tiles(torch.from_numpy(t), 416).numpy()
    assert got.shape == (4, 416, 416, 3)
    np.testing.assert_allclose(got, np.asarray(jtiling.resize_tiles(jnp.asarray(t), 416)),
                               atol=2e-6)


def _frames(seed, spec, n_rev):
    rng = np.random.default_rng(seed)
    img, b, c = make_scene(rng, spec)
    return revisit_frames(rng, img, b, c, n_rev)


SPEC = SceneSpec("golden", 384, (12, 18), (10, 24), cloud_fraction=0.2)
SMALL = SceneSpec("small", 256, (6, 10), (10, 24), cloud_fraction=0.2)


@pytest.mark.parametrize("case", ["one_resolution", "mixed_resolution"])
def test_prepare_frames_matches_reference(case):
    frames = _frames(42, SPEC, 5)
    if case == "mixed_resolution":
        small = _frames(3, SMALL, 2)
        frames = [frames[0], small[0], frames[1], small[1], frames[2]]
    want = jengine.prepare_frames(frames, 128, 64, 64)
    got = engine.prepare_frames(frames, 128, 64, 64, device="cpu")
    assert got.n == want.n
    assert got.tiles_sp.shape == want.tiles_sp.shape  # same power-of-two bucket
    np.testing.assert_array_equal(got.tiles_sp.numpy(), np.asarray(want.tiles_sp))
    np.testing.assert_array_equal(got.tiles_gd.numpy(), np.asarray(want.tiles_gd))
    np.testing.assert_array_equal(got.true, want.true)
    # moments: summation order, XLA's CPU sqrt (which differs from the
    # IEEE sqrt in the last bit for ~2% of values) and the cbrt formula;
    # measured within 1e-6
    np.testing.assert_allclose(got.moments.numpy(), np.asarray(want.moments), atol=1e-5)
    np.testing.assert_allclose(got.roi_std, np.asarray(want.roi_std), atol=1e-6)
    np.testing.assert_array_equal(got.roi_std > 0.02, np.asarray(want.roi_std) > 0.02)


@pytest.mark.parametrize("case", ["one_resolution", "mixed_resolution", "one_frame", "empty"])
def test_ground_tiles_are_the_real_rows_of_prepare_frames(case):
    """A fleet's recount makes a segment's ground tiles again from its
    frames: the real rows of ``prepare_frames``' ground tier, bit for bit
    (here at 96 px, the space tier at 64)."""
    frames = {"one_resolution": _frames(42, SPEC, 5), "one_frame": _frames(5, SPEC, 1),
              "empty": []}.get(case)
    if frames is None:
        big, small = _frames(42, SPEC, 3), _frames(3, SMALL, 2)
        frames = [big[0], small[0], big[1], small[1], big[2]]
    want = engine.prepare_frames(frames, 128, 64, 96, device="cpu")
    got = engine.ground_tiles(frames, 128, 96, device="cpu")
    assert got.shape == (want.n, 96, 96, 3)
    np.testing.assert_array_equal(got.numpy(), want.tiles_gd[:want.n].numpy())


@pytest.mark.parametrize("rows", ["scattered", "one_frame", "last_tile", "none"])
def test_recount_tiles_remake_only_the_frames_of_the_rows(rows):
    """Segments that hold no ground tiles get only the frames that hold
    their recounted rows made again, in one call over all of them, and
    their rows renumbered into it: ``tiles[idx]`` is ``prepare_frames``'
    ground tier at those rows, bit for bit (mixed resolutions, 9 and 4
    tiles a frame); a segment that holds its tiles gives them."""
    from types import SimpleNamespace

    from repro_torch.core.mission import Segment, recount_tiles
    big, small = _frames(42, SPEC, 3), _frames(3, SMALL, 2)
    frames = [big[0], small[0], big[1], small[1], big[2]]  # rows 0 9 13 22 26 (35)
    picked = {"scattered": [2, 10, 11, 30, 34], "one_frame": [22, 25, 23],
              "last_tile": [34], "none": []}[rows]
    made = {"scattered": 9 + 4 + 9, "one_frame": 4, "last_tile": 9, "none": 0}[rows]
    mission = SimpleNamespace(pcfg=SimpleNamespace(tile_size=128),
                              ground=(None, SimpleNamespace(input_size=96)), device="cpu")
    want = engine.prepare_frames(frames, 128, 64, 96, device="cpu")
    other = frames[::-1]  # a second segment, its frames in another order
    want_other = engine.prepare_frames(other, 128, 64, 96, device="cpu")
    segs = []
    for fr, ground in ((frames, False), (other, False), (frames, True)):
        seg = Segment(frames=fr)
        seg.hold(engine.prepare_frames(fr, 128, 64, 96, device="cpu"), ground=ground)
        assert seg.prep.tiles_sp is None and seg.prep.tiles_gd is None
        assert (seg.tiles_gd is None) != ground
        segs.append(seg)
    other_rows = [0, 8, 9]  # the reversed list's first two frames: 9 and 4 rows
    (t0, i0), (t1, i1), (t2, i2) = recount_tiles(
        [(mission, segs[0], np.asarray(picked, np.int64)), (mission, segs[1], other_rows),
         (mission, segs[2], picked)])
    assert t0 is t1 and t0.shape[0] == made + 9 + 4
    np.testing.assert_array_equal(t0[torch.as_tensor(i0, dtype=torch.long)].numpy(),
                                  want.tiles_gd[picked].numpy())
    np.testing.assert_array_equal(t1[torch.as_tensor(i1, dtype=torch.long)].numpy(),
                                  want_other.tiles_gd[other_rows].numpy())
    assert i2 is picked and t2.shape == want.tiles_gd.shape


def test_prepare_frames_without_stats_and_empty():
    frames = _frames(1, SMALL, 2)
    got = engine.prepare_frames(frames, 128, 64, 64, with_stats=False, device="cpu")
    want = jengine.prepare_frames(frames, 128, 64, 64, with_stats=False)
    assert got.moments is None and got.roi_std is None
    np.testing.assert_array_equal(got.tiles_sp.numpy(), np.asarray(want.tiles_sp))
    empty = engine.prepare_frames([], 128, 64, 64, device="cpu")
    assert empty.n == 0 and empty.tiles_sp.shape == (64, 64, 64, 3)
