"""The port's counters against the reference, on the CPU: the weight
bridge, the forward pass, decode, NMS, counting (plain and batched with
a gather) and reading the reference's checkpoints. Weights are the
reference's seeded ``init`` at the reduced config, with the head's
objectness and one class bias raised so that NMS has boxes to keep and
to suppress."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.core import cascade as jcascade
from repro.models import detector as jdet
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import get_config, reduced
from repro_torch.core import cascade
from repro_torch.models import detector, layers

# one intra-op thread: the suite runs in parallel worker processes,
# and torch's default pool (one thread per core) in each of them would
# starve the timing-sensitive tests of other files
torch.set_num_threads(1)

ARCHS = ("targetfuse-space", "targetfuse-ground")


_jit_init = jax.jit(jdet.init, static_argnums=1)
_jit_nms = jax.jit(jdet.nms_keep, static_argnums=(2, 3, 4))
_jit_count = jax.jit(jdet.count_and_confidence, static_argnums=(1, 2, 3))


@functools.lru_cache(maxsize=None)
def _jax_params_cached(arch, seed):
    cfg = jreduced(jget(arch))
    p = jax.tree_util.tree_map(np.array, _jit_init(jax.random.PRNGKey(seed), cfg))
    hb = p["head_b"].copy().reshape(cfg.n_anchors, -1)
    hb[:, 4] = 2.0   # objectness
    hb[:, 5] = 3.0   # class 0
    p["head_b"] = hb.reshape(-1)
    return p, cfg


def _jax_params(arch, seed):
    p, cfg = _jax_params_cached(arch, seed)
    return jax.tree_util.tree_map(np.copy, p), cfg


def _tiles(n, size=64, seed=0):
    return np.random.default_rng(seed).random((n, size, size, 3), dtype=np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_copies(arch):
    assert reduced(get_config(arch)).__dict__ == jreduced(jget(arch)).__dict__
    assert get_config(arch).__dict__ == jget(arch).__dict__


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_keeps_tree_and_values(arch):
    p, _ = _jax_params(arch, 0)
    t = detector.params_from_jax(p)
    leaves_j, tree_j = jax.tree_util.tree_flatten(p)
    leaves_t, tree_t = jax.tree_util.tree_flatten(
        jax.tree_util.tree_map(lambda v: v.numpy(), t,
                               is_leaf=lambda v: isinstance(v, torch.Tensor)))
    assert tree_j == tree_t
    for a, b in zip(leaves_j, leaves_t):
        np.testing.assert_array_equal(a, b)


def test_port_init_shapes_match_reference():
    cfg = reduced(get_config("targetfuse-ground"))
    p = detector.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    jcfg = jreduced(jget("targetfuse-ground"))
    jp = jax.eval_shape(lambda key: jdet.init(key, jcfg), jax.random.PRNGKey(0))
    shapes = jax.tree_util.tree_map(lambda v: tuple(v.shape), jp)
    assert jax.tree_util.tree_map(
        lambda v: tuple(v.shape), p,
        is_leaf=lambda v: isinstance(v, torch.Tensor)) == shapes


@pytest.mark.parametrize("size,stride", [(64, 2), (64, 1), (13, 2), (7, 2)])
def test_conv2d_same_padding_matches_reference(size, stride):
    """JAX's SAME at stride 2 on an even size pads (0, 1); atol 1e-5 for
    the conv libraries' summation order (measured ~1e-7)."""
    from repro.models import layers as jlayers
    rng = np.random.default_rng(size)
    x = rng.random((2, size, size, 5), dtype=np.float32)
    w = rng.standard_normal((3, 3, 5, 4)).astype(np.float32)
    got = layers.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride).numpy()
    np.testing.assert_allclose(got, np.asarray(jlayers.conv2d(x, w, stride)), atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    """atol 1e-5: convolution summation order (oneDNN vs XLA), measured
    2.4e-7 on the raw head."""
    p, cfg = _jax_params(arch, 1)
    x = _tiles(6)
    got = detector.forward(detector.params_from_jax(p), reduced(get_config(arch)),
                           torch.from_numpy(x)).numpy()
    want = np.asarray(jdet.forward(p, cfg, x))
    assert got.shape == want.shape == (6, 16, 16, 3, 13)
    np.testing.assert_allclose(got, want, atol=1e-5)


def _raw(arch, n=8, seed=2):
    p, cfg = _jax_params(arch, seed)
    return np.array(jdet.forward(p, cfg, _tiles(n, seed=seed))), cfg


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_nms_and_count_match_reference(arch):
    raw, cfg = _raw(arch)
    tcfg = reduced(get_config(arch))
    jb, js = map(np.array, jdet.decode(raw, cfg))
    tb, ts = detector.decode(torch.from_numpy(raw), tcfg)
    np.testing.assert_allclose(tb.numpy(), jb, atol=1e-5)   # px, up to 64
    np.testing.assert_allclose(ts.numpy(), js, atol=1e-6)
    # NMS on identical inputs: keep masks equal, one image at a time in
    # the reference, the whole batch at once in the port
    keep = detector.nms_keep(torch.from_numpy(jb), torch.from_numpy(js), 0.25, 0.25).numpy()
    for i in range(raw.shape[0]):
        np.testing.assert_array_equal(keep[i], np.asarray(_jit_nms(jb[i], js[i], 0.25, 0.25, 128)))
    assert keep.sum() > 0 and (keep.sum(-1) < (js > 0.25).sum(-1)).any()  # NMS suppressed
    jc, jf = map(np.asarray, _jit_count(raw, cfg, 0.25, 0.25))
    tc, tf = detector.count_and_confidence(torch.from_numpy(raw), tcfg, 0.25, 0.25)
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_allclose(tf.numpy(), jf, atol=1e-6)


def test_nms_top_k_breaks_ties_to_the_lower_index():
    """Equal scores: lax.top_k keeps the lower index first; so must the port."""
    boxes = np.array([[0, 0, 10, 10]] * 4 + [[50, 50, 60, 60]] * 2, np.float32)
    scores = np.array([0.9, 0.9, 0.9, 0.2, 0.9, 0.9], np.float32)
    got = detector.nms_keep(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5, 0.3,
                            max_det=4).numpy()
    want = np.asarray(_jit_nms(boxes, scores, 0.5, 0.3, 4))
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [True, False, False, False, True, False]


@pytest.mark.parametrize("arch", ARCHS)
def test_count_tiles_batched_with_gather_matches_reference(arch):
    p, cfg = _jax_params(arch, 3)
    tiles = _tiles(80, seed=4)
    idx = np.array([3, 70, 5, 5, 41, 0, 79, 12, 66, 20], np.int64)
    jc, jf = jcascade.count_tiles_batched(p, cfg, tiles, idx=idx, score_thresh=0.25)
    tc, tf = cascade.count_tiles_batched(detector.params_from_jax(p), reduced(get_config(arch)),
                                         torch.from_numpy(tiles), idx=idx, score_thresh=0.25)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(tf, jf, atol=1e-6)
    assert cascade._tier_batch(10, 64) == 16 and cascade._tier_batch(100, 64) == 64
    empty = cascade.count_tiles_batched(detector.params_from_jax(p), reduced(get_config(arch)),
                                        torch.from_numpy(tiles), idx=np.zeros(0, np.int64))
    assert empty[0].shape == (0,)


def test_load_jax_checkpoint(tmp_path):
    """The port's ``ckpt.restore`` reads the reference's checkpoints into
    its own parameter tree."""
    p, cfg = _jax_params("targetfuse-ground", 5)
    ckpt.save(str(tmp_path), 7, p)
    ckpt.save(str(tmp_path), 9, jax.tree_util.tree_map(lambda v: v + 1.0, p))
    template = detector.init(torch.Generator().manual_seed(0), reduced(get_config("targetfuse-ground")),
                             device="cpu")
    step, got = tckpt.restore(str(tmp_path), template)          # newest step
    assert step == 9
    np.testing.assert_array_equal(got["stages"][1][1]["w"].numpy(), p["stages"][1][1]["w"] + 1.0)
    _, got7 = tckpt.restore(str(tmp_path), template, step=7)
    want = detector.params_from_jax(p)
    assert len(got7["stages"]) == len(want["stages"]) == 2
    for key in ("stem", "head_w", "head_b"):
        assert torch.equal(got7[key], want[key])
    for sj, st in zip(want["stages"], got7["stages"]):
        for bj, bt in zip(sj, st):
            assert torch.equal(bj["w"], bt["w"]) and torch.equal(bj["b"], bt["b"])
    with pytest.raises(FileNotFoundError):
        tckpt.restore(str(tmp_path / "missing"), template)
