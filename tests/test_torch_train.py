"""Counter training of the port against the reference, on the CPU, at
the reduced configs: targets, the loss and its gradients at bridged
weights, the learning-rate schedule, one AdamW update, a few
``fit_counter`` steps, checkpoints read across the two packages,
``get_counters``' cache, and the cascade's premise with counters the
port trained itself. Inputs come from numpy seeds; each test states its
tolerance.

End-to-end training does not match the reference's: the two packages
draw initial weights from different generators. From the same (bridged)
weights, a step and a few steps do.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.core import cascade as jcascade
from repro.data import synthetic as jsyn
from repro.models import detector as jdet
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro_torch import tree as T
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config, reduced
from repro_torch.core import cascade, tiling
from repro_torch.data import synthetic as syn
from repro_torch.data.synthetic import SceneSpec, make_scene, tile_counts
from repro_torch.launch import serve
from repro_torch.models import detector
from repro_torch.optim import adamw, schedule

# one intra-op thread: the suite runs in parallel worker processes,
# and torch's default pool (one thread per core) in each of them would
# starve the timing-sensitive tests of other files
torch.set_num_threads(1)

ARCHS = ("targetfuse-space", "targetfuse-ground")
MINI = SceneSpec("mini", 512, (20, 30), (10, 24), cloud_fraction=0.2)

_jit_value_and_grad = jax.jit(jax.value_and_grad(jdet.loss_fn, has_aux=True),
                              static_argnums=1)


def _scenes(n, seed=0, spec=MINI):
    rng = np.random.default_rng(seed)
    return [make_scene(rng, spec) for _ in range(n)]


def _bridged(arch, seed=0):
    """The reference's seeded init at the reduced config, as numpy and as
    the port's tensors -> (jax params, port params, jax cfg, port cfg)."""
    jcfg, tcfg = jreduced(jget(arch)), reduced(get_config(arch))
    jp = jax.tree_util.tree_map(np.asarray, jdet.init(jax.random.PRNGKey(seed), jcfg))
    return jp, detector.params_from_jax(jp), jcfg, tcfg


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in flat]


def _max_rel_to_leaf_max(jtree, ttree):
    """max over leaves of max|a - b| / max|a|."""
    return max(float(np.abs(np.asarray(a) - b.numpy()).max() / np.abs(np.asarray(a)).max())
               for a, b in zip(jax.tree_util.tree_leaves(jtree), T.leaves(ttree), strict=True))


def _max_abs(jtree, ttree):
    return max(float(np.abs(np.asarray(a) - b.numpy()).max())
               for a, b in zip(jax.tree_util.tree_leaves(jtree), T.leaves(ttree), strict=True))


# ---------------------------------------------------------------------------
# targets and the pool
# ---------------------------------------------------------------------------

def test_targets_equal():
    """boxes_to_targets, clip_boxes_to_tile, _scene_targets and
    grid_size: numpy copies, so equal."""
    img, boxes, classes = _scenes(1, seed=5)[0]
    g = 512 // 128
    for tx in range(g):
        for ty in range(g):
            jb, jc = jsyn.clip_boxes_to_tile(boxes, classes, tx, ty, 128)
            tb, tc = syn.clip_boxes_to_tile(boxes, classes, tx, ty, 128)
            np.testing.assert_array_equal(tb, jb)
            np.testing.assert_array_equal(tc, jc)
            for scale in (1.0, 0.5, 3.25):
                np.testing.assert_array_equal(
                    syn.boxes_to_targets(tb, tc, 16, 3, 8, 64, scale),
                    jsyn.boxes_to_targets(jb, jc, 16, 3, 8, 64, scale))
    for arch in ARCHS:
        for j, t in ((jget(arch), get_config(arch)), (jreduced(jget(arch)), reduced(get_config(arch)))):
            assert detector.grid_size(t) == jdet.grid_size(j)
            assert detector.grid_size(t, 128) == jdet.grid_size(j, 128)
            args = (g * g, g, jdet.grid_size(j), j.n_anchors, j.n_classes, j.input_size, 128)
            np.testing.assert_array_equal(cascade._scene_targets(boxes, classes, *args),
                                          jcascade._scene_targets(boxes, classes, *args))
    empty = (np.zeros((0, 4), np.float32), np.zeros((0,), np.int32))
    np.testing.assert_array_equal(cascade._scene_targets(*empty, 4, 2, 16, 3, 8, 64, 128),
                                  jcascade._scene_targets(*empty, 4, 2, 16, 3, 8, 64, 128))


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_build_target_pool(full):
    """ys equal; xs within the capture test's 2e-6 (the full width's
    128 -> 416 px upsampling; downsampling to 64 px is bit-equal)."""
    cfgs = ((jget("targetfuse-space"), get_config("targetfuse-space")) if full else
            (jreduced(jget("targetfuse-ground")), reduced(get_config("targetfuse-ground"))))
    scenes = _scenes(1, seed=2, spec=SceneSpec("s", 256, (6, 10), (10, 24))) if full else _scenes(2)
    jxs, jys = jcascade.build_target_pool(cfgs[0], scenes, 128)
    txs, tys = cascade.build_target_pool(cfgs[1], scenes, 128, device="cpu")
    np.testing.assert_array_equal(tys, jys)
    assert txs.shape == jxs.shape and txs.dtype == torch.float32
    np.testing.assert_allclose(txs.numpy(), jxs, rtol=0, atol=2e-6 if full else 0)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def _batch(tcfg, jcfg, n=4):
    jxs, jys = jcascade.build_target_pool(jcfg, _scenes(2), 128)
    idx = np.random.default_rng(0).integers(0, len(jxs), n)
    return jxs[idx], jys[idx]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match(arch):
    """loss and aux within 1e-6 relative; every gradient leaf within 1e-5
    of the leaf's largest value (float32 sums in another order: XLA's
    convolutions against oneDNN's), but the stem's within 3e-5: its
    weight gradient sums 16384 products a weight, which one thread of
    oneDNN sums 8e-6 off the float64 gradient
    (scripts/train_grad_accuracy.py --device cpu --reduced --threads 1)
    and 1.4e-5 off the reference's here; leaf paths in JAX's order."""
    jp, tp, jcfg, tcfg = _bridged(arch)
    xb, yb = _batch(tcfg, jcfg)
    (jl, jaux), jg = _jit_value_and_grad(jp, jcfg, xb, yb)
    tpg = T.map_leaves(lambda p: p.clone().requires_grad_(True), tp)
    tl, taux = detector.loss_fn(tpg, tcfg, torch.from_numpy(xb), torch.from_numpy(yb))
    tg = T.unflatten(tpg, torch.autograd.grad(tl, T.leaves(tpg)))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    assert set(taux) == {"obj", "box", "cls"}
    for k in taux:
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]), rtol=1e-6, err_msg=k)
    paths = T.flatten_with_paths(tg)[0]
    assert paths == _jax_paths(jg)
    assert paths[:3] == ["head_b", "head_w", "stages/0/0/b"] and paths[-1] == "stem"
    for path, a, b in zip(paths, jax.tree_util.tree_leaves(jg), T.leaves(tg)):
        err = float(np.abs(np.asarray(a) - b.numpy()).max() / np.abs(np.asarray(a)).max())
        assert err <= (3e-5 if path == "stem" else 1e-5), (path, err)


def test_forward_builds_a_graph():
    """The training path is differentiable: no inference mode, no in-place
    op on a saved tensor, a gradient on every leaf."""
    _, tp, jcfg, tcfg = _bridged("targetfuse-space")
    xb, yb = _batch(tcfg, jcfg, 2)
    tpg = T.map_leaves(lambda p: p.clone().requires_grad_(True), tp)
    loss, _ = detector.loss_fn(tpg, tcfg, torch.from_numpy(xb), torch.from_numpy(yb))
    loss.backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0
               for p in T.leaves(tpg))


# ---------------------------------------------------------------------------
# the schedule and the optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("peak,warmup,total,floor", [
    (3e-3, 26, 250, 0.0), (3e-3, 201, 2000, 0.0), (1e-3, 1, 5, 0.0), (2e-4, 7, 60, 1e-5)])
def test_schedule_equal(peak, warmup, total, floor):
    """Bit-equal in float32 at every step 0..total+1."""
    jf = jschedule.cosine_with_warmup(peak, warmup, total, floor)
    tf = schedule.cosine_with_warmup(peak, warmup, total, floor)
    want = np.array([np.float32(jf(jnp.int32(s))) for s in range(total + 2)])
    got = tf(torch.arange(total + 2, dtype=torch.int32)).numpy()
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    assert tf(3).numpy().tobytes() == np.float32(jf(jnp.int32(3))).tobytes()
    assert schedule.constant(peak)(5).numpy().tobytes() == \
        np.float32(jschedule.constant(peak)(5)).tobytes()


@pytest.mark.parametrize("clip", [0.1, 1e6, None], ids=["clip-active", "clip-inactive", "no-clip"])
@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_update_matches(arch, clip):
    """Two updates from the same gradients: params within 1e-7 absolute,
    mu and nu within 1e-6 of each leaf's largest value, grad_norm within
    1e-6 relative, lr and step equal (measured 3e-8, 4e-7, 1 ulp)."""
    jp, tp, jcfg, tcfg = _bridged(arch)
    xb, yb = _batch(tcfg, jcfg)
    (_, _), jg = _jit_value_and_grad(jp, jcfg, xb, yb)
    jg = jax.tree_util.tree_map(np.asarray, jg)
    ji, ju = jadamw.adamw(jschedule.cosine_with_warmup(3e-3, 2, 10), clip_norm=clip)
    ti, tu = adamw.adamw(schedule.cosine_with_warmup(3e-3, 2, 10), clip_norm=clip)
    js, ts, tg = ji(jp), ti(tp), detector.params_from_jax(jg)
    jparams, tparams = jp, tp
    gnorm = float(jnp.sqrt(sum(jnp.sum(jnp.square(g)) for g in jax.tree_util.tree_leaves(jg))))
    if clip is not None:
        assert (gnorm > clip) == (clip == 0.1)
    for _ in range(2):
        jparams, js, jm = jax.jit(ju)(jg, js, jparams)
        tparams, ts, tm = tu(tg, ts, tparams)
        assert _max_abs(jparams, tparams) <= 1e-7
        assert _max_rel_to_leaf_max(js.mu, ts.mu) <= 1e-6
        assert _max_rel_to_leaf_max(js.nu, ts.nu) <= 1e-6
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-6)
        assert tm["lr"].numpy().tobytes() == np.float32(jm["lr"]).tobytes()
        assert int(ts.step) == int(js.step) and ts.step.dtype == torch.int32
    assert isinstance(ts, adamw.AdamWState)


def test_global_norm_and_clip():
    """global_norm sums leaves in JAX's order; clip_by_global_norm scales
    to the limit and returns the norm before scaling."""
    tree = {"b": torch.tensor([3.0]), "a": [torch.tensor([[4.0]]), torch.zeros(2)]}
    assert adamw.global_norm(tree).item() == 5.0
    clipped, n = adamw.clip_by_global_norm(tree, 1.0)
    assert n.item() == 5.0
    np.testing.assert_allclose(adamw.global_norm(clipped).item(), 1.0, rtol=1e-7)
    same, _ = adamw.clip_by_global_norm(tree, 10.0)
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(same), T.leaves(tree)))


@pytest.mark.parametrize("arch", ARCHS)
def test_fit_counter_five_steps_matches(arch, monkeypatch):
    """5 fit_counter steps from the reference's initial weights (the
    port's init swapped for one returning them): the reference's batches
    and schedule; final loss within 1e-6 relative, params within 1e-5
    absolute (measured 3.8e-6: an element whose gradient is within the
    gradient tolerance of 0 takes Adam's sign-like step, up to the rate,
    in either direction)."""
    jp, tp, jcfg, tcfg = _bridged(arch, seed=0)
    scenes = _scenes(2)
    want, want_loss = jcascade.fit_counter(jcfg, scenes, 128, 5, jax.random.PRNGKey(0))
    seen = []

    def bridged_init(gen, cfg, device="cuda"):
        seen.append((cfg, torch.device(device)))
        return detector.to_device(tp, device)
    monkeypatch.setattr(detector, "init", bridged_init)
    got, got_loss = cascade.fit_counter(tcfg, scenes, 128, 5, torch.Generator().manual_seed(0),
                                        device="cpu")
    assert seen == [(tcfg, torch.device("cpu"))]
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-6)
    assert T.flatten_with_paths(got)[0] == _jax_paths(want)
    assert not any(p.requires_grad for p in T.leaves(got))
    assert _max_abs(want, got) <= 1e-5


def test_fit_counter_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = reduced(get_config("targetfuse-space"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cascade.fit_counter(cfg, _scenes(1), 128, 1, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.get_counters(train_steps=(1, 1))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _opt_tree(tp):
    """(params, AdamWState) of the port after one update, and the same
    tree as the reference's types."""
    init, update = adamw.adamw(0.01)
    grads = T.map_leaves(lambda p: torch.ones_like(p), tp)
    params, state, _ = update(grads, init(tp), tp)
    jstate = jadamw.AdamWState(step=jnp.asarray(state.step.numpy()),
                               mu=T.map_leaves(lambda x: x.numpy(), state.mu),
                               nu=T.map_leaves(lambda x: x.numpy(), state.nu))
    return (params, state), (T.map_leaves(lambda x: x.numpy(), params), jstate)


def test_checkpoint_port_save_reference_restore(tmp_path):
    """The port writes, the reference reads: params and optimizer state
    (a named tuple), a bfloat16 and an int leaf; equal."""
    _, tp, _, _ = _bridged("targetfuse-ground", seed=3)
    ttree, jtree = _opt_tree(tp)
    ckpt.save(str(tmp_path / "opt"), 4, ttree)
    step, got = jckpt.restore(str(tmp_path / "opt"), jtree)
    assert step == 4
    assert _jax_paths(got) == T.flatten_with_paths(ttree)[0]
    assert _jax_paths(got)[0] == "0/head_b" and "1/.step" in _jax_paths(got)
    for a, b in zip(jax.tree_util.tree_leaves(got), T.leaves(ttree), strict=True):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    mixed = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3).to(torch.bfloat16) / 3,
             "n": torch.tensor([7, -2], dtype=torch.int32)}
    ckpt.save(str(tmp_path / "mixed"), 1, mixed)
    jtemplate = {"w": jnp.zeros((2, 3), jnp.bfloat16), "n": jnp.zeros((2,), jnp.int32)}
    _, got = jckpt.restore(str(tmp_path / "mixed"), jtemplate)
    assert got["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got["w"], np.float32), mixed["w"].float().numpy())
    np.testing.assert_array_equal(got["n"], mixed["n"].numpy())


def test_checkpoint_reference_save_port_restore(tmp_path):
    """The reference writes, the port reads into its own template; equal,
    of the template's dtype."""
    jp, tp, _, _ = _bridged("targetfuse-space", seed=4)
    ttree, jtree = _opt_tree(tp)
    jckpt.save(str(tmp_path / "opt"), 9, jtree)
    template = (T.map_leaves(torch.zeros_like, ttree[0]),
                adamw.AdamWState(torch.zeros((), dtype=torch.int32),
                                 *[T.map_leaves(torch.zeros_like, t) for t in ttree[1][1:]]))
    step, got = ckpt.restore(str(tmp_path / "opt"), template)
    assert step == 9 and isinstance(got[1], adamw.AdamWState)
    for a, b in zip(T.leaves(got), T.leaves(ttree), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jckpt.save(str(tmp_path / "mixed"), 2, {"w": jnp.linspace(0, 1, 6, dtype=jnp.bfloat16)})
    _, got = ckpt.restore(str(tmp_path / "mixed"), {"w": torch.zeros(6, dtype=torch.bfloat16)})
    np.testing.assert_array_equal(got["w"].float().numpy(),
                                  np.asarray(jnp.linspace(0, 1, 6, dtype=jnp.bfloat16), np.float32))


def test_checkpoint_skips_uncommitted_and_tmp(tmp_path):
    tree = {"a": torch.ones(3)}
    ckpt.save(str(tmp_path), 1, tree)
    ckpt.save(str(tmp_path), 2, T.map_leaves(lambda x: x + 1, tree))
    (tmp_path / "step_00000005").mkdir()                       # never committed
    (tmp_path / "step_00000006.tmp").mkdir()                   # a save cut short
    (tmp_path / "step_00000006.tmp" / "COMMITTED").write_text("ok")
    assert ckpt.all_steps(str(tmp_path)) == [1, 2] and ckpt.latest_step(str(tmp_path)) == 2
    step, got = ckpt.restore(str(tmp_path), tree)
    assert step == 2 and torch.equal(got["a"], torch.full((3,), 2.0))
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), tree)


def test_checkpoint_keep_collects_old_steps(tmp_path):
    for s in range(1, 6):
        ckpt.save(str(tmp_path), s, {"a": torch.full((2,), float(s))}, keep=2)
    assert ckpt.all_steps(str(tmp_path)) == [4, 5]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000004", "step_00000005"]
    _, got = ckpt.restore(str(tmp_path), {"a": torch.zeros(2)}, step=4)
    assert torch.equal(got["a"], torch.full((2,), 4.0))


def test_checkpoint_async_save_joins(tmp_path):
    """An async save copies the tensors before its thread starts: a
    later in-place change does not reach the file."""
    tree = {"a": torch.arange(5, dtype=torch.float32), "b": [torch.ones(2, 2)]}
    t = ckpt.save(str(tmp_path), 3, tree, async_=True)
    tree["a"].add_(100.0)
    t.join(timeout=30)
    assert not t.is_alive()
    _, got = ckpt.restore(str(tmp_path), tree)
    assert torch.equal(got["a"], torch.arange(5, dtype=torch.float32))
    assert torch.equal(got["b"][0], torch.ones(2, 2))
    assert ckpt.save(str(tmp_path), 4, tree) is None


def test_checkpoint_structure_mismatch_raises(tmp_path):
    _, tp, _, _ = _bridged("targetfuse-space")
    ckpt.save(str(tmp_path), 1, tp)
    _, other, _, _ = _bridged("targetfuse-ground")
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore(str(tmp_path), {"stem": other["stem"]})
    deeper = detector.init(torch.Generator().manual_seed(0), get_config("targetfuse-space"), "cpu")
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore(str(tmp_path), deeper)


# ---------------------------------------------------------------------------
# get_counters and the cascade's premise
# ---------------------------------------------------------------------------

def test_get_counters_trains_caches_and_restores(tmp_path, monkeypatch):
    """An empty folder trains and caches; a second call restores without
    training; force=True trains again."""
    calls = []
    real_fit = cascade.fit_counter

    def counting_fit(*args, **kwargs):
        calls.append(args[3])
        return real_fit(*args, **kwargs)
    monkeypatch.setattr(serve, "fit_counter", counting_fit)
    (sp, sp_cfg), (gd, gd_cfg) = serve.get_counters(train_steps=(2, 3), cache_dir=str(tmp_path),
                                                    device="cpu")
    assert calls == [2, 3]
    assert ckpt.all_steps(str(tmp_path / "space")) == [2]
    assert ckpt.all_steps(str(tmp_path / "ground")) == [3]
    assert sp_cfg == reduced(get_config("targetfuse-space"))
    assert gd_cfg == reduced(get_config("targetfuse-ground"))

    def no_training(*args, **kwargs):
        raise AssertionError("get_counters trained though a checkpoint was cached")
    monkeypatch.setattr(serve, "fit_counter", no_training)
    (sp2, _), (gd2, _) = serve.get_counters(train_steps=(2, 3), cache_dir=str(tmp_path),
                                            device="cpu")
    for a, b in ((sp, sp2), (gd, gd2)):
        assert all(torch.equal(x, y) for x, y in zip(T.leaves(a), T.leaves(b), strict=True))
    # the reference reads what the port cached
    _, jsp = jckpt.restore(str(tmp_path / "space"),
                           jdet.init(jax.random.PRNGKey(0), jreduced(jget("targetfuse-space"))))
    for a, b in zip(jax.tree_util.tree_leaves(jsp), T.leaves(sp), strict=True):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())

    calls.clear()
    monkeypatch.setattr(serve, "fit_counter", counting_fit)
    serve.get_counters(train_steps=(2, 3), cache_dir=str(tmp_path), force=True, device="cpu")
    assert calls == [2, 3]


def test_ground_tier_more_accurate():
    """The cascade's premise with counters the port trained, at
    tests/test_system.py's sizes: 6 mini scenes, 250 and 600 steps; on 3
    held-out scenes of rng(3) the ground counter's error is below the
    space counter's."""
    scenes = _scenes(6, seed=0)
    sp_cfg = reduced(get_config("targetfuse-space"))
    gd_cfg = reduced(get_config("targetfuse-ground"))
    sp, sp_loss = cascade.fit_counter(sp_cfg, scenes, 128, 250, torch.Generator().manual_seed(0),
                                      device="cpu")
    gd, gd_loss = cascade.fit_counter(gd_cfg, scenes, 128, 600, torch.Generator().manual_seed(1),
                                      device="cpu")
    assert np.isfinite(sp_loss) and np.isfinite(gd_loss)
    rng = np.random.default_rng(3)
    errs_s, errs_g = [], []
    for _ in range(3):
        img, b, c = make_scene(rng, MINI)
        true = tile_counts(b, MINI.scene_px, 128)
        t = tiling.tile_image(torch.from_numpy(img), 128)
        cs, _ = cascade.count_tiles_batched(sp, sp_cfg, tiling.resize_tiles(t, sp_cfg.input_size),
                                            score_thresh=0.25)
        cg, _ = cascade.count_tiles_batched(gd, gd_cfg, tiling.resize_tiles(t, gd_cfg.input_size),
                                            score_thresh=0.25)
        errs_s.append(np.abs(cs - true).sum() / max(true.sum(), 1))
        errs_g.append(np.abs(cg - true).sum() / max(true.sum(), 1))
    assert np.mean(errs_g) < np.mean(errs_s)
