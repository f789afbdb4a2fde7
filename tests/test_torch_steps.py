"""The port's cell layer (``repro_torch.launch.steps``: ``build_cell``,
``input_specs``, ``model_flops``) against the reference's, on the CPU.

For the 40 cells of ``all_cells()`` and the counters' three
(``targetfuse-space`` and ``-ground`` at ``tiles_416_b256``,
``targetfuse-space`` at ``train_416_b64``): the plan's input trees equal
the reference's ``ShapeDtypeStruct`` leaves (built on a one-device mesh
``("data", "model")``) in path, shape and dtype, in JAX's leaf order,
every leaf on ``meta``, nothing allocated; the one difference allowed is
a diffusion ``train`` cell's key, which the port takes as its draws ``t``
and ``noise``. ``model_flops`` within 1e-12 of the reference's. Then each
cell's step at reduced size (``get_config`` patched to ``reduced``
and ``get_shape`` to a small ``ShapeSpec`` in both modules), from the
reference's seeded weights carried over by ``from_numpy`` and inputs made
from a seed with numpy, against the reference plan's step under
``jax.jit``: every LM cell (train with and without ``grad_accum``,
prefill, decode absorbed and naive), the vision and diffusion cells,
the onboard serve cell of both counters and the counter's training
cell. Float outputs are held within stated tolerances; counts,
assignments, the downlink mask and the space tier's count must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import test_torch_zoo_train as zt
from repro.configs import base as jbase
from repro.configs import reduced as jreduced
from repro.launch import steps as jsteps
from repro.models import detector as jdetector
from repro.models import lm as jlm
from repro.optim.adamw import adamw as jadamw
from repro_torch import tree
from repro_torch.configs import all_cells, base, reduced
from repro_torch.launch import steps
from repro_torch.models import detector, layers as L, lm, resnet, unet
from repro_torch.optim.adamw import adamw

# one intra-op thread, as in the other port tests run by parallel workers
torch.set_num_threads(1)

CELLS = all_cells() + [("targetfuse-space", "tiles_416_b256"),
                       ("targetfuse-ground", "tiles_416_b256"),
                       ("targetfuse-space", "train_416_b64")]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32,
          "uint32": torch.uint32}


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"))


def _jpath(path) -> str:
    """A JAX key path as ``repro_torch.tree`` writes it."""
    out = []
    for k in path:
        if isinstance(k, jax.tree_util.DictKey):
            out.append(str(k.key))
        elif isinstance(k, jax.tree_util.SequenceKey):
            out.append(str(k.idx))
        else:
            out.append(f".{k.name}")
    return "/".join(out)


def _ref_leaves(args):
    flat, _ = jax.tree_util.tree_flatten_with_path(args)
    return [(_jpath(p), tuple(x.shape), DTYPES[str(x.dtype)]) for p, x in flat]


def _port_leaves(args):
    paths, leaves = tree.flatten_with_paths(args)
    return [(p, tuple(x.shape), x.dtype) for p, x in zip(paths, leaves)], leaves


class _Devices(TorchDispatchMode):
    """The device types of every tensor that an ATen op (factories
    included) makes inside the block."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for x in (out if isinstance(out, (list, tuple)) else [out]):
            if isinstance(x, torch.Tensor):
                self.seen.add(x.device.type)
        return out


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(arch, shape):
    """Paths, shapes and dtypes of every input leaf in JAX's order, all on
    ``meta``, and no tensor made on another device while the plan is
    built; a diffusion train cell's key (2,) uint32 becomes ``t`` (B,)
    int32 and ``noise`` shaped as the latents, float32."""
    want = _ref_leaves(jsteps.build_cell(arch, shape, _mesh()).args_sds)
    with _Devices() as made:
        plan = steps.build_cell(arch, shape)
    assert made.seen == {"meta"}
    got, leaves = _port_leaves(steps.input_specs(arch, shape))
    assert all(x.is_meta for x in leaves)
    if plan.meta["kind"] == "train" and base.get_config(arch).family == "diffusion":
        key, want = want[-1], want[:-1]
        assert key[1:] == ((2,), torch.uint32)
        (t_path, t_shape, t_dt), (n_path, n_shape, n_dt) = got[-2:]
        got = got[:-2]
        latents = got[-2]
        assert (t_path, t_shape, t_dt) == ("4", (latents[1][0],), torch.int32)
        assert (n_path, n_shape, n_dt) == ("5", latents[1], torch.float32)
    assert got == want


@pytest.mark.parametrize("arch,shape", CELLS)
def test_plan_meta_and_donation_match_reference(arch, shape):
    """The reference's ``meta`` keys and values and ``donate_argnums``; the
    host scalars are the 0-d int32 arguments."""
    jplan = jsteps.build_cell(arch, shape, _mesh())
    plan = steps.build_cell(arch, shape)
    host = plan.meta.pop("host_scalars", ())
    assert plan.meta == jplan.meta and plan.donate_argnums == jplan.donate_argnums
    assert all(plan.args[i].shape == () and plan.args[i].dtype == torch.int32 for i in host)
    assert host == {"decode": (3,), "gen": (3, 4)}.get(plan.meta["kind"], ())


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_match_reference(arch, shape):
    assert steps.model_flops(arch, shape) == pytest.approx(jsteps.model_flops(arch, shape),
                                                           rel=1e-12)


def test_build_cell_takes_the_reference_options():
    """``remat`` and ``unroll`` taken; the mesh options taken on a mesh
    and raising without one; unknown ones raise."""
    from repro_torch.sharding import AbstractMesh
    assert steps.build_cell("vit-l16", "cls_224", remat="full").fn
    assert steps.build_cell("vit-l16", "cls_224", remat="full", unroll=True).args
    for opt in ("zero1_axis", "no_pure_dp", "dp_serve", "bogus"):
        with pytest.raises(TypeError):
            steps.build_cell("vit-l16", "cls_224", **{opt: True})
    mesh = AbstractMesh((1, 1), ("data", "model"))
    for opt, value in (("zero1_axis", "data"), ("no_pure_dp", True), ("dp_serve", False)):
        assert steps.build_cell("vit-l16", "cls_224", mesh, **{opt: value}).in_shardings
    with pytest.raises(TypeError):
        steps.build_cell("vit-l16", "cls_224", mesh, bogus=True)


def test_steps_refuse_meta_inputs_and_device_scalars():
    """A plan's ``args`` give shapes only: its step refuses them; a host
    scalar on another device than the CPU is refused before any read."""
    plan = steps.build_cell("targetfuse-space", "tiles_416_b256")
    with pytest.raises(ValueError, match="meta"):
        plan.fn(*plan.args)
    with pytest.raises(ValueError, match="host scalar"):
        steps._host_int(torch.zeros((), dtype=torch.int32, device="meta"))
    assert steps._host_int(torch.tensor(7, dtype=torch.int32)) == 7


def test_meta_is_no_default_and_no_computing_device(monkeypatch):
    """``resolve_device`` refuses "meta" unless an init asks; the inits
    still default to the card."""
    from repro_torch.device import resolve_device
    with pytest.raises(ValueError, match="unsupported"):
        resolve_device("meta")
    assert resolve_device("meta", meta=True).type == "meta"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init(L.SHAPES_ONLY, reduced(base.get_config("qwen3-8b")))


@pytest.mark.parametrize("arch,mod", [("qwen3-8b", lm), ("deepseek-v2-lite-16b", lm),
                                      ("resnet-152", resnet), ("unet-sd15", unet),
                                      ("targetfuse-ground", detector)])
def test_meta_inits_give_the_cpu_inits_layout(arch, mod):
    """The shape-only trees have the CPU init's paths, shapes and dtypes."""
    cfg = reduced(base.get_config(arch))
    got = mod.init(L.SHAPES_ONLY, cfg, device="meta")
    want = mod.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert _port_leaves(got)[0] == _port_leaves(want)[0]


# ---------------------------------------------------------------------------
# each cell's step at reduced size against the reference's
# ---------------------------------------------------------------------------

# small shapes of each kind
SMALL = {"train": dict(seq_len=16, global_batch=4), "prefill": dict(seq_len=16, global_batch=2),
         "decode": dict(seq_len=24, global_batch=2), "cls": dict(img_res=32, global_batch=4),
         "serve": dict(img_res=32, global_batch=3), "gen": dict(global_batch=3, steps=4)}
# loss: relative; gradient-driven leaves (AdamW's first moment, ResNet's
# statistics, a serving output): within TOL of each leaf's largest
# magnitude (float32 sums in another order, XLA against ATen),
# tests/test_torch_zoo_train.py's gradient tolerance; the first moment of
# a leaf whose gradient is 0 in exact arithmetic (the reduced UNet's time
# embedding) within ZERO_GRAD of the tree's largest. A first AdamW step
# moves each parameter by lr (g / (|g| + eps) + 0.01 p), about +-lr: the
# update (new less old parameters) within UPDATE_TOL lr (plus the
# rounding of p - update, 2 float32 ulps of p) of the reference's where
# the reference's first moment is above NOISE of its leaf's largest, so
# that the two gradients share their sign; elsewhere, where a gradient of
# float32 noise around 0 may take the other sign, within 2 lr. At least
# DECIDED of the elements are held at UPDATE_TOL
LOSS_RTOL, TOL, ZERO_GRAD = 1e-5, 1e-4, 1e-2
UPDATE_TOL, NOISE, DECIDED = 1e-3, 1e-3, 0.5


def _small_shape(arch, shape_name):
    """The cell's ShapeSpec cut to CPU size (both packages' own)."""
    jshape = jbase.get_shape(arch, shape_name)
    cfg = reduced(base.get_config(arch))
    kw = dict(SMALL[jshape.kind])
    if jshape.kind == "serve" and cfg.family == "detector":
        kw = dict(img_res=cfg.input_size, global_batch=16)
    if jshape.kind == "train" and cfg.family == "diffusion":
        kw = dict(img_res=cfg.img_res, global_batch=3)
    if jshape.kind == "train" and cfg.family == "detector":
        kw = dict(img_res=cfg.input_size, global_batch=3)
    if jshape.kind == "gen":
        kw["img_res"] = cfg.img_res
    js = dataclasses.replace(jshape, **kw)
    return js, base.ShapeSpec(**dataclasses.asdict(js))


def _patch(monkeypatch, arch, shape_name):
    js, ps = _small_shape(arch, shape_name)
    monkeypatch.setattr(jsteps, "get_config", lambda a: jreduced(jbase.get_config(a)))
    monkeypatch.setattr(jsteps, "get_shape", lambda a, s: js)
    monkeypatch.setattr(steps, "get_config", lambda a: reduced(base.get_config(a)))
    monkeypatch.setattr(steps, "get_shape", lambda a, s: ps)
    return ps


def _weights(arch, seed):
    """-> (the reference's seeded weights, the port's copy); ResNet's with
    their running statistics, DiT's adaLN-Zero leaves nonzero."""
    jcfg = jreduced(jbase.get_config(arch))
    if jcfg.family == "lm":
        jp = jlm.init(jax.random.PRNGKey(seed), jcfg)
        return jp, tree.from_numpy(jp, device="cpu")
    if jcfg.family == "detector":
        jp = jdetector.init(jax.random.PRNGKey(seed), jcfg)
        return jp, detector.params_from_jax(jp)
    jmod, mod = zt.MODULES[jcfg.kind]
    jp = jmod.init(jax.random.PRNGKey(seed), jcfg)
    if jcfg.kind == "dit":
        jp = zt._nonzero_adaln(jp, seed + 100)
    return jp, mod.from_numpy(jp, device="cpu")


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _close(got, want, tol, what, scale=None):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max()) if scale is None else scale
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * max(scale, 1e-30), f"{what}: {err:.3e} > {tol:g} x {scale:.3e}"


def _zero_leaf(cfg, path) -> bool:
    """A leaf whose gradient is 0 in exact arithmetic (the reduced UNet's
    time embedding, tests/test_torch_zoo_train.py's)."""
    return getattr(cfg, "kind", None) == "unet" and zt._zero_in_exact_arithmetic(cfg, path)


def _train_state_close(cfg, got_params, got_opt, old, jparams, jopt, lr, lead=""):
    """AdamW's step count equal; its first moment within TOL of each
    leaf's largest (the zero-gradient leaves: ZERO_GRAD of the tree's
    largest), its second within 3 TOL; each parameter's update from
    ``old`` (the reference's weights before the step, which the port's
    equal) as set out above."""
    assert int(got_opt.step) == int(jopt.step) == 1
    paths, mus = tree.flatten_with_paths(got_opt.mu)
    jmus = jax.tree_util.tree_leaves(jopt.mu)
    top = max(float(np.abs(np.asarray(m)).max()) for m in jmus)
    for path, m, jm in zip(paths, mus, jmus):
        if _zero_leaf(cfg, path):
            _close(m, jm, ZERO_GRAD, f"{lead}mu {path}", scale=top)
        else:
            _close(m, jm, TOL, f"{lead}mu {path}")
    for path, v, jv in zip(paths, tree.leaves(got_opt.nu), jax.tree_util.tree_leaves(jopt.nu)):
        if not _zero_leaf(cfg, path):
            _close(v, jv, 3 * TOL, f"{lead}nu {path}")
    decided = total = 0
    for path, p, jp, o, jm in zip(*tree.flatten_with_paths(got_params),
                                  jax.tree_util.tree_leaves(jparams),
                                  jax.tree_util.tree_leaves(old), jmus):
        o = np.asarray(o, np.float64)
        err = np.abs((_np(p) - o) - (np.asarray(jp, np.float64) - o))
        ulps = 2 * np.finfo(np.float32).eps * np.abs(o)
        jm = np.abs(np.asarray(jm))
        held = (np.zeros(jm.shape, bool) if _zero_leaf(cfg, path)
                else jm > NOISE * jm.max())
        bad = held & (err > UPDATE_TOL * lr + ulps)
        assert not bad.any(), (f"{lead}update {path}: {err[bad].max() / lr:.3e} lr off the "
                               f"reference's at {int(bad.sum())} of {int(held.sum())}")
        assert (err <= 2 * lr + ulps).all(), f"{lead}update {path}: {err.max() / lr:.3e} lr off"
        decided, total = decided + int(held.sum()), total + held.size
    assert decided >= DECIDED * total, f"{lead}{decided} of {total} updates held"


def _loss_close(loss, jloss):
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(loss.item() - float(jloss)) <= LOSS_RTOL * abs(float(jloss))


def _run_ref(jplan, *args):
    return jax.jit(jplan.fn)(*args)


def _tokens(cfg, shape, seed):
    """Seeded tokens and ``labels = roll(tokens, -1)``."""
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (shape.global_batch, shape.seq_len), dtype=np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


@pytest.mark.parametrize("arch,grad_accum", [("qwen3-8b", 1), ("qwen3-8b", 2),
                                             ("deepseek-v2-lite-16b", 1)])
def test_lm_train_cell_matches_reference(monkeypatch, arch, grad_accum):
    shape = _patch(monkeypatch, arch, "train_4k")
    cfg = reduced(base.get_config(arch))
    jplan = jsteps.build_cell(arch, "train_4k", _mesh(), grad_accum=grad_accum)
    plan = steps.build_cell(arch, "train_4k", grad_accum=grad_accum)
    jp, p = _weights(arch, 0)
    tokens, labels = _tokens(cfg, shape, 3)
    jout = _run_ref(jplan, jp, jadamw(1e-4)[0](jp), jnp.asarray(tokens), jnp.asarray(labels))
    out = plan.fn(p, adamw(1e-4)[0](p), torch.from_numpy(tokens), torch.from_numpy(labels))
    _loss_close(out[2], jout[2])
    _train_state_close(cfg, out[0], out[1], jp, jout[0], jout[1], 1e-4)


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v2-lite-16b"])
def test_lm_prefill_cell_matches_reference(monkeypatch, arch):
    """Last-token logits and every cache leaf within 1e-5 of its largest."""
    shape = _patch(monkeypatch, arch, "prefill_32k")
    cfg = reduced(base.get_config(arch))
    jplan = jsteps.build_cell(arch, "prefill_32k", _mesh())
    plan = steps.build_cell(arch, "prefill_32k")
    jp, p = _weights(arch, 1)
    tokens, _ = _tokens(cfg, shape, 4)
    jlogits, jcache = _run_ref(jplan, jp, jnp.asarray(tokens))
    logits, cache = plan.fn(p, torch.from_numpy(tokens))
    _close(logits, jlogits, 1e-5, "logits")
    paths, leaves = tree.flatten_with_paths(cache)
    for path, c, jc in zip(paths, leaves, jax.tree_util.tree_leaves(jcache)):
        _close(c, jc, 1e-5, f"cache {path}")


@pytest.mark.parametrize("arch,absorb", [("qwen3-8b", True), ("deepseek-v2-lite-16b", True),
                                         ("deepseek-v2-lite-16b", False)])
def test_lm_decode_cell_matches_reference(monkeypatch, arch, absorb):
    """One decode step at ``pos`` 17 of a 24-position cache of seeded
    values (``pos`` a 0-d int32 CPU tensor): logits within 1e-5 of their
    largest; the cache written at ``pos`` (in place) and nowhere else."""
    shape = _patch(monkeypatch, arch, "decode_32k")
    cfg = reduced(base.get_config(arch))
    jplan = jsteps.build_cell(arch, "decode_32k", _mesh(), mla_absorb=absorb)
    plan = steps.build_cell(arch, "decode_32k", mla_absorb=absorb)
    jp, p = _weights(arch, 2)
    rng = np.random.default_rng(5)
    jcache = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32)),
        jax.eval_shape(lambda: jlm.init_cache(jreduced(jbase.get_config(arch)),
                                              shape.global_batch, shape.seq_len)))
    cache = tree.from_numpy(jcache, device="cpu")
    token = rng.integers(0, cfg.vocab_size, (shape.global_batch, 1), dtype=np.int32)
    pos = 17
    jlogits, jnew = _run_ref(jplan, jp, jnp.asarray(token), jcache, jnp.int32(pos))
    ptrs = [c.data_ptr() for c in tree.leaves(cache)]
    logits, new = plan.fn(p, torch.from_numpy(token), cache, torch.tensor(pos, dtype=torch.int32))
    _close(logits, jlogits, 1e-5, "logits")
    assert [c.data_ptr() for c in tree.leaves(new)] == ptrs, "the cache is written in place"
    for path, c, jc, old in zip(*tree.flatten_with_paths(new), jax.tree_util.tree_leaves(jnew),
                                jax.tree_util.tree_leaves(jcache)):
        _close(c, jc, 1e-5, f"cache {path}")
        keep = np.ones(c.shape[2], bool)
        keep[pos] = False
        assert np.array_equal(c.numpy()[:, :, keep], np.asarray(old)[:, :, keep]), path


def _images(shape, seed, lo=0.0):
    rng = np.random.default_rng(seed)
    b, r = shape.global_batch, shape.img_res
    return rng.uniform(lo, 1.0, (b, r, r, 3)).astype(np.float32), rng


@pytest.mark.parametrize("arch", ["vit-l16", "resnet-152"])
def test_vision_train_cell_matches_reference(monkeypatch, arch):
    """The loss, AdamW's state and, for ResNet, the running statistics
    (within TOL of each leaf's largest); the step donates: the new state
    lies in the argument's tensors."""
    shape = _patch(monkeypatch, arch, "cls_224")
    cfg = reduced(base.get_config(arch))
    jplan = jsteps.build_cell(arch, "cls_224", _mesh())
    plan = steps.build_cell(arch, "cls_224")
    jp, p = _weights(arch, 3)
    images, rng = _images(shape, 6, lo=-1.0)
    labels = rng.integers(0, cfg.n_classes, shape.global_batch).astype(np.int32)
    batch = [torch.from_numpy(images), torch.from_numpy(labels)]
    if cfg.kind == "resnet":
        opt = adamw(1e-3)[0](p[0])
        jout = _run_ref(jplan, jp[0], jp[1], jadamw(1e-3)[0](jp[0]), jnp.asarray(images),
                        jnp.asarray(labels))
        ptr = tree.leaves(p[0])[0].data_ptr()
        out = plan.fn(p[0], p[1], opt, *batch)
        assert tree.leaves(out[0])[0].data_ptr() == ptr
        _loss_close(out[3], jout[3])
        for path, s, js in zip(*tree.flatten_with_paths(out[1]),
                               jax.tree_util.tree_leaves(jout[1])):
            _close(s, js, TOL, f"statistics {path}")
        _train_state_close(cfg, out[0], out[2], jp[0], jout[0], jout[2], 1e-3)
        return
    jout = _run_ref(jplan, jp, jadamw(1e-3)[0](jp), jnp.asarray(images), jnp.asarray(labels))
    ptr = tree.leaves(p)[0].data_ptr()
    out = plan.fn(p, adamw(1e-3)[0](p), *batch)
    assert tree.leaves(out[0])[0].data_ptr() == ptr
    _loss_close(out[2], jout[2])
    _train_state_close(cfg, out[0], out[1], jp, jout[0], jout[1], 1e-3)


@pytest.mark.parametrize("arch", ["vit-l16", "convnext-b", "resnet-152"])
def test_vision_serve_cell_matches_reference(monkeypatch, arch):
    """Logits within 1e-5 of their largest."""
    shape = _patch(monkeypatch, arch, "serve_b128")
    jplan = jsteps.build_cell(arch, "serve_b128", _mesh())
    plan = steps.build_cell(arch, "serve_b128")
    jp, p = _weights(arch, 4)
    images, _ = _images(shape, 7, lo=-1.0)
    if arch == "resnet-152":
        jlogits = _run_ref(jplan, *jp, jnp.asarray(images))
        logits = plan.fn(*p, torch.from_numpy(images))
    else:
        jlogits = _run_ref(jplan, jp, jnp.asarray(images))
        logits = plan.fn(p, torch.from_numpy(images))
    _close(logits, jlogits, 1e-5, "logits")


@pytest.mark.parametrize("arch", ["dit-s2", "unet-sd15"])
def test_diffusion_train_cell_matches_reference(monkeypatch, arch):
    """The port's step given the ``t`` and noise the reference draws from
    its key: the loss and AdamW's state as above."""
    shape = _patch(monkeypatch, arch, "train_256")
    cfg = reduced(base.get_config(arch))
    jplan = jsteps.build_cell(arch, "train_256", _mesh())
    plan = steps.build_cell(arch, "train_256")
    jp, p = _weights(arch, 5)
    _, cond, key = zt._batch(cfg, 12)
    lr = shape.img_res // cfg.latent_factor
    lat = np.random.default_rng(15).standard_normal(
        (shape.global_batch, lr, lr, cfg.latent_ch)).astype(np.float32)
    t, noise = zt._key_draws(key, lat.shape)
    jout = _run_ref(jplan, jp, jadamw(1e-4)[0](jp), jnp.asarray(lat), jnp.asarray(cond), key)
    out = plan.fn(p, adamw(1e-4)[0](p), *(torch.from_numpy(a) for a in (lat, cond, t, noise)))
    _loss_close(out[2], jout[2])
    _train_state_close(cfg, out[0], out[1], jp, jout[0], jout[1], 1e-4)


@pytest.mark.parametrize("arch", ["dit-s2", "unet-sd15"])
def test_diffusion_gen_cell_matches_reference(monkeypatch, arch):
    """One DDIM step (t 749 -> 499, the 4-step table's first; ``t_cur``
    and ``t_prev`` 0-d int32 CPU tensors): the latents within 1e-5 of
    their largest."""
    shape = _patch(monkeypatch, arch, "gen_fast")
    cfg = reduced(base.get_config(arch))
    jplan = jsteps.build_cell(arch, "gen_fast", _mesh())
    plan = steps.build_cell(arch, "gen_fast")
    jp, p = _weights(arch, 6)
    _, cond, _ = zt._batch(cfg, 13)
    lr = shape.img_res // cfg.latent_factor
    lat = np.random.default_rng(14).standard_normal(
        (shape.global_batch, lr, lr, cfg.latent_ch)).astype(np.float32)
    want = _run_ref(jplan, jp, jnp.asarray(lat), jnp.asarray(cond), jnp.int32(749),
                    jnp.int32(499))
    got = plan.fn(p, torch.from_numpy(lat), torch.from_numpy(cond),
                  torch.tensor(749, dtype=torch.int32), torch.tensor(499, dtype=torch.int32))
    assert float(np.abs(np.asarray(want) - lat).max()) > 1e-3   # the step moved them
    _close(got, want, 1e-5, "latents")


def _serve_inputs(shape, seed, lo):
    """Seeded tiles of uniform noise, tile i scaled by the i-th of B steps
    from ``lo`` to 1 (so their confidences differ), and 64 centroids drawn
    among the tiles' moments plus noise."""
    tiles, rng = _images(shape, seed)
    tiles *= np.linspace(lo, 1.0, len(tiles), dtype=np.float32)[:, None, None, None]
    feats = np.asarray(jsteps.kops.tile_moments(jnp.asarray(tiles)))
    pick = rng.integers(0, len(feats), steps.SERVE_CLUSTERS)
    cents = (feats[pick] + 0.05 * rng.standard_normal((steps.SERVE_CLUSTERS, 9))).astype(
        np.float32)
    return tiles, feats, cents


def _assign_equal_but_ties(got, want, feats, cents):
    """Equal assignments, except at an exact distance tie (float64)."""
    got, want = _np(got), _np(want)
    for i in np.nonzero(got != want)[0]:
        x = feats[i].astype(np.float64)
        d = ((cents.astype(np.float64) - x) ** 2).sum(1)
        assert d[got[i]] == pytest.approx(d[want[i]], abs=1e-6), (i, got[i], want[i])


def _serve_case(monkeypatch, arch, head_scale, obj_bias, cls_bias, lo):
    """The onboard step on 16 seeded 64 px tiles (contrast from ``lo`` to
    1), the reduced counter's head weights scaled by ``head_scale``, its
    objectness bias ``obj_bias`` and class 0's ``cls_bias``, against the
    reference's: counts, assignments, the downlink mask and the space
    tier's count equal; the confidences within 1e-5, and those of tiles
    that keep a box apart by far more (checked) -> (counts, conf,
    downlink as numpy; each tile's boxes above the score threshold among
    NMS's candidates, the space tier's count)."""
    shape = _patch(monkeypatch, arch, "tiles_416_b256")
    jcfg = jreduced(jbase.get_config(arch))
    jplan = jsteps.build_cell(arch, "tiles_416_b256", _mesh())
    plan = steps.build_cell(arch, "tiles_416_b256")
    jp = jdetector.init(jax.random.PRNGKey(7), jcfg)
    head_b = np.array(jp["head_b"]).reshape(jcfg.n_anchors, 5 + jcfg.n_classes)
    head_b[:, 4], head_b[:, 5] = obj_bias, cls_bias
    jp = dict(jp, head_w=jp["head_w"] * head_scale, head_b=jnp.asarray(head_b.reshape(-1)))
    p = detector.params_from_jax(jp)
    tiles, feats, cents = _serve_inputs(shape, 8, lo)
    want = _run_ref(jplan, jp, jnp.asarray(tiles), jnp.asarray(cents))
    got = plan.fn(p, torch.from_numpy(tiles), torch.from_numpy(cents))
    counts, conf, assign, down, c_space = got
    assert counts.dtype == torch.float32 and assign.dtype == torch.int32
    assert down.dtype == torch.bool and c_space.dim() == 0
    np.testing.assert_array_equal(_np(counts), np.asarray(want[0]))
    _close(conf, want[1], 1e-5, "conf")
    _assign_equal_but_ties(assign, want[2], feats, cents)
    np.testing.assert_array_equal(_np(down), np.asarray(want[3]))
    assert c_space.item() == float(want[4])
    c, d, n = _np(conf), _np(down), _np(counts)
    assert np.diff(np.sort(c[n > 0])).min() > 1e-5
    cfg = reduced(base.get_config(arch))
    boxes, scores = detector.decode(detector.forward(p, cfg, torch.from_numpy(tiles)), cfg,
                                    shape.img_res)
    top = torch.sort(scores, dim=-1, descending=True)[0][:, :128]
    return n, c, d, _np((top > 0.3).sum(-1)), c_space.item()


@pytest.mark.parametrize("arch", ["targetfuse-space", "targetfuse-ground"])
def test_targetfuse_serve_cell_matches_reference(monkeypatch, arch):
    """The head scaled (weights x8, objectness bias 0.5, class 0's bias 3)
    so that every tile counts objects and its confidence lies between the
    throttle's thresholds: the budget then takes the 2 tiles of highest
    confidence and leaves the others to the space tier (checked)."""
    n, c, d, _, c_space = _serve_case(monkeypatch, arch, 8.0, 0.5, 3.0, 0.05)
    assert ((c > steps.SERVE_CONF_P) & (c < steps.SERVE_CONF_Q)).all(), c
    assert d.sum() == 2 and d[np.argsort(c)[-2:]].all()
    assert (n > 0).all() and c_space == n[~d].sum()


# the head's weights scaled and its objectness bias (class 0's: 2) for
# confidences in all three bands: "spread" leaves more tiles in the middle
# band than the budget's 2, "room" fewer, so a dark tile taken as a middle
# one would be downlinked
BANDS = [("targetfuse-space", "spread", 1024.0, -0.5),
         ("targetfuse-ground", "spread", 1024.0, -0.5),
         ("targetfuse-space", "room", 8192.0, -1.0),
         ("targetfuse-ground", "room", 4096.0, 0.0)]


@pytest.mark.parametrize("arch,regime,head_scale,obj_bias", BANDS,
                         ids=[f"{a}-{r}" for a, r, _, _ in BANDS])
def test_targetfuse_serve_cell_spans_the_throttle_bands(monkeypatch, arch, regime, head_scale,
                                                        obj_bias):
    """Where the throttle decides: contrast from 0 to 1 and the head
    scaled, so that the darkest tiles keep no box (confidence 0,
    discarded), NMS suppresses boxes on most tiles, and confidences fall
    both between the thresholds and above (each checked). Of the middle
    band the budget takes at most 2, those of highest confidence; its
    others and the high band are counted in space, the discarded tiles
    nowhere."""
    n, c, d, above, c_space = _serve_case(monkeypatch, arch, head_scale, obj_bias, 2.0, 0.0)
    p, q = steps.SERVE_CONF_P, steps.SERVE_CONF_Q
    low, high = c < p, c > q
    middle = ~low & ~high
    assert low.any() and high.sum() >= 2 and middle.any(), c
    assert middle.sum() > 2 if regime == "spread" else middle.sum() < 2
    assert (n[low] == 0).all() and (above > n).sum() >= len(n) // 2
    assert d.sum() == min(2, middle.sum()) and not d[~middle].any()
    assert d[np.flatnonzero(middle)[np.argsort(c[middle])[-2:]]].all()
    assert c_space == n[high | (middle & ~d)].sum()


def test_detector_train_cell_matches_reference(monkeypatch):
    """One donated step on seeded targets (3 positives a tile): the loss
    and AdamW's state as above."""
    arch = "targetfuse-space"
    shape = _patch(monkeypatch, arch, "train_416_b64")
    jcfg = jreduced(jbase.get_config(arch))
    jplan = jsteps.build_cell(arch, "train_416_b64", _mesh())
    plan = steps.build_cell(arch, "train_416_b64")
    jp, p = _weights(arch, 9)
    images, rng = _images(shape, 10)
    g = jdetector.grid_size(jcfg, shape.img_res)
    targets = np.zeros((shape.global_batch, g, g, jcfg.n_anchors, 5 + jcfg.n_classes),
                       np.float32)
    for b in range(shape.global_batch):
        for _ in range(3):
            y, x, a = rng.integers(0, g), rng.integers(0, g), rng.integers(0, jcfg.n_anchors)
            targets[b, y, x, a, :4] = rng.uniform(0.2, 0.8, 4)
            targets[b, y, x, a, 4] = 1.0
            targets[b, y, x, a, 5 + rng.integers(0, jcfg.n_classes)] = 1.0
    jout = _run_ref(jplan, jp, jadamw(1e-3)[0](jp), jnp.asarray(images), jnp.asarray(targets))
    ptr = tree.leaves(p)[0].data_ptr()
    out = plan.fn(p, adamw(1e-3)[0](p), torch.from_numpy(images), torch.from_numpy(targets))
    assert tree.leaves(out[0])[0].data_ptr() == ptr
    _loss_close(out[2], jout[2])
    _train_state_close(reduced(base.get_config(arch)), out[0], out[1], jp, jout[0], jout[1],
                       1e-3)
