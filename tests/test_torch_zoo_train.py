"""The port's vision and diffusion training steps against the reference, on
the CPU.

For each of the six models (ViT-L/16, ViT-H/14, ConvNeXt-B, ResNet-152,
DiT-S/2, the SD-1.5 UNet), reduced and in float32, from the reference's
own seeded weights carried over by ``from_numpy`` (DiT's adaLN-Zero
leaves drawn nonzero, as ``test_torch_diffusion.py`` does): the loss and
every gradient leaf of one step against ``jax.value_and_grad`` of the
reference's step body, rebuilt from ``repro``'s modules as
``repro/launch/steps.py`` writes it (``ce`` and ``forward(...,
train=True)``; ``diffusion.train_loss`` of the model's eps with a key,
whose ``t`` and noise the test derives as the reference does and hands
to the port); ResNet's new running statistics; the losses of 3
consecutive AdamW steps (``repro.optim.adamw`` against the port's);
two donated steps bit-equal to the plain steps, in the given tensors; the
gradients with ``remat`` on bit-equal to those with it off, and the
checkpoint policy keeping matrix products' and convolutions' outputs;
``train_loss``, ``draw_train_inputs`` and ``ce``. Inputs are made from a
seed with numpy.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import convnext as jconvnext
from repro.models import diffusion as jdiffusion
from repro.models import dit as jdit
from repro.models import resnet as jresnet
from repro.models import unet as junet
from repro.models import vit as jvit
from repro.optim.adamw import adamw as jadamw
from repro_torch import tree
from repro_torch.configs import get_config, reduced
from repro_torch.launch import steps
from repro_torch.models import convnext, diffusion, dit, resnet, unet, vit
from repro_torch.models import layers as L

# one intra-op thread, as in the other port tests run by parallel workers
torch.set_num_threads(1)

VISION_ARCHS = ("vit-l16", "vit-h14", "convnext-b", "resnet-152")
DIFFUSION_ARCHS = ("dit-s2", "unet-sd15")
ARCHS = VISION_ARCHS + DIFFUSION_ARCHS
MODULES = {"vit": (jvit, vit), "convnext": (jconvnext, convnext), "resnet": (jresnet, resnet),
           "dit": (jdit, dit), "unet": (junet, unet)}
# loss: relative; a gradient leaf: within GRAD_TOL of its largest magnitude
# (float32 sums in another order, XLA's scan against a loop). Only a leaf
# whose gradient is 0 in exact arithmetic (``_zero_in_exact_arithmetic``)
# is held to ZERO_GRAD of the tree's largest gradient instead, as it holds
# float32 noise on both sides: the reduced UNet (16 and 32 channels,
# GroupNorm groups of one channel) gets its time embedding as a
# per-channel constant before a GroupNorm that removes it, so its
# t_w1, t_b1, t_w2, t_b2 and every temb_w, temb_b measured 2.4e-9 to
# 2.4e-8 of the tree's largest gradient (checked under ZERO_NOISE), port
# and reference up to 2.5x such a leaf's own largest apart
LOSS_RTOL, GRAD_TOL, ZERO_GRAD, ZERO_NOISE = 1e-5, 1e-4, 1e-2, 1e-6
VISION_B, DIFFUSION_B = 8, 3
LR = {"vision": 1e-3, "diffusion": 1e-4}   # the rates of the reference's steps


def _jce(logits, labels):
    """repro/launch/steps.py's ``ce``."""
    logp = jax.nn.log_softmax(logits.astype(jnp.float32))
    return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], 1))


def _nonzero_adaln(jp, seed):
    """DiT's adaLN-Zero leaves set to seeded values: weights at fan-in
    scale, biases at 0.1."""
    rng = np.random.default_rng(seed)

    def draw(a):
        scale = 0.1 if a.ndim == 1 else 1.0 / np.sqrt(a.shape[-2])
        return jnp.asarray(rng.standard_normal(a.shape) * scale, a.dtype)
    block_leaves, top_leaves = dit.ADALN_ZERO
    jp = dict(jp, blocks=dict(jp["blocks"]))
    for k in block_leaves:
        jp["blocks"][k] = draw(jp["blocks"][k])
    for k in top_leaves:
        jp[k] = draw(jp[k])
    return jp


def _bridged(arch, seed=0, remat="none"):
    """(reference config, reference tree, port config, port tree); for
    ResNet each tree is (params, running statistics)."""
    jcfg = jreduced(jget(arch))
    cfg = dataclasses.replace(reduced(get_config(arch)), remat=remat)
    jmod, mod = MODULES[cfg.kind]
    jp = jmod.init(jax.random.PRNGKey(seed), jcfg)
    if cfg.kind == "dit":
        jp = _nonzero_adaln(jp, seed + 100)
    return jcfg, jp, cfg, mod.from_numpy(jp, device="cpu")


def _batch(cfg, seed):
    """Vision: (images, labels); diffusion: (latents, cond, key), DiT's
    latents at twice the reduced side (16 tokens), cond class ids (the
    null class among them) or a text context."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vision":
        return (rng.standard_normal((VISION_B, cfg.img_res, cfg.img_res, 3)).astype(np.float32),
                rng.integers(0, cfg.n_classes, VISION_B).astype(np.int32))
    side = dit.latent_res(cfg) * (2 if cfg.kind == "dit" else 1)
    lat = rng.standard_normal((DIFFUSION_B, side, side, cfg.latent_ch)).astype(np.float32)
    if cfg.kind == "dit":
        cond = np.array([0, 3, cfg.n_classes], np.int32)
    else:
        cond = rng.standard_normal((DIFFUSION_B, cfg.ctx_len, cfg.ctx_dim)).astype(np.float32)
    return lat, cond, jax.random.PRNGKey(seed)


def _key_draws(key, latents_shape):
    """The reference's ``train_loss`` draws, from its key as it does."""
    kt, kn = jax.random.split(key)
    t = jax.random.randint(kt, (latents_shape[0],), 0, jdiffusion.N_TRAIN_STEPS)
    noise = jax.random.normal(kn, latents_shape, jnp.float32)
    return np.array(t), np.array(noise)


def _jloss(jcfg):
    """The reference step's ``loss_fn`` of params, as
    repro/launch/steps.py writes it, on a batch."""
    jmod = MODULES[jcfg.kind][0]
    if jcfg.kind == "resnet":
        def loss(p, s, images, labels):
            logits, new_bn = jresnet.forward(p, s, jcfg, images, train=True)
            return _jce(logits, labels), new_bn
        return loss
    if jcfg.family == "vision":
        return lambda p, images, labels: _jce(jmod.forward(p, jcfg, images, train=True), labels)

    def loss(p, latents, cond, key):
        def eps_fn(x, t):
            out = jmod.forward(p, jcfg, x, t, cond, train=True)
            return out[0] if jcfg.kind == "dit" else out
        return jdiffusion.train_loss(eps_fn, latents, key)
    return loss


@functools.lru_cache(maxsize=None)
def _jstep(arch):
    """A jitted reference step -> (params, [bn_state,] opt_state, loss,
    grads), the step of repro/launch/steps.py plus its gradient."""
    jcfg = jreduced(jget(arch))
    _, opt_update = jadamw(LR[jcfg.family])
    loss = _jloss(jcfg)
    if jcfg.kind == "resnet":
        def step(params, bn_state, opt_state, images, labels):
            (val, new_bn), grads = jax.value_and_grad(
                lambda p: loss(p, bn_state, images, labels), has_aux=True)(params)
            params, opt_state, _ = opt_update(grads, opt_state, params)
            return params, new_bn, opt_state, val, grads
    else:
        def step(params, opt_state, *batch):
            val, grads = jax.value_and_grad(lambda p: loss(p, *batch))(params)
            params, opt_state, _ = opt_update(grads, opt_state, params)
            return params, opt_state, val, grads
    return jax.jit(step)


def _port_args(cfg, batch):
    """The port step's batch arguments: the key's own t and noise for
    diffusion."""
    if cfg.family == "vision":
        return [torch.from_numpy(a) for a in batch]
    lat, cond, key = batch
    t, noise = _key_draws(key, lat.shape)
    return [torch.from_numpy(a) for a in (lat, cond, t, noise)]


def _jax_args(batch):
    return [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in batch]


def _port_grads(cfg, p, batch):
    """-> (loss, gradient tree, ResNet's new statistics or None)."""
    args = _port_args(cfg, batch)
    if cfg.kind == "resnet":
        params, state = p
        return steps.value_and_grad(lambda q: steps.vision_loss(cfg)(q, state, *args), params)
    loss_fn = steps.vision_loss(cfg) if cfg.family == "vision" else steps.diffusion_loss(cfg)
    return steps.value_and_grad(lambda q: loss_fn(q, *args), p)


def _zero_in_exact_arithmetic(cfg, path):
    """The reduced UNet's time-embedding leaves (see ZERO_GRAD)."""
    leaf = path.rsplit("/", 1)[-1]
    return cfg.kind == "unet" and (leaf.startswith("temb_") or leaf in ("t_w1", "t_b1", "t_w2",
                                                                         "t_b2"))


def _assert_leaves_close(got_tree, want_tree, tol, what, cfg=None):
    paths, got = tree.flatten_with_paths(got_tree)
    want = jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want), what
    top = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for path, g, w in zip(paths, got, want):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape, (what, path)
        scale = float(np.abs(w).max())
        if cfg is not None and _zero_in_exact_arithmetic(cfg, path):
            assert scale < ZERO_NOISE * top, f"{what} {path}: {scale:.3e} is not 0 to rounding"
            scale = ZERO_GRAD * top
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, f"{what} {path}: {err:.3e} > {tol:g} x {scale:.3e}"


@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_matches_reference(arch):
    """The loss within LOSS_RTOL and every gradient leaf within GRAD_TOL
    of its largest magnitude; ResNet's running statistics within
    GRAD_TOL of each leaf's largest."""
    jcfg, jp, cfg, p = _bridged(arch)
    batch = _batch(cfg, 10)
    loss, grads, new_bn = _port_grads(cfg, p, batch)
    jparams = jp[0] if cfg.kind == "resnet" else jp
    opt = jadamw(LR[cfg.family])[0](jparams)
    if cfg.kind == "resnet":
        _, jbn, _, jloss, jgrads = _jstep(arch)(jp[0], jp[1], opt, *_jax_args(batch))
        _assert_leaves_close(new_bn, jbn, GRAD_TOL, "running statistics")
    else:
        _, _, jloss, jgrads = _jstep(arch)(jp, opt, *_jax_args(batch))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(loss.item() - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    _assert_leaves_close(grads, jgrads, GRAD_TOL, f"{arch} gradient", cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_steps_match_reference(arch):
    """Three AdamW steps on one batch: each step's loss within LOSS_RTOL
    of the reference's (the port's ``optim/adamw.py`` against
    ``repro.optim.adamw``)."""
    jcfg, jp, cfg, p = _bridged(arch, seed=1)
    batch = _batch(cfg, 11)
    args = _port_args(cfg, batch)
    if cfg.family == "vision":
        opt_init, step = steps.vision_train(cfg, LR["vision"])
    else:
        opt_init, step = steps.diffusion_train(cfg, LR["diffusion"])
    jstep = _jstep(arch)
    if cfg.kind == "resnet":
        (params, state), (jparams, jstate) = p, jp
        opt, jopt = opt_init(params), jadamw(LR["vision"])[0](jparams)
    else:
        params, jparams = p, jp
        opt, jopt = opt_init(params), jadamw(LR[cfg.family])[0](jparams)
    losses, jlosses = [], []
    for _ in range(3):
        if cfg.kind == "resnet":
            params, state, opt, loss = step(params, state, opt, *args)
            jparams, jstate, jopt, jloss, _ = jstep(jparams, jstate, jopt, *_jax_args(batch))
        else:
            params, opt, loss = step(params, opt, *args)
            jparams, jopt, jloss, _ = jstep(jparams, jopt, *_jax_args(batch))
        losses.append(loss.item())
        jlosses.append(float(jloss))
    assert int(opt.step) == 3
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_donated_steps_equal_the_plain_steps_bit_for_bit(arch):
    """Two steps with ``donate=True`` give the plain steps' losses,
    parameters, moments (and ResNet's statistics) bit for bit, and
    return the tensors they were given, written in place."""
    _, _, cfg, p = _bridged(arch, seed=2)
    args = _port_args(cfg, _batch(cfg, 12))
    make = steps.vision_train if cfg.family == "vision" else steps.diffusion_train
    runs = []
    for donate in (False, True):
        opt_init, step = make(cfg, LR[cfg.family], donate=donate)
        model = tree.map_leaves(torch.clone, p)
        state = (*model, opt_init(model[0])) if cfg.kind == "resnet" else (model, opt_init(model))

        def donated(st):   # every leaf but the optimizer's step count
            return tree.leaves((st[:-1], st[-1].mu, st[-1].nu))
        given = [x.data_ptr() for x in donated(state)]
        losses = []
        for _ in range(2):
            *state, loss = step(*state, *args)
            losses.append(loss)
        if donate:
            assert [x.data_ptr() for x in donated(state)] == given
        assert int(state[-1].step) == 2
        runs.append((losses, tree.leaves(state)))
    (losses, plain), (losses_d, donated_leaves) = runs
    assert all(torch.equal(a, b) for a, b in zip(losses, losses_d))
    assert len(plain) == len(donated_leaves)
    for a, b in zip(plain, donated_leaves):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_gradients_bit_for_bit(arch, monkeypatch):
    """``remat="dots_saveable"`` (the full configs') recomputes each block
    in the backward: the loss, every gradient leaf and ResNet's
    statistics equal those with ``remat="none"`` bit for bit, and the
    checkpoint policy kept matrix products' (and the convnets'
    convolutions') outputs."""
    decided = []

    def recording(ctx, op, *args, **kwargs):
        policy = policy_fn(ctx, op, *args, **kwargs)
        decided.append((op, policy))
        return policy
    policy_fn = L._dots_saveable
    monkeypatch.setattr(L, "_dots_saveable", recording)
    jcfg, jp, cfg, p = _bridged(arch, seed=2)
    batch = _batch(cfg, 12)
    off = _port_grads(cfg, p, batch)
    assert not decided
    on = _port_grads(dataclasses.replace(cfg, remat="dots_saveable"), p, batch)
    assert torch.equal(on[0], off[0])
    for a, b in zip(tree.leaves(on[1]), tree.leaves(off[1])):
        assert torch.equal(a, b)
    if cfg.kind == "resnet":
        for a, b in zip(tree.leaves(on[2]), tree.leaves(off[2])):
            assert torch.equal(a, b)
    saved = {str(op) for op, policy in decided if policy == L.CheckpointPolicy.MUST_SAVE}
    want = {"aten.convolution.default"} if cfg.kind in ("convnext", "resnet", "unet") else set()
    if cfg.kind != "resnet":
        want.add("aten.mm.default")
    assert want <= saved, saved
    assert any(policy == L.CheckpointPolicy.PREFER_RECOMPUTE for _, policy in decided)


def test_train_forward_without_remat_is_the_serving_forward():
    """``train=True`` with ``remat="none"`` (and ``train=False`` with any
    remat) runs the blocks as the serving forward does."""
    for arch in ("vit-l16", "convnext-b"):
        _, _, cfg, p = _bridged(arch)
        images = torch.from_numpy(_batch(cfg, 13)[0])
        mod = MODULES[cfg.kind][1]
        want = mod.forward(p, cfg, images)
        assert torch.equal(mod.forward(p, cfg, images, train=True), want)
        assert torch.equal(mod.forward(p, dataclasses.replace(cfg, remat="dots_saveable"),
                                       images), want)


def test_unstack_unbinds_each_leaf_once():
    stack = {"a": torch.arange(6.0).reshape(3, 2), "b": torch.arange(3.0)}
    layers = L.unstack(stack)
    assert len(layers) == 3 and list(layers[1]) == ["a", "b"]
    assert torch.equal(layers[2]["a"], stack["a"][2]) and layers[2]["b"].item() == 2.0
    x = stack["a"].clone().requires_grad_()
    parts = L.unstack({"x": x})
    (g,) = torch.autograd.grad(sum((i + 1) * p["x"].sum() for i, p in enumerate(parts)), x)
    assert torch.equal(g, torch.tensor([[1.0, 1.0], [2.0, 2.0], [3.0, 3.0]]))


def test_train_loss_matches_reference():
    """``train_loss`` on the key's own t and noise equals the reference's
    ``train_loss(eps_fn, latents, key)`` (an eps_fn of x and t alike on
    both sides)."""
    rng = np.random.default_rng(5)
    lat = rng.standard_normal((4, 8, 8, 4)).astype(np.float32)
    w = rng.standard_normal(4).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jdiffusion.train_loss(lambda x, t: x * jnp.asarray(w) + t[:, None, None, None] * 1e-3,
                                 jnp.asarray(lat), key)
    t, noise = _key_draws(key, lat.shape)
    got = diffusion.train_loss(lambda x, tt: x * torch.from_numpy(w)
                               + tt[:, None, None, None] * 1e-3,
                               torch.from_numpy(lat), torch.from_numpy(t),
                               torch.from_numpy(noise))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert got.item() == pytest.approx(float(want), rel=1e-6)


def test_draw_train_inputs():
    lat = torch.zeros(64, 4, 4, 4)
    t, noise = diffusion.draw_train_inputs(lat, torch.Generator().manual_seed(0))
    assert t.dtype == torch.int32 and t.shape == (64,)
    assert int(t.min()) >= 0 and int(t.max()) < diffusion.N_TRAIN_STEPS
    assert noise.dtype == torch.float32 and noise.shape == lat.shape
    t2, noise2 = diffusion.draw_train_inputs(lat, torch.Generator().manual_seed(0))
    assert torch.equal(t, t2) and torch.equal(noise, noise2)
    assert abs(noise.mean().item()) < 0.1 and abs(noise.std().item() - 1) < 0.1


def test_ce_matches_reference():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((16, 10)).astype(np.float32) * 3
    labels = rng.integers(0, 10, 16).astype(np.int32)
    got = steps.ce(torch.from_numpy(logits).bfloat16(), torch.from_numpy(labels))
    want = _jce(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels))
    assert got.item() == pytest.approx(float(want), rel=1e-6)


def test_configs_keep_the_references_remat():
    for arch in ARCHS:
        assert get_config(arch).remat == jget(arch).remat == "dots_saveable"
        assert reduced(get_config(arch)).remat == jreduced(jget(arch)).remat == "none"


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ARCHS)
def test_chip_smoke_expects_the_attentions_of_a_step(arch, monkeypatch):
    """A reduced step with ``remat`` on calls ``ops.attention`` as often
    as phase 15's ``zoo_attentions`` says (each attention once, and again
    in the recompute but for the UNet's mid block), and its counts at
    full width are 24 / 32 / 0 / 0 / 12 / 32 attentions, 24 / 32 / 0 / 0
    / 12 / 30 again."""
    from repro_torch.kernels import ops
    cs = _chip_smoke()
    _, _, cfg, p = _bridged(arch, remat="dots_saveable")
    calls, attention = [], ops.attention
    monkeypatch.setattr(ops, "attention", lambda *a, **k: calls.append(1) or attention(*a, **k))
    _port_grads(cfg, p, _batch(cfg, 14))
    n, again = cs.zoo_attentions(cfg)
    assert len(calls) == n + again
    assert cs.zoo_attentions(dataclasses.replace(cfg, remat="none")) == (n, 0)
    full = {"vit-l16": (24, 24), "vit-h14": (32, 32), "convnext-b": (0, 0),
            "resnet-152": (0, 0), "dit-s2": (12, 12), "unet-sd15": (32, 30)}
    assert cs.zoo_attentions(get_config(arch)) == full[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_chip_smoke_counts_the_training_flops(arch):
    """Phase 15's bound, ``steps.model_flops`` of the training shape
    (``cls_224`` or ``train_256``, batch 256): 3x the forward's FLOPs by
    the reference's formulas (``_vit_fwd_flops`` and the rest)."""
    from repro.launch import steps as jsteps
    cs = _chip_smoke()
    cfg = get_config(arch)
    shape = cs.ZOO_SHAPE[cfg.family]
    res = 224 if cfg.family == "vision" else 256
    jfn = {"vit": jsteps._vit_fwd_flops, "convnext": jsteps._convnext_fwd_flops,
           "resnet": jsteps._resnet_fwd_flops, "dit": jsteps._dit_fwd_flops,
           "unet": jsteps._unet_fwd_flops}[cfg.kind]
    assert steps.model_flops(arch, shape) == pytest.approx(
        3 * cs.ZOO_BATCH * jfn(jget(arch), res), rel=1e-12)


@pytest.mark.parametrize("arch", ARCHS)
def test_chip_smoke_names_the_same_zero_gradient_leaves(arch):
    """Phase 15's card-vs-CPU check holds to the tree's largest gradient
    only the leaves this file's reference comparison does: the reduced
    UNet's time embedding, and nothing of the other models."""
    cs = _chip_smoke()
    _, _, cfg, p = _bridged(arch)
    paths = tree.flatten_with_paths(p[0] if cfg.kind == "resnet" else p)[0]
    named = [path for path in paths if _zero_in_exact_arithmetic(cfg, path)]
    assert [path for path in paths if cs.zoo_zero_grad(cfg, path)] == named
    assert bool(named) == (cfg.kind == "unet")
