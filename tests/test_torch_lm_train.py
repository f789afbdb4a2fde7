"""The port's LM training against the reference, on the CPU.

For the dense LMs (qwen3-8b, phi4-mini-3.8b), reduced and in float32
(``reduced()``: 2 layers, 4 / 2 heads of 16), from the reference's own
seeded weights carried over by ``tree.from_numpy``: ``lm.loss_fn``'s
loss, ``ce`` and ``aux`` and every gradient leaf against
``jax.value_and_grad(repro.models.lm.loss_fn, has_aux=True)``; the losses
of 3 consecutive ``steps.lm_train`` steps, with ``grad_accum`` 1 and 2,
against the reference's ``_lm_train`` step body rebuilt from ``repro``'s
modules (the scan over micro-batches included); donated steps equal to
the plain steps bit for bit; gradients with ``remat`` "dots_saveable" and
"full" equal to those without it bit for bit. ``loss_fn``'s value for
the reduced MoE and MLA configs (forward only; their gradients against
the reference are tests/test_torch_moe_train.py's). The codecs of
``optim/compress.py`` against ``repro.optim.compress``: the int8 codec
bit for bit when handed ``jax.random.uniform``'s own draws, top-k on
distinct magnitudes. ``launch/train.py``: ``build_lm_trainer`` under
``run_training`` against the reference's over 3 steps, a resume from its
checkpoint, and ``main`` on the CPU. Inputs are made from a seed with
numpy.
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
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro.optim import compress as jcompress
from repro.optim.adamw import adamw as jadamw
from repro.runtime import supervisor as jsupervisor
from repro_torch import tree
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.launch import steps, train
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.optim import compress
from repro_torch.runtime import supervisor

# one intra-op thread, as in the other port tests run by parallel workers
torch.set_num_threads(1)

DENSE = ("qwen3-8b", "phi4-mini-3.8b")
MOE = ("qwen2-moe-a2.7b", "deepseek-v2-lite-16b")
# loss: relative; a gradient leaf: within GRAD_TOL of its largest
# magnitude (float32 sums in another order), tests/test_torch_zoo_train.py's
# tolerances; the MoE aux loss: absolute, tests/test_torch_moe.py's
LOSS_RTOL, GRAD_TOL, AUX_ATOL = 1e-5, 1e-4, 1e-6
B, S = 4, 16
LR = 1e-4   # the reference's _lm_train rate


def _bridged(arch, seed=0, remat="none"):
    """(reference config, reference tree, port config, port tree)."""
    jcfg = jreduced(jget(arch))
    cfg = dataclasses.replace(reduced(get_config(arch)), remat=remat)
    jp = jlm.init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, cfg, tree.from_numpy(jp, device="cpu")


def _tokens(cfg, seed, b=B, s=S):
    """Seeded tokens and ``labels = roll(tokens, -1)``, as the reference's
    ``data_fn`` makes them."""
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


@functools.lru_cache(maxsize=None)
def _jgrad(arch):
    jcfg = jreduced(jget(arch))
    return jax.jit(lambda p, t, l: jax.value_and_grad(jlm.loss_fn, has_aux=True)(p, jcfg, t, l))


@functools.lru_cache(maxsize=None)
def _jstep(arch, accum):
    """The reference's ``_lm_train`` step body (repro/launch/steps.py)
    without its shardings, jitted."""
    jcfg = jreduced(jget(arch))
    _, opt_update = jadamw(LR)

    def step(params, opt_state, tokens, labels):
        b, s = tokens.shape
        if accum > 1:
            mb_tok = tokens.reshape(accum, b // accum, s)
            mb_lab = labels.reshape(accum, b // accum, s)

            def micro(carry, xs):
                g_acc, l_acc = carry
                t, l = xs
                (loss, _), g = jax.value_and_grad(jlm.loss_fn, has_aux=True)(
                    params, jcfg, t, l)
                g_acc = jax.tree_util.tree_map(
                    lambda a, x: a + x.astype(jnp.float32) / accum, g_acc, g)
                return (g_acc, l_acc + loss / accum), None

            zeros = jax.tree_util.tree_map(lambda x: jnp.zeros(x.shape, jnp.float32), params)
            (grads, loss), _ = jax.lax.scan(micro, (zeros, 0.0), (mb_tok, mb_lab))
        else:
            (loss, _), grads = jax.value_and_grad(jlm.loss_fn, has_aux=True)(
                params, jcfg, tokens, labels)
        params, opt_state, _ = opt_update(grads, opt_state, params)
        return params, opt_state, loss
    return jax.jit(step)


def _port_grads(cfg, p, tokens, labels):
    t, l = torch.from_numpy(tokens), torch.from_numpy(labels)
    return steps.value_and_grad(lambda q: lm.loss_fn(q, cfg, t, l), p)


def _assert_leaves_close(got_tree, want_tree, tol, what):
    paths, got = tree.flatten_with_paths(got_tree)
    want = jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want), what
    for path, g, w in zip(paths, got, want):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape, (what, path)
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, f"{what} {path}: {err:.3e} > {tol:g} x {scale:.3e}"


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_gradients_match_reference(arch):
    """``loss_fn``'s loss and ``ce`` within LOSS_RTOL, ``aux`` 0 (no
    MoE), every gradient leaf within GRAD_TOL of its largest magnitude."""
    jcfg, jp, cfg, p = _bridged(arch)
    tokens, labels = _tokens(cfg, 10)
    loss, grads, aux = _port_grads(cfg, p, tokens, labels)
    (jloss, jaux), jgrads = _jgrad(arch)(jp, jnp.asarray(tokens), jnp.asarray(labels))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert loss.item() == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert aux["ce"].item() == pytest.approx(float(jaux["ce"]), rel=LOSS_RTOL)
    assert aux["aux"].item() == float(jaux["aux"]) == 0.0
    _assert_leaves_close(grads, jgrads, GRAD_TOL, f"{arch} gradient")


@pytest.mark.parametrize("arch", MOE)
def test_loss_fn_of_moe_and_mla_matches_reference(arch):
    """The reduced qwen2-moe and deepseek (MLA) configs' loss, ``ce``
    within LOSS_RTOL and ``aux`` within AUX_ATOL: the loss adds 0.01 x
    the MoE layers' aux loss (forward only; their gradients are
    tests/test_torch_moe_train.py's)."""
    jcfg, jp, cfg, p = _bridged(arch)
    tokens, labels = _tokens(cfg, 11)
    with torch.no_grad():
        loss, parts = lm.loss_fn(p, cfg, torch.from_numpy(tokens), torch.from_numpy(labels))
    jloss, jparts = jax.jit(lambda q, t, l: jlm.loss_fn(q, jcfg, t, l))(
        jp, jnp.asarray(tokens), jnp.asarray(labels))
    assert parts["aux"].item() > 0
    assert abs(parts["aux"].item() - float(jparts["aux"])) <= AUX_ATOL
    assert parts["ce"].item() == pytest.approx(float(jparts["ce"]), rel=LOSS_RTOL)
    assert loss.item() == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert torch.equal(loss, parts["ce"] + 0.01 * parts["aux"])


def test_the_labels_logit_is_the_one_hot_contraction():
    """``loss_fn`` gathers the label's logit where the reference contracts
    a one-hot: in float32 the contraction's other terms are exact zeros,
    so the two are equal bit for bit."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    onehot = jax.nn.one_hot(jnp.asarray(labels), 50, dtype=jnp.float32)
    want = np.asarray(jnp.einsum("bsv,bsv->bs", jnp.asarray(logits), onehot))
    got = torch.gather(torch.from_numpy(logits), -1, torch.from_numpy(labels).long()[..., None])
    np.testing.assert_array_equal(got[..., 0].numpy(), want)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", DENSE)
def test_three_lm_train_steps_match_reference(arch, accum):
    """Three ``lm_train`` steps on one batch of B rows: each loss within
    LOSS_RTOL of the reference's step body, with ``grad_accum`` 1 and 2
    (two micro-batches of B / 2 rows, the gradient summed in float32)."""
    jcfg, jp, cfg, p = _bridged(arch, seed=1)
    tokens, labels = _tokens(cfg, 12)
    opt_init, step = steps.lm_train(cfg, LR, grad_accum=accum)
    params, opt = p, opt_init(p)
    jparams, jopt = jp, jadamw(LR)[0](jp)
    losses, jlosses = [], []
    for _ in range(3):
        params, opt, loss = step(params, opt, torch.from_numpy(tokens), torch.from_numpy(labels))
        jparams, jopt, jloss = _jstep(arch, accum)(jparams, jopt, jnp.asarray(tokens),
                                                   jnp.asarray(labels))
        losses.append(loss.item())
        jlosses.append(float(jloss))
    assert int(opt.step) == 3 and loss.dtype == torch.float32
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", DENSE)
def test_donated_lm_steps_equal_the_plain_steps_bit_for_bit(arch, accum):
    """Two steps with ``donate=True`` (AdamW in place, slice by slice)
    give the plain steps' losses, parameters and moments bit for bit, and
    return the tensors they were given, written in place."""
    _, _, cfg, p = _bridged(arch, seed=2)
    tokens, labels = (torch.from_numpy(a) for a in _tokens(cfg, 13))
    runs = []
    for donate in (False, True):
        opt_init, step = steps.lm_train(cfg, LR, grad_accum=accum, donate=donate)
        params = tree.map_leaves(torch.clone, p)
        state = (params, opt_init(params))

        def donated(st):   # every leaf but the optimizer's step count
            return tree.leaves((st[0], st[1].mu, st[1].nu))
        given = [x.data_ptr() for x in donated(state)]
        losses = []
        for _ in range(2):
            *state, loss = step(*state, tokens, labels)
            losses.append(loss)
        if donate:
            assert [x.data_ptr() for x in donated(state)] == given
        assert int(state[1].step) == 2
        runs.append((losses, tree.leaves(state)))
    (losses, plain), (losses_d, donated_leaves) = runs
    assert all(torch.equal(a, b) for a, b in zip(losses, losses_d))
    assert len(plain) == len(donated_leaves)
    for a, b in zip(plain, donated_leaves):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_in_place_adamw_takes_the_leaves_slice_by_slice(monkeypatch):
    """With slices of a few elements (``CHUNK`` patched to 7, so every
    leaf is cut, unevenly, and groups span leaves) the in-place update
    still equals the functional one bit for bit, bf16 leaves included,
    and the functional one leaves its arguments as they were."""
    from repro_torch.optim import adamw
    monkeypatch.setattr(adamw, "CHUNK", 7)
    rng = np.random.default_rng(4)
    params = {"a": torch.from_numpy(rng.standard_normal((5, 6)).astype(np.float32)),
              "b": torch.from_numpy(rng.standard_normal(17).astype(np.float32)).bfloat16()}
    grads = tree.map_leaves(lambda x: torch.from_numpy(
        rng.standard_normal(tuple(x.shape)).astype(np.float32)).to(x.dtype) * 3, params)
    init, update = adamw.adamw(1e-2)
    given = [x.clone() for x in tree.leaves(params)]
    want_p, want_s, want_m = update(grads, init(params), params)
    assert all(torch.equal(a, b) for a, b in zip(given, tree.leaves(params)))
    state = init(params)
    got_p, got_s, got_m = update(grads, state, params, in_place=True)
    assert got_p is params and got_s.mu is state.mu
    for a, b in zip(tree.leaves((want_p, want_s)), tree.leaves((got_p, got_s))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(want_m["grad_norm"], got_m["grad_norm"])


@pytest.mark.parametrize("remat", ["dots_saveable", "full"])
@pytest.mark.parametrize("arch", DENSE)
def test_remat_gives_the_same_lm_gradients_bit_for_bit(arch, remat, monkeypatch):
    """``remat`` "dots_saveable" (the full configs') and "full" recompute
    each block in the backward: the loss and every gradient leaf equal
    those with ``remat="none"`` bit for bit; each block's attention runs
    again in the recompute; "dots_saveable" keeps the products' outputs,
    "full" goes through no selective policy (it saves nothing)."""
    decided, calls = [], []

    def recording(ctx, op, *args, **kwargs):
        policy = policy_fn(ctx, op, *args, **kwargs)
        decided.append((op, policy))
        return policy
    policy_fn = L._dots_saveable
    monkeypatch.setattr(L, "_dots_saveable", recording)
    attention = ops.attention
    monkeypatch.setattr(ops, "attention", lambda *a, **k: calls.append(1) or attention(*a, **k))
    _, _, cfg, p = _bridged(arch, seed=3)
    tokens, labels = _tokens(cfg, 14)
    off = _port_grads(cfg, p, tokens, labels)
    assert not decided and len(calls) == cfg.n_layers
    calls.clear()
    on = _port_grads(dataclasses.replace(cfg, remat=remat), p, tokens, labels)
    assert len(calls) == 2 * cfg.n_layers
    assert torch.equal(on[0], off[0])
    for a, b in zip(tree.leaves(on[1]), tree.leaves(off[1])):
        assert torch.equal(a, b)
    saved = {str(op) for op, policy in decided if policy == L.CheckpointPolicy.MUST_SAVE}
    if remat == "full":
        assert not decided
    else:
        assert "aten.mm.default" in saved, saved
        assert any(policy == L.CheckpointPolicy.PREFER_RECOMPUTE for _, policy in decided)


@pytest.mark.parametrize("arch", MOE)
def test_moe_and_mla_blocks_under_remat_give_the_same_loss_and_gradients(arch):
    """The full configs' ``remat`` wraps the MoE and MLA blocks too: on
    the CPU the loss, its parts and every gradient leaf equal those
    without it bit for bit."""
    _, _, cfg, p = _bridged(arch, seed=7)
    tokens, labels = _tokens(cfg, 17)
    off = _port_grads(cfg, p, tokens, labels)
    on = _port_grads(dataclasses.replace(cfg, remat="dots_saveable"), p, tokens, labels)
    assert torch.equal(on[0], off[0]) and torch.equal(on[2]["aux"], off[2]["aux"])
    for a, b in zip(tree.leaves(on[1]), tree.leaves(off[1])):
        assert torch.equal(a, b)


def test_train_forward_without_remat_is_the_serving_trunk():
    """``forward_train`` with ``remat="none"`` equals the one with
    "dots_saveable" outside autograd, and each layer reads the stack's
    slice: the logits equal those of the layers run one by one."""
    _, _, cfg, p = _bridged("qwen3-8b")
    tokens = torch.from_numpy(_tokens(cfg, 15)[0])
    with torch.no_grad():
        want = lm.forward_train(p, cfg, tokens)[0]
        got = lm.forward_train(p, dataclasses.replace(cfg, remat="dots_saveable"), tokens)[0]
    assert torch.equal(got, want)


def test_unstack_takes_nested_stacks():
    """``layers.unstack`` on an LM's nested stack (attention and MLP dicts
    inside a layer's): each leaf unbound once into views."""
    stack = {"a": {"w": torch.arange(6.0).reshape(3, 2)}, "b": torch.arange(3.0)}
    layers = L.unstack(stack)
    assert len(layers) == 3 and list(layers[1]) == ["a", "b"]
    assert torch.equal(layers[2]["a"]["w"], stack["a"]["w"][2]) and layers[2]["b"].item() == 2.0
    assert layers[1]["a"]["w"].data_ptr() == stack["a"]["w"][1].data_ptr()   # a view
    x = stack["a"]["w"].clone().requires_grad_()
    parts = L.unstack({"x": x})
    (g,) = torch.autograd.grad(sum((i + 1) * q["x"].sum() for i, q in enumerate(parts)), x)
    assert torch.equal(g, torch.tensor([[1.0, 1.0], [2.0, 2.0], [3.0, 3.0]]))


def test_tree_walks_leave_no_reference_cycles():
    """``tree.leaves``, ``unflatten`` and ``map_leaves`` make no reference
    cycle: a state dropped after a donated step is freed at once, without
    the cyclic collector (a full-width LM's old state, 38 GB, must go
    before a new one is drawn)."""
    import gc
    import weakref
    _, _, cfg, p = _bridged("phi4-mini-3.8b", seed=6, remat="dots_saveable")
    tokens, labels = (torch.from_numpy(a) for a in _tokens(cfg, 16))
    opt_init, step = steps.lm_train(cfg, LR, donate=True)
    # a first step, so that torch's lazy imports on the first checkpoint
    # call (whose module code makes cycles of its own frames) are done
    params = tree.map_leaves(torch.clone, p)
    step(params, opt_init(params), tokens, labels)
    gc.collect()
    params = tree.map_leaves(torch.clone, p)
    state = (params, opt_init(params))
    refs = [weakref.ref(x) for x in tree.leaves((state[0], state[1].mu, state[1].nu))]
    was = gc.isenabled()
    gc.disable()
    try:
        *state, _ = step(*state, tokens, labels)
        del state, params
        assert not any(r() is not None for r in refs)
    finally:
        if was:
            gc.enable()


def test_lm_configs_keep_the_references_remat():
    for arch in DENSE + MOE:
        assert get_config(arch).remat == jget(arch).remat == "dots_saveable"
        assert reduced(get_config(arch)).remat == jreduced(jget(arch)).remat == "none"


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

CODEC_SHAPES = [(7,), (5, 13), (3, 4, 33), (256,)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", CODEC_SHAPES)
def test_int8_codec_matches_reference_bit_for_bit(shape, dtype):
    """Handed ``jax.random.uniform(key, shape)``, the draws the reference
    makes inside ``int8_encode``, the port's rounding gives the
    reference's q and scale, and the decode its values, bit for bit."""
    rng = np.random.default_rng(sum(shape))
    g = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
    key = jax.random.PRNGKey(len(shape))
    jg = jnp.asarray(g, getattr(jnp, dtype))
    jq, jscale = jcompress.int8_encode(jg, key)
    r = torch.from_numpy(np.array(jax.random.uniform(key, shape)))
    tg = torch.from_numpy(np.asarray(jg.astype(jnp.float32))).to(getattr(torch, dtype))
    q, scale = compress.int8_encode_draws(tg, r)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert scale.item() == float(jscale)
    np.testing.assert_array_equal(compress.int8_decode(q, scale).numpy(),
                                  np.asarray(jcompress.int8_decode(jq, jscale)))


def test_int8_roundtrip_tree_draws_from_the_generator():
    """Each leaf decoded within one step of its scale of the gradient, in
    float32 and its shape; the same seed gives the same bits; the mean of
    many roundtrips tends to the gradient (stochastic rounding is
    unbiased)."""
    rng = np.random.default_rng(5)
    grads = {"w": torch.from_numpy(rng.standard_normal((6, 9)).astype(np.float32)),
             "b": torch.from_numpy(rng.standard_normal(9).astype(np.float32)).bfloat16()}
    out = compress.int8_roundtrip_tree(grads, torch.Generator().manual_seed(0))
    again = compress.int8_roundtrip_tree(grads, torch.Generator().manual_seed(0))
    for g, o, a in zip(tree.leaves(grads), tree.leaves(out), tree.leaves(again)):
        scale = g.float().abs().max() / 127
        assert o.dtype == torch.float32 and o.shape == g.shape and torch.equal(o, a)
        assert float((o - g.float()).abs().max()) <= float(scale) * (1 + 1e-6)
    gen = torch.Generator().manual_seed(1)
    mean = sum(compress.int8_roundtrip_tree(grads, gen)["w"] for _ in range(400)) / 400
    scale = float(grads["w"].abs().max() / 127)
    assert float((mean - grads["w"]).abs().max()) < 0.15 * scale


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5])
def test_topk_matches_reference_on_distinct_magnitudes(frac):
    """On distinct magnitudes ``torch.topk`` picks ``jax.lax.top_k``'s
    entries in its order: values, indices, residual and the decode equal
    (ties, where the two may pick other indices, are left out)."""
    rng = np.random.default_rng(6)
    g = rng.standard_normal((12, 17)).astype(np.float32)
    assert len(np.unique(np.abs(g))) == g.size
    jvals, jidx, jres = jcompress.topk_encode(jnp.asarray(g), frac)
    vals, idx, res = compress.topk_encode(torch.from_numpy(g), frac)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
    np.testing.assert_array_equal(compress.topk_decode(vals, idx, g.shape).numpy(),
                                  np.asarray(jcompress.topk_decode(jvals, jidx, g.shape)))


def test_topk_roundtrip_tree_matches_reference():
    """Error feedback over a tree, two rounds: the decoded gradients and
    the residuals equal the reference's (distinct magnitudes)."""
    rng = np.random.default_rng(7)
    grads = {"a": rng.standard_normal((8, 5)).astype(np.float32),
             "b": rng.standard_normal(30).astype(np.float32)}
    res = {k: np.zeros_like(v) for k, v in grads.items()}
    jres = {k: jnp.asarray(v) for k, v in res.items()}
    tres = tree.map_leaves(torch.from_numpy, res)
    for _ in range(2):
        jdec, jres = jcompress.topk_roundtrip_tree(
            {k: jnp.asarray(v) for k, v in grads.items()}, jres, 0.2)
        dec, tres = compress.topk_roundtrip_tree(tree.map_leaves(torch.from_numpy, grads),
                                                 tres, 0.2)
        for a, b in zip(tree.leaves((dec, tres)), jax.tree_util.tree_leaves((jdec, jres))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_topk_keeps_k_of_tied_magnitudes():
    """Among equal magnitudes the choice of index may differ from the
    reference's; the kept count and magnitudes do not."""
    g = torch.tensor([1.0, -1.0, 1.0, 0.5, -1.0, 0.25])
    vals, idx, res = compress.topk_encode(g, 0.5)
    assert len(idx) == 3 and torch.equal(vals.abs(), torch.ones(3))
    assert torch.equal(res.abs().sort().values, torch.tensor([0.0, 0.0, 0.0, 0.25, 0.5, 1.0]))


# ---------------------------------------------------------------------------
# launch/train.py under the supervisor
# ---------------------------------------------------------------------------

def _data_fn(cfg):
    return lambda step: _tokens(cfg, 100 + step, b=2, s=S)


def test_build_lm_trainer_matches_reference(tmp_path):
    """Three steps of ``build_lm_trainer`` under ``run_training`` (reduced
    qwen3-8b from the reference's weights, the cosine schedule with
    warm-up) give the reference trainer's losses within LOSS_RTOL."""
    jcfg, jp, cfg, p = _bridged("qwen3-8b", seed=4)
    jstep_fn, jopt_init = jtrain.build_lm_trainer(jcfg, None, total_steps=3)
    _, jreport = jsupervisor.run_training(
        (jp, jopt_init(jp), jax.random.PRNGKey(0)), jstep_fn, _data_fn(cfg),
        jsupervisor.SupervisorConfig(ckpt_dir=str(tmp_path / "ref"), max_steps=3,
                                     async_save=False))
    step_fn, opt_init = train.build_lm_trainer(cfg, total_steps=3, device="cpu")
    gen = torch.Generator().manual_seed(0)
    _, report = supervisor.run_training(
        (p, opt_init(p), gen.get_state()), step_fn, _data_fn(cfg),
        supervisor.SupervisorConfig(ckpt_dir=str(tmp_path / "port"), max_steps=3,
                                    async_save=False))
    assert report.steps_run == jreport.steps_run == 3 and report.rejected_steps == 0
    np.testing.assert_allclose(report.losses, jreport.losses, rtol=LOSS_RTOL)


def test_build_lm_trainer_resumes_from_its_checkpoint(tmp_path):
    """Two steps with a checkpoint after each, then a new run to 4 steps
    from fresh weights over the same folder: it resumes from step 2
    (``resumed_from``), and its steps 3 and 4 give the losses of an
    uninterrupted 4-step run bit for bit (the state, the generator's
    included, restored exactly). With ``compress`` each step draws the
    codec's uniforms from the state's generator."""
    _, _, cfg, p = _bridged("phi4-mini-3.8b", seed=5)
    step_fn, opt_init = train.build_lm_trainer(cfg, total_steps=4, compress=True,
                                               device="cpu")

    def fresh():
        params = tree.map_leaves(torch.clone, p)
        return params, opt_init(params), torch.Generator().manual_seed(0).get_state()

    def run(folder, max_steps):
        return supervisor.run_training(
            fresh(), step_fn, _data_fn(cfg),
            supervisor.SupervisorConfig(ckpt_dir=str(folder), ckpt_every=1,
                                        max_steps=max_steps, async_save=False))
    _, whole = run(tmp_path / "whole", 4)
    _, first = run(tmp_path / "cut", 2)
    state, second = run(tmp_path / "cut", 4)
    assert first.resumed_from is None and second.resumed_from == 2
    assert second.steps_run == 2 and int(state[1].step) == 4
    assert first.losses + second.losses == whole.losses
    assert all(np.isfinite(whole.losses))


def test_main_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    """``main`` with the reference's flags (``--device cpu``): 3 steps with
    a checkpoint at step 2 and at the end, then 5 steps over the same
    folder, which resume from step 3."""
    folder = str(tmp_path / "ckpt")
    args = ["--steps", "3", "--batch", "2", "--seq", "16", "--ckpt-dir", folder,
            "--ckpt-every", "2", "--device", "cpu"]
    report = train.main(args)
    assert report.steps_run == 3 and report.resumed_from is None
    report = train.main(args[:1] + ["5"] + args[2:] + ["--compress"])
    assert report.steps_run == 2 and report.resumed_from == 3
    assert all(np.isfinite(report.losses))
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("steps=3 resumed_from=None") and "resumed_from=3" in out[1]


def test_trainer_and_main_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("qwen3-8b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        train.build_lm_trainer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--steps", "1"])


def test_the_references_lm_flops_formula():
    """chip_smoke's phase 16 bound, ``steps.cell_flops`` of ``train_4k``
    at a cut batch: the reference's ``model_flops`` (3x the forward's
    matmul FLOPs over active parameters plus causal attention's half), at
    any batch."""
    import dataclasses
    from repro_torch.configs import get_shape
    for arch in DENSE + MOE:
        want = jsteps.model_flops(arch, "train_4k")
        shape = get_shape(arch, "train_4k")
        assert steps.cell_flops(get_config(arch), shape) == pytest.approx(want, rel=1e-12)
        one_row = dataclasses.replace(shape, global_batch=1)
        assert steps.cell_flops(get_config(arch), one_row) * 256 == pytest.approx(
            want, rel=1e-12)
