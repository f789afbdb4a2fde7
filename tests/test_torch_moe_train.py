"""MoE and MLA LM training of the port against the reference, on the CPU.

For the reduced MoE configs (``reduced()``: 2 layers, heads of 16, MLA
heads of 16 + 8, 8 routed experts top-2, float32), from the reference's
own seeded weights carried over by ``tree.from_numpy``, with inputs made
from a seed with numpy:

- ``lm.loss_fn``'s loss, ``ce``, ``aux`` and every gradient leaf, the
  routers' included, against ``jax.value_and_grad(repro.models.lm.loss_fn,
  has_aux=True)`` at ``tests/test_torch_lm_train.py``'s tolerances,
  drop-free (the reduced configs' capacity factor) and at the published
  capacity factor 1.25, where copies are dropped;
- three ``steps.lm_train`` steps against the reference's ``_lm_train``
  step body; donated steps equal to the plain ones bit for bit, with
  drops and padded experts (whose gradient is 0); ``launch/train.py``'s
  ``main --arch`` with either model;
- ``moe_block`` itself: its forward equal to an ``index_copy_`` /
  ``index_select`` formulation of the same dispatch (whose gradient adds
  with ``index_add_``), its gradients equal to autograd's through a plain
  dense dispatch (every expert on every token, masked by the kept
  copies), each gather's backward the transpose of its forward (a dropped
  copy gets a zero gradient, an empty slot none), and its backward free
  of scatter-adds over repeated indices (the ops it dispatches, recorded).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import test_torch_lm_train as lm_train_test
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import lm as jlm
from repro_torch import tree
from repro_torch.configs import get_config, reduced
from repro_torch.launch import steps
from repro_torch.models import layers as L
from repro_torch.models import lm, moe

# one intra-op thread, as in the other port tests run by parallel workers
torch.set_num_threads(1)

MOE = lm_train_test.MOE
LOSS_RTOL, GRAD_TOL, AUX_ATOL = (lm_train_test.LOSS_RTOL, lm_train_test.GRAD_TOL,
                                 lm_train_test.AUX_ATOL)
LR = lm_train_test.LR
# the reduced configs' own capacity factor (n_routed: provably drop-free)
# and the published one
CAPACITY = {"drop_free": None, "published": 1.25}
# the port's dispatch, which the scatter formulation below takes its
# routing from while it stands in for it
DISPATCH = moe._dispatch


def _configs(arch, capacity_factor=None):
    """(reference config, port config), reduced, at ``capacity_factor``
    (None: the reduced one)."""
    jcfg, cfg = jreduced(jget(arch)), reduced(get_config(arch))
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _jgrad(arch, capacity_factor):
    jcfg, _ = _configs(arch, capacity_factor)
    return jax.jit(lambda p, t, l: jax.value_and_grad(jlm.loss_fn, has_aux=True)(p, jcfg, t, l))


class _Drops:
    """While active, counts the (token, k) copies ``moe._dispatch`` routes
    and those it drops."""

    def __enter__(self):
        self.copies = self.dropped = 0
        self._orig = orig = moe._dispatch

        def dispatch(*args):
            buf, meta = orig(*args)
            self.copies += meta[2].numel()
            self.dropped += int((~meta[2]).sum())
            return buf, meta
        moe._dispatch = dispatch
        return self

    def __exit__(self, *exc):
        moe._dispatch = self._orig
        return False


@pytest.mark.parametrize("capacity", list(CAPACITY))
@pytest.mark.parametrize("arch", MOE)
def test_loss_and_gradients_match_reference(arch, capacity):
    """The loss and ``ce`` within LOSS_RTOL, ``aux`` within AUX_ATOL (and
    > 0), every gradient leaf, each router's included, within GRAD_TOL of
    its largest magnitude; at the published capacity factor some copies
    are dropped, none in the drop-free config."""
    jcfg, cfg = _configs(arch, CAPACITY[capacity])
    jp = jlm.init(jax.random.PRNGKey(20), jcfg)
    p = tree.from_numpy(jp, device="cpu")
    tokens, labels = lm_train_test._tokens(cfg, 21)
    with _Drops() as drops:
        loss, grads, aux = lm_train_test._port_grads(cfg, p, tokens, labels)
    (jloss, jaux), jgrads = _jgrad(arch, CAPACITY[capacity])(jp, jnp.asarray(tokens),
                                                            jnp.asarray(labels))
    assert (drops.dropped > 0) == (capacity == "published"), drops.dropped
    assert aux["aux"].item() > 0
    assert abs(aux["aux"].item() - float(jaux["aux"])) <= AUX_ATOL
    assert aux["ce"].item() == pytest.approx(float(jaux["ce"]), rel=LOSS_RTOL)
    assert loss.item() == pytest.approx(float(jloss), rel=LOSS_RTOL)
    paths, leaves = tree.flatten_with_paths(grads)
    routers = [g for path, g in zip(paths, leaves) if "router" in str(path)]
    assert routers and all(float(g.abs().max()) > 0 for g in routers)
    lm_train_test._assert_leaves_close(grads, jgrads, GRAD_TOL, f"{arch} {capacity} gradient")


@pytest.mark.parametrize("arch", MOE)
def test_three_lm_train_steps_match_reference(arch):
    """Three ``lm_train`` steps on one batch (``grad_accum`` 1): each loss
    within LOSS_RTOL of the reference's step body, the AdamW moments of
    the routers within GRAD_TOL of the reference's."""
    jcfg, jp, cfg, p = lm_train_test._bridged(arch, seed=22)
    tokens, labels = lm_train_test._tokens(cfg, 23)
    opt_init, step = steps.lm_train(cfg, LR)
    params, opt = p, opt_init(p)
    jparams, jopt = jp, lm_train_test.jadamw(LR)[0](jp)
    losses, jlosses = [], []
    for _ in range(3):
        params, opt, loss = step(params, opt, torch.from_numpy(tokens), torch.from_numpy(labels))
        jparams, jopt, jloss = lm_train_test._jstep(arch, 1)(jparams, jopt, jnp.asarray(tokens),
                                                             jnp.asarray(labels))
        losses.append(loss.item())
        jlosses.append(float(jloss))
    assert int(opt.step) == 3
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    lm_train_test._assert_leaves_close(opt.mu, jopt.mu, GRAD_TOL, f"{arch} first moments")


@pytest.mark.parametrize("arch", MOE)
def test_donated_moe_steps_equal_the_plain_steps_bit_for_bit(arch):
    """Two donated steps (AdamW in place) at capacity factor 1.25, with
    qwen2-moe's routed experts padded (8 to 12, as 60 to 64): the plain
    steps' losses, parameters and moments bit for bit; the padded experts'
    gradient is exactly 0."""
    _, _, cfg, p = lm_train_test._bridged(arch, seed=24)
    pad = dict(pad_experts_to=12) if arch == MOE[0] else {}
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.25, **pad))
    if pad:   # the padded experts' weights, seeded
        g = torch.Generator().manual_seed(25)
        stack = p["blocks_moe"]["moe"]
        for name in ("w_gate", "w_up", "w_down"):
            extra = torch.randn((*stack[name].shape[:1], 4, *stack[name].shape[2:]), generator=g)
            stack[name] = torch.cat([stack[name], extra * stack[name].std()], 1)
    tokens, labels = (torch.from_numpy(a) for a in lm_train_test._tokens(cfg, 26))
    _, grads, _ = steps.value_and_grad(lambda q: lm.loss_fn(q, cfg, tokens, labels), p)
    if pad:
        for name in ("w_gate", "w_up", "w_down"):
            g = grads["blocks_moe"]["moe"][name]
            assert torch.count_nonzero(g[:, 8:]) == 0 and torch.count_nonzero(g[:, :8]) > 0
    runs = []
    for donate in (False, True):
        opt_init, step = steps.lm_train(cfg, LR, donate=donate)
        params = tree.map_leaves(torch.clone, p)
        state = (params, opt_init(params))
        losses = []
        for _ in range(2):
            *state, loss = step(*state, tokens, labels)
            losses.append(loss)
        runs.append((losses, tree.leaves(state)))
    (losses, plain), (losses_d, donated) = runs
    assert all(torch.equal(a, b) for a, b in zip(losses, losses_d))
    assert len(plain) == len(donated)
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(plain, donated))


@pytest.mark.parametrize("arch", MOE)
def test_main_trains_the_moe_archs_on_the_cpu(arch, tmp_path):
    """``launch/train.py``'s ``main --arch`` with either MoE LM (reduced,
    ``--device cpu``): 2 steps, finite losses, no step rejected."""
    from repro_torch.launch import train
    report = train.main(["--arch", arch, "--steps", "2", "--batch", "2", "--seq", "16",
                         "--ckpt-dir", str(tmp_path / "ckpt"), "--device", "cpu"])
    assert report.steps_run == 2 and report.rejected_steps == 0
    assert all(np.isfinite(report.losses))


# ---------------------------------------------------------------------------
# moe_block alone
# ---------------------------------------------------------------------------

def _block(arch="qwen2-moe-a2.7b", capacity_factor=0.5, pad_to=12, seed=30, b=2, s=24):
    """The reduced config (float32, or ``capacity_factor`` and routed
    experts padded to ``pad_to``: copies dropped), layer 0's MoE weights
    of the reference's seeded init, and a seeded input (B, S, D)."""
    jcfg, cfg = _configs(arch, capacity_factor)
    changes = dict(pad_experts_to=pad_to) if pad_to else {}
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **changes))
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **changes))
    jp = jlm.init(jax.random.PRNGKey(seed), jcfg)
    p = tree.from_numpy(jax.tree_util.tree_map(lambda a: a[0], jp["blocks_moe"]["moe"]),
                        device="cpu")
    x = np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return cfg, p, torch.from_numpy(x)


def _scatter_dispatch(xg, probs, k, n_exp, cap):
    """The same dispatch by ``index_select`` of each copy's token and
    ``index_copy_`` into its slot (the dropped ones onto the dump row, cut
    off), and its combine by ``index_select`` of each copy's slot (row 0
    for a dropped one) times the kept mask: autograd's gradient of it adds
    with ``index_add_`` over repeated indices."""
    order, slot, valid, topw, tok = DISPATCH(xg.detach(), probs.detach(), k, n_exp, cap)[1][:5]
    topw = torch.topk(probs, k, dim=-1).values
    topw = topw / (torch.sum(topw, -1, keepdim=True) + 1e-9)
    g, s, d = xg.shape
    rows = n_exp * cap + 1
    base = torch.arange(g)[:, None]
    src = xg.reshape(g * s, d).index_select(0, (base * s + tok).reshape(-1))
    buf = xg.new_zeros(g * rows, d).index_copy(0, (base * rows + slot).reshape(-1), src)
    return buf.view(g, rows, d)[:, : n_exp * cap], (order, slot, valid, topw, tok)


def _scatter_combine(y_flat, meta, s, k):
    order, slot, valid, topw, tok = meta
    g, n, d = y_flat.shape
    inv = torch.argsort(order, dim=-1)
    pos = torch.sort(inv.view(g, s, k), dim=-1).values.reshape(g, s * k)
    keep = valid.gather(1, pos)
    safe = torch.where(keep, slot.gather(1, pos), 0)
    base = torch.arange(g)[:, None] * n
    y = y_flat.reshape(g * n, d).index_select(0, (base + safe).reshape(-1)).view(g, s, k, d)
    y = y * keep.view(g, s, k, 1).to(y.dtype)
    w = topw.reshape(g, s * k).gather(1, order.gather(1, pos)).to(y.dtype).view(g, s, k, 1)
    y = y * w
    out = y[:, :, 0]
    for j in range(1, k):
        out = out + y[:, :, j]
    return out


def _dense_moe(p, cfg, x):
    """moe_block's output by a plain dense dispatch: every expert's SwiGLU
    on every token, each token's kept copies (the port's own kept mask,
    a discrete choice) weighted and added in ascending expert order."""
    e = cfg.moe
    b, s, d = x.shape
    n_groups, group = moe._group_shape(b * s)
    xf = x.reshape(n_groups, group, d)
    et = moe.n_experts_padded(e)
    logits = xf.float() @ p["router"]
    probs = torch.nn.functional.pad(torch.softmax(logits, dim=-1), (0, et - e.n_routed))
    cap = moe.capacity(e, group)
    _, slot, valid, _, tok = DISPATCH(xf.detach(), probs.detach(), e.top_k, et, cap)[1][:5]
    topw, topi = torch.topk(probs, e.top_k, dim=-1)
    topw = topw / (torch.sum(topw, -1, keepdim=True) + 1e-9)
    kept = torch.zeros(n_groups, group, et, dtype=torch.bool)
    sorted_e = slot // cap
    for g in range(n_groups):
        for c in range(group * e.top_k):
            if valid[g, c]:
                kept[g, tok[g, c], sorted_e[g, c]] = True
    h = L.silu(torch.einsum("gsd,edf->gesf", xf, p["w_gate"])) * torch.einsum(
        "gsd,edf->gesf", xf, p["w_up"])
    y = torch.einsum("gesf,efd->gesd", h, p["w_down"])
    w = torch.zeros(n_groups, group, et).scatter(2, topi, topw) * kept
    out = torch.zeros_like(xf)
    for ex in range(et):   # ascending expert order
        out = out + y[:, ex] * w[:, :, ex, None]
    out = out.reshape(b, s, d)
    if e.n_shared:
        sp = p["shared"]
        out = out + L.swiglu(x, sp["w_gate"], sp["w_up"], sp["w_down"])
    return out


def _grads(fn, p, x, dy):
    """(output, d(output . dy)/dx, d/d every weight leaf) of ``fn(p, x)``."""
    leaves = [t.detach().requires_grad_() for t in tree.leaves(p)]
    xx = x.detach().requires_grad_()
    out = fn(tree.unflatten(p, leaves), xx)
    out = out[0] if isinstance(out, tuple) else out
    g = torch.autograd.grad(out, [xx, *leaves], dy)
    return out.detach(), g


@pytest.mark.parametrize("case", [dict(), dict(arch="deepseek-v2-lite-16b", pad_to=0),
                                  dict(capacity_factor=None, pad_to=0)],
                         ids=["drops_padded", "deepseek_drops", "drop_free"])
def test_moe_block_forward_equals_the_scatter_formulation(case, monkeypatch):
    """The forward bit for bit (the sign of zeros aside: a gathered row
    of a dropped copy is +0 where the scatter formulation multiplies a row
    by 0) and the aux loss equal to the ``index_copy_`` / ``index_select``
    formulation's, and the gradients of the input and every weight equal
    to autograd's through it (a CPU ``index_add_`` adds a token's copies
    in the sorted list's order, which is its ascending expert order)."""
    cfg, p, x = _block(**case)
    dy = torch.from_numpy(np.random.default_rng(31).standard_normal(tuple(x.shape))
                          .astype(np.float32))
    out, aux = moe.moe_block(p, cfg, x)
    got = _grads(lambda q, xx: moe.moe_block(q, cfg, xx), p, x, dy)
    monkeypatch.setattr(moe, "_dispatch", _scatter_dispatch)
    monkeypatch.setattr(moe, "_combine", _scatter_combine)
    out_s, aux_s = moe.moe_block(p, cfg, x)
    want = _grads(lambda q, xx: moe.moe_block(q, cfg, xx), p, x, dy)
    assert torch.equal(out, out_s) and torch.equal(aux, aux_s)
    same_bits = out.view(torch.int32) == out_s.view(torch.int32)
    assert bool((same_bits | (out == 0)).all())
    for a, b in zip(got[1], want[1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("case", [dict(), dict(arch="deepseek-v2-lite-16b", pad_to=0)],
                         ids=["drops_padded", "deepseek_drops"])
def test_moe_block_gradients_match_a_dense_dispatch(case):
    """With copies dropped, the output and the gradients of the input and
    of the expert and shared weights within 1e-5 of a plain dense
    dispatch's (the same float32 products in other shapes); a padded
    expert's weights get a zero gradient."""
    cfg, p, x = _block(**case)
    dy = torch.from_numpy(np.random.default_rng(32).standard_normal(tuple(x.shape))
                          .astype(np.float32))
    with _Drops() as drops:
        out, got = _grads(lambda q, xx: moe.moe_block(q, cfg, xx)[0], p, x, dy)
    assert drops.dropped > 0
    want_out, want = _grads(lambda q, xx: _dense_moe(q, cfg, xx), p, x, dy)
    torch.testing.assert_close(out, want_out, atol=1e-5, rtol=1e-5)
    paths = ["x"] + [str(path) for path in tree.flatten_with_paths(p)[0]]
    for path, a, b in zip(paths, got, want):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-5 * max(scale, 1.0), path
    grads = tree.unflatten(p, list(got[1:]))
    n_routed = cfg.moe.n_routed
    for name in ("w_gate", "w_up", "w_down"):
        assert torch.count_nonzero(grads[name][n_routed:]) == 0, name
        assert torch.count_nonzero(grads[name][:n_routed]) > 0, name


def test_each_gather_backward_is_its_transpose():
    """On a dispatch with drops: a token's input gradient is the sum of
    its kept slots' rows of the buffer's gradient, in ascending expert
    order, bit for bit; an expert output row's gradient is its one kept
    copy's weighted output gradient, 0 for an empty slot; a dropped copy's
    weight gets a zero gradient."""
    cfg, p, x = _block()
    e = cfg.moe
    et, k = moe.n_experts_padded(e), e.top_k
    n_groups, group = moe._group_shape(x.shape[0] * x.shape[1])
    xf = x.reshape(n_groups, group, -1).requires_grad_()
    probs = torch.nn.functional.pad(torch.softmax(xf.detach() @ p["router"], -1),
                                    (0, et - e.n_routed))
    cap = moe.capacity(e, group)
    buf, meta = moe._dispatch(xf, probs, k, et, cap)
    order, slot, valid, topw, tok, (tslot, tkeep, tpick, fill, filled) = meta
    assert int((~valid).sum()) > 0
    gbuf = torch.randn(buf.shape, generator=torch.Generator().manual_seed(33))
    (gx,) = torch.autograd.grad(buf, xf, gbuf)
    for g in range(n_groups):
        for t in range(group):
            want = torch.zeros_like(gx[g, t])
            for j in range(k):   # tslot is in ascending expert order
                if tkeep[g, t, j]:
                    want = want + gbuf[g, tslot[g, t, j]]
            assert torch.equal(gx[g, t], want)
    y_flat = torch.randn(buf.shape, generator=torch.Generator().manual_seed(34)).requires_grad_()
    tw = topw.detach().requires_grad_()
    out = moe._combine(y_flat, (*meta[:3], tw, *meta[4:]), group, k)
    gout = torch.randn(out.shape, generator=torch.Generator().manual_seed(35))
    gy, gw = torch.autograd.grad(out, (y_flat, tw), gout)
    w = tw.detach().reshape(n_groups, -1)
    for g in range(n_groups):
        for r in range(buf.shape[1]):
            if filled[g, r]:
                c = int(fill[g, r])
                want = gout[g, c // k] * w[g, tpick[g, c]]
                assert torch.equal(gy[g, r], want)
            else:
                assert torch.count_nonzero(gy[g, r]) == 0
        dropped = order[g][~valid[g]]   # indices into the (S, k) picks
        assert torch.count_nonzero(gw.reshape(n_groups, -1)[g, dropped]) == 0


class _ScatterAdds(TorchDispatchMode):
    """Records every op dispatched, and each accumulating scatter
    (``index_add``, ``index_put`` with ``accumulate``, ``scatter_add``,
    ``index_select``'s backward) whose indices repeat
    along the accumulated axis."""

    def __init__(self):
        super().__init__()
        self.ops, self.repeated = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        self.ops.append(name)
        index = None
        if name in ("index_add", "index_add_", "index_select_backward"):
            index = args[2] if name != "index_select_backward" else args[3]
            repeats = index.numel() != index.unique().numel()
        elif name in ("index_put", "index_put_", "_index_put_impl_"):
            acc = args[3] if len(args) > 3 else kwargs.get("accumulate", False)
            idx = torch.stack([i.reshape(-1) for i in args[1] if i is not None])
            repeats = bool(acc) and idx.unique(dim=1).shape[1] != idx.shape[1]
        elif name in ("scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_"):
            dim, index = args[1], args[2]
            srt = index.movedim(dim, -1).sort(-1).values
            repeats = bool((srt[..., 1:] == srt[..., :-1]).any())
        else:
            repeats = False
        if repeats:
            self.repeated.append(name)
        return func(*args, **kwargs)


@pytest.mark.parametrize("arch", MOE)
def test_moe_backward_adds_over_no_repeated_index(arch):
    """The MoE layer's backward (router, top-k weights, aux and z-loss
    included) dispatches no ``index_add``, no ``index_put`` with
    ``accumulate`` and no ``scatter_add`` whose indices repeat: on a card
    those add with atomics in an order that changes from run to run. The
    scatter formulation's backward does (the recorder sees it)."""
    cfg, p, x = _block(arch=arch, pad_to=12 if arch == MOE[0] else 0)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(36))
    leaves = [t.detach().requires_grad_() for t in tree.leaves(p)]
    xx = x.detach().requires_grad_()
    out, aux = moe.moe_block(tree.unflatten(p, leaves), cfg, xx)
    loss = (out * dy).sum() + 0.01 * aux
    with _ScatterAdds() as rec:
        torch.autograd.grad(loss, [xx, *leaves])
    assert rec.ops and not rec.repeated, rec.repeated
    old = (moe._dispatch, moe._combine)
    moe._dispatch, moe._combine = _scatter_dispatch, _scatter_combine
    try:
        out, aux = moe.moe_block(tree.unflatten(p, leaves), cfg, xx)
        with _ScatterAdds() as rec_old:
            torch.autograd.grad((out * dy).sum() + 0.01 * aux, [xx, *leaves])
    finally:
        moe._dispatch, moe._combine = old
    assert rec_old.repeated
