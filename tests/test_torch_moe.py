"""The port's MoE block and MLA attention against the reference, on the CPU.

The same inputs, made from a seed with numpy, go through ``repro`` and
``repro_torch``: ``moe._group_shape``, the dispatch (which (token,
expert) copies are kept, and in which slot), ``moe_block``'s output and
aux loss at reduced width, drop-free and with drops and padded experts,
in one group and in several, and ``lm._mla_attend`` in prefill and in
both decode paths. Weights are the reference's own seeded ones, carried
over by ``lm.from_numpy``. The card runs the same code (``chip_smoke.py``
phase 12).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch.configs import get_config, reduced
from repro_torch.models import lm, moe

torch.set_num_threads(1)

# float32: outputs within 1e-5 and the aux loss within 1e-6 (float32
# products summed in another order; measured within 7.2e-7 and 1.2e-7;
# the smallest k-th / (k+1)-th probability gap at these seeds is 2.5e-6)
ATOL, AUX_ATOL = 1e-5, 1e-6
# a (token, expert) copy may be routed differently only where the k-th
# and (k+1)-th router probabilities lie this close: the last bits of a
# float32 router product summed in another order
ROUTE_GAP = 1e-6
# the reference's own test of absorbed against naive MLA decode
# (tests/test_models.py:47)
ABSORB_ATOL = 2e-4


def _moe_cfg(arch="qwen2-moe-a2.7b", **moe_changes):
    """Reduced config of the port and the reference, with the same changes
    to the MoE spec (float32)."""
    cfg, jcfg = reduced(get_config(arch)), jreduced(jget(arch))
    if moe_changes:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_changes))
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe_changes))
    return cfg, jcfg


def _moe_layer(jcfg, seed):
    """Layer 0 of the reference's seeded MoE stack -> (reference leaves,
    the port's)."""
    jp = jlm.init(jax.random.PRNGKey(seed), jcfg)
    jblk = jax.tree_util.tree_map(lambda a: a[0], jp["blocks_moe"]["moe"])
    return jblk, lm.from_numpy(jblk, device="cpu")


def _assert_bf16_rounds_as(got, want):
    assert got.dtype == torch.bfloat16
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.mean(got == want) >= 0.99
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want))


def _x(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


@pytest.mark.parametrize("t", [2, 16, 6144, 8192, 8256, 4097])
def test_group_shape_matches_reference(t):
    assert moe._group_shape(t) == jmoe._group_shape(t)


def test_group_shape_halves_to_divide():
    assert moe._group_shape(8256) == (129, 64)
    assert moe._group_shape(4097) == (4097, 1)


def _ref_dispatch(jp, jcfg, x):
    """The reference's router and per-group dispatch, as its
    ``moe_block`` runs them -> (probs, valid, slot) as numpy."""
    e = jcfg.moe
    b, s, d = x.shape
    n_groups, group = jmoe._group_shape(b * s)
    xf = jnp.asarray(x).reshape(n_groups, group, d)
    et = jmoe.n_experts_padded(e)
    probs = jax.nn.softmax(jnp.einsum("gsd,de->gse", xf, jp["router"]), axis=-1)
    if et > e.n_routed:
        probs = jnp.pad(probs, ((0, 0), (0, 0), (0, et - e.n_routed)))
    cap = max(1, int(np.ceil(e.top_k * group * e.capacity_factor / e.n_routed)))
    _, metas = jax.vmap(lambda xg, pg: jmoe._dispatch(xg, pg, e.top_k, et, cap))(xf, probs)
    _, slot, valid, _, _ = metas
    return np.asarray(probs), np.asarray(valid), np.asarray(slot)


def _port_dispatch(p, cfg, x):
    e = cfg.moe
    b, s, d = x.shape
    n_groups, group = moe._group_shape(b * s)
    xf = torch.from_numpy(x).reshape(n_groups, group, d)
    et = moe.n_experts_padded(e)
    probs = torch.softmax(xf @ p["router"], dim=-1)
    probs = torch.nn.functional.pad(probs, (0, et - e.n_routed))
    _, (_, slot, valid, _, _) = moe._dispatch(xf, probs, e.top_k, et, moe.capacity(e, group))
    return valid.numpy(), slot.numpy(), torch.topk(probs, e.top_k, dim=-1).indices.numpy()


# drop-free (the reduced config's own capacity factor, n_routed), and
# with drops: capacity factor 0.5 and 8 routed experts padded to 12
MOE_CASES = {"drop_free": {}, "drops_padded": dict(capacity_factor=0.5, pad_experts_to=12)}


@pytest.mark.parametrize("b,s", [(2, 8), (2, 4096)])    # T 16: one group; 8192: two
@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_block_matches_reference(case, b, s):
    cfg, jcfg = _moe_cfg(**MOE_CASES[case])
    jp, p = _moe_layer(jcfg, seed=s)
    x = _x(s + 1, b, s, cfg.d_model)

    # which copies are kept, and where: equal but at a near-tie of the
    # router (counted; 0 at these seeds)
    probs, jvalid, jslot = _ref_dispatch(jp, jcfg, x)
    valid, slot, topi = _port_dispatch(p, cfg, x)
    k = cfg.moe.top_k
    top = -np.sort(-probs, axis=-1)
    near = np.abs(top[..., k - 1] - top[..., k]) < ROUTE_GAP
    jtopi = np.argsort(-probs, axis=-1, kind="stable")[..., :k]
    rerouted = np.any(np.sort(topi, -1) != np.sort(jtopi, -1), axis=-1)
    assert not np.any(rerouted & ~near), "a token routed differently away from a near-tie"
    assert int(near.sum()) == 0
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_array_equal(slot, jslot)
    n_dropped = int((~valid).sum())
    if case == "drop_free":
        assert n_dropped == 0
    else:
        assert n_dropped > 0 and not np.any(topi >= cfg.moe.n_routed)  # padded: never routed

    jout, jaux = jmoe.moe_block(jp, jcfg, jnp.asarray(x))
    out, aux = moe.moe_block(p, cfg, torch.from_numpy(x))
    assert out.shape == x.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), atol=AUX_ATOL)


def test_moe_block_token_permutation_equivariance():
    """The reference's test (tests/test_models.py:72) on the port: routing
    is per token, so permuting the tokens of a group permutes the
    output."""
    cfg, jcfg = _moe_cfg()
    _, p = _moe_layer(jcfg, seed=0)
    x = torch.from_numpy(_x(0, 2, 16, cfg.d_model))
    out, aux = moe.moe_block(p, cfg, x)
    assert out.shape == x.shape and np.isfinite(float(aux))
    perm = torch.from_numpy(np.random.default_rng(0).permutation(16))
    out_p, _ = moe.moe_block(p, cfg, x[:, perm])
    np.testing.assert_allclose(out_p.numpy(), out[:, perm].numpy(), atol=1e-4)


def test_moe_block_bf16_rounds_as_reference():
    """A bf16 MoE block (drops and padded experts included) and the
    reference's, run eagerly op by op: the port rounds where the
    reference does (99% of the values bit-equal, the rest within one bf16
    ulp, as ``test_torch_lm.py`` holds a dense block; measured 99.99%
    equal).
    The router stays float32."""
    cfg, jcfg = _moe_cfg(capacity_factor=0.5, pad_experts_to=12)
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16")
    jp, p = _moe_layer(jcfg, seed=5)
    assert p["router"].dtype == torch.float32 and p["w_gate"].dtype == torch.bfloat16
    x = _x(5, 2, 64, cfg.d_model)
    jout, jaux = jmoe.moe_block(jp, jcfg, jnp.asarray(x, jnp.bfloat16))
    out, aux = moe.moe_block(p, cfg, torch.from_numpy(x).bfloat16())
    _assert_bf16_rounds_as(out, jout)
    np.testing.assert_allclose(float(aux), float(jaux), atol=AUX_ATOL)


# ---------------------------------------------------------------------------
# MLA attention: prefill, absorbed and naive decode (float32, ATOL)
# ---------------------------------------------------------------------------

def _mla_layer(seed):
    jcfg = jreduced(jget("deepseek-v2-lite-16b"))
    cfg = reduced(get_config("deepseek-v2-lite-16b"))
    jp = jlm.init(jax.random.PRNGKey(seed), jcfg)
    jattn = jax.tree_util.tree_map(lambda a: a[0], jp["blocks_dense"]["attn"])
    return cfg, jcfg, jattn, lm.from_numpy(jattn, device="cpu")


def test_mla_attend_matches_reference():
    cfg, jcfg, jattn, attn = _mla_layer(seed=2)
    b, s, total = 2, 7, 12
    x = _x(2, b, total, cfg.d_model)
    positions = np.arange(s, dtype=np.int32)[None]
    jout, jcache = jlm._mla_attend(jattn, jcfg, jnp.asarray(x[:, :s]), jnp.asarray(positions),
                                   "prefill")
    cache = {k: torch.zeros(shape[1:]) for k, shape in
             lm._cache_shapes(cfg, 1, b, s).items()}
    out = lm._mla_attend(attn, cfg, torch.from_numpy(x[:, :s]), torch.from_numpy(positions),
                         "prefill", cache)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    assert set(cache) == set(jcache) == {"c_kv", "k_rope"}
    for kk in cache:
        np.testing.assert_allclose(cache[kk].numpy(), np.asarray(jcache[kk]), atol=ATOL)

    jcache = {k: jnp.pad(c, [(0, 0), (0, total - s), (0, 0)]) for k, c in jcache.items()}
    cache = {k: torch.nn.functional.pad(c, (0, 0, 0, total - s)) for k, c in cache.items()}
    caches = {a: {k: c.clone() for k, c in cache.items()} for a in (True, False)}
    jcaches = {a: jcache for a in (True, False)}
    for pos in range(s, total):
        xt = x[:, pos:pos + 1]
        pt = np.full((b, 1), pos, np.int32)
        outs = {}
        for a in (True, False):
            outs[a] = lm._mla_attend(attn, cfg, torch.from_numpy(xt), torch.from_numpy(pt),
                                     "decode", caches[a], pos, absorb=a)
            jo, jcaches[a] = jlm._mla_attend(jattn, jcfg, jnp.asarray(xt), jnp.asarray(pt),
                                             "decode", jcaches[a], pos, absorb=a)
            np.testing.assert_allclose(outs[a].numpy(), np.asarray(jo), atol=ATOL)
            for kk in caches[a]:
                np.testing.assert_allclose(caches[a][kk].numpy(), np.asarray(jcaches[a][kk]),
                                           atol=ATOL)
        np.testing.assert_allclose(outs[True].numpy(), outs[False].numpy(), atol=ABSORB_ATOL)


def test_mla_absorb_equivalence():
    """The reference's test (tests/test_models.py:47) on the port's whole
    model: weight-absorbed decode equals naive decode within 2e-4."""
    cfg = reduced(get_config("deepseek-v2-lite-16b"))
    p = lm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8)).astype(np.int64))
    _, pre = lm.prefill(p, cfg, tokens[:, :4])
    cache = lm.init_cache(cfg, 2, 8, device="cpu")
    for name, stack in cache.items():
        for kk, c in stack.items():
            c[:, :, :4] = pre[name][kk]
    copy = {n: {k: c.clone() for k, c in st.items()} for n, st in cache.items()}
    la, _ = lm.decode_step(p, cfg, tokens[:, 4:5], cache, 4, absorb=True)
    ln, _ = lm.decode_step(p, cfg, tokens[:, 4:5], copy, 4, absorb=False)
    np.testing.assert_allclose(la.numpy(), ln.numpy(), atol=ABSORB_ATOL)
