"""The port's dense-GQA LM serving path against the reference, on the CPU.

The same inputs, made from a seed with numpy, go through ``repro`` and
``repro_torch``: the attention oracle (and the Pallas ``flash_attention``
kernel in interpret mode), the LM layers, and ``forward_train``,
``prefill`` and ``decode_step`` of reduced qwen3-8b (qk-norm) and
phi4-mini (tied embeddings) with the reference's own seeded weights
carried over by ``lm.from_numpy``. The CUDA kernel itself runs only on a
card (``chip_smoke.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.configs.base import LM_SHAPES as J_LM_SHAPES
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import layers as JL
from repro.models import lm as jlm
from repro_torch.configs import LM_SHAPES, get_config, reduced
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from repro_torch.models import lm

# one intra-op thread: the suite runs in parallel worker processes,
# and torch's default pool (one thread per core) in each of them would
# starve the timing-sensitive tests of other files
torch.set_num_threads(1)

LM_ARCHS = ("qwen3-8b", "phi4-mini-3.8b")


def _qkv(seed, b, sq, skv, hq, hkv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _assert_bf16_rounds_as(got, want):
    """bf16 ``got`` rounds where ``want`` does: 99% of the values equal
    bit for bit, the rest within one bf16 ulp (2**-7 of the value), the
    last bit of a product whose float32 sum runs in another order.
    Rounding once where the reference rounds several times (``F.silu``
    for ``jax.nn.silu``) leaves only 34-65% equal."""
    assert got.dtype == torch.bfloat16
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.mean(got == want) >= 0.99
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want))


# ---------------------------------------------------------------------------
# attention: atol 2e-5 in float32 and 3e-2 in bf16, the reference's own
# kernel contract (tests/test_kernels.py); float32 sums in another order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,hq,hkv,d", [
    (1, 128, 1, 1, 128),
    (2, 256, 4, 2, 128),
    (1, 384, 8, 8, 128),
    (2, 128, 6, 2, 256),
    (1, 200, 4, 2, 16),    # ragged, the reduced LMs' head dim
])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_matches_reference(b, s, hq, hkv, d, causal):
    q, k, v = _qkv(s + d, b, s, s, hq, hkv, d)
    got = ref.attention(*_t(q, k, v), causal=causal).numpy()
    np.testing.assert_allclose(got, np.asarray(jref.attention(q, k, v, causal=causal)),
                               atol=2e-5, rtol=2e-5)


def test_attention_bf16_matches_reference():
    """bf16 inputs (the same values on both sides: float32 rounded to
    bf16 by each framework); the output stays in bf16."""
    q, k, v = _qkv(1, 1, 128, 128, 2, 2, 128)
    got = ref.attention(*[t.to(torch.bfloat16) for t in _t(q, k, v)], causal=True)
    assert got.dtype == torch.bfloat16
    want = jref.attention(*[jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)], causal=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=3e-2, rtol=3e-2)


def test_attention_kv_len_masks_the_cache_tail():
    """Decode: one query against a 12-long cache with 5 and 12 valid
    positions; what lies past kv_len does not matter."""
    q, k, v = _qkv(2, 2, 1, 12, 4, 2, 16)
    kv_len = np.array([5, 12], np.int32)
    got = ref.attention(*_t(q, k, v), kv_len=torch.from_numpy(kv_len)).numpy()
    want = np.asarray(jref.attention(q, k, v, kv_len=jnp.asarray(kv_len)))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    k2, v2 = k.copy(), v.copy()
    k2[0, 5:], v2[0, 5:] = 100.0, -100.0
    again = ref.attention(*_t(q, k2, v2), kv_len=torch.from_numpy(kv_len)).numpy()
    np.testing.assert_array_equal(again[0], got[0])
    short = ref.attention(*_t(q[:1], k[:1, :5], v[:1, :5])).numpy()
    np.testing.assert_allclose(got[:1], short, atol=1e-6)


def test_attention_causal_with_offset():
    """A causal chunk of 4 queries at positions 8..11 of 12 keys equals
    the last rows of the full causal attention."""
    q, k, v = _qkv(3, 1, 12, 12, 4, 2, 16)
    full = ref.attention(*_t(q, k, v), causal=True).numpy()
    tail = ref.attention(*_t(q[:, 8:], k, v), causal=True, q_offset=8).numpy()
    np.testing.assert_allclose(tail, full[:, 8:], atol=1e-6)
    want = np.asarray(jref.attention(q[:, 8:], k, v, causal=True, q_offset=8))
    np.testing.assert_allclose(tail, want, atol=2e-5, rtol=2e-5)


def test_attention_matches_pallas_interpret():
    q, k, v = _qkv(4, 1, 256, 256, 4, 2, 128)
    got = ref.attention(*_t(q, k, v), causal=True).numpy()
    want = np.asarray(pallas_flash(q, k, v, causal=True, interpret=True))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_ops_attention_sends_cpu_tensors_to_the_plain_version():
    q, k, v = _t(*_qkv(5, 1, 33, 33, 4, 2, 16))
    before = [(kk.launches, kk._lib) for kk in ops.KERNELS]
    assert torch.equal(ops.attention(q, k, v, causal=True), ref.attention(q, k, v, causal=True))
    kv_len = torch.tensor([7], dtype=torch.int32)
    assert torch.equal(ops.decode_attention(q[:, :1], k, v, kv_len=kv_len),
                       ref.attention(q[:, :1], k, v, kv_len=kv_len))
    assert [(kk.launches, kk._lib) for kk in ops.KERNELS] == before


# ---------------------------------------------------------------------------
# layers: 1e-6 (float32; XLA's and torch's sin, cos and rsqrt may differ
# in the last bit)
# ---------------------------------------------------------------------------

def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(L.rmsnorm(*_t(x, scale), 1e-6).numpy(),
                               np.asarray(JL.rmsnorm(x, scale, 1e-6)), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("theta,d", [(1e6, 128), (1e4, 128), (1e6, 16)])
def test_apply_rope_matches_reference(theta, d):
    """Positions up to 4096: the frequencies are XLA's bit for bit (an
    error there grows with the position)."""
    np.testing.assert_array_equal(L.rope_freqs(d, theta).numpy(),
                                  np.asarray(JL.rope_freqs(d, theta)))
    x = np.random.default_rng(d).standard_normal((2, 4097, 2, d)).astype(np.float32)
    pos = np.arange(4097, dtype=np.int32)[None]
    np.testing.assert_allclose(L.apply_rope(*_t(x, pos), theta).numpy(),
                               np.asarray(JL.apply_rope(x, pos, theta)), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_matches_reference(dtype):
    """In bf16, silu rounds where ``jax.nn.silu`` does."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    wg, wu = (rng.standard_normal((64, 128)).astype(np.float32) / 8 for _ in range(2))
    wd = rng.standard_normal((128, 64)).astype(np.float32) / 11
    if dtype == "float32":
        np.testing.assert_allclose(L.swiglu(*_t(x, wg, wu, wd)).numpy(),
                                   np.asarray(JL.swiglu(x, wg, wu, wd)), atol=1e-6, rtol=1e-6)
        return
    got = L.swiglu(*(t.to(torch.bfloat16) for t in _t(x, wg, wu, wd)))
    _assert_bf16_rounds_as(got, JL.swiglu(*(jnp.asarray(a, jnp.bfloat16)
                                             for a in (x, wg, wu, wd))))
    xs = np.linspace(-12, 12, 4801, dtype=np.float32)
    np.testing.assert_array_equal(
        L.silu(torch.from_numpy(xs).bfloat16()).float().numpy(),
        np.asarray(jax.nn.silu(jnp.asarray(xs, jnp.bfloat16)), np.float32))


# ---------------------------------------------------------------------------
# configs, init and the weight bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_configs_match_reference(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    assert cfg.n_params == jcfg.n_params
    for c, j in ((cfg, jcfg), (reduced(cfg), jreduced(jcfg))):
        for f in dataclasses.fields(c):
            assert getattr(c, f.name) == getattr(j, f.name), f.name
    assert [dataclasses.astuple(s)[:4] for s in LM_SHAPES] == \
        [(s.name, s.kind, s.seq_len, s.global_batch) for s in J_LM_SHAPES]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_init_has_the_reference_layout(arch):
    cfg = reduced(get_config(arch))
    p = lm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    jp = jax.eval_shape(lambda key: jlm.init(key, jreduced(jget(arch))), jax.random.PRNGKey(0))
    flat = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    got = {tuple(jax.tree_util.DictKey(k) for k in path): t
           for path, t in _flatten(p)}
    assert set(got) == set(flat)
    for path, t in got.items():
        assert tuple(t.shape) == flat[path].shape and t.dtype == torch.float32, path
    assert ("lm_head" in p) == (not cfg.tie_embeddings)
    wq = p["blocks_dense"]["attn"]["wq"]
    assert abs(wq.std().item() - 0.88 / cfg.d_model ** 0.5) < 0.02  # trunc. normal, ±2σ


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_lm_init_refuses_moe_and_mla():
    cfg = reduced(get_config("qwen3-8b"))
    for bad in (dataclasses.replace(cfg, moe="spec"), dataclasses.replace(cfg, mla="spec")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            lm.init(torch.Generator().manual_seed(0), bad, device="cpu")


def test_from_numpy_carries_bf16_exactly():
    cfg = dataclasses.replace(reduced(get_config("qwen3-8b")), param_dtype="bfloat16")
    jp = jlm.init(jax.random.PRNGKey(1), dataclasses.replace(
        jreduced(jget("qwen3-8b")), param_dtype="bfloat16"))
    p = lm.from_numpy(jp, cfg, device="cpu")
    for path, t in _flatten(p):
        j = jp
        for k in path:
            j = j[k]
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))


# ---------------------------------------------------------------------------
# the serving path: forward, prefill and decode against the reference.
# float32: atol 1e-5 (the reference's own prefill/decode test allows
# 2e-4): float32 products summed in another order; measured within 5e-7.
# bf16: a relative norm of 2e-2 per tensor. Op for op the port rounds
# where the reference does (one block run eagerly, below), but XLA
# compiles the reference's layer scan and keeps the residual sum in
# float32 inside a block, where the eager port rounds it to bf16:
# measured 3.0e-3 to 1.0e-2 on the logits and caches of the forward,
# prefill and decode, over 3 seeds and both configs
# ---------------------------------------------------------------------------

ATOL = 1e-5
BF16_RTOL = 2e-2


def _bridged(arch, dtype="float32"):
    jcfg = dataclasses.replace(jreduced(jget(arch)), param_dtype=dtype)
    jp = jlm.init(jax.random.PRNGKey(0), jcfg)
    cfg = dataclasses.replace(reduced(get_config(arch)), param_dtype=dtype)
    return jcfg, jp, cfg, lm.from_numpy(jp, cfg, device="cpu")


def _close(got, want, dtype):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL)
    else:
        assert np.linalg.norm(got - want) <= BF16_RTOL * np.linalg.norm(want)


def _pad_cache(cache, to):
    return {"blocks_dense": {
        k: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, to - c.shape[2]))
        for k, c in cache["blocks_dense"].items()}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_serving_matches_reference(arch, dtype):
    jcfg, jp, cfg, p = _bridged(arch, dtype)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jfull, _ = jlm.forward_train(jp, jcfg, jnp.asarray(tokens))
    full, aux = lm.forward_train(p, cfg, torch.from_numpy(tokens))
    assert full.shape == (2, 12, cfg.vocab_size) and float(aux) == 0.0
    assert full.dtype == getattr(torch, dtype)
    _close(full, jfull, dtype)

    jlog, jcache = jlm.prefill(jp, jcfg, jnp.asarray(tokens[:, :6]))
    log, cache = lm.prefill(p, cfg, torch.from_numpy(tokens[:, :6]))
    _close(log, jlog, dtype)
    for kk in ("k", "v"):
        got = cache["blocks_dense"][kk]
        assert got.shape == (cfg.n_layers, 2, 6, cfg.n_kv_heads, cfg.head_dim)
        _close(got, jcache["blocks_dense"][kk], dtype)

    jcache = jax.tree_util.tree_map(
        lambda c: jnp.pad(c, [(0, 0), (0, 0), (0, 6), (0, 0), (0, 0)]), jcache)
    cache = _pad_cache(cache, 12)
    for pos in range(6, 9):
        tok = tokens[:, pos:pos + 1]
        jlog, jcache = jlm.decode_step(jp, jcfg, jnp.asarray(tok), jcache, pos)
        log, cache = lm.decode_step(p, cfg, torch.from_numpy(tok), cache, pos)
        _close(log, jlog, dtype)
        for kk in ("k", "v"):
            _close(cache["blocks_dense"][kk], jcache["blocks_dense"][kk], dtype)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_block_bf16_rounds_as_reference(arch):
    """One bf16 block of the reference run eagerly, op for op, and the
    port's agree as ``_assert_bf16_rounds_as`` demands, so every
    intermediate is rounded to bf16 where the reference rounds it (norms,
    RoPE, attention, silu, residuals)."""
    jcfg, jp, cfg, p = _bridged(arch, "bfloat16")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    positions = np.arange(6, dtype=np.int32)[None]
    jblock = jax.tree_util.tree_map(lambda a: a[0], jp["blocks_dense"])
    want, _, _ = jlm._block(jblock, jcfg, jp["embed"][tokens], jnp.asarray(positions),
                            "train", False)
    got = lm._block(lm._map(lambda a: a[0], p["blocks_dense"]), cfg,
                    p["embed"][torch.from_numpy(tokens)], torch.from_numpy(positions), "train")
    _assert_bf16_rounds_as(got, want)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_prefill_decode_consistency(arch):
    """The port on its own: prefill then greedy decode give the logits
    of the full forward over prompt + generated tokens (the check
    chip_smoke.py makes at full width)."""
    cfg = reduced(get_config(arch))
    p = lm.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    prompt = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 7)).astype(np.int64))
    log, pre = lm.prefill(p, cfg, prompt)
    cache = lm.init_cache(cfg, 2, 7 + 4, device="cpu")
    for kk in ("k", "v"):
        cache["blocks_dense"][kk][:, :, :7] = pre["blocks_dense"][kk]
    logits, seq = [log], prompt
    for pos in range(7, 11):
        tok = logits[-1].argmax(-1, keepdim=True)
        seq = torch.cat([seq, tok], dim=1)
        log, cache = lm.decode_step(p, cfg, tok, cache, pos)
        logits.append(log)
    full, _ = lm.forward_train(p, cfg, seq)
    np.testing.assert_allclose(torch.stack(logits, 1).numpy(), full[:, 6:].numpy(), atol=ATOL)
