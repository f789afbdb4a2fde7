"""Decoder-only LM of the port: dense GQA serving (prefill and decode).

Counterpart of ``repro/models/lm.py`` for the dense configs (qwen3-8b,
phi4-mini): RoPE, GQA with optional qk-norm, SwiGLU FFN, a KV cache.
MoE and MLA are not ported (``init`` refuses them; ROADMAP queue 1), nor
is the backward: ``forward_train`` is the forward alone.

Layouts are the reference's at the public functions, so the tests
compare like with like: parameters are a dict of tensors with dense
weights (d_in, d_out) used as ``x @ w``, the layers stacked on a leading
axis under ``blocks_dense``, and the cache is
``{"blocks_dense": {"k", "v"}: (L, B, S, Hkv, D)}``. The layers run in
a Python loop. Prefill attention goes through ``ops.attention`` (the
``flash_attention`` kernel on CUDA), decode attention through
``ops.decode_attention`` (plain tensor ops, as in the reference).

Entry points run on ``device="cuda"`` and raise without a card unless
the caller passes ``device="cpu"``; the device of the parameters decides
where ``forward_train``, ``prefill`` and ``decode_step`` run.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L


def _dt(cfg: LMConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# init and the weight bridge
# ---------------------------------------------------------------------------


def init(gen: torch.Generator, cfg: LMConfig, device="cuda") -> dict:
    """Random weights in ``cfg.param_dtype``, drawn from ``gen``, which
    must live on ``device`` (so full-width weights are drawn on the card,
    not on the host). Truncated normals as the reference's: stddev
    1/sqrt(d_in) for the dense weights, 0.02 for the embedding and head;
    norms at one."""
    device = resolve_device(device)
    if cfg.moe is not None or cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE and MLA are not ported yet (ROADMAP queue 1)")
    if gen.device.type != device.type:
        raise ValueError(f"the generator lives on {gen.device}, the weights go to {device}")
    dt = _dt(cfg)
    d, n, hd = cfg.d_model, cfg.n_layers, cfg.head_dim

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    def dense(d_in, d_out):
        return L.dense_init(gen, d_in, d_out, dt, lead=(n,))

    attn = {"wq": dense(d, cfg.n_heads * hd), "wk": dense(d, cfg.n_kv_heads * hd),
            "wv": dense(d, cfg.n_kv_heads * hd), "wo": dense(cfg.n_heads * hd, d)}
    if cfg.qk_norm:
        attn["q_norm"] = ones(n, hd)
        attn["k_norm"] = ones(n, hd)
    params = {
        "embed": L.truncated_normal(gen, (cfg.vocab_size, d), 0.02, dt),
        "final_norm": ones(d),
        "blocks_dense": {
            "ln1": ones(n, d), "ln2": ones(n, d), "attn": attn,
            "mlp": {"w_gate": dense(d, cfg.d_ff), "w_up": dense(d, cfg.d_ff),
                    "w_down": dense(cfg.d_ff, d)},
        },
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, d, cfg.vocab_size, dt, 0.02)
    return params


def from_numpy(tree, cfg: LMConfig, device="cuda") -> dict:
    """The reference's ``lm.init`` pytree (nested dicts of arrays, layer
    axis kept) -> the port's parameters in ``cfg.param_dtype`` on
    ``device``. bf16 arrays come out of JAX as ``ml_dtypes.bfloat16``,
    which ``torch.from_numpy`` refuses: they go through float32, which
    holds every bf16 value exactly."""
    device = resolve_device(device)
    dt = _dt(cfg)
    return _map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(device, dt), tree)


def init_cache(cfg: LMConfig, batch: int, max_len: int, device="cuda") -> dict:
    """A zeroed KV cache of ``max_len`` positions."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"blocks_dense": {
        "k": torch.zeros(shape, dtype=_dt(cfg), device=device),
        "v": torch.zeros(shape, dtype=_dt(cfg), device=device)}}


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _gqa_attend(p, cfg: LMConfig, x, positions, mode, cache=None, pos=None):
    """mode: 'train' | 'prefill' | 'decode'. ``cache`` is this layer's
    {"k", "v"} (B, S, Hkv, D): prefill fills it, decode writes the new
    position in place (an index copy at ``pos``, where the reference's
    ``dynamic_update_slice`` returns a new cache) and attends over the
    first ``pos + 1`` positions."""
    b, s, _ = x.shape
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (x @ p["wk"]).reshape(b, s, hk, hd)
    v = (x @ p["wv"]).reshape(b, s, hk, hd)
    if cfg.qk_norm:
        q = L.rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = L.rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    if mode in ("train", "prefill"):
        o = kops.attention(q, k, v, causal=True)
        if mode == "prefill":
            cache["k"].copy_(k)
            cache["v"].copy_(v)
    else:  # decode: s == 1, the cache holds the full length
        cache["k"][:, pos] = k[:, 0]
        cache["v"][:, pos] = v[:, 0]
        kv_len = torch.full((b,), pos + 1, dtype=torch.int32, device=x.device)
        o = kops.decode_attention(q, cache["k"], cache["v"], kv_len=kv_len)
    return o.reshape(b, s, h * hd) @ p["wo"]


def _block(p, cfg: LMConfig, x, positions, mode, cache=None, pos=None):
    a = _gqa_attend(p["attn"], cfg, L.rmsnorm(x, p["ln1"], cfg.norm_eps),
                    positions, mode, cache, pos)
    x = x + a
    h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + L.swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"], p["mlp"]["w_down"])


def _trunk(params, cfg: LMConfig, x, positions, mode, caches=None, pos=None):
    """All layers in order; layer i reads slice i of every stack."""
    blocks = params["blocks_dense"]
    layer_caches = None if caches is None else caches["blocks_dense"]
    for i in range(blocks["ln1"].shape[0]):
        p = _map(lambda a: a[i], blocks)
        c = None if layer_caches is None else _map(lambda a: a[i], layer_caches)
        x = _block(p, cfg, x, positions, mode, c, pos)
    return x


def _logits(params, cfg: LMConfig, x):
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def forward_train(params, cfg: LMConfig, tokens):
    """tokens (B, S) -> (logits (B, S, V), aux loss 0.0): the training
    forward (the backward is not ported)."""
    s = tokens.shape[1]
    x = params["embed"][tokens]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    x = _trunk(params, cfg, x, positions, "train")
    return _logits(params, cfg, x), torch.zeros((), device=x.device)


def prefill(params, cfg: LMConfig, tokens):
    """tokens (B, S) -> (last-token logits (B, V), cache of S positions)."""
    b, s = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    caches = init_cache(cfg, b, s, x.device)
    x = _trunk(params, cfg, x, positions, "prefill", caches)
    return _logits(params, cfg, x[:, -1:, :])[:, 0], caches


def decode_step(params, cfg: LMConfig, token, caches, pos: int):
    """token (B, 1); caches from ``init_cache``/``prefill``, at least
    ``pos + 1`` long, written in place at ``pos``. Returns (logits
    (B, V), caches)."""
    x = params["embed"][token]
    positions = torch.full(token.shape, pos, dtype=torch.int32, device=x.device)
    x = _trunk(params, cfg, x, positions, "decode", caches, pos)
    return _logits(params, cfg, x)[:, 0], caches
