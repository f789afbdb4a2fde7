"""Decoder-only LM of the port: training (``forward_train``,
``loss_fn``) and serving (prefill and decode) of all four LMs.

Counterpart of ``repro/models/lm.py``: RoPE, GQA with optional qk-norm
(qwen3-8b, phi4-mini), SwiGLU dense FFN, the MoE FFN of
:mod:`repro_torch.models.moe` (qwen2-moe, deepseek), MLA attention with
its compressed cache and both decode paths (deepseek), a KV cache. The
training forward rematerializes each block as the reference's
``jax.checkpoint`` does (``cfg.remat``); its gradient is autograd's, the
attention's that of the ``flash_attention`` backward kernels on a card
(causal; GQA at D 128 for the dense LMs and qwen2-moe, MLA's q/k heads of
192 with v zero-padded on the D 192 entries, whose padded columns get the
zero gradient of ``_pad_to``'s slice), the MoE layers' that of
:mod:`repro_torch.models.moe`'s gathers, which add no gradient with
atomics.

Layouts are the reference's at the public functions, so the tests
compare like with like: parameters are a dict of tensors with dense
weights (d_in, d_out) used as ``x @ w``; ``first_dense_layers`` layers
(all of them without MoE) stacked on a leading axis under
``blocks_dense``, then the MoE layers under ``blocks_moe``; each stack's
cache is ``{"k", "v"}: (L, B, S, Hkv, D)``, or for MLA
``{"c_kv": (L, B, S, rank), "k_rope": (L, B, S, rope_dim)}``. The layers
run in a Python loop over each stack unbound once (views of its layers).
Training and prefill attention go through ``ops.attention``
(on CUDA the ``flash_attention`` kernel's tensor-core entry in bf16:
head dim 128 for GQA, 192 for MLA's q/k heads of 128 + 64 with v
zero-padded to 192), decode attention through
``ops.decode_attention`` or, for absorbed MLA, plain products (both
plain tensor ops, as in the reference).

Entry points run on ``device="cuda"`` and raise without a card unless
the caller passes ``device="cpu"``; the device of the parameters decides
where ``forward_train``, ``prefill`` and ``decode_step`` run.
"""
from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models.moe import init_moe, moe_block
from repro_torch.tree import from_numpy  # noqa: F401  (the weight bridge)


def _dt(cfg: LMConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# init and the weight bridge
# ---------------------------------------------------------------------------


def _stacks(cfg: LMConfig):
    """(stack name, layers, MoE?) of each non-empty layer stack, in order."""
    n_dense = cfg.moe.first_dense_layers if cfg.moe else cfg.n_layers
    stacks = (("blocks_dense", n_dense, False), ("blocks_moe", cfg.n_layers - n_dense, True))
    return [st for st in stacks if st[1]]


def _init_attn(gen, cfg: LMConfig, n: int) -> dict:
    dt, d, h = _dt(cfg), cfg.d_model, cfg.n_heads

    def dense(d_in, d_out):
        return L.dense_init(gen, d_in, d_out, dt, lead=(n,))

    if cfg.mla is not None:
        m = cfg.mla
        return {"wq": dense(d, h * (m.qk_nope_head_dim + m.qk_rope_head_dim)),
                "w_dkv": dense(d, m.kv_lora_rank + m.qk_rope_head_dim),
                "kv_norm": torch.ones((n, m.kv_lora_rank), dtype=dt, device=gen.device),
                "w_uk": dense(m.kv_lora_rank, h * m.qk_nope_head_dim),
                "w_uv": dense(m.kv_lora_rank, h * m.v_head_dim),
                "wo": dense(h * m.v_head_dim, d)}
    hd = cfg.head_dim
    attn = {"wq": dense(d, h * hd), "wk": dense(d, cfg.n_kv_heads * hd),
            "wv": dense(d, cfg.n_kv_heads * hd), "wo": dense(h * hd, d)}
    if cfg.qk_norm:
        attn["q_norm"] = torch.ones((n, hd), dtype=dt, device=gen.device)
        attn["k_norm"] = torch.ones((n, hd), dtype=dt, device=gen.device)
    return attn


def init(gen: torch.Generator, cfg: LMConfig, device="cuda") -> dict:
    """Random weights in ``cfg.param_dtype`` (the MoE router in float32,
    as the reference's), drawn from ``gen``, which must live on
    ``device`` (so full-width weights are drawn on the card, not on the
    host). Truncated normals as the reference's: stddev 1/sqrt(d_in) for
    the dense and expert weights, 0.02 for the embedding and head; norms
    at one."""
    device = resolve_device(device)
    if gen.device.type != device.type:
        raise ValueError(f"the generator lives on {gen.device}, the weights go to {device}")
    dt, d = _dt(cfg), cfg.d_model

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    params = {"embed": L.truncated_normal(gen, (cfg.vocab_size, d), 0.02, dt),
              "final_norm": ones(d)}
    for name, n, use_moe in _stacks(cfg):
        blk = {"ln1": ones(n, d), "ln2": ones(n, d), "attn": _init_attn(gen, cfg, n)}
        if use_moe:
            blk["moe"] = init_moe(gen, cfg, lead=(n,))
        else:
            blk["mlp"] = {"w_gate": L.dense_init(gen, d, cfg.d_ff, dt, lead=(n,)),
                          "w_up": L.dense_init(gen, d, cfg.d_ff, dt, lead=(n,)),
                          "w_down": L.dense_init(gen, cfg.d_ff, d, dt, lead=(n,))}
        params[name] = blk
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, d, cfg.vocab_size, dt, 0.02)
    return params


def _cache_shapes(cfg: LMConfig, n: int, batch: int, max_len: int) -> dict:
    if cfg.mla is not None:
        m = cfg.mla
        return {"c_kv": (n, batch, max_len, m.kv_lora_rank),
                "k_rope": (n, batch, max_len, m.qk_rope_head_dim)}
    shape = (n, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": shape, "v": shape}


def init_cache(cfg: LMConfig, batch: int, max_len: int, device="cuda") -> dict:
    """A zeroed cache of ``max_len`` positions, a dict per layer stack."""
    device = resolve_device(device)
    return {name: {k: torch.zeros(shape, dtype=_dt(cfg), device=device)
                   for k, shape in _cache_shapes(cfg, n, batch, max_len).items()}
            for name, n, _ in _stacks(cfg)}


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


def _pad_to(v, d):
    """Zero-pad the last axis of v to ``d`` (contiguous: the kernel takes
    contiguous tensors)."""
    return torch.nn.functional.pad(v, (0, d - v.shape[-1]))


def _mla_attend(p, cfg: LMConfig, x, positions, mode, cache=None, pos=None,
                absorb: bool = True):
    """MLA, the reference's ``_mla_attend``. ``cache`` is this layer's
    {"c_kv" (B, S, rank) after ``kv_norm``, "k_rope" (B, S, rope_dim)
    roped}: prefill fills it, decode writes ``pos`` in place. Prefill
    attends with q/k heads of nope + rope (v zero-padded to that width
    and cut back); decode either attends in the latent space (``absorb``:
    ``w_uk`` folded into q, ``w_uv`` applied after; scores and the latent
    output in float32 over the stored cache) or expands the cache
    (``absorb=False``)."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    nope, rope_d, vd, rank = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim, m.kv_lora_rank
    q = (x @ p["wq"]).reshape(b, s, h, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)
    ckv_full = x @ p["w_dkv"]
    c_kv = L.rmsnorm(ckv_full[..., :rank], p["kv_norm"], cfg.norm_eps)
    k_rope = L.apply_rope(ckv_full[:, :, None, rank:], positions, cfg.rope_theta)  # one head

    def expand_kv(ckv):
        t = ckv.shape[1]
        return ((ckv @ p["w_uk"]).reshape(-1, t, h, nope),
                (ckv @ p["w_uv"]).reshape(-1, t, h, vd))

    if mode in ("train", "prefill"):
        k_nope, v = expand_kv(c_kv)
        k = torch.cat([k_nope, k_rope.expand(b, s, h, rope_d)], -1)
        qq = torch.cat([q_nope, q_rope], -1)
        o = kops.attention(qq, k, _pad_to(v, nope + rope_d), causal=True)[..., :vd]
        if mode == "prefill":
            cache["c_kv"].copy_(c_kv)
            cache["k_rope"].copy_(k_rope[:, :, 0])
    else:  # decode: s == 1
        cache["c_kv"][:, pos] = c_kv[:, 0]
        cache["k_rope"][:, pos] = k_rope[:, 0, 0]
        cc, cr = cache["c_kv"], cache["k_rope"]
        kv_len = torch.full((b,), pos + 1, dtype=torch.int32, device=x.device)
        if absorb:
            w_uk = p["w_uk"].reshape(rank, h, nope)
            q_lat = torch.einsum("bshn,lhn->bshl", q_nope, w_uk)  # (b, 1, h, rank)
            scale = 1.0 / math.sqrt(nope + rope_d)
            ccf = cc.float()
            sc = (torch.einsum("bshl,btl->bhst", q_lat.float(), ccf)
                  + torch.einsum("bshr,btr->bhst", q_rope.float(), cr.float())) * scale
            valid = torch.arange(cc.shape[1], device=x.device)[None, :] < kv_len[:, None]
            sc = torch.where(valid[:, None, None, :], sc, -1e30)
            w = torch.softmax(sc, dim=-1)
            o_lat = torch.einsum("bhst,btl->bshl", w.to(cc.dtype).float(), ccf)
            w_uv = p["w_uv"].reshape(rank, h, vd)
            o = torch.einsum("bshl,lhv->bshv", o_lat.to(x.dtype), w_uv)
        else:
            k_nope, v = expand_kv(cc)
            k = torch.cat([k_nope, cr[:, :, None, :].expand(b, cr.shape[1], h, rope_d)], -1)
            qq = torch.cat([q_nope, q_rope], -1)
            o = kops.decode_attention(qq, k, _pad_to(v, nope + rope_d), kv_len=kv_len)[..., :vd]
    return o.reshape(b, s, h * vd) @ p["wo"]


def _block(p, cfg: LMConfig, x, positions, mode, use_moe, cache=None, pos=None,
           absorb=True):
    """One layer -> (x, aux loss of its MoE FFN, float32 0 without)."""
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        a = _mla_attend(p["attn"], cfg, h, positions, mode, cache, pos, absorb)
    else:
        a = _gqa_attend(p["attn"], cfg, h, positions, mode, cache, pos)
    x = x + a
    h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    if use_moe:
        f, aux = moe_block(p["moe"], cfg, h)
    else:
        f = L.swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"], p["mlp"]["w_down"])
        aux = torch.zeros((), device=x.device)
    return x + f, aux


def _remat(fn, cfg: LMConfig, mode: str):
    """``fn`` as the reference's ``_scan_blocks`` wraps a block in train
    mode: ``cfg.remat`` "full" saves nothing (a plain non-reentrant
    checkpoint: ``_remat_policy``'s None), "dots_saveable" keeps the
    outputs of matrix products (``layers.remat``), "none" (and every
    other mode) runs ``fn`` itself. The recompute runs the same ops on the
    same inputs, so the gradients are those without it."""
    if mode != "train" or cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    return L.remat(fn, cfg, True)


def _trunk(params, cfg: LMConfig, x, positions, mode, caches=None, pos=None,
           absorb=True):
    """The dense stack, then the MoE stack; layer i of a stack reads slice
    i of its leaves -> (x, the layers' aux losses summed)."""
    aux_total = torch.zeros((), device=x.device)
    for name, n, use_moe in _stacks(cfg):
        layer_caches = [None] * n if caches is None else L.unstack(caches[name])

        def block(p, xb, c, use_moe=use_moe):
            return _block(p, cfg, xb, positions, mode, use_moe, c, pos, absorb)
        block = _remat(block, cfg, mode)
        aux_stack = torch.zeros((), device=x.device)
        for p, c in zip(L.unstack(params[name]), layer_caches):
            x, aux = block(p, x, c)
            aux_stack = aux_stack + aux
        aux_total = aux_total + aux_stack
    return x, aux_total


def _logits(params, cfg: LMConfig, x):
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def forward_train(params, cfg: LMConfig, tokens):
    """tokens (B, S) -> (logits (B, S, V), aux loss scalar: the MoE
    layers' load-balance and z-losses, 0.0 without MoE): the training
    forward, each block rematerialized as ``cfg.remat`` asks; autograd
    gives its gradient (:func:`loss_fn`)."""
    s = tokens.shape[1]
    x = params["embed"][tokens]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    x, aux = _trunk(params, cfg, x, positions, "train")
    return _logits(params, cfg, x), aux


def loss_fn(params, cfg: LMConfig, tokens, labels):
    """tokens, labels (B, S) -> (loss, {"ce", "aux"}): the mean
    cross-entropy of the labels under float32 logits, ``logsumexp`` less
    the label's logit, plus 0.01 x the MoE aux loss, as the reference's
    ``loss_fn``. The label's logit is a gather where the reference
    contracts a one-hot (for a vocab-sharded mesh): in float32 the
    contraction adds exact zeros to the one term, so the two are equal bit
    for bit, and a (B, S, V) one-hot would hold 3.3 GB a 4096-token row of
    phi4-mini's 200064-token vocabulary on the card."""
    logits, aux = forward_train(params, cfg, tokens)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    ce = torch.mean(lse - ll)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def prefill(params, cfg: LMConfig, tokens):
    """tokens (B, S) -> (last-token logits (B, V), cache of S positions)."""
    b, s = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    caches = init_cache(cfg, b, s, x.device)
    x, _ = _trunk(params, cfg, x, positions, "prefill", caches)
    return _logits(params, cfg, x[:, -1:, :])[:, 0], caches


def decode_step(params, cfg: LMConfig, token, caches, pos: int, absorb: bool = True):
    """token (B, 1); caches from ``init_cache``/``prefill``, at least
    ``pos + 1`` long, written in place at ``pos``; ``absorb`` picks MLA's
    decode path (weight-absorbed, or the expanded cache). Returns (logits
    (B, V), caches)."""
    x = params["embed"][token]
    positions = torch.full(token.shape, pos, dtype=torch.int32, device=x.device)
    x, _ = _trunk(params, cfg, x, positions, "decode", caches, pos, absorb)
    return _logits(params, cfg, x)[:, 0], caches
