"""SD-1.5-class UNet of the port: serving and training.

Counterpart of ``repro/models/unet.py``: res blocks with the time
embedding, spatial transformer blocks (self-attention, cross-attention
over a ``ctx_len`` text context, a GEGLU feed-forward) at the configured
levels, a skip-connected encoder and decoder (stride-2 SAME downsample,
2x nearest upsample). The modality frontends are stubs: the model takes
VAE latents (img_res / 8, 4 channels) and precomputed text embeddings
(B, ctx_len, ctx_dim). ``forward(..., train=True)`` wraps each down
and up block (not the mid block) in ``layers.remat`` as the reference
does (``cfg.remat``); the backward is autograd's, through the
``flash_attention`` kernel's own.

Parameters are the reference's tree: dicts of tensors, the stages and
their blocks in lists; convolutions HWIO, dense weights (d_in, d_out)
used as ``x @ w``. Attention has heads of 64 (``c // 64`` of them) and
goes through ``ops.attention``: on CUDA in bf16 the ``flash_attention``
kernel's tensor-core entry, for the self-attention (Sq = Skv = H * W)
and the cross-attention (Skv = ctx_len, 77 keys at full width).

``init`` and ``from_numpy`` run on ``device="cuda"`` and raise without
a card unless the caller passes ``device="cpu"``; ``forward`` runs where
the parameters are.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import DiffusionConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.sharding import ctx as mesh_ctx
from repro_torch.tree import from_numpy  # noqa: F401  (the weight bridge)


def _dt(cfg: DiffusionConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def init(gen: torch.Generator, cfg: DiffusionConfig, device="cuda") -> dict:
    """Random weights in ``cfg.param_dtype`` drawn from ``gen``, which
    must live on ``device``: fan-in truncated normals for the
    convolutions and dense weights, norms at one, biases at zero; the
    reference's tree of down stages, mid block and up stages."""
    device = resolve_device(device, meta=True)
    if gen.device.type != device.type:
        raise ValueError(f"the generator lives on {gen.device}, the weights go to {device}")
    dt, ch = _dt(cfg), cfg.ch
    temb_dim = 4 * ch
    chans = [ch * m for m in cfg.ch_mult]

    def ones(n):
        return torch.ones((n,), dtype=dt, device=device)

    def zeros(n):
        return torch.zeros((n,), dtype=dt, device=device)

    def conv(k, c_in, c_out):
        return L.conv_init(gen, k, k, c_in, c_out, dt)

    def dense(d_in, d_out):
        return L.dense_init(gen, d_in, d_out, dt)

    def res(c_in, c_out):
        p = {"gn1_s": ones(c_in), "gn1_b": zeros(c_in), "w1": conv(3, c_in, c_out),
             "temb_w": dense(temb_dim, c_out), "temb_b": zeros(c_out),
             "gn2_s": ones(c_out), "gn2_b": zeros(c_out), "w2": conv(3, c_out, c_out)}
        if c_in != c_out:
            p["skip_w"] = conv(1, c_in, c_out)
        return p

    def xformer(c):
        return {"gn_s": ones(c), "gn_b": zeros(c), "proj_in": dense(c, c),
                "ln1_s": ones(c), "ln1_b": zeros(c),
                "sa_qkv": dense(c, 3 * c), "sa_o": dense(c, c),
                "ln2_s": ones(c), "ln2_b": zeros(c),
                "ca_q": dense(c, c), "ca_k": dense(cfg.ctx_dim, c),
                "ca_v": dense(cfg.ctx_dim, c), "ca_o": dense(c, c),
                "ln3_s": ones(c), "ln3_b": zeros(c),
                "ff_in": dense(c, 8 * c),  # GEGLU: 2 x 4c
                "ff_out": dense(4 * c, c), "proj_out": dense(c, c)}

    def block(lvl, c_in, c):
        blk = {"res": res(c_in, c)}
        if lvl in cfg.attn_levels:
            blk["attn"] = xformer(c)
        return blk

    params = {"t_w1": dense(ch, temb_dim), "t_b1": zeros(temb_dim),
              "t_w2": dense(temb_dim, temb_dim), "t_b2": zeros(temb_dim),
              "conv_in": conv(3, cfg.latent_ch, ch)}
    # down path; skips: conv_in's output, each block's, each downsample's
    down, skips, c_prev = [], [ch], ch
    for lvl, c in enumerate(chans):
        blocks = []
        for _ in range(cfg.n_res_blocks):
            blocks.append(block(lvl, c_prev, c))
            skips.append(c)
            c_prev = c
        stage = {"blocks": blocks}
        if lvl + 1 < len(chans):
            stage["down_w"] = conv(3, c, c)
            skips.append(c)
        down.append(stage)
    params["down"] = down
    params["mid"] = {"res1": res(c_prev, c_prev), "attn": xformer(c_prev),
                     "res2": res(c_prev, c_prev)}
    # up path: n_res_blocks + 1 blocks a level, each taking the last skip
    up = []
    for lvl in reversed(range(len(chans))):
        c = chans[lvl]
        blocks = []
        for _ in range(cfg.n_res_blocks + 1):
            blocks.append(block(lvl, c_prev + skips.pop(), c))
            c_prev = c
        stage = {"blocks": blocks}
        if lvl > 0:
            stage["up_w"] = conv(3, c, c)
        up.append(stage)
    params["up"] = up
    params["gn_out_s"], params["gn_out_b"] = ones(ch), zeros(ch)
    params["conv_out"] = conv(3, ch, cfg.latent_ch)
    return params


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """NHWC nearest 2x upsample: ``jax.image.resize(..., "nearest")`` at
    exactly twice the size repeats each row and column."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _res(p: dict, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
    h = L.conv2d(L.silu(L.groupnorm(x, p["gn1_s"], p["gn1_b"])), p["w1"])
    h = h + (L.silu(temb) @ p["temb_w"] + p["temb_b"])[:, None, None, :]
    h = L.conv2d(L.silu(L.groupnorm(h, p["gn2_s"], p["gn2_b"])), p["w2"])
    return h + (L.conv2d(x, p["skip_w"]) if "skip_w" in p else x)


def heads(c: int) -> int:
    return max(1, c // 64)


def self_attention_inputs(p: dict, h: torch.Tensor):
    """The self-attention's q, k, v (B, S, H, D) of the block's tokens
    ``h`` (B, S, C), contiguous (the reference's split gives strided
    views, the kernel reads contiguous tensors)."""
    b, s, c = h.shape
    y = L.layernorm(h, p["ln1_s"], p["ln1_b"])
    qkv = mesh_ctx.split_heads(y @ p["sa_qkv"], b, s, 3 * heads(c), c // heads(c))
    return [t.contiguous() for t in torch.split(qkv, heads(c), dim=2)]


def cross_attention_inputs(p: dict, h: torch.Tensor, ctx: torch.Tensor):
    """The cross-attention's q (B, S, H, D) of ``h`` and k, v (B,
    ctx_len, H, D) of the context, each from its own product
    (contiguous)."""
    b, s, c = h.shape
    nh = heads(c)
    y = L.layernorm(h, p["ln2_s"], p["ln2_b"])
    ctx = ctx.to(y.dtype)
    return (mesh_ctx.split_heads(y @ p["ca_q"], b, s, nh, c // nh),
            mesh_ctx.split_heads(ctx @ p["ca_k"], b, -1, nh, c // nh),
            mesh_ctx.split_heads(ctx @ p["ca_v"], b, -1, nh, c // nh))


def xformer_tokens(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The transformer block's tokens (B, H * W, C) of its input x (B, H,
    W, C): GroupNorm, then ``proj_in``."""
    b, hh, ww, c = x.shape
    return L.groupnorm(x, p["gn_s"], p["gn_b"]).reshape(b, hh * ww, c) @ p["proj_in"]


def _xformer(p: dict, x: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
    b, hh, ww, c = x.shape
    h = xformer_tokens(p, x)
    a = kops.attention(*self_attention_inputs(p, h), causal=False).reshape(b, hh * ww, c)
    h = h + _rows(a @ p["sa_o"])
    a = kops.attention(*cross_attention_inputs(p, h, ctx), causal=False).reshape(b, hh * ww, c)
    h = h + _rows(a @ p["ca_o"])
    # on a mesh the GEGLU's two halves are whole on "model" (its chunk
    # does not split along the shards)
    u1, u2 = torch.chunk(_rows(L.layernorm(h, p["ln3_s"], p["ln3_b"]) @ p["ff_in"]), 2, dim=-1)
    h = h + _rows((u1 * L.gelu(u2)) @ p["ff_out"])
    return (h @ p["proj_out"]).reshape(b, hh, ww, c) + x


def _rows(y: torch.Tensor) -> torch.Tensor:
    """A product's output whole on "model" (a row-parallel one's partial
    sum reduced), the rows over the data axes; off a mesh, y (DiT's
    ``_rows``)."""
    return mesh_ctx.constrain(y, ("pod", "data"), None, None)


def _block(blk: dict, h: torch.Tensor, temb: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
    h = _res(blk["res"], h, temb)
    return _xformer(blk["attn"], h, ctx) if "attn" in blk else h


def time_embedding(params: dict, cfg: DiffusionConfig, t: torch.Tensor) -> torch.Tensor:
    temb = L.sinusoidal_embedding(t, cfg.ch).to(_dt(cfg))
    temb = temb @ params["t_w1"] + params["t_b1"]
    return L.silu(temb) @ params["t_w2"] + params["t_b2"]


def forward(params: dict, cfg: DiffusionConfig, latents: torch.Tensor, t: torch.Tensor,
            ctx: torch.Tensor, train: bool = False) -> torch.Tensor:
    """latents (B, Hl, Wl, 4), t (B,), ctx (B, ctx_len, ctx_dim) -> eps
    (B, Hl, Wl, 4) float32. ``train`` rematerializes each down and up
    block where ``cfg.remat`` asks (the numbers are the same)."""
    temb = time_embedding(params, cfg, t)
    block = L.remat(_block, cfg, train)
    up_block = L.remat(lambda blk, h, skip: _block(blk, torch.cat([h, skip], dim=-1), temb, ctx),
                       cfg, train)
    h = L.conv2d(latents.to(_dt(cfg)), params["conv_in"])
    skips = [h]
    for stage in params["down"]:
        for blk in stage["blocks"]:
            h = block(blk, h, temb, ctx)
            skips.append(h)
        if "down_w" in stage:
            h = L.conv2d(h, stage["down_w"], stride=2)
            skips.append(h)
    m = params["mid"]
    h = _res(m["res2"], _xformer(m["attn"], _res(m["res1"], h, temb), ctx), temb)
    for stage in params["up"]:
        for blk in stage["blocks"]:
            h = up_block(blk, h, skips.pop())
        if "up_w" in stage:
            h = L.conv2d(upsample2x(h), stage["up_w"])
    h = L.silu(L.groupnorm(h, params["gn_out_s"], params["gn_out_b"]))
    return L.conv2d(h, params["conv_out"]).float()
