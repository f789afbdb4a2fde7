"""Vision Transformer of the port (ViT-L/16, ViT-H/14): serving and
training.

Counterpart of ``repro/models/vit.py``: patchify by a VALID conv, a cls
token, learned position embeddings (resized bilinearly, as
``jax.image.resize``, for another resolution than init's), pre-norm
blocks of multi-head attention and a GELU MLP, a final LayerNorm and a
linear head on the cls token. ``forward(..., train=True)`` wraps each
block in ``layers.remat`` as the reference does (``cfg.remat``); the
backward is autograd's, through the ``flash_attention`` kernel's own.

Parameters are a dict of tensors in the reference's layout: the patch
conv HWIO, dense weights (d_in, d_out) used as ``x @ w``, the blocks'
leaves stacked on a leading layer axis under ``blocks``. The layers run
in a Python loop over the stack unbound once (``layers.unstack``). Attention goes through ``ops.attention`` (on CUDA the
``flash_attention`` kernel's tensor-core entry in bf16: ViT-L/16's heads
of 64 natively, ViT-H/14's heads of 80 zero-padded to 128 by the
wrapper).

``init`` and ``from_numpy`` run on ``device="cuda"`` and raise without
a card unless the caller passes ``device="cpu"``; ``forward`` runs where
the parameters are.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import VisionConfig
from repro_torch.core.tiling import resize_tiles
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.sharding import ctx as mesh_ctx
from repro_torch.tree import from_numpy  # noqa: F401  (the weight bridge)


def _dt(cfg: VisionConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def init(gen: torch.Generator, cfg: VisionConfig, device="cuda") -> dict:
    """Random weights in ``cfg.param_dtype`` drawn from ``gen``, which
    must live on ``device``. Truncated normals as the reference's: fan-in
    scaling for the patch conv and the dense weights, 0.02 for the cls
    token, the position embeddings and the head; norms at one, biases
    at zero."""
    device = resolve_device(device, meta=True)
    if gen.device.type != device.type:
        raise ValueError(f"the generator lives on {gen.device}, the weights go to {device}")
    dt, d, f, n = _dt(cfg), cfg.d_model, cfg.d_ff, cfg.n_layers
    n_tok = (cfg.img_res // cfg.patch) ** 2 + 1  # + cls

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    blocks = {
        "ln1_s": ones(n, d), "ln1_b": zeros(n, d),
        "ln2_s": ones(n, d), "ln2_b": zeros(n, d),
        "wqkv": L.dense_init(gen, d, 3 * d, dt, lead=(n,)), "bqkv": zeros(n, 3 * d),
        "wo": L.dense_init(gen, d, d, dt, lead=(n,)), "bo": zeros(n, d),
        "w_in": L.dense_init(gen, d, f, dt, lead=(n,)), "b_in": zeros(n, f),
        "w_out": L.dense_init(gen, f, d, dt, lead=(n,)), "b_out": zeros(n, d),
    }
    return {
        "patch_w": L.conv_init(gen, cfg.patch, cfg.patch, 3, d, dt),
        "patch_b": zeros(d),
        "cls": L.truncated_normal(gen, (1, 1, d), 0.02, dt),
        "pos": L.truncated_normal(gen, (1, n_tok, d), 0.02, dt),
        "blocks": blocks,
        "ln_f_s": ones(d), "ln_f_b": zeros(d),
        "head": L.dense_init(gen, d, cfg.n_classes, dt, 0.02),
    }


def attention_inputs(p: dict, cfg: VisionConfig, x: torch.Tensor):
    """Layer ``p``'s pre-norm q, k, v (B, S, H, D), contiguous (the
    kernel reads contiguous tensors; the reference's split gives strided
    views)."""
    b, s, d = x.shape
    h = L.layernorm(x, p["ln1_s"], p["ln1_b"])
    qkv = mesh_ctx.split_heads(h @ p["wqkv"] + p["bqkv"], b, s, 3 * cfg.n_heads,
                               d // cfg.n_heads)
    return [t.contiguous() for t in torch.split(qkv, cfg.n_heads, dim=2)]


def _block(p: dict, cfg: VisionConfig, x: torch.Tensor) -> torch.Tensor:
    b, s, d = x.shape
    q, k, v = attention_inputs(p, cfg, x)
    a = kops.attention(q, k, v, causal=False)
    x = x + a.reshape(b, s, d) @ p["wo"] + p["bo"]
    h = L.layernorm(x, p["ln2_s"], p["ln2_b"])
    return x + L.gelu_mlp(h, p["w_in"], p["b_in"], p["w_out"], p["b_out"])


def embed(params: dict, cfg: VisionConfig, images: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, 3) -> the first block's input (B, 1 + gh * gw, D):
    the cls token, then the patches, plus the position embeddings (the
    grid resized bilinearly in float32 where gh * gw differs from
    init's)."""
    x = L.conv2d(images.to(_dt(cfg)), params["patch_w"], stride=cfg.patch,
                 padding="VALID") + params["patch_b"]
    b, gh, gw, d = x.shape
    x = x.reshape(b, gh * gw, d)
    pos = params["pos"]
    n_img = pos.shape[1] - 1
    if gh * gw != n_img:
        side = int(round(n_img ** 0.5))
        grid = resize_tiles(pos[:, 1:, :].reshape(1, side, side, d), (gh, gw))
        pos = torch.cat([pos[:, :1, :], grid.to(pos.dtype).reshape(1, gh * gw, d)], dim=1)
    cls = params["cls"].expand(b, 1, d).to(x.dtype)
    return torch.cat([cls, x], dim=1) + pos


def forward(params: dict, cfg: VisionConfig, images: torch.Tensor,
            train: bool = False) -> torch.Tensor:
    """images (B, H, W, 3) -> logits (B, n_classes) float32. Layer i
    reads slice i of the stacked block leaves; ``train`` rematerializes
    each block where ``cfg.remat`` asks (the numbers are the same)."""
    x = embed(params, cfg, images)
    block = L.remat(lambda p, xb: _block(p, cfg, xb), cfg, train)
    for p in L.unstack(params["blocks"]):
        x = block(p, x)
    x = L.layernorm(x, params["ln_f_s"], params["ln_f_b"])
    return (x[:, 0, :] @ params["head"]).float()
