"""DiT (Diffusion Transformer, DiT-S/2) of the port: serving and
training.

Counterpart of ``repro/models/dit.py``: patchified VAE latents (a stub
VAE: 8x downsample, 4 channels) plus a 2-D sin-cos position embedding,
adaLN-Zero blocks conditioned on the timestep and class embedding,
multi-head self-attention and a GELU MLP, a final adaLN and a linear
unpatchify to (eps, sigma). ``forward(..., train=True)`` wraps each
block in ``layers.remat`` as the reference does (``cfg.remat``); the
backward is autograd's, through the ``flash_attention`` kernel's own.

Parameters are a dict of tensors in the reference's layout: dense
weights (d_in, d_out) used as ``x @ w``, the blocks' leaves stacked on a
leading layer axis under ``blocks``; the layers run in a Python loop
over the stack unbound once (``layers.unstack``).
``init`` zeroes the adaLN-Zero leaves (``ADALN_ZERO``) as the reference
does, so a forward from it returns exactly 0. Attention goes through
``ops.attention`` (on CUDA in bf16 the ``flash_attention`` kernel's
tensor-core entry: DiT-S/2's heads are 64 wide).

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

# the leaves init sets to zero (adaLN-Zero): (blocks' leaves, top-level leaves)
ADALN_ZERO = (("ada_w", "ada_b"), ("final_ada_w", "final_ada_b", "final_w", "final_b"))


def _dt(cfg: DiffusionConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def latent_res(cfg: DiffusionConfig, img_res: int = None) -> int:
    return (img_res or cfg.img_res) // cfg.latent_factor


def init(gen: torch.Generator, cfg: DiffusionConfig, device="cuda") -> dict:
    """Random weights in ``cfg.param_dtype`` drawn from ``gen``, which
    must live on ``device``: fan-in truncated normals for the dense
    weights, 0.02 for the class embedding (``n_classes + 1`` rows, the
    last the null class), biases and the adaLN-Zero leaves at zero."""
    device = resolve_device(device, meta=True)
    if gen.device.type != device.type:
        raise ValueError(f"the generator lives on {gen.device}, the weights go to {device}")
    dt, d, c, p, n = _dt(cfg), cfg.d_model, cfg.latent_ch, cfg.patch, cfg.n_layers

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    blocks = {
        "wqkv": L.dense_init(gen, d, 3 * d, dt, lead=(n,)),
        "wo": L.dense_init(gen, d, d, dt, lead=(n,)),
        "w_in": L.dense_init(gen, d, 4 * d, dt, lead=(n,)),
        "w_out": L.dense_init(gen, 4 * d, d, dt, lead=(n,)),
        "ada_w": zeros(n, d, 6 * d), "ada_b": zeros(n, 6 * d),
    }
    return {
        "patch_w": L.dense_init(gen, c * p * p, d, dt), "patch_b": zeros(d),
        "t_w1": L.dense_init(gen, 256, d, dt), "t_b1": zeros(d),
        "t_w2": L.dense_init(gen, d, d, dt), "t_b2": zeros(d),
        "y_emb": L.truncated_normal(gen, (cfg.n_classes + 1, d), 0.02, dt),
        "blocks": blocks,
        "final_ada_w": zeros(d, 2 * d), "final_ada_b": zeros(2 * d),
        "final_w": zeros(d, p * p * c * 2), "final_b": zeros(p * p * c * 2),
    }


def _modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def _ln(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm without scale or bias, eps 1e-6, in float32 (population
    variance), cast back to x's dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + 1e-6)).to(x.dtype)


def attention_inputs(h: torch.Tensor, wqkv: torch.Tensor, n_heads: int):
    """q, k, v (B, S, H, D) of the modulated input ``h``, contiguous (the
    kernel reads contiguous tensors; the reference's split gives strided
    views)."""
    b, s, d = h.shape
    qkv = mesh_ctx.split_heads(h @ wqkv, b, s, 3 * n_heads, d // n_heads)
    return [t.contiguous() for t in torch.split(qkv, n_heads, dim=2)]


def _block(p: dict, cfg: DiffusionConfig, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    b, s, d = x.shape
    ada = L.silu(cond) @ p["ada_w"] + p["ada_b"]
    sh1, sc1, g1, sh2, sc2, g2 = torch.chunk(ada, 6, dim=-1)
    q, k, v = attention_inputs(_modulate(_ln(x), sh1, sc1), p["wqkv"], cfg.n_heads)
    a = kops.attention(q, k, v, causal=False).reshape(b, s, d)
    x = x + g1[:, None, :] * _rows(a @ p["wo"])
    h = _modulate(_ln(x), sh2, sc2)
    h = _rows(L.gelu(h @ p["w_in"]) @ p["w_out"])
    return x + g2[:, None, :] * h


def _rows(y: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's output (a partial sum on a mesh) reduced
    whole on "model", the rows over the data axes; off a mesh, y. DTensor
    would reduce-scatter it over the tokens, and a later product cannot
    take the tokens split over two mesh dims."""
    return mesh_ctx.constrain(y, ("pod", "data"), None, None)


def embed(params: dict, cfg: DiffusionConfig, latents: torch.Tensor, t: torch.Tensor,
          y: torch.Tensor):
    """-> (the first block's input (B, gh * gw, D): the patches plus the
    2-D sin-cos position embedding; the conditioning (B, D): the
    timestep's MLP plus the class embedding)."""
    dt, d, p = _dt(cfg), cfg.d_model, cfg.patch
    b, hl, wl, c = latents.shape
    gh, gw = hl // p, wl // p
    x = latents.to(dt).reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, gh * gw, p * p * c) @ params["patch_w"] + params["patch_b"]
    # resolution-agnostic, so gen_1024 runs the weights of 256 px
    dev = latents.device
    ph = L.sinusoidal_embedding(torch.arange(gh, device=dev), d // 2)
    pw = L.sinusoidal_embedding(torch.arange(gw, device=dev), d // 2)
    pos = torch.cat([ph[:, None, :].expand(gh, gw, d // 2),
                     pw[None, :, :].expand(gh, gw, d // 2)], dim=-1).reshape(1, gh * gw, d)
    x = x + pos.to(dt)
    temb = L.sinusoidal_embedding(t, 256).to(dt)
    cond = L.silu(temb @ params["t_w1"] + params["t_b1"])
    cond = cond @ params["t_w2"] + params["t_b2"]
    return x, cond + params["y_emb"][y]


def forward(params: dict, cfg: DiffusionConfig, latents: torch.Tensor, t: torch.Tensor,
            y: torch.Tensor, train: bool = False):
    """latents (B, Hl, Wl, C), t (B,) timesteps, y (B,) class ids ->
    (eps, sigma), each (B, Hl, Wl, C) float32. Layer i reads slice i of
    the stacked block leaves; ``train`` rematerializes each block where
    ``cfg.remat`` asks (the numbers are the same)."""
    b, hl, wl, c = latents.shape
    p = cfg.patch
    x, cond = embed(params, cfg, latents, t, y)
    block = L.remat(lambda pb, xb: _block(pb, cfg, xb, cond), cfg, train)
    for pb in L.unstack(params["blocks"]):
        x = block(pb, x)
    ada = L.silu(cond) @ params["final_ada_w"] + params["final_ada_b"]
    sh, sc = torch.chunk(ada, 2, dim=-1)
    x = _modulate(_ln(x), sh, sc) @ params["final_w"] + params["final_b"]
    x = x.reshape(b, hl // p, wl // p, p, p, 2 * c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, hl, wl, 2 * c)
    return x[..., :c].float(), x[..., c:].float()
