"""ConvNeXt of the port (ConvNeXt-B): serving and training.

Counterpart of ``repro/models/convnext.py``: a 4x4 stride-4 patchify
stem and its LayerNorm, four stages of blocks (7x7 depthwise SAME conv,
LayerNorm, inverted MLP with GELU, a layer scale ``gamma``, a residual),
a LayerNorm and 2x2 stride-2 VALID conv between stages, global average
pooling, LayerNorm and a linear head. No kernel of the port: the
convolutions and products are cuDNN's and cuBLAS's.
``forward(..., train=True)`` wraps each block in ``layers.remat`` as the
reference does (``cfg.remat``); the backward is autograd's.

Parameters are a dict of tensors in the reference's layout: HWIO convs
(the depthwise ones (7, 7, 1, C), run with ``groups=C``), dense weights
(d_in, d_out); ``stages`` is a list of one dict a stage whose leaves
stack the stage's blocks on a leading axis, ``downs`` a list of the
three downsamplers. ``init`` and ``from_numpy`` run on ``device="cuda"``
and raise without a card unless the caller passes ``device="cpu"``;
``forward`` runs where the parameters are.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import VisionConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.tree import from_numpy  # noqa: F401  (the weight bridge)


def _dt(cfg: VisionConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def init(gen: torch.Generator, cfg: VisionConfig, device="cuda") -> dict:
    """Random weights in ``cfg.param_dtype`` drawn from ``gen``, which
    must live on ``device``: fan-in scaled truncated normals for the
    convs and dense weights, 0.02 for the head, norms at one, biases at
    zero, ``gamma`` at 1e-6, as the reference's."""
    device = resolve_device(device, meta=True)
    if gen.device.type != device.type:
        raise ValueError(f"the generator lives on {gen.device}, the weights go to {device}")
    dt = _dt(cfg)

    def full(shape, v):
        return torch.full(shape, v, dtype=dt, device=device)

    c0 = cfg.dims[0]
    params = {"stem_w": L.conv_init(gen, 4, 4, 3, c0, dt), "stem_b": full((c0,), 0.0),
              "stem_ln_s": full((c0,), 1.0), "stem_ln_b": full((c0,), 0.0),
              "stages": [], "downs": []}
    for i, (dep, dim) in enumerate(zip(cfg.depths, cfg.dims)):
        params["stages"].append({
            "dw": L.conv_init(gen, 7, 7, 1, dim, dt, lead=(dep,)),
            "ln_s": full((dep, dim), 1.0), "ln_b": full((dep, dim), 0.0),
            "pw1": L.dense_init(gen, dim, 4 * dim, dt, lead=(dep,)),
            "b1": full((dep, 4 * dim), 0.0),
            "pw2": L.dense_init(gen, 4 * dim, dim, dt, lead=(dep,)),
            "b2": full((dep, dim), 0.0),
            "gamma": full((dep, dim), 1e-6)})
        if i + 1 < len(cfg.dims):
            nxt = cfg.dims[i + 1]
            params["downs"].append({"ln_s": full((dim,), 1.0), "ln_b": full((dim,), 0.0),
                                    "w": L.conv_init(gen, 2, 2, dim, nxt, dt),
                                    "b": full((nxt,), 0.0)})
    last = cfg.dims[-1]
    params["head_ln_s"] = full((last,), 1.0)
    params["head_ln_b"] = full((last,), 0.0)
    params["head"] = L.dense_init(gen, last, cfg.n_classes, dt, 0.02)
    return params


def _block(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = L.conv2d(x, p["dw"], groups=x.shape[-1])
    h = L.layernorm(h, p["ln_s"], p["ln_b"])
    h = L.gelu(h @ p["pw1"] + p["b1"])
    h = h @ p["pw2"] + p["b2"]
    return x + p["gamma"] * h


def forward(params: dict, cfg: VisionConfig, images: torch.Tensor,
            train: bool = False) -> torch.Tensor:
    """images (B, H, W, 3) -> logits (B, n_classes) float32. A stage's
    block j reads slice j of its stacked leaves (unbound once); ``train``
    rematerializes each block where ``cfg.remat`` asks (the numbers are
    the same)."""
    x = L.conv2d(images.to(_dt(cfg)), params["stem_w"], stride=4,
                 padding="VALID") + params["stem_b"]
    x = L.layernorm(x, params["stem_ln_s"], params["stem_ln_b"])
    block = L.remat(_block, cfg, train)
    for i, stage in enumerate(params["stages"]):
        for p in L.unstack(stage):
            x = block(p, x)
        if i < len(params["downs"]):
            d = params["downs"][i]
            x = L.layernorm(x, d["ln_s"], d["ln_b"])
            x = L.conv2d(x, d["w"], stride=2, padding="VALID") + d["b"]
    x = torch.mean(x, dim=(1, 2))
    x = L.layernorm(x, params["head_ln_s"], params["head_ln_b"])
    return (x @ params["head"]).float()
