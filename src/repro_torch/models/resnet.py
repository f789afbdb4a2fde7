"""ResNet of the port (ResNet-152): serving and training, with the
forward's BatchNorm statistics.

Counterpart of ``repro/models/resnet.py``: a 7x7 stride-2 SAME stem
conv, BatchNorm and ReLU, a 3x3 stride-2 SAME max-pool (XLA's
``reduce_window``: -inf padding, the odd pixel at the end), four stages
of bottleneck blocks (1x1, 3x3 carrying the stage's stride, 1x1, each
with BatchNorm; a projection on each stage's first block), global
average pooling and a linear head. No kernel of the port: the
convolutions and products are cuDNN's and cuBLAS's; the backward is
autograd's. ``forward(..., train=True)`` wraps each bottleneck in
``layers.remat`` as the reference does (``cfg.remat``).

BatchNorm is functional, as in the reference: ``params`` hold each
norm's (scale, bias), a separate ``state`` its running (mean, var) in
float32. ``forward(..., train=True)`` normalizes with the batch
statistics and returns the running statistics updated with momentum
``BN_MOM``; eval uses the running statistics and returns them as they
are. Both trees keep the reference's layout: HWIO convs, ``stages`` a
list of stages, each a list of block dicts. ``init`` and ``from_numpy``
run on ``device="cuda"`` and raise without a card unless the caller
passes ``device="cpu"``; ``forward`` runs where the parameters are.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import VisionConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.tree import from_numpy  # noqa: F401  (the weight bridge)

BN_MOM = 0.9


def _dt(cfg: VisionConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def init(gen: torch.Generator, cfg: VisionConfig, device="cuda") -> Tuple[dict, dict]:
    """-> (params in ``cfg.param_dtype``, running statistics in float32
    at mean 0 and var 1), drawn from ``gen``, which must live on
    ``device``: fan-in scaled truncated normals for the convs, 0.02 for
    the head, BatchNorm scales at one and biases at zero."""
    device = resolve_device(device, meta=True)
    if gen.device.type != device.type:
        raise ValueError(f"the generator lives on {gen.device}, the weights go to {device}")
    dt = _dt(cfg)

    def bn(c):
        return {"scale": torch.ones(c, dtype=dt, device=device),
                "bias": torch.zeros(c, dtype=dt, device=device)}

    def bn_state(c):
        return {"mean": torch.zeros(c, device=device), "var": torch.ones(c, device=device)}

    w = cfg.width
    params = {"stem_w": L.conv_init(gen, 7, 7, 3, w, dt), "stem_bn": bn(w), "stages": []}
    state = {"stem_bn": bn_state(w), "stages": []}
    c_in = w
    for i, dep in enumerate(cfg.depths):
        c_mid = w * (2 ** i)
        c_out = c_mid * 4
        stage_p, stage_s = [], []
        for b in range(dep):
            p = {"w1": L.conv_init(gen, 1, 1, c_in, c_mid, dt), "bn1": bn(c_mid),
                 "w2": L.conv_init(gen, 3, 3, c_mid, c_mid, dt), "bn2": bn(c_mid),
                 "w3": L.conv_init(gen, 1, 1, c_mid, c_out, dt), "bn3": bn(c_out)}
            s = {"bn1": bn_state(c_mid), "bn2": bn_state(c_mid), "bn3": bn_state(c_out)}
            if b == 0:
                p["proj_w"] = L.conv_init(gen, 1, 1, c_in, c_out, dt)
                p["proj_bn"] = bn(c_out)
                s["proj_bn"] = bn_state(c_out)
            stage_p.append(p)
            stage_s.append(s)
            c_in = c_out
        params["stages"].append(stage_p)
        state["stages"].append(stage_s)
    params["head"] = L.dense_init(gen, c_in, cfg.n_classes, dt, 0.02)
    return params, state


def _bn(x, p, s, train):
    if train:
        y, mu, var = L.batchnorm_train(x, p["scale"], p["bias"])
        return y, {"mean": BN_MOM * s["mean"] + (1 - BN_MOM) * mu,
                   "var": BN_MOM * s["var"] + (1 - BN_MOM) * var}
    return L.batchnorm_eval(x, p["scale"], p["bias"], s["mean"], s["var"]), s


def _bottleneck(p, s, x, stride, train):
    h, s1 = _bn(L.conv2d(x, p["w1"]), p["bn1"], s["bn1"], train)
    h = torch.relu(h)
    h, s2 = _bn(L.conv2d(h, p["w2"], stride=stride), p["bn2"], s["bn2"], train)
    h = torch.relu(h)
    h, s3 = _bn(L.conv2d(h, p["w3"]), p["bn3"], s["bn3"], train)
    new_s = {"bn1": s1, "bn2": s2, "bn3": s3}
    if "proj_w" in p:
        sc, new_s["proj_bn"] = _bn(L.conv2d(x, p["proj_w"], stride=stride), p["proj_bn"],
                                   s["proj_bn"], train)
    else:
        sc = x
    return torch.relu(h + sc), new_s


def forward(params: dict, state: dict, cfg: VisionConfig, images: torch.Tensor,
            train: bool = False):
    """images (B, H, W, 3) -> (logits (B, n_classes) float32, the new
    running statistics: updated with the batch's if ``train``, else
    ``state``'s). ``train`` also rematerializes each bottleneck where
    ``cfg.remat`` asks (the numbers are the same)."""
    x = L.conv2d(images.to(_dt(cfg)), params["stem_w"], stride=2)
    x, stem_s = _bn(x, params["stem_bn"], state["stem_bn"], train)
    x = L.max_pool_same(torch.relu(x), 3, 2)
    new_state = {"stem_bn": stem_s, "stages": []}
    for i, (stage_p, stage_s) in enumerate(zip(params["stages"], state["stages"])):
        new_stage = []
        for b, (p, s) in enumerate(zip(stage_p, stage_s)):
            stride = 2 if (b == 0 and i > 0) else 1
            block = L.remat(lambda p, s, x, stride=stride: _bottleneck(p, s, x, stride, train),
                            cfg, train)
            x, ns = block(p, s, x)
            new_stage.append(ns)
        new_state["stages"].append(new_stage)
    x = torch.mean(x, dim=(1, 2))
    return (x @ params["head"]).float(), new_state
