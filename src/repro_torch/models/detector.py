"""Single-shot detector 'counters' (the paper's Table II models), PyTorch.

Counterpart of ``repro/models/detector.py``: stride-2 conv stages and a
1x1 head emitting (box4, obj1, class C) per cell and anchor; counting is
decode -> NMS (the ``iou_matrix`` kernel, batched over the counting
batch) -> count above threshold, with the mean kept score as the tile's
confidence. Parameters are a dict of tensors in the reference's layout
(HWIO conv weights), so :func:`params_from_jax` carries the reference's
weights over as they are.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import DetectorConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L


def init(gen: torch.Generator, cfg: DetectorConfig, device="cuda") -> dict:
    """Random weights from ``gen`` (drawn on the CPU, then moved to
    ``device``: "cuda", the default, raises without a card, or "cpu")."""
    device = resolve_device(device)
    p = {"stem": L.conv_init(gen, 3, 3, 3, cfg.widths[0]), "stages": []}
    prev = cfg.widths[0]
    for w in cfg.widths[1:]:
        stage = [{"w": L.conv_init(gen, 3, 3, prev, w), "b": torch.zeros(w)}]
        for _ in range(cfg.n_blocks_per_stage - 1):
            stage.append({"w": L.conv_init(gen, 3, 3, w, w), "b": torch.zeros(w)})
        p["stages"].append(stage)
        prev = w
    n_out = cfg.n_anchors * (5 + cfg.n_classes)
    p["head_w"] = L.truncated_normal(gen, (1, 1, prev, n_out), 0.01)
    p["head_b"] = torch.zeros(n_out)
    return to_device(p, device)


def to_device(tree, device):
    """The parameter tree with every tensor on ``device`` (float32)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, device) for v in tree]
    return torch.as_tensor(tree, dtype=torch.float32).to(device)


def params_from_jax(tree) -> dict:
    """A reference parameter tree (nested dicts/lists of numpy or JAX
    arrays, HWIO weights) -> the same tree of CPU float32 tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v) for v in tree]
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def load_jax_checkpoint(ckpt_dir: str, step: int = None) -> dict:
    """Read the newest committed step of a reference checkpoint (a
    ``step_XXXXXXXX/`` folder with ``manifest.json`` and ``arrays.npz``)
    with numpy alone -> the parameter tree of CPU tensors."""
    if step is None:
        steps = sorted(
            int(d[5:]) for d in (os.listdir(ckpt_dir) if os.path.isdir(ckpt_dir) else [])
            if d.startswith("step_") and not d.endswith(".tmp")
            and os.path.exists(os.path.join(ckpt_dir, d, "COMMITTED")))
        if not steps:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
        step = steps[-1]
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as data:
        vals = [np.asarray(data[f"a{i}"], np.float32)
                for i in range(len(manifest["keys"]))]
    tree: dict = {}
    for key, val in zip(manifest["keys"], vals):
        *path, leaf = key.split("/")
        node = tree
        for part, nxt in zip(path, path[1:] + [leaf]):
            node = _child(node, part, list if nxt.isdigit() else dict)
        _set(node, leaf, val)
    return params_from_jax(tree)


def _child(node, part: str, kind):
    if isinstance(node, list):
        i = int(part)
        while len(node) <= i:
            node.append(kind())
        return node[i]
    return node.setdefault(part, kind())


def _set(node, part: str, val) -> None:
    if isinstance(node, list):
        i = int(part)
        while len(node) <= i:
            node.append(None)
        node[i] = val
    else:
        node[part] = val


def forward(params: dict, cfg: DetectorConfig, images: torch.Tensor) -> torch.Tensor:
    """images (B, S, S, 3) in [0,1] -> raw head (B, G, G, A, 5+C).

    Works in NCHW inside (a channels-last view of the NHWC input); the
    bias is added after each convolution, as the reference does.
    """
    def bias(b):
        return b[None, :, None, None]

    x = images.to(torch.float32).permute(0, 3, 1, 2)
    x = F.leaky_relu(L.conv2d_nchw(x, L.hwio_to_oihw(params["stem"])), 0.1)
    for stage in params["stages"]:
        for j, blk in enumerate(stage):
            x = L.conv2d_nchw(x, L.hwio_to_oihw(blk["w"]),
                              stride=2 if j == 0 else 1) + bias(blk["b"])
            x = F.leaky_relu(x, 0.1)
    x = L.conv2d_nchw(x, L.hwio_to_oihw(params["head_w"])) + bias(params["head_b"])
    b, g = x.shape[0], x.shape[2]
    return x.permute(0, 2, 3, 1).reshape(b, g, g, cfg.n_anchors, 5 + cfg.n_classes)


def decode(raw: torch.Tensor, cfg: DetectorConfig, input_size=None):
    """raw (B,G,G,A,5+C) -> (boxes (B,N,4) xyxy in px, scores (B,N))."""
    b, g = raw.shape[0], raw.shape[1]
    s = input_size or cfg.input_size
    cell = s / g
    ar = torch.arange(g, dtype=torch.float32, device=raw.device) + 0.5
    cy = ar[None, :, None, None]
    cx = ar[None, None, :, None]
    box = torch.sigmoid(raw[..., :4])
    # xy offset within cell [-0.5, 0.5]; wh up to 4 cells
    bx = (cx + box[..., 0] - 0.5) * cell
    by = (cy + box[..., 1] - 0.5) * cell
    bw = box[..., 2] * 4 * cell
    bh = box[..., 3] * 4 * cell
    boxes = torch.stack([bx - bw / 2, by - bh / 2, bx + bw / 2, by + bh / 2], -1)
    obj = torch.sigmoid(raw[..., 4])
    cls = torch.softmax(raw[..., 5:], -1).amax(-1)
    scores = obj * cls
    n = g * g * cfg.n_anchors
    return boxes.reshape(b, n, 4), scores.reshape(b, n)


def nms_keep(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh=0.5,
             score_thresh=0.3, max_det=128) -> torch.Tensor:
    """Greedy NMS: (..., N, 4), (..., N) -> keep mask (..., N) bool.

    The top ``max_det`` candidates by a stable descending sort (ties to
    the lower index, as ``lax.top_k``), their IoU matrix from the kernel
    in one batched launch, then the greedy suppression over all images
    of the batch at once.
    """
    n = boxes.shape[-2]
    k = min(max_det, n)
    top_s, top_i = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_s, top_i = top_s[..., :k], top_i[..., :k]
    top_b = torch.gather(boxes, -2, top_i[..., None].expand(*top_i.shape, 4))
    iou = kops.iou_matrix(top_b.contiguous(), top_b.contiguous())
    keep = top_s > score_thresh
    ar = torch.arange(k, device=boxes.device)
    later = ar[None, :] > ar[:, None]  # later[i, j]: j after i
    over = iou > iou_thresh
    for i in range(k):
        keep = keep & ~(over[..., i, :] & later[i] & keep[..., i:i + 1])
    return torch.zeros(scores.shape, dtype=torch.bool,
                       device=scores.device).scatter(-1, top_i, keep)


def count_and_confidence(raw: torch.Tensor, cfg: DetectorConfig,
                         score_thresh=0.3, iou_thresh=0.5, input_size=None):
    """Per-tile object count + mean-score confidence after NMS.

    raw (B,G,G,A,5+C) -> (count (B,) f32, conf (B,) f32 in [0,1]).
    """
    boxes, scores = decode(raw, cfg, input_size)
    keep = nms_keep(boxes, scores, iou_thresh, score_thresh)
    cnt = keep.to(torch.float32).sum(-1)
    conf = (scores * keep).sum(-1) / torch.clamp(cnt, min=1.0)
    return cnt, conf
