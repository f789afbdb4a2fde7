"""Single-shot detector 'counters' (the paper's Table II models), PyTorch.

Counterpart of ``repro/models/detector.py``: stride-2 conv stages and a
1x1 head emitting (box4, obj1, class C) per cell and anchor; counting is
decode -> NMS (the ``iou_matrix`` library's ``nms_keep_f32``, one launch
a counting batch) -> count above threshold, with the mean kept score as
the tile's confidence. Parameters are a dict of tensors in the reference's layout
(HWIO conv weights), so :func:`params_from_jax` carries the reference's
weights over as they are, and ``repro_torch.checkpoint.ckpt`` reads the
reference's checkpoints. :func:`loss_fn` is the training loss; autograd
differentiates it through :func:`forward`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import DetectorConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L


def init(gen: torch.Generator, cfg: DetectorConfig, device="cuda") -> dict:
    """Random weights from ``gen`` (drawn on the CPU, then moved to
    ``device``: "cuda", the default, raises without a card, or "cpu"; or
    with ``layers.SHAPES_ONLY`` shapes alone on "meta")."""
    device = resolve_device(device, meta=True)
    p = {"stem": L.conv_init(gen, 3, 3, 3, cfg.widths[0]), "stages": []}
    prev = cfg.widths[0]
    for w in cfg.widths[1:]:
        stage = [{"w": L.conv_init(gen, 3, 3, prev, w), "b": torch.zeros(w, device=gen.device)}]
        for _ in range(cfg.n_blocks_per_stage - 1):
            stage.append({"w": L.conv_init(gen, 3, 3, w, w), "b": torch.zeros(w, device=gen.device)})
        p["stages"].append(stage)
        prev = w
    n_out = cfg.n_anchors * (5 + cfg.n_classes)
    p["head_w"] = L.truncated_normal(gen, (1, 1, prev, n_out), 0.01)
    p["head_b"] = torch.zeros(n_out, device=gen.device)
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


def grid_size(cfg: DetectorConfig, input_size=None) -> int:
    return (input_size or cfg.input_size) // (2 ** len(cfg.widths[1:]))


def forward(params: dict, cfg: DetectorConfig, images: torch.Tensor) -> torch.Tensor:
    """images (B, S, S, 3) in [0,1] -> raw head (B, G, G, A, 5+C).

    Works in NCHW inside (a channels-last view of the NHWC input) and in
    the weights' dtype (float32 for every counter config, as the
    reference's param dtype); the bias is added after each convolution,
    as the reference does.
    """
    def bias(b):
        return b[None, :, None, None]

    x = images.to(params["stem"].dtype).permute(0, 3, 1, 2)
    x = F.leaky_relu(L.conv2d_nchw(x, L.hwio_to_oihw(params["stem"])), 0.1)
    for stage in params["stages"]:
        for j, blk in enumerate(stage):
            x = L.conv2d_nchw(x, L.hwio_to_oihw(blk["w"]),
                              stride=2 if j == 0 else 1) + bias(blk["b"])
            x = F.leaky_relu(x, 0.1)
    x = L.conv2d_nchw(x, L.hwio_to_oihw(params["head_w"])) + bias(params["head_b"])
    b, g = x.shape[0], x.shape[2]
    return x.permute(0, 2, 3, 1).reshape(b, g, g, cfg.n_anchors, 5 + cfg.n_classes)


def loss_fn(params: dict, cfg: DetectorConfig, images: torch.Tensor,
            targets: torch.Tensor):
    """targets (B,G,G,A,5+C): [x,y,w,h (cell units), obj, onehot-class]
    -> (2 obj + 5 box + cls, {"obj", "box", "cls"}), the reference's
    formulas: the objectness BCE from logits with positives weighted 16,
    the box MSE through a sigmoid at positives, the class cross-entropy
    through a log-softmax at positives."""
    raw = forward(params, cfg, images)
    obj_t = targets[..., 4]
    obj_logit = raw[..., 4]
    bce = (torch.maximum(obj_logit, torch.zeros_like(obj_logit)) - obj_logit * obj_t
           + torch.log1p(torch.exp(-torch.abs(obj_logit))))
    # positives are ~1% of cells; upweight them so objectness converges
    w = torch.where(obj_t > 0, 16.0, 1.0)
    obj_loss = torch.sum(w * bce) / torch.sum(w)
    n_pos = torch.clamp(torch.sum(obj_t), min=1.0)
    pos = obj_t[..., None]
    box_loss = torch.sum(pos * torch.square(torch.sigmoid(raw[..., :4]) - targets[..., :4]))
    box_loss = box_loss / n_pos
    logp = torch.log_softmax(raw[..., 5:], dim=-1)
    cls_loss = -torch.sum(obj_t * torch.sum(targets[..., 5:] * logp, -1)) / n_pos
    return 2.0 * obj_loss + 5.0 * box_loss + cls_loss, {
        "obj": obj_loss, "box": box_loss, "cls": cls_loss}


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
    the lower index, as ``lax.top_k``), then the suppression over all
    images of the batch at once: on the card one ``nms_keep_f32`` launch,
    on the CPU the plain loop (``ref.nms_keep``).
    """
    k = min(max_det, boxes.shape[-2])
    top_s, top_i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return kops.nms_keep(boxes, top_i[..., :k], top_s[..., :k], iou_thresh, score_thresh)


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
