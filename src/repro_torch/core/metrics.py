"""Counting metrics of the port: CMAE (the paper's headline metric) and
the mAP@0.5 of the tile-size study (Fig. 4).

Counterpart of ``repro/core/metrics.py``. :func:`ap50` takes each
image's IoU matrix with ``ops.iou_matrix`` on ``device`` (the
``iou_matrix_f32`` kernel on the card, the plain version on the CPU);
the greedy matching and the AP stay on the host, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops


def cmae(pred_counts, true_counts) -> float:
    """Count Mean Absolute Error: sum|y_i - g_i| / sum g_i (paper §IV-A6)."""
    y = np.asarray(pred_counts, dtype=np.float64)
    g = np.asarray(true_counts, dtype=np.float64)
    denom = max(g.sum(), 1e-9)
    return float(np.abs(y - g).sum() / denom)


def ap50(pred_boxes, pred_scores, gt_boxes, iou_thresh: float = 0.5,
         device="cuda") -> float:
    """Average precision at IoU 0.5 for one class over a list of images.

    pred_boxes: list of (Ni, 4) xyxy; pred_scores: list of (Ni,); gt_boxes:
    list of (Mi, 4). Greedy score-ordered matching, 101-point
    interpolation. The IoU is float32, one ``ops.iou_matrix`` call an
    image with predictions and ground truth, on ``device`` ("cuda", the
    default, raises without a card; or "cpu").
    """
    device = resolve_device(device)
    rows = []  # (score, is_tp)
    n_gt = 0
    for pb, ps, gb in zip(pred_boxes, pred_scores, gt_boxes):
        pb, ps, gb = np.asarray(pb), np.asarray(ps), np.asarray(gb)
        n_gt += len(gb)
        if len(pb) == 0:
            continue
        order = np.argsort(-ps)
        pb, ps = pb[order], ps[order]
        matched = np.zeros(len(gb), bool)
        if len(gb):
            a, b = (torch.as_tensor(v, dtype=torch.float32).reshape(-1, 4).to(device)
                    for v in (pb, gb))
            iou = kops.iou_matrix(a, b).cpu().numpy()
        for i in range(len(pb)):
            tp = False
            if len(gb):
                j = int(np.argmax(iou[i] * ~matched))
                if iou[i, j] >= iou_thresh and not matched[j]:
                    matched[j] = True
                    tp = True
            rows.append((ps[i], tp))
    if not rows or n_gt == 0:
        return 0.0
    rows.sort(key=lambda r: -r[0])
    tps = np.array([r[1] for r in rows], dtype=np.float64)
    cum_tp = np.cumsum(tps)
    precision = cum_tp / (np.arange(len(rows)) + 1)
    recall = cum_tp / n_gt
    ap = 0.0
    for r in np.linspace(0, 1, 101):  # 101-point interpolated AP
        p = precision[recall >= r]
        ap += (p.max() if len(p) else 0.0) / 101
    return float(ap)
