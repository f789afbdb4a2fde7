"""Satellite-ground cascade: counting tiles with a counter, PyTorch.

Counterpart of the counting half of ``repro/core/cascade.py``. Every
forward runs at a power-of-two batch tier (the trailing batch and a
gathered subset are padded), as the reference's compiled programs do;
the detector is per-sample, so padding never changes a real tile.
Results stay on the device until one host copy at the end.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import DetectorConfig
from repro_torch.core.dedup import bucket_size
from repro_torch.models import detector


def count_tiles(params, cfg: DetectorConfig, tiles, score_thresh: float = 0.3,
                nms_iou: float = 0.25):
    """tiles (N, S, S, 3) already at cfg.input_size -> (counts, conf)."""
    raw = detector.forward(params, cfg, tiles)
    return detector.count_and_confidence(raw, cfg, score_thresh=score_thresh,
                                         iou_thresh=nms_iou)


def _tier_batch(n: int, batch: int, floor: int = 8) -> int:
    """The smallest power-of-two tier in [floor, batch] covering ``n``."""
    return min(bucket_size(n, floor), batch)


def _count_forward(params, cfg, t, batch: int, score_thresh, nms_iou) -> np.ndarray:
    """Zero-pad rows to whole ``batch`` chunks, count chunk by chunk, and
    copy (counts, conf) to the host once -> (2, n_rows_padded)."""
    pad = -t.shape[0] % batch
    if pad:
        t = torch.cat([t, t.new_zeros((pad, *t.shape[1:]))])
    outs_c, outs_f = [], []
    for chunk in t.split(batch):
        c, f = count_tiles(params, cfg, chunk, score_thresh, nms_iou)
        outs_c.append(c)
        outs_f.append(f)
    return torch.stack([torch.cat(outs_c), torch.cat(outs_f)]).cpu().numpy()


def count_tiles_batched(params, cfg, tiles, batch: int = 64, score_thresh=0.3,
                        nms_iou: float = 0.25, idx=None):
    """Count ``tiles`` (or ``tiles[idx]``, gathered on the device) in
    fixed-shape batches -> host (counts, conf) float32 arrays."""
    n = int(len(idx)) if idx is not None else tiles.shape[0]
    if n == 0:
        return np.zeros((0,), np.float32), np.zeros((0,), np.float32)
    batch = _tier_batch(n, batch)
    if idx is not None:
        n_pad = -(-n // batch) * batch
        idx_pad = np.zeros(n_pad, np.int64)
        idx_pad[:n] = np.asarray(idx)
        t = tiles.index_select(0, torch.from_numpy(idx_pad).to(tiles.device))
    else:
        t = tiles
    out = _count_forward(params, cfg, t, batch, score_thresh, nms_iou)
    return out[0, :n], out[1, :n]
