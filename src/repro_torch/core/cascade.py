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
from repro_torch.core import xfer
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


def _count_tiles_chunks(params, cfg: DetectorConfig, chunks, score_thresh: float,
                        nms_iou: float):
    """:func:`count_tiles` over a stack of equal chunks (n_chunks, batch,
    S, S, 3) -> (counts, conf), each (n_chunks, batch): chunk by chunk,
    one NMS launch a chunk (the reference vmaps the chunk axis; the
    detector is per-sample, so a chunk's counts are its own)."""
    outs = [count_tiles(params, cfg, chunk, score_thresh, nms_iou) for chunk in chunks]
    return torch.stack([c for c, _ in outs]), torch.stack([f for _, f in outs])


def _count_forward_device(params, cfg, t, batch: int, score_thresh,
                          nms_iou) -> torch.Tensor:
    """:func:`_count_forward` without the host copy -> (2, n_rows_padded)
    on the device."""
    pad = -t.shape[0] % batch
    if pad:
        t = torch.cat([t, t.new_zeros((pad, *t.shape[1:]))])
    c, f = _count_tiles_chunks(params, cfg, t.reshape(-1, batch, *t.shape[1:]),
                               score_thresh, nms_iou)
    return torch.stack([c.reshape(-1), f.reshape(-1)])


def count_tiles_multi(params, cfg, parts, batch: int = 64, score_thresh=0.3,
                      nms_iou: float = 0.25, defer: bool = False):
    """Count several independent gathers in shared fixed-shape batches.

    Counterpart of ``repro/core/cascade.py``'s ``count_tiles_multi``.
    ``parts``: list of ``(tiles, idx)``, e.g. one a satellite, each
    gathering a subset of its own bucketed tile tensor. Each gather is
    padded to a power-of-two size (floor 2; pad slots gather tile 0 and
    are trimmed), the gathers are concatenated and counted in batches of
    one size tier, and the results split back per part: the same counts
    as :func:`count_tiles_batched` per part, with the trailing batch's
    padding paid once for the fleet.

    -> ``[(counts, conf), ...]`` host arrays aligned with ``parts``. With
    ``defer=True`` the forwards are launched but not copied back: a
    zero-argument resolver is returned, which makes the one host copy and
    gives that list when called.
    """
    sizes = [int(len(idx)) for _, idx in parts]
    empty = (np.zeros((0,), np.float32), np.zeros((0,), np.float32))
    if sum(sizes) == 0:
        out = [empty for _ in parts]
        return (lambda: out) if defer else out
    gathered, spans, off = [], [], 0
    for (tiles, idx), k in zip(parts, sizes):
        if not k:
            spans.append((0, 0))
            continue
        k_pad = bucket_size(k, 2)
        idx_pad = np.zeros(k_pad, np.int64)
        idx_pad[:k] = np.asarray(idx)
        gathered.append(tiles.index_select(
            0, xfer.device_constant(idx_pad, tiles.device)))
        spans.append((off, k))
        off += k_pad
    t = gathered[0] if len(gathered) == 1 else torch.cat(gathered)
    fwd = _count_forward_device(params, cfg, t, _tier_batch(off, batch),
                                score_thresh, nms_iou)

    def resolve():
        out = fwd.cpu().numpy()  # the one host copy
        return [(out[0, o:o + k], out[1, o:o + k]) if k else empty
                for o, k in spans]
    return resolve if defer else resolve()
