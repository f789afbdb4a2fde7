"""Satellite-ground cascade: counting tiles with a counter, and training
counters, PyTorch.

Counterpart of ``repro/core/cascade.py``. Every counting forward runs at
a power-of-two batch tier (the trailing batch and a gathered subset are
padded), as the reference's compiled programs do; the detector is
per-sample, so padding never changes a real tile. Results stay on the
device until one host copy at the end. :func:`count_tiles_batched_ref`
keeps the seed's host-side batching for the reference path. Training
(:func:`fit_counter`) keeps its tile pool on the device and gathers each
batch there.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs.base import DetectorConfig
from repro_torch.core import tiling, xfer
from repro_torch.core.dedup import bucket_size
from repro_torch.device import resolve_device
from repro_torch.models import detector
from repro_torch.optim.adamw import adamw
from repro_torch.optim.schedule import cosine_with_warmup


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
    # analysis: waive(host-sync): the designed single host copy of a
    # counting batch (counts and confidences together)
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
    """:func:`_count_forward` over whole ``batch`` chunks, without the
    host copy -> (2, n_rows) on the device."""
    c, f = _count_tiles_chunks(params, cfg, t.reshape(-1, batch, *t.shape[1:]),
                               score_thresh, nms_iou)
    return torch.stack([c.reshape(-1), f.reshape(-1)])


def count_tiles_multi(params, cfg, parts, batch: int = 64, score_thresh=0.3,
                      nms_iou: float = 0.25, defer: bool = False):
    """Count several independent gathers in shared fixed-shape batches.

    Counterpart of ``repro/core/cascade.py``'s ``count_tiles_multi``.
    ``parts``: list of ``(tiles, idx)``, e.g. one a satellite, each
    gathering a subset of its own tile tensor. Each gather is padded to a
    power-of-two size (floor 2; pad slots gather tile 0 and are trimmed)
    and lands in its slot of one buffer of whole batches of one size
    tier (zero rows after the last slot), which is counted batch by
    batch, and the results split back per part: the same counts as
    :func:`count_tiles_batched` per part, with the trailing batch's
    padding paid once for the fleet. The buffer is the one device
    allocation of the gathers, sized by the batch count alone.

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
    spans, off = [], 0
    for k in sizes:
        spans.append((off, k) if k else (0, 0))
        off += bucket_size(k, 2) if k else 0
    tier = _tier_batch(off, batch)
    t = None
    for ((tiles, idx), k), (o, _) in zip(zip(parts, sizes), spans):
        if not k:
            continue
        if t is None:
            t = tiles.new_empty((-(-off // tier) * tier, *tiles.shape[1:]))
            t[off:].zero_()
        idx_pad = np.zeros(bucket_size(k, 2), np.int64)
        idx_pad[:k] = np.asarray(idx)
        torch.index_select(tiles, 0, xfer.device_constant(idx_pad, tiles.device),
                           out=t[o:o + len(idx_pad)])
    fwd = _count_forward_device(params, cfg, t, tier, score_thresh, nms_iou)

    def resolve():
        # analysis: waive(host-sync): the single deferred host copy of the
        # shared batches; callers resolve() at a pipeline boundary
        out = fwd.cpu().numpy()
        return [(out[0, o:o + k], out[1, o:o + k]) if k else empty
                for o, k in spans]
    return resolve if defer else resolve()


def count_tiles_batched_ref(params, cfg, tiles, batch: int = 64, score_thresh=0.3,
                            nms_iou: float = 0.25):
    """The seed's host-side batching, the reference path's counting:
    host ``tiles`` in slices of ``batch``, each copied to the counter's
    device and counted by one :func:`count_tiles` (one NMS launch a
    slice). A slice is zero-padded to ``batch`` only when there are more
    than ``batch`` tiles -> host (counts, conf) float32 arrays."""
    dev = params["stem"].device
    outs_c, outs_f = [], []
    tiles = np.asarray(tiles)
    n = tiles.shape[0]
    for i in range(0, n, batch):
        sl = tiles[i:i + batch]
        pad = 0
        if sl.shape[0] < batch and n > batch:
            pad = batch - sl.shape[0]
            sl = np.concatenate([sl, np.zeros((pad, *sl.shape[1:]), sl.dtype)])
        c, f = count_tiles(params, cfg, torch.from_numpy(sl).to(dev), score_thresh, nms_iou)
        c, f = c.cpu().numpy(), f.cpu().numpy()
        if pad:
            c, f = c[:-pad], f[:-pad]
        outs_c.append(c)
        outs_f.append(f)
    return np.concatenate(outs_c), np.concatenate(outs_f)


# ---------------------------------------------------------------------------
# counter training (shared by examples / benchmarks / tests)
# ---------------------------------------------------------------------------


def _scene_targets(boxes, classes, n_tiles: int, g: int, grid: int,
                   n_anchors: int, n_classes: int, input_size: int,
                   tile_size: int):
    """Vectorized per-scene target tensor (n_tiles, G, G, A, 5+C).

    Matches the loop semantics of `clip_boxes_to_tile` +
    `boxes_to_targets`: boxes are center-assigned to tiles, localized,
    scaled to model-input px, and fill anchor slots in box order (boxes
    past `n_anchors` in a cell are dropped).
    """
    t = np.zeros((n_tiles, grid, grid, n_anchors, 5 + n_classes), np.float32)
    if len(boxes) == 0:
        return t
    b = np.asarray(boxes, np.float32)
    scale = np.float32(input_size / tile_size)
    cell = np.float32(input_size / grid)
    cx_s = (b[:, 0] + b[:, 2]) / 2
    cy_s = (b[:, 1] + b[:, 3]) / 2
    tx = np.minimum((cx_s // tile_size).astype(np.int64), g - 1)
    ty = np.minimum((cy_s // tile_size).astype(np.int64), g - 1)
    tile_idx = ty * g + tx
    # tile-local, model-input-px corner coordinates (float32 throughout,
    # scaled corner-first — matching the scalar arithmetic of the former
    # clip_boxes_to_tile + boxes_to_targets per-box loop bit-for-bit)
    x1 = (b[:, 0] - (tx * tile_size).astype(np.float32)) * scale
    x2 = (b[:, 2] - (tx * tile_size).astype(np.float32)) * scale
    y1 = (b[:, 1] - (ty * tile_size).astype(np.float32)) * scale
    y2 = (b[:, 3] - (ty * tile_size).astype(np.float32)) * scale
    cx, cy, w, h = (x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1
    gx = np.minimum((cx / cell).astype(np.int64), grid - 1)
    gy = np.minimum((cy / cell).astype(np.int64), grid - 1)
    # anchor slot = occurrence index of the box within its (tile, cell)
    key = (tile_idx * grid + gy) * grid + gx
    order = np.argsort(key, kind="stable")
    sk = key[order]
    new_grp = np.r_[True, sk[1:] != sk[:-1]]
    starts = np.flatnonzero(new_grp)
    occ = np.empty(len(key), np.int64)
    occ[order] = np.arange(len(key)) - starts[np.cumsum(new_grp) - 1]
    m = occ < n_anchors
    ti, gyi, gxi, ai = tile_idx[m], gy[m], gx[m], occ[m]
    t[ti, gyi, gxi, ai, 0] = np.clip(cx[m] / cell - gxi.astype(np.float32), 0, 1)
    t[ti, gyi, gxi, ai, 1] = np.clip(cy[m] / cell - gyi.astype(np.float32), 0, 1)
    t[ti, gyi, gxi, ai, 2] = np.clip(w[m] / (4 * cell), 0, 1)
    t[ti, gyi, gxi, ai, 3] = np.clip(h[m] / (4 * cell), 0, 1)
    t[ti, gyi, gxi, ai, 4] = 1.0
    t[ti, gyi, gxi, ai, 5 + np.asarray(classes)[m].astype(np.int64)] = 1.0
    return t


def build_target_pool(cfg: DetectorConfig, scenes, tile_size: int, device="cuda"):
    """(xs, ys) tile/target training pool for :func:`fit_counter`: xs
    (N, S, S, 3) tiles resized to the counter's input on ``device``, ys
    (N, G, G, A, 5+C) float32 numpy targets."""
    device = resolve_device(device)
    grid = detector.grid_size(cfg)
    xs, ys = [], []
    for img, boxes, classes in scenes:
        s = img.shape[0]
        g = (s + tile_size - 1) // tile_size
        t = tiling.tile_image(torch.as_tensor(img, dtype=torch.float32).to(device), tile_size)
        xs.append(tiling.resize_tiles(t, cfg.input_size))
        ys.append(_scene_targets(boxes, classes, g * g, g, grid,
                                 cfg.n_anchors, cfg.n_classes,
                                 cfg.input_size, tile_size))
    return torch.cat(xs), np.concatenate(ys).astype(np.float32)


def train_step(params, cfg: DetectorConfig, opt_update, opt_state, xb, yb):
    """One AdamW step of ``detector.loss_fn`` on a batch -> (params,
    opt_state, loss, aux, metrics), all still on the device."""
    params = T.map_leaves(lambda p: p.detach().requires_grad_(True), params)
    loss, aux = detector.loss_fn(params, cfg, xb, yb)
    grads = T.unflatten(params, torch.autograd.grad(loss, T.leaves(params)))
    with torch.no_grad():
        params, opt_state, metrics = opt_update(grads, opt_state, params)
    return params, opt_state, loss.detach(), {k: v.detach() for k, v in aux.items()}, metrics


def fit_counter(cfg: DetectorConfig, scenes, tile_size: int, steps: int,
                gen: torch.Generator, batch: int = 16, lr: float = 3e-3,
                log_every: int = 0, device="cuda"):
    """Train a counter on (image, boxes, classes) scenes.

    Tiles each scene, builds YOLO-style targets, runs AdamW with a cosine
    schedule after a warm-up of a tenth of the steps; the batches are the
    reference's draws (``default_rng(0)``), gathered on the device. The
    host waits for the card only at a log line and at the end. Returns
    (params in the reference layout, final loss).
    """
    device = resolve_device(device)
    params = detector.init(gen, cfg, device)
    xs, ys = build_target_pool(cfg, scenes, tile_size, device)
    ys = torch.from_numpy(ys).to(device)
    opt_init, opt_update = adamw(cosine_with_warmup(lr, steps // 10 + 1, steps))
    opt_state = opt_init(params)

    rng = np.random.default_rng(0)
    idx = torch.from_numpy(np.stack([rng.integers(0, len(xs), batch)
                                     for _ in range(steps)])).to(device)
    loss = None
    for step in range(steps):
        params, opt_state, loss, _, _ = train_step(
            params, cfg, opt_update, opt_state, xs[idx[step]], ys[idx[step]])
        if log_every and step % log_every == 0:
            print(f"  step {step:4d} loss {float(loss):.4f}")
    return params, float(loss)
