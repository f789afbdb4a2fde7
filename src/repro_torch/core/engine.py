"""Capture: tile, resize and take the color moments of frame buckets.

Counterpart of ``repro/core/engine.py`` (``prepare_frames``). Frames of
one resolution go through the frame program in buckets of
``FRAME_BUCKET`` (zero frames fill the last bucket): tile, resize to
both counters' input sizes, and ``tile_moments`` once on the space-tier
tiles. The stddev moments are the ROI statistic and the moments feed
dedup, so each tile is read once. Tile arrays stay on the device,
zero-padded to a power-of-two tile bucket, for the gathers downstream.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import tiling
from repro_torch.core.dedup import bucket_size
from repro_torch.data.synthetic import tile_counts
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops

FRAME_BUCKET = 4  # frames per frame-program call (padded up)


@dataclass
class PreparedFrames:
    """Capture output: device tiles + per-tile statistics.

    Device tensors are zero-padded to a power-of-two tile bucket (rows
    past ``n`` are zero tiles); host arrays (``roi_std``, ``true``) hold
    the ``n`` real tiles only. ``moments``/``roi_std`` are ``None`` when
    prepared with ``with_stats=False``.
    """
    tiles_sp: torch.Tensor  # (N_pad, s_sp, s_sp, C) space-tier input
    tiles_gd: torch.Tensor  # (N_pad, s_gd, s_gd, C) ground-tier input
    moments: object         # (N_pad, 3C) raw color moments (or None)
    roi_std: object         # (n,) mean per-channel stddev, host (or None)
    true: np.ndarray        # (n,) ground-truth per-tile counts
    n: int                  # real tile count (rows [n:] are padding)


def _frame_program(imgs: torch.Tensor, tile_size: int, sp_size: int,
                   gd_size: int, with_stats: bool = True):
    """(B, H, W, C) frames -> (tiles_sp, tiles_gd[, moments, roi_std]);
    tiles row-major within each frame, frames in batch order."""
    c = imgs.shape[-1]
    t = tiling.tile_image(imgs, tile_size)
    tiles_sp = tiling.resize_tiles(t, sp_size)
    tiles_gd = tiling.resize_tiles(t, gd_size)
    if not with_stats:
        return tiles_sp, tiles_gd
    moments = kops.tile_moments(tiles_sp)
    roi_std = moments[:, c:2 * c].mean(-1)
    return tiles_sp, tiles_gd, moments, roi_std


def _bucketed_chunks(imgs, shape, tile_size: int, sp_size: int, gd_size: int,
                     frame_bucket: int, device, with_stats: bool = True):
    """Zero-pad a same-resolution image list to whole ``frame_bucket``s
    and run the frame program bucket by bucket."""
    nb = -(-len(imgs) // frame_bucket) * frame_bucket
    arr = np.zeros((nb, *shape), np.float32)
    for j, img in enumerate(imgs):
        arr[j] = img
    return [_frame_program(torch.from_numpy(arr[c0:c0 + frame_bucket]).to(device),
                           tile_size, sp_size, gd_size, with_stats)
            for c0 in range(0, nb, frame_bucket)]


def _per_frame_pieces(frames, tile_size: int, sp_size: int, gd_size: int,
                      frame_bucket: int, device, with_stats: bool = True):
    """The frame program grouped by resolution; the piece of every frame,
    in input order."""
    groups: dict = {}
    for i, (img, _, _) in enumerate(frames):
        groups.setdefault(np.shape(img), []).append(i)
    per_frame = [None] * len(frames)
    for shape, idxs in groups.items():
        chunks = _bucketed_chunks([frames[i][0] for i in idxs], shape,
                                  tile_size, sp_size, gd_size, frame_bucket,
                                  device, with_stats=with_stats)
        ntile = chunks[0][0].shape[0] // frame_bucket
        for j, i in enumerate(idxs):
            ck, off = chunks[j // frame_bucket], (j % frame_bucket) * ntile
            per_frame[i] = tuple(a[off:off + ntile] for a in ck)
    return per_frame


def _assemble(parts, frames, tile_size: int, n: int = None) -> PreparedFrames:
    """Pieces (input order) -> one bucket-padded PreparedFrames. ``n``:
    the real tile count when the pieces carry trailing pad-frame rows."""
    if n is None:
        n = sum(p[0].shape[0] for p in parts)

    def cat(j):
        return parts[0][j] if len(parts) == 1 else torch.cat([p[j] for p in parts])

    n_pad = bucket_size(n)

    def pad(a):
        if a.shape[0] >= n_pad:
            return a[:n_pad]
        return torch.cat([a, a.new_zeros((n_pad - a.shape[0], *a.shape[1:]))])

    with_stats = len(parts[0]) == 4
    tiles_sp = pad(cat(0))
    tiles_gd = pad(cat(1))
    moments = pad(cat(2)) if with_stats else None
    roi_std = pad(cat(3))[:n].cpu().numpy() if with_stats else None
    true = np.concatenate([
        tile_counts(boxes, np.shape(img)[0], tile_size)
        for img, boxes, _ in frames
    ]).astype(np.float64)
    return PreparedFrames(tiles_sp, tiles_gd, moments, roi_std, true, n)


def _empty_prepared(sp_size: int, gd_size: int, device,
                    with_stats: bool = True) -> PreparedFrames:
    n_pad = bucket_size(0)
    z = dict(dtype=torch.float32, device=device)
    return PreparedFrames(
        tiles_sp=torch.zeros((n_pad, sp_size, sp_size, 3), **z),
        tiles_gd=torch.zeros((n_pad, gd_size, gd_size, 3), **z),
        moments=torch.zeros((n_pad, 9), **z) if with_stats else None,
        roi_std=np.zeros(0) if with_stats else None,
        true=np.zeros(0, np.float64), n=0)


def prepare_frames(frames, tile_size: int, sp_size: int, gd_size: int,
                   frame_bucket: int = FRAME_BUCKET, with_stats: bool = True,
                   device="cuda") -> PreparedFrames:
    """Run the frame program over a workload of (img, boxes, classes).

    Frames are grouped by resolution and processed in zero-padded buckets
    of ``frame_bucket``; ground-truth counts are collected on the host.
    ``with_stats=False`` skips the moments (policies that use neither ROI
    nor dedup); the tiles are the same either way. ``device`` is "cuda"
    (the default; raises without a card) or "cpu".
    """
    device = resolve_device(device)
    if not frames:
        return _empty_prepared(sp_size, gd_size, device, with_stats)
    shapes = {np.shape(img) for img, _, _ in frames}
    if len(shapes) == 1:
        # one resolution: the buckets are already in frame order, and the
        # pad frames' rows fold into the tile padding
        (shape,) = shapes
        parts = _bucketed_chunks([img for img, _, _ in frames], shape,
                                 tile_size, sp_size, gd_size, frame_bucket,
                                 device, with_stats=with_stats)
        ntile = parts[0][0].shape[0] // frame_bucket
        return _assemble(parts, frames, tile_size, n=ntile * len(frames))
    parts = _per_frame_pieces(frames, tile_size, sp_size, gd_size,
                              frame_bucket, device, with_stats=with_stats)
    return _assemble(parts, frames, tile_size)
