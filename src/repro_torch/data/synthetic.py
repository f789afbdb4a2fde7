"""Synthetic EO scene generator (host-side, numpy).

The port's own copy of ``repro.data.synthetic``: the same generator
from the same seed gives the same scenes on both sides.

Replaces xView/DOTA/UAVOD10 (no offline access) with procedurally
generated geospatial scenes whose object counts are exact by
construction: textured background + planted objects (vehicles/
buildings/planes as compact colored blobs) with ground-truth boxes.

Revisit simulation (paper §IV-A4): the satellite re-images the same
ground area along its track; frames are near-duplicates under small
shift/rotation/illumination jitter — exactly what clustering-based
dedup is built to exploit. 50% of frames are flipped/rotated, matching
the paper's augmentation protocol.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class SceneSpec:
    name: str
    scene_px: int
    objects_per_scene: Tuple[int, int]   # (lo, hi)
    object_px: Tuple[int, int]           # (lo, hi)
    n_classes: int = 8
    cloud_fraction: float = 0.3          # prob a region is cloud-obscured
    texture_scale: int = 64


# Scaled-down analogues of Table I (same relative size/density character).
XVIEW_LIKE = SceneSpec("xview", 1024, (40, 80), (8, 20))
DOTA_LIKE = SceneSpec("dota", 1536, (30, 60), (10, 32))
UAVOD_LIKE = SceneSpec("uavod", 768, (8, 24), (12, 40))
DATASETS = {s.name: s for s in (XVIEW_LIKE, DOTA_LIKE, UAVOD_LIKE)}

_CLASS_COLORS = np.array([
    [0.9, 0.2, 0.2], [0.2, 0.9, 0.2], [0.2, 0.3, 0.9], [0.9, 0.9, 0.2],
    [0.9, 0.2, 0.9], [0.2, 0.9, 0.9], [0.95, 0.6, 0.1], [0.7, 0.7, 0.7],
])


def _smooth_noise(rng, size, scale):
    small = rng.random((size // scale + 2, size // scale + 2, 3))
    idx = np.linspace(0, small.shape[0] - 1.001, size)
    xi, yi = np.meshgrid(idx, idx, indexing="ij")
    x0, y0 = xi.astype(int), yi.astype(int)
    fx, fy = (xi - x0)[..., None], (yi - y0)[..., None]
    a = small[x0, y0] * (1 - fx) * (1 - fy) + small[x0 + 1, y0] * fx * (1 - fy)
    a += small[x0, y0 + 1] * (1 - fx) * fy + small[x0 + 1, y0 + 1] * fx * fy
    return a


def make_scene(rng: np.random.Generator, spec: SceneSpec):
    """-> (image (S,S,3) f32 in [0,1], boxes (M,4) xyxy px, classes (M,))."""
    s = spec.scene_px
    img = 0.25 + 0.35 * _smooth_noise(rng, s, spec.texture_scale)
    img += 0.03 * rng.standard_normal((s, s, 3))
    n_obj = int(rng.integers(*spec.objects_per_scene))
    boxes, classes = [], []
    for _ in range(n_obj):
        w = int(rng.integers(*spec.object_px))
        h = int(rng.integers(*spec.object_px))
        x = int(rng.integers(0, s - w))
        y = int(rng.integers(0, s - h))
        c = int(rng.integers(0, spec.n_classes))
        col = _CLASS_COLORS[c] * (0.8 + 0.4 * rng.random())
        yy, xx = np.mgrid[y:y + h, x:x + w]
        cy, cx = y + h / 2, x + w / 2
        inside = (((yy - cy) / (h / 2)) ** 2 + ((xx - cx) / (w / 2)) ** 2) <= 1.0
        region = img[y:y + h, x:x + w]
        region[inside] = col * 0.85 + 0.15 * region[inside]
        boxes.append([x, y, x + w, y + h])
        classes.append(c)
    # cloud occlusion (the paper: 67% of observations cloud-degraded)
    if rng.random() < spec.cloud_fraction:
        cs = int(rng.integers(s // 4, s // 2))
        cx0 = int(rng.integers(0, s - cs))
        cy0 = int(rng.integers(0, s - cs))
        cloud = 0.85 + 0.1 * _smooth_noise(rng, cs, max(cs // 4, 2))
        img[cy0:cy0 + cs, cx0:cx0 + cs] = (
            0.7 * cloud + 0.3 * img[cy0:cy0 + cs, cx0:cx0 + cs]
        )
        keep = []
        for i, (x1, y1, x2, y2) in enumerate(boxes):
            cxm, cym = (x1 + x2) / 2, (y1 + y2) / 2
            if not (cx0 < cxm < cx0 + cs and cy0 < cym < cy0 + cs):
                keep.append(i)
        boxes = [boxes[i] for i in keep]
        classes = [classes[i] for i in keep]
    img = np.clip(img, 0.0, 1.0).astype(np.float32)
    b = np.asarray(boxes, np.float32).reshape(-1, 4)
    c = np.asarray(classes, np.int32).reshape(-1)
    return img, b, c


def revisit_frames(rng, img, boxes, classes, n_frames: int, max_shift: int = 24):
    """Simulate repeated passes over the same ground area."""
    s = img.shape[0]
    frames = []
    for i in range(n_frames):
        dx, dy = int(rng.integers(-max_shift, max_shift + 1)), int(rng.integers(-max_shift, max_shift + 1))
        f = np.roll(img, (dy, dx), axis=(0, 1))
        b = boxes.copy()
        if len(b):
            b[:, [0, 2]] = (b[:, [0, 2]] + dx) % s
            b[:, [1, 3]] = (b[:, [1, 3]] + dy) % s
            ok = (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])  # drop wrapped boxes
            b, cl = b[ok], classes[ok]
        else:
            cl = classes
        f = np.clip(f * (0.92 + 0.16 * rng.random()), 0, 1)  # illumination
        if rng.random() < 0.5:  # paper: flip/rotate 50% of images
            rot = int(rng.integers(1, 4))
            f = np.rot90(f, rot).copy()
            b2 = b.copy()
            for _ in range(rot):
                if len(b2):
                    x1, y1, x2, y2 = b2[:, 0].copy(), b2[:, 1].copy(), b2[:, 2].copy(), b2[:, 3].copy()
                    b2 = np.stack([y1, s - x2, y2, s - x1], axis=1)
            b = b2
        frames.append((f.astype(np.float32), b, cl))
    return frames


def tile_counts(boxes, scene_px: int, tile_size: int):
    """Ground-truth object count per tile (object assigned to the tile
    holding its center). -> (G*G,) int array, row-major tiles."""
    g = (scene_px + tile_size - 1) // tile_size
    counts = np.zeros((g, g), np.int64)
    for x1, y1, x2, y2 in boxes:
        cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
        tx, ty = min(int(cx // tile_size), g - 1), min(int(cy // tile_size), g - 1)
        counts[ty, tx] += 1
    return counts.reshape(-1)


def boxes_to_targets(boxes, classes, grid: int, n_anchors: int, n_classes: int,
                     input_size: int, scale: float = 1.0):
    """Build a (G,G,A,5+C) detector training target from GT boxes.

    ``scale`` maps scene px -> model-input px when tiles were resized.
    """
    t = np.zeros((grid, grid, n_anchors, 5 + n_classes), np.float32)
    cell = input_size / grid
    for (x1, y1, x2, y2), c in zip(boxes, classes):
        x1, y1, x2, y2 = x1 * scale, y1 * scale, x2 * scale, y2 * scale
        cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
        gx, gy = min(int(cx / cell), grid - 1), min(int(cy / cell), grid - 1)
        a = 0
        while a < n_anchors and t[gy, gx, a, 4] > 0:
            a += 1
        if a == n_anchors:
            continue
        t[gy, gx, a, 0] = np.clip(cx / cell - gx, 0, 1)          # x in cell
        t[gy, gx, a, 1] = np.clip(cy / cell - gy, 0, 1)
        t[gy, gx, a, 2] = np.clip((x2 - x1) / (4 * cell), 0, 1)  # w, up to 4 cells
        t[gy, gx, a, 3] = np.clip((y2 - y1) / (4 * cell), 0, 1)
        t[gy, gx, a, 4] = 1.0
        t[gy, gx, a, 5 + int(c)] = 1.0
    return t


def clip_boxes_to_tile(boxes, classes, tx, ty, tile_size):
    """Boxes of one scene -> boxes local to tile (tx,ty), center-assigned."""
    out_b, out_c = [], []
    for (x1, y1, x2, y2), c in zip(boxes, classes):
        cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
        if tx * tile_size <= cx < (tx + 1) * tile_size and ty * tile_size <= cy < (ty + 1) * tile_size:
            out_b.append([x1 - tx * tile_size, y1 - ty * tile_size,
                          x2 - tx * tile_size, y2 - ty * tile_size])
            out_c.append(c)
    return np.asarray(out_b, np.float32).reshape(-1, 4), np.asarray(out_c, np.int32)
