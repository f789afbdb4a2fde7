"""Adaptive image tiling (paper §III-B, Algorithm 1), PyTorch.

Counterpart of ``repro/core/tiling.py``: frames are cut into tiles and
resized to a counter's input size, and :func:`optimal_tile_size`
ternary-searches the tile size of best mAP. ``resize_tiles`` reproduces
``jax.image.resize(..., "bilinear")``: the same triangle-kernel weight
matrices, built with the same float32 arithmetic, contracted over H and
then W, which is the order JAX's einsum takes. On the CPU that is
bit-equal to the reference for downsampling (128 -> 64 px); for
upsampling (128 -> 416 px) the two stay within 2e-6.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def tile_image(img: torch.Tensor, tile_size: int) -> torch.Tensor:
    """img (H, W, C) -> (N, tile_size, tile_size, C), zero-padded to a
    multiple of the tile size; tiles row-major. A leading frame axis
    (B, H, W, C) gives the frames' tiles in frame order."""
    frames = img if img.dim() == 4 else img[None]
    b, h, w, c = frames.shape
    ph, pw = -h % tile_size, -w % tile_size
    if ph or pw:
        frames = F.pad(frames, (0, 0, 0, pw, 0, ph))
    gh, gw = (h + ph) // tile_size, (w + pw) // tile_size
    t = frames.reshape(b, gh, tile_size, gw, tile_size, c).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b * gh * gw, tile_size, tile_size, c)


def untile_counts(counts) -> torch.Tensor:
    """Aggregate per-tile counts back to a per-frame total."""
    return torch.as_tensor(counts).sum()


@functools.lru_cache(maxsize=32)
def _weight_mat(in_size: int, out_size: int, device: str) -> torch.Tensor:
    """(in_size, out_size) bilinear weights with antialiasing, as
    ``jax._src.image.scale.compute_weight_mat`` builds them."""
    f32 = torch.float32
    inv_scale = torch.tensor(1.0 / (out_size / in_size), dtype=f32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = ((torch.arange(out_size, dtype=f32) + 0.5) * inv_scale
              - 0.0 * inv_scale - 0.5)
    x = torch.abs(sample[None, :] - torch.arange(in_size, dtype=f32)[:, None])
    w = torch.clamp(1 - torch.abs(x / kernel_scale), min=0)
    tot = w.sum(0, keepdim=True)
    w = torch.where(tot.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(tot != 0, tot, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0).to(device)


def resize_tiles(tiles: torch.Tensor, out_size) -> torch.Tensor:
    """(N, H, W, C) -> (N, out_h, out_w, C) float32, bilinear with
    antialiasing, contiguous; ``out_size`` is out_h = out_w or a pair."""
    _, h, w, _ = tiles.shape
    out_h, out_w = (out_size, out_size) if isinstance(out_size, int) else out_size
    x = tiles.to(torch.float32)
    dev = str(x.device)
    if h != out_h:
        x = torch.einsum("nhwc,hp->npwc", x, _weight_mat(h, out_h, dev))
    if w != out_w:
        x = torch.einsum("npwc,wq->npqc", x, _weight_mat(w, out_w, dev))
    return x.contiguous()


def n_tiles(img_hw: Tuple[int, int], tile_size: int) -> int:
    h, w = img_hw
    return ((h + tile_size - 1) // tile_size) * ((w + tile_size - 1) // tile_size)


def optimal_tile_size(map_fn: Callable[[int], float], s_min: int, s_max: int,
                      eps: int = 32) -> Tuple[int, Dict[int, float]]:
    """Algorithm 1: ternary search for the mAP-optimal tile size.

    ``map_fn(size) -> mAP``. Narrows [s_left, s_right] by thirds,
    comparing mAP at the one-third points, until the interval is below
    ``eps``, and returns the midpoint of the last interval with the cache
    of evaluated sizes: (s_best, {size: mAP}).
    """
    cache: Dict[int, float] = {}

    def f(s: int) -> float:
        s = int(s)
        if s not in cache:
            cache[s] = float(map_fn(s))
        return cache[s]

    s_left, s_right = s_min, s_max
    while s_right - s_left > eps:
        s_midl = s_left + (s_right - s_left) / 3.0
        s_midr = s_right - (s_right - s_left) / 3.0
        if f(int(s_midl)) < f(int(s_midr)):
            s_left = s_midl
        else:
            s_right = s_midr
    s_best = int((s_left + s_right) / 2)
    f(s_best)
    return s_best, cache
