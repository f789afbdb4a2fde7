"""Image tiling and tile resize (paper §III-B), PyTorch.

Counterpart of ``repro/core/tiling.py``. ``resize_tiles`` reproduces
``jax.image.resize(..., "bilinear")``: the same triangle-kernel weight
matrices, built with the same float32 arithmetic, contracted over H and
then W, which is the order JAX's einsum takes. On the CPU that is
bit-equal to the reference for downsampling (128 -> 64 px); for
upsampling (128 -> 416 px) the two stay within 2e-6.
"""
from __future__ import annotations

import functools

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


def resize_tiles(tiles: torch.Tensor, out_size: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, out_size, out_size, C) float32, bilinear with
    antialiasing, contiguous."""
    _, h, w, _ = tiles.shape
    x = tiles.to(torch.float32)
    dev = str(x.device)
    if h != out_size:
        x = torch.einsum("nhwc,hp->npwc", x, _weight_mat(h, out_size, dev))
    if w != out_size:
        x = torch.einsum("npwc,wq->npqc", x, _weight_mat(w, out_size, dev))
    return x.contiguous()

