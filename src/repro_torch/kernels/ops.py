"""Kernel entry points of the port, dispatched by the tensor's device.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the plain PyTorch version in :mod:`ref`. There is
no switch and no fallback: the device of the data decides. Four kernels
have more than one entry in their one source:

- ``kmeans_assign`` (``csrc/kmeans_assign.cu``): ``kmeans_assign`` runs
  the dedup's Lloyd steps and final assignment (``kmeans_assign_f32``);
  ``kmeanspp_seed`` runs its whole k-means++ seeding in one launch
  (``kmeanspp_seed_f32``); ``kmeans_assign_lanes`` and
  ``kmeanspp_seed_lanes`` do the same for the L lanes of the fleet's
  dedup in one launch each (``kmeans_assign_lanes_f32``,
  ``kmeanspp_seed_lanes_f32``). The seeding kernel holds a row's features in
  a fixed register array of 16 and raises above that: the dedup's D is
  3C = 9, and no caller has more.
- ``iou_matrix`` (``csrc/iou.cu``): ``iou_matrix`` gives the IoU
  matrix (``iou_matrix_f32``); ``nms_keep`` runs the detector's whole
  NMS of a counting batch in one launch (``nms_keep_f32``), the matrix
  kept in shared memory as a bitmask. It takes k <= 1024 candidates an
  image; the detector's is 128.
- ``flash_attention`` (``csrc/flash_attention.cu``): bf16 with D 64, 128
  or 192 on the tensor cores (``flash_attention_bf16_sm90``; D 192 is
  deepseek-v2-lite's MLA prefill), and D 80 (ViT-H/14) zero-padded to
  128 there; float32 and bf16 of other head dims
  on the CUDA cores (the rule is
  :func:`repro_torch.kernels.flash_attention.choose_route`). Under
  autograd its gradient (``prep``, ``dkdv``, ``dq``; causal or not, GQA)
  is the seventh library, ``csrc/flash_attention_bwd_sm90.cu`` (tensor
  cores, bf16 with D 64, 80, 128, and 192 on entries of its own, MLA's;
  ``flash_attention.BWD_TC_KERNEL``), or the sixth,
  ``csrc/flash_attention_bwd.cu`` (CUDA cores, everything else up to D
  128; ``flash_attention.BWD_KERNEL``); the rule is
  :func:`repro_torch.kernels.flash_attention.choose_bwd_route`. A CPU
  tensor's gradient is autograd's of ``ref.attention``.
- ``int8_matmul`` (``csrc/int8_matmul.cu``): the s8 tensor cores where
  K and N are multiples of 16, dp4a on the CUDA cores otherwise (the
  rule is :func:`repro_torch.kernels.int8_matmul.choose_route`).

Unlike the reference's dispatch, no shape falls back either:
``attention`` sends every CUDA tensor to the kernel, which takes ragged
lengths and any head dim up to 256 (see
:mod:`repro_torch.kernels.flash_attention`).

A DTensor never reaches a kernel: the kernels take raw pointers. An
entry given one runs the kernel (or, on the CPU, its plain version) on
each rank's shard through ``local_map``, under the placements where the
op is local, and first redistributes any other layout to one of those
(mesh dim by mesh dim, a sharding the op cannot keep becomes
``Replicate()``):

- ``tile_moments``: the tiles sharded on the batch;
- ``kmeans_assign``, ``iou_matrix``: rows sharded (and ``iou_matrix``'s
  leading batch dims), the centroids or ``b``'s rows replicated;
- ``nms_keep``: images sharded;
- ``attention``: batch and/or heads sharded, q's heads on the same mesh
  dims as k's and v's, so that whole GQA groups are local (a sequence
  sharding, whose causal offset the kernel does not take, is gathered);
  its gradient goes through the autograd Function as before;
- ``int8_matmul``: x's rows and w's columns (not both on one mesh dim);
- the lane entries: lanes sharded;
- ``kmeanspp_seed``, a sequential pass over all rows: x replicated.

- ``decode_attention`` (no kernel: the plain version) as ``attention``,
  a cache sharded on its length gathered first.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import int8_matmul as _int8
from repro_torch.kernels import iou as _iou
from repro_torch.kernels import kmeans_assign as _kmeans
from repro_torch.kernels import ref
from repro_torch.kernels import tile_moments as _moments
from repro_torch.sharding.local import is_dtensor as _is_dtensor
from repro_torch.sharding.local import keep as _keep
from repro_torch.sharding.local import local_op as _local
from repro_torch.sharding.local import refill as _refill
from repro_torch.sharding.local import replicated as _replicated

KERNELS = (_moments.KERNEL, _kmeans.KERNEL, _iou.KERNEL, _flash.KERNEL, _int8.KERNEL,
           _flash.BWD_KERNEL, _flash.BWD_TC_KERNEL)


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def tile_moments(tiles):
    if _is_dtensor(tiles):
        pl = _keep(tiles, (0,))
        return _local(tile_moments, (tiles,), tiles.device_mesh, (pl,), pl)
    if _on_cuda(tiles):
        return _moments.tile_moments(tiles)
    return ref.tile_moments(tiles)


def kmeans_assign(x, centroids):
    if _is_dtensor(x) or _is_dtensor(centroids):
        mesh = (x if _is_dtensor(x) else centroids).device_mesh
        pl = _keep(x, (0,)) if _is_dtensor(x) else _replicated(mesh)
        return _local(kmeans_assign, (x, centroids), mesh, (pl, _replicated(mesh)), (pl, pl))
    if _on_cuda(x):
        return _kmeans.kmeans_assign(x, centroids)
    return ref.kmeans_assign(x, centroids)


def kmeanspp_seed(x, n, first, k, k_pad):
    """The dedup's k-means++ seeding -> (centroids (k_pad, D), picks
    (k_pad,) int32); see :func:`ref.kmeanspp_seed`."""
    if _is_dtensor(x):
        r = _replicated(x.device_mesh)
        return _local(lambda a: kmeanspp_seed(a, n, first, k, k_pad), (x,), x.device_mesh,
                      (r,), (r, r))
    if _on_cuda(x):
        return _kmeans.kmeanspp_seed(x, n, first, k, k_pad)
    return ref.kmeanspp_seed(x, n, first, k, k_pad)


def kmeans_assign_lanes(x, centroids):
    """x (L, N, D), centroids (L, K, D) -> (assign (L, N) int32, sqdist
    (L, N) float32), lane by lane :func:`kmeans_assign`."""
    if _is_dtensor(x):
        pl = _keep(x, (0,))
        return _local(kmeans_assign_lanes, (x, centroids), x.device_mesh, (pl, pl), (pl, pl))
    if _on_cuda(x):
        return _kmeans.kmeans_assign_lanes(x, centroids)
    return ref.kmeans_assign_lanes(x, centroids)


def kmeanspp_seed_lanes(x, n, first, k, k_pad):
    """The seeding of L dedup lanes -> (centroids (L, k_pad, D), picks
    (L, k_pad) int32); see :func:`ref.kmeanspp_seed_lanes`."""
    if _is_dtensor(x):
        pl = _keep(x, (0,))
        lanes = [a for a in (n, first, k) if isinstance(a, torch.Tensor)]
        return _local(lambda a, *rest: kmeanspp_seed_lanes(a, *_refill(rest, (n, first, k)), k_pad),
                      (x, *lanes), x.device_mesh, (pl,) + (pl,) * len(lanes), (pl, pl))
    if _on_cuda(x):
        return _kmeans.kmeanspp_seed_lanes(x, n, first, k, k_pad)
    return ref.kmeanspp_seed_lanes(x, n, first, k, k_pad)


def iou_matrix(a, b):
    if _is_dtensor(a) or _is_dtensor(b):
        from torch.distributed.tensor import Replicate, Shard
        mesh = (a if _is_dtensor(a) else b).device_mesh
        lead = a.ndim - 2
        pa = _keep(a, range(a.ndim - 1)) if _is_dtensor(a) else _replicated(mesh)
        # b's leading dims, where it has a's, follow a's; its rows are whole
        same = b.ndim == a.ndim
        pb = tuple(p if same and isinstance(p, Shard) and p.dim < lead else Replicate()
                   for p in pa)
        return _local(iou_matrix, (a, b), mesh, (pa, pb), pa)
    if _on_cuda(a):
        return _iou.iou_matrix(a, b)
    return ref.iou_matrix(a, b)


def nms_keep(boxes, top_i, top_s, iou_thresh, score_thresh):
    """Greedy NMS over the top-k candidates -> keep mask; see
    :func:`ref.nms_keep`."""
    if _is_dtensor(boxes):
        pl = _keep(boxes, range(boxes.ndim - 2))
        return _local(lambda b, i, t: nms_keep(b, i, t, iou_thresh, score_thresh),
                      (boxes, top_i, top_s), boxes.device_mesh, (pl, pl, pl), pl)
    if _on_cuda(boxes):
        return _iou.nms_keep(boxes, top_i, top_s, iou_thresh, score_thresh)
    return ref.nms_keep(boxes, top_i, top_s, iou_thresh, score_thresh)


def attention(q, k, v, *, causal: bool = False):
    """GQA attention: q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D)."""
    if _is_dtensor(q) or _is_dtensor(k) or _is_dtensor(v):
        pl = _attention_layout(q, k)
        return _local(lambda a, b, c: attention(a, b, c, causal=causal), (q, k, v),
                      (q if _is_dtensor(q) else k).device_mesh, (pl, pl, pl), pl)
    if _on_cuda(q):
        return _flash.flash_attention(q, k, v, causal=causal)
    return ref.attention(q, k, v, causal=causal)


def _attention_layout(q, k):
    """The placements where attention is local, taken from q's: per mesh
    dim its batch or head sharding where k's heads divide as q's do,
    else replicated."""
    from torch.distributed.tensor import Replicate, Shard
    src = q if _is_dtensor(q) else k
    mesh = src.device_mesh
    sizes = dict(zip(range(mesh.ndim), mesh.shape))
    out, split = [], {0: 1, 2: 1}
    for i, p in enumerate(src.placements):
        if isinstance(p, Shard) and p.dim in (0, 2):
            n = split[p.dim] * sizes[i]
            dims = (q.shape[0], k.shape[0]) if p.dim == 0 else (q.shape[2], k.shape[2])
            if all(d % n == 0 for d in dims):
                split[p.dim] = n
                out.append(p)
                continue
        out.append(Replicate())
    return tuple(out)


def decode_attention(q, k, v, *, kv_len):
    """Single-token decode: q (B, 1, Hq, D) against a full-length cache
    with per-batch valid lengths kv_len (B,). No kernel, as in the
    reference: the plain version on both devices. On DTensors it runs on
    shards laid out as :func:`attention`'s (batch and/or heads; a cache
    sharded on its length is gathered: the reference's flash-decode
    layout, which keeps it sharded and combines the shards' softmax
    statistics, is not ported)."""
    if _is_dtensor(q) or _is_dtensor(k):
        from torch.distributed.tensor import Replicate, Shard
        pl = _attention_layout(q, k)
        batch = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in pl)
        return _local(lambda a, b, c, n: decode_attention(a, b, c, kv_len=n), (q, k, v, kv_len),
                      (q if _is_dtensor(q) else k).device_mesh, (pl, pl, pl, batch), pl)
    return ref.attention(q, k, v, causal=False, kv_len=kv_len)


def int8_matmul(x_q, w_q, x_scale, w_scale):
    if any(_is_dtensor(t) for t in (x_q, w_q, x_scale, w_scale)):
        return _int8_local(x_q, w_q, x_scale, w_scale)
    if _on_cuda(x_q):
        return _int8.int8_matmul(x_q, w_q, x_scale, w_scale)
    return ref.int8_matmul(x_q, w_q, x_scale, w_scale)


def _int8_local(x_q, w_q, x_scale, w_scale):
    """:func:`int8_matmul` on shards: per mesh dim x's rows, else w's
    columns, else nothing, sharded; the scales follow their operand."""
    from torch.distributed.tensor import Replicate, Shard
    src = next(t for t in (x_q, w_q, x_scale, w_scale) if _is_dtensor(t))
    mesh = src.device_mesh
    px = x_q.placements if _is_dtensor(x_q) else _replicated(mesh)
    pw = w_q.placements if _is_dtensor(w_q) else _replicated(mesh)
    x_pl, w_pl, xs_pl, ws_pl, out_pl = [], [], [], [], []
    for a, b in zip(px, pw):
        rows = isinstance(a, Shard) and a.dim == 0
        cols = not rows and isinstance(b, Shard) and b.dim == 1
        x_pl.append(Shard(0) if rows else Replicate())
        xs_pl.append(Shard(0) if rows else Replicate())
        w_pl.append(Shard(1) if cols else Replicate())
        ws_pl.append(Shard(0) if cols else Replicate())
        out_pl.append(Shard(0) if rows else Shard(1) if cols else Replicate())
    return _local(int8_matmul, (x_q, w_q, x_scale, w_scale), mesh,
                  (tuple(x_pl), tuple(w_pl), tuple(xs_pl), tuple(ws_pl)), tuple(out_pl))


def quantize_int8(x: torch.Tensor, dim: int = -1):
    """Symmetric int8 quantization along ``dim`` -> (q int8, scale f32):
    ``scale = max(amax, 1e-8) / 127``, ``q = clip(round(x / scale))``,
    rounding half to even as ``jnp.round`` does."""
    amax = torch.amax(torch.abs(x.float()), dim=dim, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(dim)
