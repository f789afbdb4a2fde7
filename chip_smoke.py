#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository's sources; it imports
nothing of JAX or of the reference package ``repro``. Phases:

1. device: the card's name and power limit, torch/CUDA versions, and
   the build of every hand-written kernel from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, in parallel), with ptxas's registers and
   spills of each kernel entry (a spill or a serialized ``wgmma`` in the
   tensor-core ``flash_attention`` fails the run);
2. kernels: each kernel against its plain PyTorch version on the card,
   at the shapes its path gives it and at ragged ones (a bf16
   ``flash_attention`` also against the plain version on its inputs
   upcast to float32, within one bf16 rounding; every case checks which
   entry of its library it launched; the prefill's attention and a
   qwen3-8b projection's int8 product run on both routes; the dedup's
   k-means++ seeding gives the plain version's centroids and picks, and
   ``kmeans_assign_f32`` its assignments and distances bit for bit;
   ``tile_moments`` runs at C 1, 3, 5 and 64, ragged and misaligned
   tiles, constant and offset data, and every cluster size; the NMS
   entry ``nms_keep_f32`` gives the plain loop's keep masks bit for bit
   at a counter chunk's shape, unbatched, N < 128, k 1000, all boxes but
   one suppressed, none above the score threshold and a NaN box, and
   ``iou_matrix_f32`` the plain IoU bit for bit, NaN boxes included;
   the fleet dedup's lane entries ``kmeanspp_seed_lanes_f32`` and
   ``kmeans_assign_lanes_f32`` bit-equal to their plain versions and,
   lane by lane, to the one-lane entries, at 32 lanes of the Mission
   dedup's shape, a ragged bucket of 32 lanes and one lane),
   timed with CUDA events beside the plain version, the least time the
   card could take (``bound_ms``) and, where one PyTorch call computes
   the same function, that call (``library_ms``, a yardstick the port
   never calls); and ``int8_matmul``'s one path, ``ops.int8_matmul`` at
   the kernel bench's shape, on the tensor-core entry;
3. the Mission at full width: the ``targetfuse-space`` and
   ``targetfuse-ground`` counters (seeded random weights) on xview-like
   traffic, every selection policy, with every kernel's launch count by
   entry, the dedup stage's time from this run (one seeding launch a
   dedup, checked; one ``nms_keep_f32`` launch a counter chunk and no
   ``iou_matrix_f32``, checked), the device time of the capture stage's
   ``tile_moments`` calls and, in each counting stage, of its counter
   chunks and their NMS (CUDA events the script records around
   ``ops.tile_moments``, ``cascade.count_tiles`` and
   ``detector.nms_keep``);
4. CUDA against CPU: the same reduced-config Mission on the card
   (kernels) and on the CPU (plain versions), per-tile predictions equal;
5. LM serving at full width: qwen3-8b (36 layers, d_model 4096, seeded
   random bf16 weights) prefills 2 prompts of 4096 tokens and decodes 32
   greedy tokens; ``flash_attention`` launches once a layer in the
   prefill, every launch on its tensor-core entry; decode logits are held
   against ``forward_train`` over prompt and generated tokens;
6. the constellation at full width: ``run_scenario`` of targetfuse (a
   ``Fleet``; each round's contacts a ``ContactPlan`` at ground-segment
   depth 0) over benchmarks/fleet_bench.py's contact cell (32 satellites,
   8 stations, 3 rounds of 1 frame a pass) with phase 3's counters;
   per-satellite results equal 32 looped Missions on the card, one
   ``kmeanspp_seed_lanes_f32`` launch a shape bucket a round and no
   one-lane k-means launch in ``Fleet.ingest`` (checked); tiles/s,
   windows/s, the stages' wall times and the launches by entry;
7. CUDA against CPU: reduced qwen3 in float32, prefill and 3 decode
   steps on the card (the CUDA-core kernel) and on the CPU (plain version);
8. the recount pipeline and the orbital geometry: phase 6's cell at
   ``async_depth`` 1 and 2 (each round's recount on a worker thread and
   its own CUDA stream, checked) equal to depth 0 in results, ledgers
   and ``nms_keep_f32`` launches, and a worker crash recovered by the
   watchdog at depth 2 equal to depth 0 under the same fault plan,
   printing tiles/s, windows/s and the recount's hidden share a depth;
   benchmarks/orbits_bench.py's propagation, elevation and eclipse sizes
   timed and held against the CPU; fleet_bench's orbital cell (16
   satellites, 8 sites) generated on the card and run through
   ``run_scenario``, equal to its FIFO reference and 16 looped Missions;
9. counter training: (a) one training step of each full-width counter
   on the card and on the CPU from the same seeded weights and 2 tiles
   of ``build_target_pool``, loss, aux terms, gradients, global norm and
   updated weights compared; (b) ``fit_counter`` of each full-width
   counter at batch 16 on ``get_counters``' 8 training scenes, 200 steps,
   printing ms a step, tiles/s, the share of the float32 bound, peak
   memory and one step under torch.profiler, the loss falling (checked),
   and whether two seeded 20-step runs give bit-equal losses; (c) tests/test_system.py's reduced
   counters trained on the card, the ground counter's held-out CMAE
   below the space counter's (checked), ``get_counters`` at its default
   steps into a temporary folder, the restored counters bit-equal to the
   trained ones, and serve's CMAE table for every policy from that
   folder, with its launches by kernel entry;
10. the reference path, the tile-size search and the examples: (a) phase
   3's counters and 576 tiles through ``Mission(use_engine=False)`` for
   every policy, per-tile predictions equal to the engine path's on the
   card (checked), tiles/s of both paths, one ``nms_keep_f32`` a counter
   chunk and, on the dedup policies, ``tile_moments_f32``,
   ``kmeanspp_seed_f32`` and ``kmeans_assign_f32`` (checked); (b) phase
   6's cell with every fourth satellite on the reference path, per
   satellite equal to looped Missions, one ``kmeanspp_seed_lanes_f32``
   launch a shape bucket a round (checked); (c) Algorithm 1
   (``optimal_tile_size``) over benchmarks/fig4_tilesize.py's ``ap50``
   map (sizes 32-384, eps 48, 2 mini scenes) with 9c's space counter,
   ``ap50`` on the card equal to ``ap50`` on the CPU from the same boxes
   and ``iou_matrix_f32`` launched (checked), printing ``s_best``, the
   evaluated sizes and the mAP curve; (d) the three example drivers'
   ``main`` (quickstart, serve_collaborative, constellation_sim with
   ``--check``, which must hold) on 9c's counters.
11. the frozen monolith, the static analysis and the steady-state
   guard: (a) phase 3's cell through ``core/_legacy.py``'s
   ``run_pipeline_legacy`` on the engine path for every policy and on
   the reference path for kodan and targetfuse, each bit for bit the
   Mission with the same config (checked), with its wall time beside the
   Mission's and its launches by entry; (b) ``python -m
   repro_torch.analysis`` over the port with the checked-in empty
   baseline exits 0 (checked); (c) ``LaunchGuard`` over the steady-state
   rounds of two cells, tests/test_analysis.py's JitGuard cell (2
   satellites, the 256 px "jg" scene; rounds 3 and 4, their launches by
   entry equal, checked) and phase 6's cell (round 3), each after 2
   warm-up rounds on an emptied allocator cache: no kernel library
   loaded and no new allocator segment (checked), syncs printed.

It prints a ``{"kernels": [...]}`` line (each kernel at its main shape,
with an ``entries`` list giving each entry of its library at the entry's
first phase 2 case and its launches on the main paths: the Mission's
runs of phase 3, the fleet's of phase 6, the depth and orbital runs of
phase 8, serve's Missions of phase 9, phase 10's runs, phase 11's
monolith runs, qwen3-8b's of phase 5 and ``int8_matmul``'s one path),
then the
``nvidia-smi`` name and power limit, and last ``{"ok": true, "device":
{...}}``. Any failure exits non-zero before that last line.
"""
from __future__ import annotations

import inspect
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate
FP32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12         # H100 SXM bf16 tensor cores, dense
INT8_OPS = 1979e12          # H100 SXM int8 tensor cores, dense
SEED = 0
XVIEW_SCENES, XVIEW_REVISITS = 3, 3
# phase 5: LM_SHAPES' prefill_32k (B 32, S 32768) cut to what one card
# holds
LM_BATCH, LM_PROMPT, LM_STEPS = 2, 4096, 32
# phase 5: relative norm of decode logits against the full forward's at
# each generated position. bf16 activations through 36 layers, and the
# prefill's kernel keeps p to ~16 bits (float32 on the CUDA cores, two
# bf16 halves on the tensor cores) where the decode's plain version rounds
# it to bf16: measured 1.6e-2 to 1.7e-2 at every position on the H100, so
# about twice that (PERF.md)
LM_DECODE_RTOL = 0.03
# phase 2: a bf16 flash_attention output against the plain version on
# the inputs upcast to float32, the arithmetic the kernel does: the
# kernel's one rounding of its output to bf16 is at most 2**-8 of the
# value, so twice that relative, and float32 sums in another order
FLASH_BF16_RTOL, FLASH_BF16_ATOL = 2.0 ** -7, 1e-5


# phase 2's tile_moments cases, (shape, data); the first is the main
# path's (a capture bucket: 4 frames of 64 tiles). The comments give
# the cluster size the kernel picks on an H100 (132 SMs, 4 CTAs each;
# csrc/tile_moments.cu)
TILE_MOMENTS_CASES = [
    ((256, 416, 416, 3), "uniform"),    # clusters of 2
    ((130, 64, 64, 3), "uniform"),      # clusters of 2
    ((64, 416, 416, 1), "uniform"),     # C 1, clusters of 8
    ((40, 24, 24, 64), "uniform"),      # C 64 (CTA sums through shared memory), clusters of 8
    ((20, 101, 103, 5), "uniform"),     # C 5, ragged H*W, clusters of 8
    ((7, 333, 171, 3), "uniform"),      # ragged H*W: tiles off the 16-byte boundary, 8
    ((9, 100, 100, 3), "misaligned"),   # a view 4 bytes past its allocation's start, 4
    ((600, 5, 7, 5), "uniform"),        # one CTA a tile
    ((3, 1, 2, 3), "uniform"),          # less than one float4 a tile
    ((16, 416, 416, 3), "constant"),    # m2 = m3 = 0, clusters of 8
    ((32, 128, 128, 3), "offset"),      # 1e3 + uniform: the skew of shifted data, 8
]
# phase 2's kmeans_assign_f32 cases, (N, K, D); the first is the dedup's
# Lloyd steps and final assignment (k_pad 512 centroids, D = 3C = 9)
KMEANS_CASES = [(1024, 512, 9), (1024, 1, 9), (1024, 64, 9), (1000, 1, 9), (1000, 64, 9),
                (1000, 512, 9), (128, 1, 9), (128, 64, 9), (128, 512, 9), (1024, 33, 9),
                (300, 1000, 9), (1000, 45, 16), (256, 100, 128)]
# phase 2's lane cases of kmeans_assign, (n_pad, k_pad, n of each lane, k
# of each lane): first phase 6's bucket, 32 ragged lanes (9-tile passes: n
# 5-9, k n // 2 or an odd k), then 32 lanes at the Mission dedup's shape
# and one lane. The plain seeding of 32 lanes at 1024 rows takes 22-36 s on
# the card (a loop of 32 x 511 picks of ~30 small launches each), so that
# case times its plain version by the one call the comparison makes
LANE_CASES = [(128, 64, [5 + i % 5 for i in range(32)], [max(2, (5 + i % 5) // 2) + i % 3
                                                         for i in range(32)]),
              (1024, 512, [1024] * 32, [512] * 32),
              (1024, 512, [1000], [500])]
LANE_ENTRIES = ("kmeans_assign_lanes_f32", "kmeanspp_seed_lanes_f32")
# phase 6: benchmarks/fleet_bench.py's contact cell, _contact_spec(32, 8,
# seed=6) at its default knobs (3 rounds, 1 frame a pass)
FLEET_SATS, FLEET_STATIONS, FLEET_SEED, FLEET_ROUNDS, FLEET_FRAMES = 32, 8, 6, 3, 1
# phase 2's nms_keep_f32 cases, (case, B or None for unbatched (N, 4)
# boxes, N, max_det); the first is a counter chunk's: 64 tiles of 13 x 13
# cells x 3 anchors at 416 px, k = 128, the Mission's thresholds
NMS_CASES = [("main", 64, 507, 128), ("unbatched", None, 507, 128), ("n_37", 64, 37, 128),
             ("all_suppressed", 64, 507, 128), ("none_above", 64, 507, 128),
             ("nan_box", 64, 507, 128), ("k_1000", 4, 1000, 1000)]
NMS_IOU, NMS_SCORE = 0.25, 0.25  # count_tiles_batched's nms_iou, phase 3's score_thresh
LEDGER_LANES = ("budget_j", "e_cap", "e_com", "e_agg", "e_down", "bytes_budget",
                "bytes_requested", "bytes_spent")
# phase 8: benchmarks/fleet_bench.py's depth sweep (_depth_sweep) on phase
# 6's cell, and a watchdog no healthy recount round comes near
FLEET_DEPTHS, WATCHDOG_S = (1, 2), 60.0
# phase 8: benchmarks/orbits_bench.py's sizes (FULL_SATS x FULL_STEPS at a
# 60 s grid, the CATALOG_SIZE catalog x 90 steps, 8 stations x 1024 x
# 1440 elevation, 1024 x 1440 eclipse) and fleet_bench's orbital cell,
# _orbital_spec(16, 8, seed=6)
ORBIT_PROP, ORBIT_CATALOG, ORBIT_VIS = (4096, 1440), (14368, 90), (8, 1024, 1440)
ORBITAL_CELL = (16, 8, 6)
# phase 8: the CPU runs the first satellites of each orbital case. The
# card and the CPU do the same IEEE float32 and float64 operations, so
# positions should be bit-equal; a one-ulp allowance covers an fma the
# compiler of either side may contract. The elevation takes float64 asin
# and sqrt, which CUDA computes within 2 ulps of float64: the float32
# sine may then differ by one ulp, or two with the positions' ulp, so the
# pass edge moves only where an elevation is within that of the 10
# degree mask; budgets follow the sine of the pass maximum (5 degree
# mask of the orbital cell)
ORBIT_CPU_SATS, ORBIT_POS_ULPS = 256, 1
ORBIT_SIN_TOL = 4 * 2.0 ** -24
ORBIT_EDGE_DEG = math.degrees(ORBIT_SIN_TOL / math.cos(math.radians(10.0)))
ORBIT_BUDGET_RTOL = ORBIT_SIN_TOL / math.sin(math.radians(5.0))


def nms_args(g, dev, case, b, n):
    """(boxes (B, N, 4) or (N, 4), scores) on the card for an NMS_CASES
    row, shaped like the counters' decode: centres across a 416 px tile,
    sides up to 4 cells of 32 px, scores in [0, 0.6)."""
    import torch
    lead = (1 if b is None else b, n)
    c = torch.rand((*lead, 2), generator=g, device=dev) * 416
    wh = torch.rand((*lead, 2), generator=g, device=dev) * (48 if case == "k_1000" else 128)
    boxes = torch.cat([c - wh / 2, c + wh / 2], -1)
    scores = torch.rand(lead, generator=g, device=dev) * 0.6
    if case == "all_suppressed":     # every box the same: one kept an image
        boxes[:] = boxes[:, :1].clone()
        scores += 0.3
    elif case == "none_above":
        scores *= 0.4
    elif case == "nan_box":          # among the first candidates: suppresses nothing
        boxes[:, 5] = torch.tensor([float("nan"), 10, 200, 300], device=dev)
        boxes[:, 6, 3] = float("nan")
        scores[:, 5:7] = 0.59
    if b is None:
        boxes, scores = boxes[0], scores[0]
    return boxes.contiguous(), scores.contiguous()


def moment_tiles(g, dev, shape, data):
    """(N, H, W, C) float32 tiles on the card for a TILE_MOMENTS_CASES row."""
    import torch
    n, h, w, c = shape
    if data == "constant":
        return torch.rand((n, 1, 1, c), generator=g, device=dev).expand(shape).contiguous()
    if data == "misaligned":
        return torch.rand(n * h * w * c + 1, generator=g, device=dev)[1:].view(shape)
    t = torch.rand(shape, generator=g, device=dev)
    return t + 1e3 if data == "offset" else t


def kmeans_args(g, dev, n, k, d):
    """x (n, d), centroids (k, d) on the card with planted ties: duplicate
    rows and centroids, an exact hit, and a -0 row against +0 and -0
    centroids."""
    import torch
    x = torch.randn((n, d), generator=g, device=dev)
    cent = torch.randn((k, d), generator=g, device=dev)
    if k > 1:
        cent[k // 2] = cent[0]   # duplicate centroid: ties go to index 0
        cent[-1] = x[3]          # an exact hit
    if k > 8:
        cent[1] = 0.0            # row 7 is at d2 0 from both: index 1
        cent[2] = -0.0
    x[5] = x[3]
    x[7] = -0.0
    return x, cent


def bit_equal(got, want) -> bool:
    """Equal in every element, NaN where the other has NaN."""
    import torch
    if not got.is_floating_point():
        return torch.equal(got, want)
    nan = torch.isnan(got)
    return torch.equal(nan, torch.isnan(want)) and torch.equal(got[~nan], want[~nan])


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int, warmup: int = 2, hold: bool = True) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events.

    ``hold`` first keeps the card busy (``torch.cuda._sleep``) while the
    host queues all the runs, so the events time the device alone; else
    a small kernel's time is the host's launch rate (wrapper checks,
    ``ctypes`` and the launch).
    """
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if hold:
        torch.cuda._sleep(50_000_000)  # ~25 ms at the H100's clock
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float, rate: float = FP32_FLOPS):
    """The larger of the bytes over the memory rate and the operations
    over ``rate`` (their type's peak) -> (ms, what bounds it)."""
    t_b, t_f = n_bytes / HBM_BYTES_PER_S, n_ops / rate
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_cases(dev):
    """-> {kernel name: [case, ...]}; the first case of each kernel is its
    main-path shape, the one the ``kernels`` line reports."""
    import torch
    import torch.nn.functional as F
    from repro_torch import random as jrandom
    from repro_torch.kernels import (flash_attention, int8_matmul, iou, kmeans_assign, ref,
                                     tile_moments)

    g = torch.Generator(device=dev).manual_seed(SEED)
    cases = {"tile_moments": [], "kmeans_assign": [], "iou_matrix": [],
             "flash_attention": [], "int8_matmul": []}
    for shape, data in TILE_MOMENTS_CASES:
        t = moment_tiles(g, dev, shape, data)
        n, h, w, c = shape
        cases["tile_moments"].append(dict(
            shape=f"{shape} {data}", entry=(tile_moments.KERNEL, "tile_moments_f32"),
            kernel=lambda t=t: tile_moments.tile_moments(t),
            plain=lambda t=t: ref.tile_moments(t), atol=1e-4,
            bytes=t.numel() * 4 + n * 3 * c * 4, flops=7 * t.numel()))
    # the dedup's k-means++ seeding first (one launch of kmeanspp_seed_f32 a
    # dedup): (n_pad, n, k, k_pad, D, distinct rows or None)
    seed_entry = (kmeans_assign.KERNEL, "kmeanspp_seed_f32")
    for n_pad, n, k, k_pad, d, distinct in [
            (1024, 1024, 512, 512, 9, None),   # the main path's shape
            (1024, 1000, 500, 512, 9, None),   # pad rows zeroed, as _dedup_core leaves them
            (128, 128, 64, 64, 9, None),
            (256, 250, 64, 64, 9, 20),          # 20 distinct rows: ties, then all d2 0
            (8192, 8192, 256, 256, 9, None),    # past shared memory: rows from L2
            (4096, 4000, 128, 128, 16, None)]:  # D 16 past shared memory: rows from L2
        x = torch.randn((n_pad if distinct is None else distinct, d), generator=g, device=dev)
        if distinct is not None:
            x = x[torch.randint(0, distinct, (n_pad,), generator=g, device=dev)]
        x[n:] = 0.0
        x = x.contiguous()
        first = jrandom.randint(SEED + n, n)
        picks = min(k, k_pad) - 1
        cases["kmeans_assign"].append(dict(
            shape=f"kmeanspp_seed x({n_pad}, {d}) n {n} k {k} k_pad {k_pad}"
                  + ("" if distinct is None else f" {distinct} distinct rows"),
            entry=seed_entry, exact=True, chain=(picks, "dependent block reductions"),
            kernel=lambda x=x, a=(n, first, k, k_pad): kmeans_assign.kmeanspp_seed(x, *a),
            plain=lambda x=x, a=(n, first, k, k_pad): ref.kmeanspp_seed(x, *a),
            # x read once, the table and picks written once; a pick takes
            # a dot, the distance, a min and a compare a row
            bytes=n * d * 4 + k_pad * (d + 1) * 4, flops=picks * n * (2 * d + 6)))
    for n, k, d in KMEANS_CASES:
        x, cent = kmeans_args(g, dev, n, k, d)
        cases["kmeans_assign"].append(dict(
            shape=f"x({n}, {d}) c({k}, {d})", entry=(kmeans_assign.KERNEL, "kmeans_assign_f32"),
            kernel=lambda x=x, c=cent: kmeans_assign.kmeans_assign(x, c),
            plain=lambda x=x, c=cent: ref.kmeans_assign(x, c), exact=True,
            bytes=(n + k) * d * 4 + n * 8, flops=2 * n * k * d + 3 * n * k))
    # the lane entries of the fleet's dedup (dedup_multi): L lanes of one
    # (n_pad, k_pad) bucket, each held bit-equal to the plain version and,
    # lane by lane, to the one-lane entry. LANE_CASES: 32 lanes at the
    # Mission dedup's shape, a ragged bucket at phase 6's (n and k differ
    # by lane, pad rows zeroed), one lane
    for n_pad, k_pad, ns, ks in LANE_CASES:
        lanes, d = len(ns), 9
        x = torch.randn((lanes, n_pad, d), generator=g, device=dev)
        for i, n in enumerate(ns):
            x[i, n:] = 0.0
        x[:, 5] = x[:, 3]                      # a duplicate row a lane: ties
        firsts = [jrandom.randint(SEED + i, n) for i, n in enumerate(ns)]
        args = (ns, firsts, ks, k_pad)
        picks = [min(k, k_pad) - 1 for k in ks]
        shape = f"x({lanes}, {n_pad}, {d}) k_pad {k_pad}" + (
            "" if len(set(ns)) == 1 else f" ragged n {min(ns)}-{max(ns)} k {min(ks)}-{max(ks)}")
        cases["kmeans_assign"].append(dict(
            shape=f"kmeanspp_seed_lanes {shape}",
            entry=(kmeans_assign.KERNEL, "kmeanspp_seed_lanes_f32"), exact=True,
            plain_once=lanes * n_pad > 4096,
            chain=(max(picks), "dependent block reductions (lanes side by side)"),
            kernel=lambda x=x, a=args: kmeans_assign.kmeanspp_seed_lanes(x, *a),
            plain=lambda x=x, a=args: ref.kmeanspp_seed_lanes(x, *a),
            lanewise=lambda x=x, a=args: [kmeans_assign.kmeanspp_seed(
                x[i].contiguous(), a[0][i], a[1][i], a[2][i], a[3]) for i in range(len(a[0]))],
            bytes=sum(n * d * 4 + k_pad * (d + 1) * 4 for n in ns),
            flops=sum(p * n * (2 * d + 6) for p, n in zip(picks, ns))))
        cent = ref.kmeanspp_seed_lanes(x, *args)[0]
        cases["kmeans_assign"].append(dict(
            shape=f"kmeans_assign_lanes {shape}",
            entry=(kmeans_assign.KERNEL, "kmeans_assign_lanes_f32"), exact=True,
            kernel=lambda x=x, c=cent: kmeans_assign.kmeans_assign_lanes(x, c),
            plain=lambda x=x, c=cent: ref.kmeans_assign_lanes(x, c),
            lanewise=lambda x=x, c=cent: [kmeans_assign.kmeans_assign(
                x[i].contiguous(), c[i].contiguous()) for i in range(x.shape[0])],
            bytes=lanes * ((n_pad + k_pad) * d * 4 + n_pad * 8),
            flops=lanes * (2 * n_pad * k_pad * d + 3 * n_pad * k_pad)))
    # the counter chunk's NMS first (one nms_keep_f32 launch a chunk), on
    # the sort's top k as detector.nms_keep gives them; then iou_matrix_f32
    # at its earlier main shape, a ragged unbatched one and NaN boxes
    for case, b, n, max_det in NMS_CASES:
        boxes, scores = nms_args(g, dev, case, b, n)
        k = min(max_det, n)
        top_s, top_i = torch.sort(scores, dim=-1, descending=True, stable=True)
        args = (boxes, top_i[..., :k], top_s[..., :k], NMS_IOU, NMS_SCORE)
        # the work these inputs need: each kept candidate's IoU with every
        # later one (~14 operations); the scan's chain is one step a kept
        # box of the longest image
        kept = ref.nms_keep(*args).gather(-1, args[1]).reshape(-1, k)
        ious = int((kept * (k - 1 - torch.arange(k, device=dev))).sum())
        bs = b or 1
        cases["iou_matrix"].append(dict(
            shape=f"nms_keep {case}: boxes {tuple(boxes.shape)} k {k}",
            entry=(iou.KERNEL, "nms_keep_f32"), exact=True,
            chain=(int(kept.sum(-1).max()), "scan steps (kept boxes of the longest image)"),
            kernel=lambda a=args: iou.nms_keep(*a), plain=lambda a=args: ref.nms_keep(*a),
            bytes=bs * k * (16 + 8 + 4) + bs * n, flops=14 * ious))
    for b, n, m, nan in [(64, 128, 128, False), (None, 200, 300, False), (64, 128, 128, True)]:
        lead = () if b is None else (b,)
        bx = torch.rand((*lead, n + m, 4), generator=g, device=dev) * 50
        bx[..., 2:] = bx[..., :2] + bx[..., 2:].abs() + 0.01
        if nan:     # a coordinate, a whole box, and inf - inf
            bx[:, 3, 2], bx[:, 17], bx[:, 25, 0] = float("nan"), float("nan"), float("inf")
        a, bb = bx[..., :n, :].contiguous(), bx[..., n:, :].contiguous()
        if b is not None:
            bb = a           # NMS: the candidates against themselves
            m = n
        bs = b or 1
        cases["iou_matrix"].append(dict(
            shape=f"{tuple(a.shape)} x {tuple(bb.shape)}" + (" NaN boxes" if nan else ""),
            entry=(iou.KERNEL, "iou_matrix_f32"), exact=True,
            kernel=lambda a=a, bb=bb: iou.iou_matrix(a, bb),
            plain=lambda a=a, bb=bb: ref.iou_matrix(a, bb),
            bytes=bs * (n + m) * 16 + bs * n * m * 4, flops=12 * bs * n * m))

    # the LM prefill's shape first (qwen3-8b, B 2, S 4096: the tensor-core
    # route), the same on the CUDA-core route (forced, to time the two in
    # one run), bf16 shapes of the tensor-core route (ragged, D 64, Hq =
    # Hkv, Sq < Skv), then the f32 shapes of tests/test_kernels.py and
    # ragged ones, and bf16 with D 96 (the CUDA-core route)
    tc, cc = flash_attention.TENSOR_CORE, flash_attention.CUDA_CORE
    bf16, f32 = torch.bfloat16, torch.float32
    main = (2, 4096, 4096, 32, 8, 128)
    attn = [(main, bf16, True, tc), (main, bf16, True, cc),
            ((1, 200, 200, 4, 2, 128), bf16, True, tc),
            ((2, 256, 256, 4, 2, 64), bf16, False, tc),
            ((1, 384, 384, 8, 8, 128), bf16, True, tc),
            ((1, 128, 384, 4, 2, 128), bf16, False, tc)]
    attn += [((b, s, s, hq, hkv, d), f32, causal, cc)
             for b, s, hq, hkv, d in [(1, 128, 1, 1, 128), (2, 256, 4, 2, 128), (1, 384, 8, 8, 128),
                                      (2, 128, 6, 2, 256)] for causal in (False, True)]
    attn += [((1, 200, 200, 4, 2, 128), f32, True, cc),
             ((2, 200, 200, 4, 2, 16), f32, False, cc),
             ((1, 200, 200, 4, 2, 100), f32, True, cc),
             ((1, 200, 200, 4, 2, 96), bf16, True, cc)]
    for (b, sq, skv, hq, hkv, d), dt, causal, route in attn:
        check(route == cc or flash_attention.choose_route(dt, d) == route,
              f"flash case {(b, sq, skv, hq, hkv, d)} {dt}: not a {route} shape")
        q = torch.randn((b, sq, hq, d), generator=g, device=dev).to(dt)
        k, v = (torch.randn((b, skv, hkv, d), generator=g, device=dev).to(dt) for _ in range(2))
        tol = 3e-2 if dt == bf16 else 2e-5
        flops = 4 * b * hq * sq * skv * d / (2 if causal else 1)
        cases["flash_attention"].append(dict(
            shape=f"q{(b, sq, hq, d)} kv{(b, skv, hkv, d)} {str(dt)[6:]} causal={causal} "
                  f"route={route}",
            entry=(flash_attention.KERNEL, flash_attention.SYMBOLS[route, dt]),
            kernel=lambda q=q, k=k, v=v, c=causal, r=route: flash_attention.flash_attention(
                q, k, v, causal=c, route=r),
            plain=lambda q=q, k=k, v=v, c=causal: ref.attention(q, k, v, causal=c),
            library=lambda q=q, k=k, v=v, c=causal: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=c,
                enable_gqa=True),
            upcast=None if dt == f32 else (
                lambda q=q, k=k, v=v, c=causal: ref.attention(q.float(), k.float(), v.float(),
                                                              causal=c)),
            atol=tol, rtol=tol, bytes=2 * (q.numel() + k.numel()) * q.element_size(),
            flops=flops, rate=BF16_FLOPS if dt == bf16 else FP32_FLOPS))
    # a qwen3-8b gate/up projection over one 4096-token prompt first, on
    # both routes (the CUDA-core one forced), the kernel bench's shape on
    # both, those of tests/test_kernels.py, a ragged M with K and N off
    # the 128 tiles, then every product at +-127 * -127 over K 4096:
    # |acc| = 66,064,384, past float32's 24-bit integers, so only an exact
    # int32 sum agrees (N 2 on the CUDA cores, N 16 on the tensor cores)
    tc8, cc8 = int8_matmul.TENSOR_CORE, int8_matmul.CUDA_CORE
    for (m, k, n), route in [((4096, 4096, 12288), tc8), ((4096, 4096, 12288), cc8),
                             ((256, 512, 256), tc8), ((256, 512, 256), cc8),
                             ((128, 128, 128), tc8), ((100, 200, 150), cc8),
                             ((256, 512, 384), tc8), ((100, 208, 144), tc8),
                             ((1, 64, 1), cc8), ((3, 4096, 2), cc8), ((3, 4096, 16), tc8)]:
        check(route == cc8 or int8_matmul.choose_route(m, k, n) == route,
              f"int8 case {(m, k, n)}: not a {route} shape")
        args = int8_extreme(dev, n) if k == 4096 and m == 3 else int8_args(g, dev, m, k, n)
        cases["int8_matmul"].append(dict(
            shape=f"({m}, {k}) x ({k}, {n}) route={route}",
            entry=(int8_matmul.KERNEL, int8_matmul.SYMBOLS[route]),
            kernel=lambda a=args, r=route: int8_matmul.int8_matmul(*a, route=r),
            plain=lambda a=args: ref.int8_matmul(*a),
            library=lambda a=args: torch._int_mm(a[0], a[1]), exact=True,
            bytes=m * k + k * n + 4 * (m + n) + 4 * m * n, flops=2 * m * k * n, rate=INT8_OPS))
        del args
    return cases


def check_upcast(name, case, got):
    """A bf16 output against the plain version on float32 inputs."""
    import torch
    want = case["upcast"]()
    diff = (got.float() - want).abs()
    rel = (diff / want.abs().clamp(min=FLASH_BF16_ATOL / FLASH_BF16_RTOL)).max().item()
    norm = (diff.norm() / want.norm()).item()
    print(f"kernel {name} {case['shape']}: against float32 upcast inputs max_abs_err "
          f"{diff.max().item():.3e}, max relative {rel:.3e}, relative norm {norm:.3e} "
          f"(rtol {FLASH_BF16_RTOL:.3e}, atol {FLASH_BF16_ATOL:.0e})", flush=True)
    check(torch.allclose(got.float(), want, atol=FLASH_BF16_ATOL, rtol=FLASH_BF16_RTOL),
          f"{name} {case['shape']}: off the float32 version by {diff.max().item()}")


TC_ENTRY = "flash_tc_kernel"  # the tensor-core flash_attention kernels
TC_SYMBOL = "flash_attention_bf16_sm90"  # and their C entry point
INT8_TC_ENTRY = "int8_tc_kernel"  # the tensor-core int8_matmul kernel


def ptxas_report(logs: dict):
    """Registers, spills and shared memory of every kernel entry, from
    ptxas's report in this run's build. Fails if a tensor-core entry of
    ``flash_attention`` or ``int8_matmul`` spills, or if ptxas serializes
    a ``wgmma``."""
    if "flash_attention" not in logs:
        print("ptxas: flash_attention was built by an earlier run, no report to check", flush=True)
    for name, log in logs.items():
        entry, spill = "?", ""
        for line in log.splitlines():
            line = line.strip()
            if "Compiling entry function" in line:
                entry, spill = line.split("'")[1], ""
            elif "spill stores" in line:
                spill = line
            elif line.startswith("ptxas info") and ": Used " in line:
                print(f"ptxas {name} {entry}: {line.split(': ', 1)[1]}; {spill}", flush=True)
                if TC_ENTRY in entry or INT8_TC_ENTRY in entry:
                    check("0 bytes spill stores, 0 bytes spill loads" in spill,
                          f"ptxas: {entry} spills ({spill})")
            if "wgmma" in line and "serializ" in line:
                fail(f"ptxas serializes wgmma: {line}")
            if "warning" in line.lower():
                print(f"ptxas {name} {entry}: {line}", flush=True)
    if "flash_attention" in logs:
        check(TC_ENTRY in logs["flash_attention"], "ptxas reported no tensor-core entry")
    if "int8_matmul" in logs:
        check(INT8_TC_ENTRY in logs["int8_matmul"], "ptxas reported no int8 tensor-core entry")


def int8_args(g, dev, m, k, n):
    import torch
    return (torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8),
            torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8),
            torch.rand(m, generator=g, device=dev) + 0.1,
            torch.rand(n, generator=g, device=dev) + 0.1)


def int8_extreme(dev, n):
    """(3, 4096) x (4096, n) at +-127 * -127: |acc| up to 66,064,384."""
    import torch
    x = torch.full((3, 4096), -127, dtype=torch.int8, device=dev)
    w = torch.full((4096, n), -127, dtype=torch.int8, device=dev)
    x[1] = 127
    w[::3, 1] = 126
    return x, w, torch.ones(3, device=dev), torch.ones(n, device=dev)


LIBRARY_NOTE = {
    "tile_moments": "null: no one PyTorch call computes mean, stddev and cube-root skew",
    "kmeans_assign": "null: no PyTorch call seeds k-means++ (the plain version is ~6 calls a "
                     "pick); for kmeans_assign_f32, torch.cdist gives the distances but not "
                     "the argmin",
    "iou_matrix": "null: no PyTorch call does greedy NMS (torchvision's nms is not "
                  "installed); for iou_matrix_f32, no batched box IoU in PyTorch",
    "flash_attention": "scaled_dot_product_attention(is_causal, enable_gqa) on (B, H, S, D) "
                       "views, at the first shape",
    "int8_matmul": "torch._int_mm, the int32 product without the scales, at the first shape",
}


def phase_kernels(dev):
    import torch
    rows = {}
    for name, cases in kernel_cases(dev).items():
        for i, case in enumerate(cases):
            lib, symbol = case["entry"]
            before = dict(lib.symbol_launches)
            got = case["kernel"]()
            t_plain = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            t_plain[0].record()
            want = case["plain"]()
            t_plain[1].record()
            torch.cuda.synchronize()
            took = {k: n - before[k] for k, n in lib.symbol_launches.items() if n != before[k]}
            check(took == {symbol: 1}, f"{name} {case['shape']}: launched {took}, not {symbol}")
            if case.get("exact"):
                pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
                err = max((g.double() - w.double()).abs().nan_to_num(0.0).max().item()
                          for g, w in pairs)
                check(all(bit_equal(g, w) for g, w in pairs),
                      f"{name} {case['shape']}: not bit-equal ({err})")
            else:
                err = (got.float() - want.float()).abs().max().item()
                check(torch.allclose(got.float(), want.float(), atol=case["atol"],
                                     rtol=case.get("rtol", 1e-4)),
                      f"{name} {case['shape']}: off by {err}")
            if case.get("upcast") is not None:
                check_upcast(name, case, got)
            if case.get("lanewise") is not None:
                # lane by lane against the one-lane entry (not counted)
                lanes = case["lanewise"]()
                torch.cuda.synchronize()
                check(all(bit_equal(g[i], w) for g, ws in zip(got, zip(*lanes))
                          for i, w in enumerate(ws)),
                      f"{name} {case['shape']}: a lane differs from the one-lane entry")
                print(f"kernel {name} {case['shape']}: each of {len(lanes)} lanes bit-equal "
                      f"to the one-lane entry", flush=True)
            del got, want
            ms = cuda_ms(case["kernel"], reps=20)
            host_ms = cuda_ms(case["kernel"], reps=20, hold=False)
            plain_ms = (t_plain[0].elapsed_time(t_plain[1]) if case.get("plain_once")
                        else cuda_ms(case["plain"], reps=5, warmup=1))
            b_ms, b_by = bound_ms(case["bytes"], case["flops"], case.get("rate", FP32_FLOPS))
            lib_ms = cuda_ms(case["library"], reps=20) if i == 0 and "library" in case else None
            chain = "" if "chain" not in case else (
                f" chain of {case['chain'][0]} {case['chain'][1]}, "
                f"{1e3 * ms / max(case['chain'][0], 1):.4f} us a step")
            print(f"kernel {name} {case['shape']}: max_abs_err {err:.3e} "
                  f"ms {ms:.4f} (with host launch {host_ms:.4f}) "
                  f"plain_ms {plain_ms:.4f} bound_ms {b_ms:.4f} "
                  f"({b_by}) share {b_ms / ms:.3f}"
                  + ("" if lib_ms is None else f" library_ms {lib_ms:.4f}") + chain, flush=True)
            if i == 0:
                rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, entries={})
            # each entry of the library at its first case
            rows[name]["entries"].setdefault(symbol, dict(
                shape=case["shape"], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by))
        torch.cuda.empty_cache()
    for name, why in LIBRARY_NOTE.items():
        print(f"kernel {name}: library_ms {why}")
    return rows


def int8_path(dev, kernel):
    """``int8_matmul``'s one path, as the reference's kernel bench drives
    it: ``ops.int8_matmul`` at 256 x 512 x 256, which the route rule sends
    to the tensor cores -> launches in that run."""
    import torch
    from repro_torch.kernels import ops
    args = int8_args(torch.Generator(device=dev).manual_seed(SEED + 1), dev, 256, 512, 256)
    kernel.reset()
    out = ops.int8_matmul(*args)
    torch.cuda.synchronize()
    check(out.shape == (256, 256) and bool(torch.isfinite(out).all()), "int8 path: bad output")
    check(kernel.symbol_launches == {"int8_matmul_s8_sm90": 1, "int8_matmul_s8": 0},
          f"int8 path: launched {kernel.symbol_launches}, not the tensor-core entry once")
    print(f"int8 path: ops.int8_matmul (256, 512) x (512, 256), {kernel.launches} launch, "
          f"by entry {kernel.symbol_launches}", flush=True)
    return kernel.launches


# ---------------------------------------------------------------------------
# phases 3 and 4: the Mission
# ---------------------------------------------------------------------------

POLICIES = ("space_only", "ground_only", "tiansuan", "kodan", "targetfuse")


def counters(cfg_pair, dev, head_scale=1.0):
    """Seeded random counters with the head's objectness and class-0
    biases raised (to 2), so every tile has boxes for NMS to keep and
    suppress and confidences fall between the throttle's thresholds.
    ``head_scale`` widens the head's weights, so confidences spread."""
    import torch
    from repro_torch.models import detector
    out = []
    for seed, cfg in enumerate(cfg_pair):
        p = detector.init(torch.Generator().manual_seed(SEED + seed), cfg, device=dev)
        p["head_w"] = p["head_w"] * head_scale
        hb = p["head_b"].view(cfg.n_anchors, 5 + cfg.n_classes)
        hb[:, 4] = 2.0
        hb[:, 5] = 2.0
        out.append((p, cfg))
    return out


def scene_frames(spec, n_scenes, n_revisits, seed):
    import numpy as np
    from repro_torch.data.synthetic import make_scene, revisit_frames
    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(n_scenes):
        img, b, c = make_scene(rng, spec)
        frames += revisit_frames(rng, img, b, c, n_revisits)
    return frames


class Timed:
    """A Mission stage with a wall-clock timer around it; the card is
    synchronized on both sides, so the time is the stage's own. After
    the stage, each of ``events`` (:class:`EventTimes`) gives the device
    ms of the calls it recorded in it, kept by stage in ``device_ms``."""

    def __init__(self, stage, times: dict, events=(), device_ms=None):
        self.stage, self.times, self.name = stage, times, stage.name
        self.events, self.device_ms = events, device_ms

    def run(self, mission, seg, window=None):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.stage.run(mission, seg, window)
        torch.cuda.synchronize()
        self.times[self.name] = self.times.get(self.name, 0.0) + time.perf_counter() - t0
        for ev in self.events:
            self.device_ms.setdefault(self.name, {}).setdefault(ev.attr, []).extend(ev.take())


class EventTimes:
    """CUDA events recorded around every call of ``module.attr`` while
    the context is open (the script wraps the function; the package is
    not changed). Each pair gives the device time from the stream
    reaching the call to the end of its work: the kernel, and any wait
    for the host's launch when the card is idle."""

    def __init__(self, module, attr: str):
        self.module, self.attr, self.fn, self.pairs = module, attr, getattr(module, attr), []

    def __enter__(self):
        import torch

        def timed(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = self.fn(*args, **kwargs)
            end.record()
            self.pairs.append((start, end))
            return out
        setattr(self.module, self.attr, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.fn)

    def take(self) -> list:
        """-> ms of each call since the last take."""
        import torch
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in self.pairs]
        self.pairs = []
        return ms


def run_mission(space, ground, frames, method, dev):
    """One full-width Mission of ``method`` -> (its result, a dict of:
    ingest_s, contact_s, tiles_per_s, stages_s (each stage's wall time),
    the device ms of capture's ``ops.tile_moments`` calls, and by stage
    the device ms of each counter chunk (``cascade.count_tiles``) and of
    its NMS (``detector.nms_keep``)). Events wrap the functions by name,
    so the same measurement runs on any checkout of the port."""
    from repro_torch.core import cascade
    from repro_torch.core import mission as M
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.kernels import ops
    from repro_torch.models import detector

    stages, device_ms = {}, {}
    chunk, nms = EventTimes(cascade, "count_tiles"), EventTimes(detector, "nms_keep")

    def timed(sts):
        return [Timed(st, stages, (chunk, nms), device_ms) for st in sts]
    pcfg = PipelineConfig(method=method, score_thresh=NMS_SCORE, seed=SEED)
    m = M.Mission(space, ground, pcfg, device=dev,
                  ingest_stages=timed(M.default_ingest_stages()),
                  contact_stages=timed(M.default_contact_stages()))
    with EventTimes(ops, "tile_moments") as moments, chunk, nms:
        t0 = time.perf_counter()
        m.ingest(frames)
        t1 = time.perf_counter()
        m.contact_window()
        t2 = time.perf_counter()
    r = m.result()

    def by_stage(attr):
        return {st: d[attr] for st, d in device_ms.items() if d[attr]}
    return r, dict(ingest_s=t1 - t0, contact_s=t2 - t1, tiles_per_s=r.tiles_total / (t2 - t0),
                   stages_s=stages, capture_tile_moments_ms=moments.take(),
                   chunk_ms=by_stage("count_tiles"), nms_ms=by_stage("nms_keep"))


def phase_full_width(dev, kernels):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import dedup as dd
    from repro_torch.data.synthetic import DATASETS

    cfgs = (get_config("targetfuse-space"), get_config("targetfuse-ground"))
    space, ground = counters(cfgs, dev)
    frames = scene_frames(DATASETS["xview"], XVIEW_SCENES, XVIEW_REVISITS, SEED)
    n_tiles = len(frames) * (DATASETS["xview"].scene_px // 128) ** 2
    print(f"full width: {len(frames)} xview frames, {n_tiles} tiles; "
          f"space {cfgs[0].widths} ground {cfgs[1].widths} at "
          f"{cfgs[0].input_size} px", flush=True)

    run_mission(space, ground, frames, "targetfuse", dev)  # warm-up
    torch.cuda.synchronize()
    for k in kernels:
        k.reset()
    per_policy = {}
    iters = inspect.signature(dd.dedup_from_moments).parameters["iters"].default
    for method in POLICIES:
        before = {k.name: k.launches for k in kernels}
        before_entry = {s: n for k in kernels for s, n in k.symbol_launches.items()}
        torch.cuda.reset_peak_memory_stats()
        r, run = run_mission(space, ground, frames, method, dev)
        launches = {k.name: k.launches - before[k.name] for k in kernels}
        entries = {s: n - before_entry[s] for k in kernels for s, n in k.symbol_launches.items()}
        check(r.tiles_total == n_tiles, f"{method}: {r.tiles_total} tiles")
        # one seeding launch a dedup, then the Lloyd steps and the final
        # assignment: no launch a k-means++ pick
        check(entries["kmeans_assign_f32"] == (iters + 1) * entries["kmeanspp_seed_f32"],
              f"{method}: kmeans_assign launches by entry {entries}")
        # one NMS launch a counter chunk, and no IoU matrix
        chunks = sum(len(v) for v in run["chunk_ms"].values())
        check(entries["nms_keep_f32"] == chunks == sum(len(v) for v in run["nms_ms"].values())
              and entries["iou_matrix_f32"] == 0,
              f"{method}: {chunks} counter chunks, iou launches by entry {entries}")
        check(np.isfinite(r.per_tile_pred).all() and r.per_tile_pred.shape == (n_tiles,),
              f"{method}: bad predictions")
        stages = run["stages_s"]
        per_policy[method] = dict(
            ingest_s=run["ingest_s"], contact_s=run["contact_s"], tiles_per_s=run["tiles_per_s"],
            max_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            launches=launches, launches_by_entry=entries, counter_chunks=chunks,
            dedup_s=stages.get("dedup", 0.0), stages_s=stages,
            capture_tile_moments_ms=run["capture_tile_moments_ms"],
            nms_ms_by_stage={st: sum(v) for st, v in run["nms_ms"].items()},
            chunk_ms_by_stage={st: sum(v) for st, v in run["chunk_ms"].items()},
            cmae=r.cmae, total_pred=r.total_pred, total_true=r.total_true,
            processed=r.tiles_processed_space, downlinked=r.tiles_downlinked)
        print(f"mission {method}: " + json.dumps(per_policy[method]), flush=True)
        cap_ms, moments_ms = 1e3 * stages.get("capture", 0.0), run["capture_tile_moments_ms"]
        print(f"mission {method} capture: {cap_ms:.4f} ms, of which ops.tile_moments "
              f"{sum(moments_ms):.4f} ms of device time in {len(moments_ms)} calls "
              f"({sum(moments_ms) / max(cap_ms, 1e-9):.4f})", flush=True)
        for st, ms in run["nms_ms"].items():
            chunk_ms = sum(run["chunk_ms"][st])
            print(f"mission {method} {st}: {1e3 * stages[st]:.4f} ms; {len(ms)} counter chunks "
                  f"of {chunk_ms:.4f} ms device time, of which detector.nms_keep "
                  f"{sum(ms):.4f} ms ({sum(ms) / max(chunk_ms, 1e-9):.4f}; "
                  f"{sum(ms) / len(ms):.4f} ms a chunk)", flush=True)
    # every kernel entry of the Mission ran in targetfuse, but iou_matrix_f32,
    # whose IoU matrix the NMS keeps in shared memory now, and the fleet's
    # lane entries
    tf = per_policy["targetfuse"]["launches_by_entry"]
    idle = ("iou_matrix_f32",) + LANE_ENTRIES
    check(all(v > 0 for e, v in tf.items() if e not in idle) and not any(tf[e] for e in idle),
          f"targetfuse missed a kernel entry, or launched {idle}: {tf}")
    check(per_policy["targetfuse"]["downlinked"] > 0, "targetfuse downlinked nothing")
    return {k.name: k.launches for k in kernels}


class ReplayDedup:
    """Dedup stage that runs the port's own clustering, keeps its result,
    then gives each segment the representatives of another run."""

    def __init__(self, rep_ofs):
        from repro_torch.core.mission import Dedup
        self.inner, self.rep_ofs, self.own = Dedup(), list(rep_ofs), []
        self.name = "dedup"

    def run(self, mission, seg, window=None):
        self.inner.run(mission, seg, window)
        self.own.append(seg.rep_of.copy())
        seg.rep_of = self.rep_ofs.pop(0).copy()


def same_partition(a, b) -> bool:
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


def phase_cuda_vs_cpu(dev):
    """The reduced Mission on the card and on the CPU: equal per-tile
    predictions. Two-member clusters are ties that the last bit of the
    moments decides (kernel and plain version sum in another order), so
    the clustering policies are compared with the CPU run's
    representatives replayed on the card, after checking that the card
    found the same clusters."""
    import numpy as np
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import mission as M
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.data.synthetic import SceneSpec

    cfgs = (reduced(get_config("targetfuse-space")), reduced(get_config("targetfuse-ground")))
    spec = SceneSpec("golden", 384, (12, 18), (10, 24), cloud_fraction=0.2)
    frames = scene_frames(spec, 2, 3, 42)
    cpu_counters = counters(cfgs, "cpu", head_scale=30.0)
    gpu_counters = counters(cfgs, dev, head_scale=30.0)
    for method in POLICIES:
        pcfg = PipelineConfig(method=method, score_thresh=0.25, seed=SEED)
        cpu = M.Mission(*cpu_counters, pcfg, device="cpu")
        want = cpu.run(frames)
        gpu = M.Mission(*gpu_counters, pcfg, device=dev)
        free = gpu.run(frames)
        stages, replay = None, None
        if method in ("kodan", "targetfuse"):
            replay = ReplayDedup([s.rep_of for s in cpu._segments])
            stages = [M.Capture(), M.RoiFilter(), replay, M.OnboardCount()]
        got = M.Mission(*gpu_counters, pcfg, ingest_stages=stages, device=dev).run(frames)
        if replay is not None:
            check(same_partition(replay.own[0], cpu._segments[0].rep_of),
                  f"{method}: the card's clusters differ from the CPU's")
        equal = np.array_equal(got.per_tile_pred, want.per_tile_pred)
        print(f"cuda vs cpu {method}: preds equal {equal} (free-running dedup: "
              f"{np.array_equal(free.per_tile_pred, want.per_tile_pred)}); "
              f"pred {got.total_pred} true {want.total_true} "
              f"downlinked {got.tiles_downlinked} processed {got.tiles_processed_space}",
              flush=True)
        check(equal, f"{method}: CUDA and CPU per-tile predictions differ")
        check(got.summary() == want.summary(), f"{method}: summaries differ")
        check(want.total_pred > 0, f"{method}: nothing counted")


# ---------------------------------------------------------------------------
# phase 6: the constellation
# ---------------------------------------------------------------------------

def contact_spec(n_sats, n_stations, seed):
    """The port's copy of ``benchmarks/fleet_bench.py:_contact_spec``: every
    round offers ``n_stations`` rotating windows at staggered bandwidths,
    so passes pile up between a satellite's contacts and windows drain
    several segments."""
    from repro_torch.data.scenarios import FleetScenarioSpec, GroundStation
    from repro_torch.data.synthetic import SceneSpec
    scene = SceneSpec("contact", 384, (10, 20), (10, 24), cloud_fraction=0.25)
    stations = tuple(GroundStation(f"gs{k}", bandwidth_mbps=30.0 + 5.0 * (k % 5),
                                   contact_s=240.0 + 30.0 * (k % 3))
                     for k in range(n_stations))
    return FleetScenarioSpec(n_sats=n_sats, n_rounds=FLEET_ROUNDS,
                             frames_per_pass=FLEET_FRAMES, stations=stations,
                             scene_mix=(scene,), seed=seed)


class WallTimes:
    """Synchronized host wall time of every call of ``owner.attr`` while
    the context is open, summed into ``times[name]`` (the script wraps
    the function; the package is not changed)."""

    def __init__(self, owner, attr: str, name: str, times: dict):
        self.owner, self.attr, self.name, self.times = owner, attr, name, times
        self.fn = getattr(owner, attr)

    def __enter__(self):
        import torch

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.times[self.name] = self.times.get(self.name, 0.0) + time.perf_counter() - t0
            return out
        setattr(self.owner, self.attr, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self.fn)


def phase_fleet(dev, kernels):
    """The constellation at full width: ``run_scenario`` (a Fleet, each
    round's contacts a ContactPlan at ground-segment depth 0) of
    targetfuse over benchmarks/fleet_bench.py's contact cell, with the
    full-width counters of phase 3. Checks: per-satellite results equal
    FLEET_SATS looped Missions on the card, and so do a second run and an
    ``ingest_overlap`` run's; one kmeanspp_seed_lanes_f32
    launch a shape bucket a round, (iters + 1) kmeans_assign_lanes_f32
    launches each, and no one-lane kmeans_assign launch inside
    Fleet.ingest. Prints tiles/s, windows/s, the stages' synchronized
    wall times (a second run) and the launches by entry -> the launches
    by kernel name and by entry."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import contact, dedup as dd, engine, fleet as F
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.data.scenarios import generate_scenario

    cfgs = (get_config("targetfuse-space"), get_config("targetfuse-ground"))
    space, ground = counters(cfgs, dev)
    sc = generate_scenario(contact_spec(FLEET_SATS, FLEET_STATIONS, FLEET_SEED))
    n_tiles = sum(len(p.frames) * 9 for r in sc.rounds for p in r.passes)
    pcfg = PipelineConfig(method="targetfuse", score_thresh=NMS_SCORE, seed=SEED)
    iters = inspect.signature(dd.dedup_multi).parameters["iters"].default
    print(f"fleet: {FLEET_SATS} satellites, {FLEET_STATIONS} stations, {len(sc.rounds)} rounds "
          f"of {FLEET_FRAMES} frame a pass (no round cut), {n_tiles} tiles; targetfuse, "
          f"space {cfgs[0].widths} ground {cfgs[1].widths} at {cfgs[0].input_size} px",
          flush=True)
    F.run_scenario(space, ground, pcfg, sc, device=dev)  # warm-up, dropped
    torch.cuda.synchronize()

    buckets, in_ingest = [], {}
    multi, ingest = dd.dedup_multi, F.Fleet.ingest

    def counted_multi(parts, *a, **kw):
        buckets.append(len({dd._buckets_for(int(m.shape[0]) if n is None else n, k)
                            for m, k, _, n in parts}))
        return multi(parts, *a, **kw)

    def counted_ingest(self, *a, **kw):
        before = {s: n for k in kernels for s, n in k.symbol_launches.items()}
        out = ingest(self, *a, **kw)
        for k in kernels:
            for s, n in k.symbol_launches.items():
                in_ingest[s] = in_ingest.get(s, 0) + n - before[s]
        return out
    dd.dedup_multi, F.Fleet.ingest = counted_multi, counted_ingest
    for k in kernels:
        k.reset()
    torch.cuda.reset_peak_memory_stats()
    try:
        got, fl = F.run_scenario(space, ground, pcfg, sc, device=dev)
        torch.cuda.synchronize()
    finally:
        dd.dedup_multi, F.Fleet.ingest = multi, ingest
    launches = {k.name: k.launches for k in kernels}
    entries = {s: n for k in kernels for s, n in k.symbol_launches.items()}
    summ = fl.summary()
    ledger = {f: getattr(fl.ledger, f)[:FLEET_SATS].copy() for f in LEDGER_LANES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # a Mission's segments keep their two tile tensors (a 64-row bucket
    # of 416 px tiles each, ~0.27 GB a pass; a fleet's keep none), so
    # each run's Fleet or Missions are dropped before the next run and
    # only their host results are kept
    del fl

    stages = {}
    with WallTimes(engine, "prepare_frames_multi", "capture", stages), \
            WallTimes(F.Fleet, "_dedup_batched", "dedup", stages), \
            WallTimes(F.Fleet, "_onboard_count_batched", "onboard_count", stages), \
            WallTimes(contact, "_select_downlink", "select_downlink", stages), \
            WallTimes(contact, "_recount_aggregate", "ground_recount_aggregate", stages):
        timed = F.run_scenario(space, ground, pcfg, sc, device=dev)[0]
    overlap = F.run_scenario(space, ground, pcfg, sc, ingest_overlap=True, device=dev)[0]
    want = F.run_scenario(space, ground, pcfg, sc, fleet=False, device=dev)[0]

    same = same_fleet_results(got, want)
    same_timed, same_overlap = (all(same_fleet_results(r, got)) for r in (timed, overlap))
    print(f"fleet vs {FLEET_SATS} looped Missions: {sum(same)} of {len(same)} satellites equal "
          f"(per-tile predictions and summaries); the staged run and the ingest_overlap run "
          f"equal the fleet: {same_timed}, {same_overlap}", flush=True)
    check(all(same), f"fleet: satellites {[i for i, e in enumerate(same) if not e]} differ "
                     f"from their looped Missions")
    check(same_timed and same_overlap, "fleet: a second run or the ingest_overlap run differs")
    check(sum(r.tiles_total for r in got) == n_tiles and summ["windows_served"] > 0
          and all(np.isfinite(r.per_tile_pred).all() for r in got)
          and sum(r.tiles_downlinked for r in got) > 0, f"fleet: bad results {summ}")
    # one seeding launch a shape bucket a round, the Lloyd steps and the
    # final assignment on the lane entry, no one-lane k-means launch
    check(len(buckets) == len(sc.rounds)
          and entries["kmeanspp_seed_lanes_f32"] == in_ingest["kmeanspp_seed_lanes_f32"]
          == sum(buckets)
          and entries["kmeans_assign_lanes_f32"] == (iters + 1) * sum(buckets)
          and in_ingest["kmeans_assign_f32"] == in_ingest["kmeanspp_seed_f32"] == 0
          and entries["kmeans_assign_f32"] == entries["kmeanspp_seed_f32"] == 0
          and entries["iou_matrix_f32"] == 0 and entries["nms_keep_f32"] > 0
          and entries["tile_moments_f32"] > 0,
          f"fleet: launches by entry {entries}, in ingest {in_ingest}, buckets {buckets}")
    row = dict(sats=FLEET_SATS, stations=FLEET_STATIONS, rounds=len(sc.rounds),
               tiles=n_tiles, tiles_per_s=summ["tiles_per_s"], ingest_s=summ["ingest_s"],
               contact_s=summ["contact_s"], windows_served=summ["windows_served"],
               windows_per_s=summ["windows_per_s"], peak_gb=peak_gb,
               buckets_per_round=buckets,
               launches_by_entry=entries, stages_s=stages,
               total_pred=sum(r.total_pred for r in got), total_true=summ["total_true"],
               downlinked=summ["tiles_downlinked"], processed=summ["tiles_processed_space"])
    print("fleet targetfuse: " + json.dumps(row), flush=True)
    print(f"fleet tiles/s {summ['tiles_per_s']:.1f} (ingest {summ['ingest_s']:.4f} s), "
          f"windows/s {summ['windows_per_s']:.1f} ({summ['windows_served']} windows in "
          f"{summ['contact_s']:.4f} s); stages (synchronized, second run): "
          + ", ".join(f"{k} {v:.4f} s" for k, v in stages.items()), flush=True)
    print(f"fleet launches by entry: {entries}", flush=True)
    return launches, entries, dict(results=got, ledger=ledger, summary=summ, entries=entries)


# ---------------------------------------------------------------------------
# phase 8: the recount pipeline at depth >= 1, and the orbital geometry
# ---------------------------------------------------------------------------

def counted_run(kernels, fn):
    """Run ``fn`` as a main path: every launch count set to 0 just before
    and read just after -> (fn's result, launches by kernel, by entry)."""
    import torch
    for k in kernels:
        k.reset()
    out = fn()
    torch.cuda.synchronize()
    return (out, {k.name: k.launches for k in kernels},
            {s: n for k in kernels for s, n in k.symbol_launches.items()})


def same_fleet_results(xs, ys) -> list:
    import numpy as np
    return [np.array_equal(a.per_tile_pred, b.per_tile_pred) and a.summary() == b.summary()
            for a, b in zip(xs, ys, strict=True)]


def phase_depth(dev, kernels, base):
    """benchmarks/fleet_bench.py's depth sweep on the card: phase 6's cell
    (targetfuse, 32 satellites, 8 stations, 3 rounds) at ``async_depth``
    1 and 2, each round's ground recount and Aggregate on a worker thread
    and its own CUDA stream. Checks against phase 6's depth-0 run
    (``base``): per-satellite predictions and summaries, every ledger
    lane and the nms_keep_f32 launches equal; at most ``depth`` rounds in
    flight (``depth`` at depth 2); recount_wait_s <= recount_s; every
    recount on a worker thread, on a stream other than the foreground's.
    Then a worker crash in round 1 with the watchdog set, at depth 2,
    equals the same fault plan at depth 0, one recovery. -> launches by
    kernel and by entry of the depth runs and the faulty depth-2 run."""
    import threading

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import contact, fleet as F
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.data.scenarios import generate_scenario

    space, ground = counters((get_config("targetfuse-space"),
                              get_config("targetfuse-ground")), dev)
    sc = generate_scenario(contact_spec(FLEET_SATS, FLEET_STATIONS, FLEET_SEED))
    pcfg = PipelineConfig(method="targetfuse", score_thresh=NMS_SCORE, seed=SEED)
    main_stream = torch.cuda.current_stream(dev).cuda_stream
    total, total_entries = {}, {}

    def add(launches, entries):
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        for sym, n in entries.items():
            total_entries[sym] = total_entries.get(sym, 0) + n

    s0 = base["summary"]
    rows = {0: dict(tiles_per_s=s0["tiles_per_s"], windows_per_s=s0["windows_per_s"],
                    contact_s=s0["contact_s"], recount_s=s0["recount_s"],
                    recount_wait_s=s0["recount_wait_s"],
                    recount_hidden_frac=s0["recount_hidden_frac"])}
    recount_calls, count = [], contact.count_tiles_multi

    def spy(*args, **kwargs):
        recount_calls.append((threading.current_thread() is threading.main_thread(),
                              torch.cuda.current_stream(dev).cuda_stream))
        return count(*args, **kwargs)

    # warm-up, dropped: a first depth-1 run reads slower, its first worker
    # thread setting up its stream and library handles
    # (scripts/recount_pipeline_bench.py: contact_s 0.120 s, 0.055-0.065 s after)
    F.run_scenario(space, ground, pcfg, sc, async_depth=FLEET_DEPTHS[-1], device=dev)
    for depth in FLEET_DEPTHS:
        recount_calls.clear()
        contact.count_tiles_multi = spy
        try:
            (got, fl), launches, entries = counted_run(
                kernels, lambda: F.run_scenario(space, ground, pcfg, sc, async_depth=depth,
                                                device=dev))
        finally:
            contact.count_tiles_multi = count
        add(launches, entries)
        s = fl.summary()
        same = same_fleet_results(got, base["results"])
        lanes = [f for f in LEDGER_LANES
                 if not np.array_equal(getattr(fl.ledger, f)[:FLEET_SATS], base["ledger"][f])]
        on_worker = [not main and stream != main_stream for main, stream in recount_calls]
        rows[depth] = dict(tiles_per_s=s["tiles_per_s"], windows_per_s=s["windows_per_s"],
                           contact_s=s["contact_s"], recount_s=s["recount_s"],
                           recount_wait_s=s["recount_wait_s"],
                           recount_hidden_frac=s["recount_hidden_frac"],
                           max_in_flight=s["recount_max_in_flight"],
                           rounds_deferred=s["recount_rounds_deferred"],
                           recount_calls=len(recount_calls),
                           nms_keep_f32=entries["nms_keep_f32"])
        print(f"depth {depth}: {sum(same)} of {len(same)} satellites equal depth 0; "
              f"ledger lanes differing {lanes}; " + json.dumps(rows[depth]), flush=True)
        check(all(same), f"depth {depth}: satellites {[i for i, e in enumerate(same) if not e]} "
                         f"differ from depth 0")
        check(not lanes, f"depth {depth}: ledger lanes {lanes} differ from depth 0")
        check(s["recount_max_in_flight"] <= depth
              and (depth != 2 or s["recount_max_in_flight"] == 2),
              f"depth {depth}: {s['recount_max_in_flight']} rounds in flight")
        check(s["recount_wait_s"] <= s["recount_s"] and s["recount_rounds_deferred"] > 0,
              f"depth {depth}: recount accounting {s}")
        check(entries["nms_keep_f32"] == base["entries"]["nms_keep_f32"],
              f"depth {depth}: {entries['nms_keep_f32']} nms_keep_f32 launches, depth 0 "
              f"{base['entries']['nms_keep_f32']}")
        check(entries["tile_moments_f32"] > 0 and entries["kmeans_assign_lanes_f32"] > 0
              and entries["kmeanspp_seed_lanes_f32"] > 0,
              f"depth {depth}: launches by entry {entries}")
        check(recount_calls and all(on_worker),
              f"depth {depth}: recounts off a worker stream {recount_calls} "
              f"(foreground stream {main_stream})")
        del fl
    fp = FaultPlan(worker_faults={1: "crash"})
    want, f0 = F.run_scenario(space, ground, pcfg, sc, faults=fp, device=dev)
    del f0
    (got, fl), launches, entries = counted_run(
        kernels, lambda: F.run_scenario(space, ground, pcfg, sc, faults=fp, async_depth=2,
                                        watchdog_s=WATCHDOG_S, device=dev))
    add(launches, entries)
    s = fl.summary()
    same = same_fleet_results(got, want)
    print(f"depth 2 with a worker crash in round 1 (watchdog {WATCHDOG_S} s): {sum(same)} of "
          f"{len(same)} satellites equal the same fault plan at depth 0; crashes "
          f"{s['fault_worker_crashes']}, recoveries {s['fault_watchdog_recoveries']}",
          flush=True)
    check(all(same), "depth 2 crash: results differ from depth 0 under the same fault plan")
    check(s["fault_worker_crashes"] == 1 and s["fault_watchdog_recoveries"] == 1,
          f"depth 2 crash: {s['fault_worker_crashes']} crashes, "
          f"{s['fault_watchdog_recoveries']} recoveries")
    del fl
    for d, r in rows.items():
        print(f"depth {d}: tiles/s {r['tiles_per_s']:.1f}, windows/s {r['windows_per_s']:.1f}, "
              f"contact_s {r['contact_s']:.4f}, recount_s {r['recount_s']:.4f}, "
              f"recount_wait_s {r['recount_wait_s']:.4f}, "
              f"recount_hidden_frac {r['recount_hidden_frac']:.3f}", flush=True)
    return total, total_entries


def orbital_spec(n_sats, n_stations, seed):
    """The port's copy of ``benchmarks/fleet_bench.py:_orbital_spec``: the
    contact cell's stations at ``default_sites``, contacts from extracted
    passes (5 degree mask), harvest from eclipse fractions."""
    from repro_torch.data.scenarios import FleetScenarioSpec, GroundStation
    from repro_torch.data.synthetic import SceneSpec
    from repro_torch.orbits import default_sites
    scene = SceneSpec("orbital", 384, (10, 20), (10, 24), cloud_fraction=0.25)
    sites = default_sites(n_stations)
    stations = tuple(GroundStation(f"gs{k}", bandwidth_mbps=30.0 + 5.0 * (k % 5),
                                   contact_s=240.0 + 30.0 * (k % 3), site=sites[k])
                     for k in range(n_stations))
    return FleetScenarioSpec(n_sats=n_sats, n_rounds=FLEET_ROUNDS,
                             frames_per_pass=FLEET_FRAMES, stations=stations,
                             scene_mix=(scene,), seed=seed, geometry="orbital",
                             min_elev_deg=5.0)


def within_ulps(got, want, ulps: int) -> bool:
    """float32 arrays within ``ulps`` units in the last place of ``want``."""
    import numpy as np
    ulp = np.spacing(np.abs(want).astype(np.float32))
    return bool((np.abs(got.astype(np.float64) - want) <= ulps * ulp).all())


def phase_orbits(dev, kernels):
    """benchmarks/orbits_bench.py's sizes on the card: propagation of 4096
    satellites x 1440 steps (60 s) and of the 14368-satellite catalog x
    90 steps, the elevation grid of 8 stations x 1024 satellites x 1440
    steps and the eclipse mask of 1024 x 1440, each timed by CUDA events
    and held against the port's CPU run on the same inputs (the
    functions are elementwise over satellites, so the CPU runs a leading
    slice of them: ORBIT_CPU_SATS), within ORBIT_POS_ULPS / ORBIT_SIN_TOL;
    passes from the card's elevation equal the CPU's on every row
    without a CPU sample within ORBIT_EDGE_DEG of the mask. Then
    fleet_bench's orbital cell, ``_orbital_spec(16, 8, seed=6)``,
    generated on the card (contacts equal the CPU's generation) and run
    through ``run_scenario``: the batched executor equals
    ``contact_reference=True`` and 16 looped Missions. -> launches by
    kernel and by entry of the batched run."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import fleet as F
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.data.scenarios import generate_scenario
    from repro_torch.orbits import (default_sites, eclipse_mask, elevation_deg,
                                    extract_passes, propagate, shell, station_ecef,
                                    sun_direction, walker_delta)

    n_sats, n_steps = ORBIT_PROP
    times = np.arange(n_steps, dtype=np.float64) * 60.0
    planes = max(d for d in range(1, int(np.sqrt(n_sats)) + 1) if n_sats % d == 0)
    cases = [("walker", walker_delta(n_sats, planes, 53.0, 550.0), times),
             ("catalog", shell(ORBIT_CATALOG[0], 53.0, 550.0),
              np.arange(ORBIT_CATALOG[1], dtype=np.float64) * 60.0)]
    rates = {}
    for name, els, t in cases:
        ms = cuda_ms(lambda: propagate(els, t, device=dev), reps=3, hold=False)
        pos = propagate(els, t, device=dev).cpu().numpy()
        k = min(ORBIT_CPU_SATS, els.n_sats)
        head = type(els)(*(a[:k] for a in els.arrays()))
        cpu = propagate(head, t, device="cpu").numpy()
        equal = float((pos[:k] == cpu).mean())
        rates[name] = els.n_sats * t.size / (ms / 1e3)
        print(f"orbits propagate {name} {els.n_sats} x {t.size}: {ms:.3f} ms, "
              f"{rates[name] / 1e6:.1f} M sat-steps/s; first {k} satellites vs CPU: "
              f"{equal:.6f} bit-equal", flush=True)
        check(np.isfinite(pos).all() and pos.shape == (els.n_sats, t.size, 3),
              f"orbits {name}: bad positions")
        check(within_ulps(pos[:k], cpu, ORBIT_POS_ULPS),
              f"orbits {name}: card and CPU positions differ by more than "
              f"{ORBIT_POS_ULPS} ulp")

    n_st, n_vis, _ = ORBIT_VIS
    sub = shell(n_vis, 53.0, 550.0)
    pos = propagate(sub, times, device=dev)
    sites = np.stack([station_ecef(*s) for s in default_sites(n_st)])
    ms = cuda_ms(lambda: elevation_deg(pos, times, sites), reps=3, hold=False)
    elev = elevation_deg(pos, times, sites).cpu().numpy()
    k = ORBIT_CPU_SATS // 4
    cpu = elevation_deg(pos[:k].cpu(), times, sites).numpy()
    sin_err = float(np.abs(np.sin(np.radians(elev[:, :k].astype(np.float64)))
                           - np.sin(np.radians(cpu.astype(np.float64)))).max())
    near = np.argwhere(np.abs(cpu - 10.0) < ORBIT_EDGE_DEG)
    skip = {int(a) * k + int(b) for a, b, _ in near}
    got_p, want_p = extract_passes(elev[:, :k], times, 10.0), extract_passes(cpu, times, 10.0)
    keep = lambda ps: [i for i in range(ps.n_passes) if int(ps.row[i]) not in skip]
    same_passes = (len(keep(got_p)) == len(keep(want_p)) and all(
        np.array_equal(getattr(got_p, f)[keep(got_p)], getattr(want_p, f)[keep(want_p)])
        for f in ("row", "start", "stop")))
    rates["elevation"] = n_st * n_vis * n_steps / (ms / 1e3)
    passes = extract_passes(elev, times, 10.0)
    print(f"orbits elevation {n_st} x {n_vis} x {n_steps}: {ms:.3f} ms, "
          f"{rates['elevation'] / 1e6:.1f} M station-sat-steps/s; {passes.n_passes} passes "
          f"above 10 deg; first {k} satellites vs CPU: max sine error {sin_err:.3e}, "
          f"{float((elev[:, :k] == cpu).mean()):.6f} bit-equal, {len(near)} samples at the "
          f"edge, passes equal {same_passes}", flush=True)
    check(np.isfinite(elev).all() and sin_err <= ORBIT_SIN_TOL and same_passes,
          "orbits elevation: card and CPU differ")
    sun = sun_direction(times, device=dev)
    ms = cuda_ms(lambda: eclipse_mask(pos, sun), reps=3, hold=False)
    mask = eclipse_mask(pos, sun).cpu().numpy()
    cpu_mask = eclipse_mask(pos.cpu(), sun_direction(times, device="cpu")).numpy()
    rates["eclipse"] = n_vis * n_steps / (ms / 1e3)
    print(f"orbits eclipse {n_vis} x {n_steps}: {ms:.3f} ms, "
          f"{rates['eclipse'] / 1e6:.1f} M sat-steps/s, shadowed {mask.mean():.3f}; equal to "
          f"the CPU: {np.array_equal(mask, cpu_mask)}", flush=True)
    check(np.array_equal(mask, cpu_mask) and 0.0 < mask.mean() < 1.0,
          "orbits eclipse: card and CPU masks differ")
    del pos

    spec = orbital_spec(*ORBITAL_CELL)
    sc = generate_scenario(spec, device=dev)
    cpu_sc = generate_scenario(spec, device="cpu")
    contacts = [(c.sat, c.station.name) for r in sc.rounds for c in r.contacts]
    budgets = np.array([c.budget_bytes for r in sc.rounds for c in r.contacts])
    cpu_budgets = np.array([c.budget_bytes for r in cpu_sc.rounds for c in r.contacts])
    check(contacts == [(c.sat, c.station.name) for r in cpu_sc.rounds for c in r.contacts]
          and np.allclose(budgets, cpu_budgets, rtol=ORBIT_BUDGET_RTOL, atol=0)
          and [p.harvest_j for r in sc.rounds for p in r.passes]
          == [p.harvest_j for r in cpu_sc.rounds for p in r.passes],
          "orbital cell: the card's scenario differs from the CPU's")
    check(len(contacts) > 0, "orbital cell: no passes")
    cfgs = (get_config("targetfuse-space"), get_config("targetfuse-ground"))
    space, ground = counters(cfgs, dev)
    pcfg = PipelineConfig(method="targetfuse", score_thresh=NMS_SCORE, seed=SEED)
    F.run_scenario(space, ground, pcfg, sc, device=dev)  # warm-up, dropped
    (got, fl), launches, entries = counted_run(
        kernels, lambda: F.run_scenario(space, ground, pcfg, sc, device=dev))
    s = fl.summary()
    del fl
    ref = F.run_scenario(space, ground, pcfg, sc, contact_reference=True, device=dev)[0]
    looped = F.run_scenario(space, ground, pcfg, sc, fleet=False, device=dev)[0]
    same_ref, same_loop = same_fleet_results(got, ref), same_fleet_results(got, looped)
    print(f"orbital cell {ORBITAL_CELL[0]} satellites, {ORBITAL_CELL[1]} stations, "
          f"{len(sc.rounds)} rounds: {len(contacts)} passes (contacts), budget p50 "
          f"{np.median(budgets):.0f} p90 {np.percentile(budgets, 90):.0f} bytes; tiles/s "
          f"{s['tiles_per_s']:.1f}, windows/s {s['windows_per_s']:.1f} "
          f"({s['windows_served']} windows in {s['contact_s']:.4f} s); equal to the FIFO "
          f"reference {sum(same_ref)} of {len(got)}, to looped Missions {sum(same_loop)} of "
          f"{len(got)}; launches by entry {entries}", flush=True)
    check(all(same_ref) and all(same_loop), "orbital cell: the batched fleet differs from its "
                                            "FIFO reference or the looped Missions")
    check(s["windows_served"] > 0 and entries["tile_moments_f32"] > 0
          and entries["nms_keep_f32"] > 0 and entries["kmeans_assign_lanes_f32"] > 0,
          f"orbital cell: {s['windows_served']} windows, launches by entry {entries}")
    return launches, entries, rates


# ---------------------------------------------------------------------------
# phases 5 and 7: LM serving
# ---------------------------------------------------------------------------

def synced(fn):
    """(fn(), seconds) with the card synchronized on both sides."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_lm_serving(dev, flash):
    """qwen3-8b at full width (36 layers, d_model 4096, vocab 151936;
    seeded random bf16 weights, as no trained weights exist and none may
    be downloaded): prefill of LM_BATCH prompts of LM_PROMPT seeded
    tokens, then LM_STEPS greedy decode steps on a cache of
    LM_PROMPT + LM_STEPS positions. Cut from ``LM_SHAPES`` prefill_32k
    (B 32, S 32768): at B 32 the KV cache alone is 155 GB in bf16, more
    than the card holds.

    Checks: ``flash_attention`` launches once a layer in the prefill, every
    launch on its tensor-core entry, and not in the decode; the logits of
    the prefill's last position and of every decode step agree with
    ``forward_train`` over prompt and generated tokens within
    LM_DECODE_RTOL (relative norm per position).
    -> (flash_attention launches in the serving run, the same by entry).
    """
    import torch
    from repro_torch.configs import LM_SHAPES, get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    cfg = get_config("qwen3-8b")
    b, s, steps = LM_BATCH, LM_PROMPT, LM_STEPS
    (cut_from,) = [sh for sh in LM_SHAPES if sh.name == "prefill_32k"]
    kv_gb = 2 * cfg.n_layers * cut_from.global_batch * cut_from.seq_len * cfg.n_kv_heads \
        * cfg.head_dim * 2 / 1e9
    g = torch.Generator(device=dev).manual_seed(SEED)
    params, init_s = synced(lambda: lm.init(g, cfg, device=dev))
    weight_gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=g, device=dev)
    lm.prefill(params, cfg, prompt[:, :256])  # warm-up: cuBLAS handles, kernel load
    print(f"lm serving: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model}, "
          f"{cfg.n_params / 1e9:.3f} B params, {weight_gb:.2f} GB of bf16 weights drawn "
          f"in {init_s:.2f} s; B {b} prompt {s} decode {steps}, cut from {cut_from.name} "
          f"(B {cut_from.global_batch}, S {cut_from.seq_len}: its bf16 KV cache alone is "
          f"{kv_gb:.1f} GB)", flush=True)

    torch.cuda.reset_peak_memory_stats()
    flash.reset()
    (logits, pre), prefill_s = synced(lambda: lm.prefill(params, cfg, prompt))
    prefill_launches = flash.launches
    routes = dict(flash.symbol_launches)
    check(prefill_launches == cfg.n_layers,
          f"prefill launched flash_attention {prefill_launches} times, not {cfg.n_layers}")
    check(routes[TC_SYMBOL] == cfg.n_layers,
          f"prefill's flash_attention launches by entry {routes}: not all on {TC_SYMBOL}")
    cache = lm.init_cache(cfg, b, s + steps, device=dev)
    for kk in ("k", "v"):
        cache["blocks_dense"][kk][:, :, :s] = pre["blocks_dense"][kk]
    del pre
    outs, tokens, step_s = [logits], [], []
    for i in range(steps):
        tok = outs[-1].argmax(-1, keepdim=True)
        tokens.append(tok)
        (log, cache), dt = synced(lambda: lm.decode_step(params, cfg, tok, cache, s + i))
        outs.append(log)
        step_s.append(dt)
    launches = flash.launches
    check(launches == prefill_launches and flash.symbol_launches == routes,
          "decode launched flash_attention")
    profile_step("lm decode", lambda: lm.decode_step(params, cfg, tokens[-1], cache, s + steps - 1))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    decode_ms = 1e3 * sum(step_s) / steps
    print(f"lm prefill: {prefill_s:.4f} s, {b * s / prefill_s:.1f} tokens/s; flash_attention "
          f"launches {prefill_launches} ({cfg.n_layers} layers), by entry {routes}", flush=True)
    print(f"lm decode: {decode_ms:.4f} ms/step (first {1e3 * step_s[0]:.4f}, median "
          f"{1e3 * sorted(step_s)[steps // 2]:.4f}), {1e3 * b / decode_ms:.1f} tokens/s; "
          f"peak memory {peak_gb:.2f} GB", flush=True)

    # where the prefill's time goes: one layer, synchronized timers
    x = params["embed"][prompt]
    positions = torch.arange(s, device=dev)[None, :]
    layer0 = lm._map(lambda a: a[0], params["blocks_dense"])
    q = torch.randn((b, s, cfg.n_heads, cfg.head_dim), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((b, s, cfg.n_kv_heads, cfg.head_dim), generator=g,
                        device=dev).bfloat16() for _ in range(2))
    block_s = min(synced(lambda: lm._block(layer0, cfg, x, positions, "train"))[1]
                  for _ in range(3))
    attn_s = min(synced(lambda: ops.attention(q, k, v, causal=True))[1] for _ in range(3))
    print(f"lm prefill split, one layer: {1e3 * block_s:.4f} ms, of which attention "
          f"{1e3 * attn_s:.4f} ms ({attn_s / block_s:.3f}) and matmuls, norms and rope "
          f"{1e3 * (block_s - attn_s):.4f} ms", flush=True)
    del x, q, k, v

    # decode against the full forward over prompt + generated tokens
    seq = torch.cat([prompt] + tokens, dim=1)
    full, _ = lm.forward_train(params, cfg, seq)
    want = full[:, s - 1:].float()
    del full
    got = torch.stack(outs, dim=1).float()
    check(got.shape == want.shape == (b, steps + 1, cfg.vocab_size)
          and bool(torch.isfinite(got).all()), "decode logits: bad shape or not finite")
    rel = ((got - want).norm(dim=(0, 2)) / want.norm(dim=(0, 2))).tolist()
    same = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    print(f"lm decode vs forward: relative norm max {max(rel):.4e} (prefill position "
          f"{rel[0]:.4e}, decode median {sorted(rel[1:])[steps // 2]:.4e}), limit "
          f"{LM_DECODE_RTOL}; argmax agrees at {same:.3f} of positions", flush=True)
    check(max(rel) <= LM_DECODE_RTOL, f"decode logits off the forward's by {max(rel):.4e}")
    del params, cache, outs, got, want
    torch.cuda.empty_cache()
    return launches, routes


def profile_step(name, step):
    """One call of ``step`` (after a warm-up call) under torch.profiler:
    the device time by kernel, and the share of the call's wall time the
    card was busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"{name} profile: wall {wall_us / 1e3:.4f} ms, device busy "
          f"{busy_us / 1e3:.4f} ms ({busy_us / wall_us:.3f}), {sum(e.count for e in kernels)} "
          f"kernel launches", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:.4f} ms x{e.count} {e.key[:90]}", flush=True)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def phase_lm_cuda_vs_cpu(dev, flash):
    """Reduced qwen3 in float32: prefill of 6 tokens and 3 decode steps
    on the card (the kernel) and on the CPU (the plain version); logits
    within 1e-4 (float32 sums in another order)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import lm

    cfg = reduced(get_config("qwen3-8b"))
    p_cpu = lm.init(torch.Generator().manual_seed(SEED), cfg, device="cpu")
    tokens = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (2, 9))
    runs = {}
    for device, p in (("cpu", p_cpu), (dev, lm.from_numpy(p_cpu, cfg, dev))):
        t = torch.from_numpy(tokens).to(device)
        before = flash.symbol_launches["flash_attention_f32"]
        log, pre = lm.prefill(p, cfg, t[:, :6])
        launched = flash.symbol_launches["flash_attention_f32"] - before
        cache = lm.init_cache(cfg, 2, 9, device=device)
        for kk in ("k", "v"):
            cache["blocks_dense"][kk][:, :, :6] = pre["blocks_dense"][kk]
        logits = [log]
        for pos in range(6, 9):
            log, cache = lm.decode_step(p, cfg, t[:, pos:pos + 1], cache, pos)
            logits.append(log)
        runs[str(device)] = (torch.stack(logits).cpu(), launched)
    (want, cpu_launched), (got, gpu_launched) = runs["cpu"], runs[str(dev)]
    err = (got - want).abs().max().item()
    print(f"lm cuda vs cpu: reduced qwen3 prefill + 3 decode steps, logits max_abs_err "
          f"{err:.3e}; flash_attention_f32 (CUDA-core) launches on the card {gpu_launched}, "
          f"on the CPU {cpu_launched}", flush=True)
    check(gpu_launched == cfg.n_layers and cpu_launched == 0, "flash_attention dispatch")
    check(torch.allclose(got, want, atol=1e-4, rtol=1e-4), f"CUDA and CPU logits differ by {err}")


# ---------------------------------------------------------------------------
# phase 9: counter training
# ---------------------------------------------------------------------------

# phase 9b: fit_counter's default batch and rate, 200 steps; the first
# TRAIN_WARMUP steps (the allocator's and cuDNN's first calls) are left
# out of the timing
TRAIN_STEPS, TRAIN_BATCH, TRAIN_WARMUP = 200, 16, 20
# phase 9a: card against CPU, one step at full width on 2 tiles. Loss,
# aux and gradient norm: float32 sums of 416 x 416 x 2 positions in
# another order (cuDNN against oneDNN). Gradients: each leaf within
# 2e-2 of its largest value. Against a float64 gradient the CPU's leaves
# are within 1.4e-4, but cuDNN's default float32 backward of the space
# counter's stage 2/0 (64 -> 128 channels, stride 2, at 104 px) is
# 1.1e-2 off in the leaves below it (stages 0-1, the stem), the same
# with cudnn.deterministic; its gradient sums cancel heavily (PERF.md).
STEP_BATCH, STEP_RTOL, STEP_GRAD_TOL = 2, 1e-5, 2e-2
# phase 9c: tests/test_system.py's counters (6 mini scenes, 250 and 600
# steps) and held-out scenes (3 of rng(3))
PREMISE_STEPS, PREMISE_SCENES, PREMISE_HELD_OUT = (250, 600), 6, 3
ARCHS = ("targetfuse-space", "targetfuse-ground")


def train_gflop(cfg) -> float:
    """GFLOP of one training step a tile: the forward, the weight
    gradient of every layer, the input gradient of every layer but the
    stem (the tiles need none)."""
    from repro_torch.core.energy import detector_gflops
    stem = cfg.input_size ** 2 * 9 * 3 * cfg.widths[0] * 2 / 1e9
    return 3 * detector_gflops(cfg) - stem


class StepRecorder:
    """CUDA events around, and the loss of, every ``cascade.train_step``
    while the context is open (the script wraps the function by name)."""

    def __init__(self):
        from repro_torch.core import cascade
        self.module, self.fn, self.events, self.losses = cascade, cascade.train_step, [], []

    def __enter__(self):
        import torch

        def timed(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = self.fn(*args, **kwargs)
            end.record()
            self.events.append((start, end))
            self.losses.append(out[2])
            return out
        self.module.train_step = timed
        return self

    def __exit__(self, *exc):
        self.module.train_step = self.fn

    def ms_per_step(self, skip: int) -> float:
        """Device-clock ms from the start of step ``skip`` to the end of
        the last step, over the steps in between."""
        import torch
        torch.cuda.synchronize()
        return self.events[skip][0].elapsed_time(self.events[-1][1]) / (len(self.events) - skip)

    def loss_array(self):
        import torch
        return torch.stack(self.losses).cpu().numpy()


def phase_train_step(dev):
    """One training step of each full-width counter on the card and on
    the CPU, from the same seeded weights and the same 2 tiles of
    ``build_target_pool``: loss, aux terms, gradients, the global norm and
    every updated parameter compared. Adam's first step moves a weight by
    the rate times g / (|g| + eps), about the sign of its gradient g: with
    dg the largest gradient difference of the weight's leaf, a weight
    with |g| <= 2 dg may step the other way (apart by up to twice the
    rate); every other one agrees within the rate times
    eps dg / (|g| - dg)^2 + 1e-5, plus 2 float32 ulps."""
    import numpy as np
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.core import cascade
    from repro_torch.launch import serve
    from repro_torch.models import detector
    from repro_torch.optim.adamw import adamw
    from repro_torch.optim.schedule import cosine_with_warmup

    scene = serve.training_scenes()[:1]
    for arch in ARCHS:
        cfg = get_config(arch)
        xs, ys = cascade.build_target_pool(cfg, scene, 128, device="cpu")
        idx = np.random.default_rng(SEED).integers(0, len(xs), STEP_BATCH)
        xb, yb = xs[idx], torch.from_numpy(ys[idx])
        p_cpu = detector.init(torch.Generator().manual_seed(SEED), cfg, device="cpu")
        runs = {}
        for key, d, p in (("cpu", "cpu", p_cpu), ("card", dev, detector.to_device(p_cpu, dev))):
            init, update = adamw(cosine_with_warmup(3e-3, TRAIN_STEPS // 10 + 1, TRAIN_STEPS))
            pg = T.map_leaves(lambda x: x.detach().requires_grad_(True), p)
            loss, _ = detector.loss_fn(pg, cfg, xb.to(d), yb.to(d))
            grads = torch.autograd.grad(loss, T.leaves(pg))
            new_p, _, loss, aux, metrics = cascade.train_step(p, cfg, update, init(p),
                                                              xb.to(d), yb.to(d))
            runs[key] = dict(loss=loss.item(), aux={k: v.item() for k, v in aux.items()},
                           grad_norm=metrics["grad_norm"].item(), lr=metrics["lr"].item(),
                           grads=[g.cpu() for g in grads], params=[x.cpu() for x in T.leaves(new_p)])
        cpu, gpu = runs["cpu"], runs["card"]
        lr = cpu["lr"]
        rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
        grad_err, sure_err, unsure, unsure_err = {}, 0.0, 0, 0.0
        for path, gc, gg, pc, pgpu, p0 in zip(T.flatten_with_paths(p_cpu)[0], cpu["grads"],
                                              gpu["grads"], cpu["params"], gpu["params"],
                                              T.leaves(p_cpu)):
            dg = (gc - gg).abs().max().item()
            grad_err[path] = dg / gc.abs().max().item()
            sure = gc.abs() > 2 * dg
            diff = (pc - pgpu).abs()
            limit = (lr * (1e-8 * dg / (gc.abs() - dg).clamp(min=1e-30) ** 2 + 1e-5)
                     + 2 * 2.0 ** -23 * torch.maximum(pc.abs(), p0.abs()))
            if sure.any():
                sure_err = max(sure_err, (diff / limit)[sure].max().item())
            if (~sure).any():
                unsure += int((~sure).sum())
                unsure_err = max(unsure_err, diff[~sure].max().item())
        n = sum(x.numel() for x in cpu["params"])
        print(f"train step {arch}: loss cpu {cpu['loss']:.7e} card {gpu['loss']:.7e} (rel "
              f"{rel(gpu['loss'], cpu['loss']):.2e}); aux rel "
              + ", ".join(f"{k} {rel(gpu['aux'][k], cpu['aux'][k]):.2e}" for k in cpu["aux"])
              + f"; grad norm rel {rel(gpu['grad_norm'], cpu['grad_norm']):.2e}; gradients "
              f"within {max(grad_err.values()):.2e} of each leaf's max ("
              + ", ".join(f"{k} {v:.1e}" for k, v in grad_err.items())
              + f"); params: {n - unsure} of {n} within "
              f"{sure_err:.3f} of their limit, {unsure} with a gradient near 0 apart by "
              f"{unsure_err:.3e} (rate {lr:.3e})", flush=True)
        check(rel(gpu["loss"], cpu["loss"]) <= STEP_RTOL, f"{arch}: step loss differs")
        check(all(rel(gpu["aux"][k], cpu["aux"][k]) <= STEP_RTOL for k in cpu["aux"]),
              f"{arch}: aux terms differ")
        check(rel(gpu["grad_norm"], cpu["grad_norm"]) <= STEP_RTOL, f"{arch}: grad norm differs")
        check(max(grad_err.values()) <= STEP_GRAD_TOL, f"{arch}: gradients differ: {grad_err}")
        check(sure_err <= 1.0 and unsure_err <= 2.1 * lr, f"{arch}: updated parameters differ")


def profile_train(cfg, scenes, dev):
    """One ``train_step`` at batch TRAIN_BATCH under torch.profiler."""
    import numpy as np
    import torch
    from repro_torch.core import cascade
    from repro_torch.models import detector
    from repro_torch.optim.adamw import adamw
    from repro_torch.optim.schedule import cosine_with_warmup

    xs, ys = cascade.build_target_pool(cfg, scenes, 128, device=dev)
    idx = torch.from_numpy(np.random.default_rng(SEED).integers(0, len(xs), TRAIN_BATCH)).to(dev)
    params = detector.init(torch.Generator().manual_seed(SEED), cfg, device=dev)
    init, update = adamw(cosine_with_warmup(3e-3, TRAIN_STEPS // 10 + 1, TRAIN_STEPS))
    state, xb, yb = init(params), xs[idx], torch.from_numpy(ys).to(dev)[idx]
    profile_step(f"train {cfg.name}", lambda: cascade.train_step(params, cfg, update, state, xb, yb))


def phase_train_throughput(dev):
    """``fit_counter`` of each full-width counter at batch 16 on
    ``get_counters``' 8 training scenes, 200 steps: ms a step on the
    device's clock after TRAIN_WARMUP steps, tiles/s, the share of the
    float32 bound, peak memory; the loss finite, the mean of the last 20
    steps below the first 20's; one step of each, and of the reduced
    ground counter, under torch.profiler. Then two seeded 20-step runs of
    the space counter: are their losses bit-equal (cuDNN's algorithm
    choice left at its default)?"""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import cascade
    from repro_torch.launch import serve

    scenes = serve.training_scenes()
    for arch in ARCHS:
        cfg = get_config(arch)
        torch.cuda.reset_peak_memory_stats()
        with StepRecorder() as rec:
            t0 = time.perf_counter()
            _, final = cascade.fit_counter(cfg, scenes, 128, TRAIN_STEPS,
                                           torch.Generator().manual_seed(SEED),
                                           batch=TRAIN_BATCH, device=dev)
            wall = time.perf_counter() - t0
        ms = rec.ms_per_step(TRAIN_WARMUP)
        losses = rec.loss_array()
        gflop = train_gflop(cfg) * TRAIN_BATCH
        bound = gflop * 1e9 / FP32_FLOPS * 1e3
        row = dict(ms_per_step=ms, tiles_per_s=TRAIN_BATCH / ms * 1e3, gflop_per_step=gflop,
                   bound_ms=bound, bound_share=bound / ms, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   fit_counter_s=wall, first20=float(losses[:20].mean()),
                   last20=float(losses[-20:].mean()), final_loss=final,
                   timed_steps=TRAIN_STEPS - TRAIN_WARMUP, batch=TRAIN_BATCH)
        print(f"train {arch}: " + json.dumps(row), flush=True)
        check(np.isfinite(losses).all() and len(losses) == TRAIN_STEPS, f"{arch}: loss not finite")
        check(row["last20"] < row["first20"], f"{arch}: the loss did not fall")
        profile_train(cfg, scenes, dev)
    profile_train(reduced(get_config("targetfuse-ground")), scenes, dev)
    cfg = get_config("targetfuse-space")
    runs = []
    for _ in range(2):
        with StepRecorder() as rec:
            cascade.fit_counter(cfg, scenes, 128, 20, torch.Generator().manual_seed(SEED),
                                batch=TRAIN_BATCH, device=dev)
        runs.append(rec.loss_array())
    print(f"train determinism: two seeded 20-step runs of targetfuse-space, losses bit-equal "
          f"{runs[0].tobytes() == runs[1].tobytes()}; max abs diff "
          f"{float(np.abs(runs[0] - runs[1]).max()):.3e}", flush=True)


def phase_trained_mission(dev, kernels):
    """Counters trained on the card, then served. tests/test_system.py's
    counters (reduced configs, 6 mini scenes, 250 and 600 steps): on 3
    held-out scenes the ground counter's CMAE is below the space
    counter's. Then ``get_counters`` at its default steps into a
    temporary folder; the restored counters bit-equal to the trained
    ones; serve's CMAE table for every policy from that folder on the
    card, as a main path -> (launches by kernel, by entry, the restored
    (space, ground) counters)."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch
    from repro_torch import tree as T
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import cascade, tiling
    from repro_torch.data.synthetic import SceneSpec, make_scene, tile_counts
    from repro_torch.launch import serve
    from repro_torch.models import detector

    spec = SceneSpec("mini", 512, (20, 30), (10, 24), cloud_fraction=0.2)
    rng = np.random.default_rng(0)
    scenes = [make_scene(rng, spec) for _ in range(PREMISE_SCENES)]
    cfgs = [reduced(get_config(a)) for a in ARCHS]
    t0 = time.perf_counter()
    trained = [cascade.fit_counter(cfg, scenes, 128, steps, torch.Generator().manual_seed(k),
                                   device=dev)
               for k, (cfg, steps) in enumerate(zip(cfgs, PREMISE_STEPS))]
    train_s = time.perf_counter() - t0
    rng = np.random.default_rng(3)
    errs = [[], []]
    for _ in range(PREMISE_HELD_OUT):
        img, b, c = make_scene(rng, spec)
        true = tile_counts(b, spec.scene_px, 128)
        t = tiling.tile_image(torch.from_numpy(img).to(dev), 128)
        for e, (params, _), cfg in zip(errs, trained, cfgs):
            cnt, _ = cascade.count_tiles_batched(params, cfg, tiling.resize_tiles(t, cfg.input_size),
                                                 score_thresh=0.25)
            e.append(np.abs(cnt - true).sum() / max(true.sum(), 1))
    cmae_s, cmae_g = float(np.mean(errs[0])), float(np.mean(errs[1]))
    print(f"trained counters: {PREMISE_STEPS} steps in {train_s:.2f} s, final loss space "
          f"{trained[0][1]:.4f} ground {trained[1][1]:.4f}; held-out CMAE space {cmae_s:.4f} "
          f"ground {cmae_g:.4f}", flush=True)
    check(cmae_g < cmae_s, "the ground counter is not more accurate than the space counter")

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        pair = serve.get_counters(cache_dir=tmp, device=dev)
        torch.cuda.synchronize()
        print(f"get_counters: trained and cached {ckpt.all_steps(tmp + '/space')} / "
              f"{ckpt.all_steps(tmp + '/ground')} steps in {time.perf_counter() - t0:.2f} s",
              flush=True)
        for name, (params, cfg), k in zip(("space", "ground"), pair, (0, 1)):
            fresh = detector.init(torch.Generator().manual_seed(k + 7), cfg, device=dev)
            _, got = ckpt.restore(f"{tmp}/{name}", fresh)
            check(all(torch.equal(a, b) for a, b in zip(T.leaves(got), T.leaves(params), strict=True)),
                  f"{name}: restored counter differs from the trained one")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            _, launches, entries = counted_run(
                kernels, lambda: serve.main(["--counters", tmp, "--device", str(dev)]))
    table = out.getvalue().strip().splitlines()
    for line in table:
        print(f"serve: {line}", flush=True)
    rows = {r.split()[0]: r.split()[1:] for r in table[2:]}
    check(sorted(rows) == sorted(POLICIES) and all(np.isfinite(float(v[0])) for v in rows.values()),
          f"serve's table: {table}")
    print(f"serve launches: {launches}, by entry {entries}", flush=True)
    idle = ("iou_matrix_f32",) + LANE_ENTRIES
    check(all(n > 0 for e, n in entries.items() if e in
              ("tile_moments_f32", "kmeanspp_seed_f32", "kmeans_assign_f32", "nms_keep_f32"))
          and not any(entries[e] for e in idle), f"serve missed a kernel entry: {entries}")
    return launches, entries, pair


# ---------------------------------------------------------------------------
# phase 10: the reference path, Algorithm 1 with ap50, the examples
# ---------------------------------------------------------------------------

# phase 10c: benchmarks/fig4_tilesize.py's tile sizes, its search interval
# and eps, on 2 of its mini scenes (rng 11)
FIG4_SIZES, FIG4_EPS = (32, 64, 128, 192, 256, 384), 48


def phase_reference_path(dev, kernels):
    """10a: phase 3's full-width counters and 576 xview tiles through
    ``Mission(use_engine=False)`` (tiles on the host, frame-by-frame
    resize, the unpadded dedup, host slices counted a chunk at a time),
    every policy, against the engine path on the card: per-tile
    predictions and summaries equal (checked). Launches of the reference
    runs: one nms_keep_f32 a counter chunk; on the dedup policies one
    tile_moments_f32 and one kmeanspp_seed_f32 a dedup with 11
    kmeans_assign_f32 each; no iou_matrix_f32 and no lane entry (all
    checked). A second reference run of targetfuse gives its stages'
    synchronized wall times -> launches by kernel and by entry of the
    reference runs."""
    import inspect as _inspect

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import cascade, dedup as dd
    from repro_torch.core import mission as M
    from repro_torch.core.mission import Mission
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.data.synthetic import DATASETS

    space, ground = counters((get_config("targetfuse-space"), get_config("targetfuse-ground")),
                             dev)
    frames = scene_frames(DATASETS["xview"], XVIEW_SCENES, XVIEW_REVISITS, SEED)
    n_tiles = len(frames) * (DATASETS["xview"].scene_px // 128) ** 2
    iters = _inspect.signature(dd.dedup_from_moments).parameters["iters"].default
    total, total_entries = {}, {}

    def timed_run(pcfg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = Mission(space, ground, pcfg, device=dev).run(frames)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    timed_run(PipelineConfig(method="targetfuse", score_thresh=NMS_SCORE, seed=SEED,
                             use_engine=False))  # warm-up, dropped
    for method in POLICIES:
        kw = dict(method=method, score_thresh=NMS_SCORE, seed=SEED)
        want, eng_s = timed_run(PipelineConfig(**kw))
        with EventTimes(cascade, "count_tiles") as chunk_events:
            (got, ref_s), launches, entries = counted_run(
                kernels, lambda: timed_run(PipelineConfig(use_engine=False, **kw)))
        chunks = len(chunk_events.take())
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        for sym, n in entries.items():
            total_entries[sym] = total_entries.get(sym, 0) + n
        equal = (np.array_equal(got.per_tile_pred, want.per_tile_pred)
                 and got.summary() == want.summary())
        row = dict(tiles=got.tiles_total, engine_tiles_per_s=n_tiles / eng_s,
                   reference_tiles_per_s=n_tiles / ref_s, engine_s=eng_s, reference_s=ref_s,
                   counter_chunks=chunks, launches_by_entry=entries,
                   total_pred=got.total_pred, total_true=got.total_true,
                   downlinked=got.tiles_downlinked, processed=got.tiles_processed_space)
        print(f"reference path {method}: equal to the engine path {equal}; " + json.dumps(row),
              flush=True)
        check(equal, f"reference path {method}: per-tile predictions or summary differ from "
                     f"the engine path's")
        check(got.tiles_total == n_tiles and np.isfinite(got.per_tile_pred).all(),
              f"reference path {method}: bad results")
        dedups = entries["kmeanspp_seed_f32"]
        check(entries["nms_keep_f32"] == chunks
              and entries["iou_matrix_f32"] == 0
              and not any(entries[e] for e in LANE_ENTRIES)
              and entries["kmeans_assign_f32"] == (iters + 1) * dedups
              and entries["tile_moments_f32"] == dedups
              and (dedups > 0) == (method in ("kodan", "targetfuse")),
              f"reference path {method}: {chunks} counter chunks, launches by entry {entries}")
    stages = {}
    m = Mission(space, ground, PipelineConfig(method="targetfuse", score_thresh=NMS_SCORE,
                                              seed=SEED, use_engine=False), device=dev,
                ingest_stages=[Timed(st, stages) for st in M.default_ingest_stages()],
                contact_stages=[Timed(st, stages) for st in M.default_contact_stages()])
    m.run(frames)
    print("reference path targetfuse stages (synchronized, second run): "
          + ", ".join(f"{k} {v:.4f} s" for k, v in stages.items()), flush=True)
    return total, total_entries


def phase_mixed_fleet(dev, kernels):
    """10b: phase 6's cell with every fourth satellite on the reference
    path: per-satellite results equal looped Missions (checked); the
    batched satellites still make one kmeanspp_seed_lanes_f32 launch a
    shape bucket a round, the reference-path ones one kmeanspp_seed_f32
    launch a dedup and none of their k-means runs on the lanes (checked)
    -> launches by kernel and by entry of the fleet run."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import dedup as dd, fleet as F
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.data.scenarios import generate_scenario

    space, ground = counters((get_config("targetfuse-space"), get_config("targetfuse-ground")),
                             dev)
    sc = generate_scenario(contact_spec(FLEET_SATS, FLEET_STATIONS, FLEET_SEED))
    pcfgs = [PipelineConfig(method="targetfuse", score_thresh=NMS_SCORE, seed=SEED,
                            use_engine=i % 4 != 0) for i in range(FLEET_SATS)]
    buckets, multi, one = [], dd.dedup_multi, dd.dedup_from_moments
    lane_sats, seq_dedups = [], []

    def counted_multi(parts, *a, **kw):
        buckets.append(len({dd._buckets_for(int(m.shape[0]) if n is None else n, k)
                            for m, k, _, n in parts}))
        lane_sats.append(len(parts))
        return multi(parts, *a, **kw)

    def counted_one(*a, **kw):
        seq_dedups.append(1)
        return one(*a, **kw)
    dd.dedup_multi, dd.dedup_from_moments = counted_multi, counted_one
    t0 = time.perf_counter()
    try:
        (got, fl), launches, entries = counted_run(
            kernels, lambda: F.run_scenario(space, ground, pcfgs, sc, device=dev))
    finally:
        dd.dedup_multi, dd.dedup_from_moments = multi, one
    wall = time.perf_counter() - t0
    batchable = list(fl._batchable)
    summ = fl.summary()
    del fl
    want = F.run_scenario(space, ground, pcfgs, sc, fleet=False, device=dev)[0]
    torch.cuda.synchronize()
    same = same_fleet_results(got, want)
    row = dict(sats=FLEET_SATS, reference_sats=batchable.count(False), wall_s=wall,
               tiles_per_s=summ["tiles_per_s"], windows_per_s=summ["windows_per_s"],
               buckets_per_round=buckets, lane_sats_per_round=lane_sats,
               reference_dedups=len(seq_dedups), launches_by_entry=entries)
    print(f"mixed fleet: {sum(same)} of {len(same)} satellites equal their looped Missions; "
          + json.dumps(row), flush=True)
    check(all(same), f"mixed fleet: satellites {[i for i, e in enumerate(same) if not e]} "
                     f"differ from their looped Missions")
    check(batchable == [i % 4 != 0 for i in range(FLEET_SATS)], f"batchable {batchable}")
    check(len(buckets) == len(sc.rounds)
          and entries["kmeanspp_seed_lanes_f32"] == sum(buckets)
          and entries["kmeanspp_seed_f32"] == len(seq_dedups) > 0
          and entries["tile_moments_f32"] > entries["kmeanspp_seed_f32"]
          and entries["iou_matrix_f32"] == 0 and entries["nms_keep_f32"] > 0,
          f"mixed fleet: launches by entry {entries}, buckets {buckets}, "
          f"reference dedups {len(seq_dedups)}")
    return launches, entries


def fig4_map(space, scenes, tile_size, dev, cpu_maps, ap_s):
    """``benchmarks/fig4_tilesize.py``'s mAP at one tile size, on the card:
    tile, resize, the counter's forward and decode, one NMS launch for
    the scene's tiles, kept boxes scaled back to tile pixels against
    each tile's ground truth (``clip_boxes_to_tile``); ``ap50`` on the
    card, and on the CPU from the same boxes into ``cpu_maps``; the two
    ``ap50`` calls' wall seconds into ``ap_s``."""
    import torch
    from repro_torch.core import metrics, tiling
    from repro_torch.data.synthetic import clip_boxes_to_tile
    from repro_torch.models import detector

    params, cfg = space
    pred_b, pred_s, gts = [], [], []
    for img, boxes, classes in scenes:
        t = tiling.tile_image(torch.from_numpy(img).to(dev), tile_size)
        tr = tiling.resize_tiles(t, cfg.input_size)
        bxs, scs = detector.decode(detector.forward(params, cfg, tr), cfg)
        keep = detector.nms_keep(bxs, scs, 0.25, 0.25).cpu().numpy()
        bxs, scs = bxs.cpu().numpy(), scs.cpu().numpy()
        g = img.shape[0] // tile_size
        scale = tile_size / cfg.input_size
        for ty in range(g):
            for tx in range(g):
                i = ty * g + tx
                pred_b.append(bxs[i][keep[i]] * scale)
                pred_s.append(scs[i][keep[i]])
                gts.append(clip_boxes_to_tile(boxes, classes, tx, ty, tile_size)[0])
    t0 = time.perf_counter()
    cpu_maps[tile_size] = metrics.ap50(pred_b, pred_s, gts, device="cpu")
    t1 = time.perf_counter()
    card = metrics.ap50(pred_b, pred_s, gts, device=dev)
    ap_s.append((time.perf_counter() - t1, t1 - t0))
    return card


def phase_tile_search(dev, kernels, space):
    """10c: Algorithm 1 (``tiling.optimal_tile_size``) over
    ``fig4_map`` on 2 mini scenes, tile sizes 32-384 and eps 48 as
    fig4_tilesize.py, with phase 9c's trained reduced space counter;
    then the fig4 sizes' curve. Checks: ``ap50`` on the card equals
    ``ap50`` on the CPU from the same boxes at every size;
    iou_matrix_f32 launches (> 0) in the search -> launches by kernel and
    by entry of the search. Prints the search's ``iou_matrix_f32`` calls'
    shapes, and the kernel's device time at the median call's own inputs
    beside its plain version's and its bound."""
    import numpy as np
    from repro_torch.core import tiling
    from repro_torch.data.synthetic import SceneSpec, make_scene
    from repro_torch.kernels import iou, ops, ref

    rng = np.random.default_rng(11)
    mini = SceneSpec("mini", 512, (20, 30), (10, 24), cloud_fraction=0.2)
    scenes = [make_scene(rng, mini) for _ in range(2)]
    cpu_maps, card_maps, ap_s, calls = {}, {}, [], []

    def map_fn(s):
        card_maps[int(s)] = fig4_map(space, scenes, int(s), dev, cpu_maps, ap_s)
        return card_maps[int(s)]
    iou_fn = ops.iou_matrix

    def spy(a, b):
        if a.device.type == dev.type:
            calls.append((a, b))
        return iou_fn(a, b)
    ops.iou_matrix = spy
    t0 = time.perf_counter()
    try:
        (s_best, cache), launches, entries = counted_run(
            kernels, lambda: tiling.optimal_tile_size(map_fn, 32, 384, eps=FIG4_EPS))
    finally:
        ops.iou_matrix = iou_fn
    search_s = time.perf_counter() - t0
    shapes = sorted((a.shape[0], b.shape[0]) for a, b in calls)
    a, b = next((a, b) for a, b in calls
                if (a.shape[0], b.shape[0]) == shapes[len(shapes) // 2])
    n, m = shapes[len(shapes) // 2]
    ms = cuda_ms(lambda: iou.iou_matrix(a, b), reps=20)
    host_ms = cuda_ms(lambda: iou.iou_matrix(a, b), reps=20, hold=False)
    plain_ms = cuda_ms(lambda: ref.iou_matrix(a, b), reps=5, warmup=1)
    b_ms, b_by = bound_ms((n + m) * 16 + n * m * 4, 12 * n * m)
    print(f"tile search iou_matrix_f32: {len(calls)} calls, (N, M) from {shapes[0]} to "
          f"{shapes[-1]}, median {(n, m)}: ms {ms:.4f} (with host launch {host_ms:.4f}) "
          f"plain_ms {plain_ms:.4f} bound_ms {b_ms:.3e} ({b_by}); ap50 wall s card / CPU "
          f"{sum(c for c, _ in ap_s):.4f} / {sum(h for _, h in ap_s):.4f} over "
          f"{len(ap_s)} sizes", flush=True)
    check(bit_equal(iou.iou_matrix(a, b), ref.iou_matrix(a, b)),
          "tile search: iou_matrix_f32 differs from its plain version")
    curve = {s: card_maps[s] if s in card_maps else map_fn(s) for s in FIG4_SIZES}
    print(f"tile search: s_best {s_best}, evaluated {sorted(cache)} in {search_s:.2f} s; "
          f"mAP50 at the evaluated sizes {json.dumps({k: cache[k] for k in sorted(cache)})}; "
          f"fig4 curve {json.dumps(curve)}; measured optimum "
          f"{max(curve, key=curve.get)}; launches by entry {entries}", flush=True)
    check(cpu_maps == card_maps, f"tile search: ap50 card {card_maps} != CPU {cpu_maps}")
    check(entries["iou_matrix_f32"] > 0 and entries["nms_keep_f32"] == len(cache) * 2,
          f"tile search: launches by entry {entries}")
    check(32 <= s_best <= 384 and all(0.0 <= v <= 1.0 for v in cache.values()),
          f"tile search: s_best {s_best}, cache {cache}")
    return launches, entries


def phase_examples(dev, kernels, pair):
    """10d: the three example drivers' ``main`` in this process on the
    card, each at its smallest flags, their ``get_counters`` giving phase
    9c's counters; constellation_sim_torch's ``--check`` (the fleet equal
    to looped Missions) must hold -> launches by kernel and by entry."""
    import contextlib
    import io

    sys.path.insert(0, str(ROOT / "examples"))
    import constellation_sim_torch
    import quickstart_torch
    import serve_collaborative_torch
    runs = ((quickstart_torch, []), (serve_collaborative_torch, ["--passes", "1"]),
            (constellation_sim_torch, ["--sats", "2", "--rounds", "1", "--check"]))
    total, total_entries = {}, {}
    for mod, argv in runs:
        saved, mod.get_counters = mod.get_counters, lambda **kw: pair
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                _, launches, entries = counted_run(
                    kernels, lambda: mod.main(argv + ["--device", str(dev.type)]))
        finally:
            mod.get_counters = saved
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        for sym, n in entries.items():
            total_entries[sym] = total_entries.get(sym, 0) + n
        lines = out.getvalue().strip().splitlines()
        for line in lines:
            print(f"{mod.__name__}: {line}", flush=True)
        check(lines and "nan" not in out.getvalue(), f"{mod.__name__}: {lines}")
        if mod is constellation_sim_torch:
            check(any(ln.startswith("parity check: fleet == looped Missions (exact)")
                      for ln in lines), "constellation_sim_torch: --check did not hold")
    print(f"examples launches by entry: {total_entries}", flush=True)
    return total, total_entries


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 11: the frozen monolith, the static analysis, the steady-state guard
# ---------------------------------------------------------------------------

# 11a: the clustering policies also run the monolith's reference path
LEGACY_REFERENCE = ("kodan", "targetfuse")
# 11c: tests/test_analysis.py's JitGuard cell (2 satellites, the 256 px
# "jg" scene, targetfuse at score 0.25, rng 17, one frame a pass) and
# phase 6's cell, with their warm-up and guarded rounds
GUARD_JG_SPEC = ("jg", 256, (6, 12), (10, 20), 0.2)
GUARD_WARMUP, GUARD_ROUNDS = 2, 2


def phase_legacy(dev, kernels):
    """11a: phase 3's cell (full-width counters, 576 xview tiles) through
    ``core/_legacy.py``'s ``run_pipeline_legacy``, on the engine path for
    every policy and on the reference path for kodan and targetfuse, each
    bit for bit the port's Mission with the same config: per-tile
    predictions, ground truth and the summary (checked). Prints each
    run's wall time beside the Mission's and its launches by entry ->
    launches by kernel and by entry of the monolith's runs."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core._legacy import run_pipeline_legacy
    from repro_torch.core.mission import Mission
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.data.synthetic import DATASETS

    space, ground = counters((get_config("targetfuse-space"), get_config("targetfuse-ground")),
                             dev)
    frames = scene_frames(DATASETS["xview"], XVIEW_SCENES, XVIEW_REVISITS, SEED)
    n_tiles = len(frames) * (DATASETS["xview"].scene_px // 128) ** 2
    total, total_entries = {}, {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    runs = ([(m, True) for m in POLICIES] + [(m, False) for m in LEGACY_REFERENCE])
    for method, use_engine in runs:
        pcfg = PipelineConfig(method=method, score_thresh=NMS_SCORE, seed=SEED,
                              use_engine=use_engine)
        want, mission_s = timed(lambda: Mission(space, ground, pcfg, device=dev).run(frames))
        (got, legacy_s), launches, entries = counted_run(
            kernels, lambda: timed(lambda: run_pipeline_legacy(frames, space, ground, pcfg,
                                                               device=dev)))
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        for sym, n in entries.items():
            total_entries[sym] = total_entries.get(sym, 0) + n
        equal = (np.array_equal(got.per_tile_pred, want.per_tile_pred)
                 and np.array_equal(got.per_tile_true, want.per_tile_true)
                 and got.summary() == want.summary())
        path = "engine" if use_engine else "reference"
        row = dict(tiles=got.tiles_total, legacy_s=legacy_s, mission_s=mission_s,
                   launches_by_entry={s: n for s, n in entries.items() if n},
                   total_pred=got.total_pred, downlinked=got.tiles_downlinked,
                   processed=got.tiles_processed_space)
        print(f"legacy {method} {path}: bit-identical to the Mission {equal}; "
              + json.dumps(row), flush=True)
        check(equal, f"legacy {method} {path}: differs from the Mission")
        check(got.tiles_total == n_tiles and np.isfinite(got.per_tile_pred).all(),
              f"legacy {method} {path}: bad results")
        check(entries["nms_keep_f32"] > 0 and entries["iou_matrix_f32"] == 0
              and (entries["kmeanspp_seed_f32"] > 0) == (method in LEGACY_REFERENCE),
              f"legacy {method} {path}: launches by entry {entries}")
    print(f"legacy launches by entry: {total_entries}", flush=True)
    return total, total_entries


def phase_analysis():
    """11b: ``python -m repro_torch.analysis`` over src/repro_torch with
    the checked-in baseline (analysis_baseline_torch.json): exit 0."""
    import os
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    last = (out.stdout.strip().splitlines() or [""])[-1]
    print(f"analysis: exit {out.returncode} in {time.perf_counter() - t0:.2f} s: {last}",
          flush=True)
    check(out.returncode == 0, f"analysis: {out.stdout[-2000:]}{out.stderr[-2000:]}")


def guard_rounds(label, round_fn, guarded):
    """``GUARD_WARMUP`` rounds, then ``guarded`` rounds each under a
    ``LaunchGuard``: prints each guarded round's builds, new allocator
    segments, launches by entry and syncs, in all and by call site -> the
    guards. The allocator's
    cache is emptied first, so the warm-up rounds, not the phases before,
    decide what the guarded rounds may reuse."""
    import torch
    from repro_torch.analysis import LaunchGuard
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for _ in range(GUARD_WARMUP):
        round_fn()
    torch.cuda.synchronize()
    guards = []
    for r in range(guarded):
        live0 = torch.cuda.memory_stats()["allocated_bytes.all.current"]
        t0 = time.perf_counter()
        with LaunchGuard(f"{label} round {GUARD_WARMUP + r + 1}") as g:
            round_fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = torch.cuda.memory_stats()
        print(f"guard {g.label}: builds {g.builds} new segments {g.new_segments} syncs "
              f"{g.syncs} (counted {g.counts_syncs}); {wall:.4f} s; live memory "
              f"{(stats['allocated_bytes.all.current'] - live0) / 1e6:+.1f} MB, reserved "
              f"{stats['reserved_bytes.all.current'] / 1e9:.3f} GB; launches by entry "
              f"{json.dumps(g.launches)}; syncs by site {json.dumps(g.sync_sites)}", flush=True)
        guards.append(g)
    return guards


def phase_guard(dev):
    """11c: ``LaunchGuard`` at two cells. (1) tests/test_analysis.py's
    JitGuard cell on phase 3's counters: a 2-satellite Fleet ingesting
    one frame a satellite a round; 2 warm-up rounds, 2 guarded rounds,
    whose launches by entry must be equal. (2) phase 6's cell (32
    satellites, 8 stations): a Fleet driven round by round (ingest, then
    the round's ContactPlan at depth 0), round 3 guarded after 2 warm-up
    rounds. In both, ``assert_steady_state``: no kernel library loaded and
    no new allocator segment (checked); syncs are reported."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import fleet as F
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.data.scenarios import generate_scenario
    from repro_torch.data.synthetic import SceneSpec, make_scene, revisit_frames

    space, ground = counters((get_config("targetfuse-space"), get_config("targetfuse-ground")),
                             dev)
    name, px, n_obj, size, cloud = GUARD_JG_SPEC
    rng = np.random.default_rng(17)
    img, b, c = make_scene(rng, SceneSpec(name, px, n_obj, size, cloud_fraction=cloud))
    fleet = F.Fleet(space, ground, PipelineConfig(method="targetfuse", score_thresh=0.25),
                    n_sats=2, device=dev)

    def jg_round():
        fleet.ingest([revisit_frames(rng, img, b, c, 1) for _ in range(2)])
    jg = guard_rounds("jg cell", jg_round, GUARD_ROUNDS)
    jg_results = fleet.finalize()
    del fleet

    sc = generate_scenario(contact_spec(FLEET_SATS, FLEET_STATIONS, FLEET_SEED))
    n = FLEET_SATS
    check(len(sc.rounds) == GUARD_WARMUP + 1, f"phase 6's cell has {len(sc.rounds)} rounds")
    fleet = F.Fleet(space, ground, PipelineConfig(method="targetfuse", score_thresh=NMS_SCORE,
                                                  seed=SEED), n_sats=n, device=dev)
    rounds = iter(sc.rounds)

    def fleet_round():
        rnd = next(rounds)
        fleet.ingest(rnd.frames_per_sat(n), rnd.harvest_per_sat(n))
        if rnd.contacts:
            fleet.contact_round(plan=rnd.contact_plan(n))
    cell = guard_rounds("phase 6 cell", fleet_round, 1)
    cell_results = fleet.finalize()
    del fleet
    check(all(np.isfinite(r.per_tile_pred).all() for r in jg_results + cell_results),
          "guard cells: bad results")
    check(jg[0].launches == jg[1].launches and jg[0].launches,
          f"jg cell: launches by entry differ between the guarded rounds "
          f"{jg[0].launches} / {jg[1].launches}")
    for g in jg + cell:
        g.assert_steady_state()


def main():
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    try:
        from repro_torch.kernels import _build, ops
    except ImportError as e:
        fail(f"the port's sources are not beside this script: {e}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    logs = _build.build_all(ops.KERNELS)
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(ops.KERNELS)} kernels "
          f"({len(logs)} built in this run)", flush=True)
    ptxas_report(logs)

    kernel = {k.name: k for k in ops.KERNELS}
    t0 = time.perf_counter()
    rows = phase_kernels(dev)
    launches = {"int8_matmul": int8_path(dev, kernel["int8_matmul"])}
    entry_launches = dict(kernel["int8_matmul"].symbol_launches)  # by entry, main paths only
    print(f"phase kernels: {time.perf_counter() - t0:.1f} s", flush=True)
    mission_kernels = [kernel[n] for n in ("tile_moments", "kmeans_assign", "iou")]
    t0 = time.perf_counter()
    launches.update(phase_full_width(dev, mission_kernels))
    for k in mission_kernels:
        entry_launches.update(k.symbol_launches)
    print(f"phase full-width mission: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_cuda_vs_cpu(dev)
    print(f"phase cuda vs cpu: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches["flash_attention"], flash_entries = phase_lm_serving(dev, kernel["flash_attention"])
    entry_launches.update(flash_entries)
    print(f"phase lm serving: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    fleet_launches, fleet_entries, depth0 = phase_fleet(dev, mission_kernels)
    for name, n in fleet_launches.items():   # the main paths: Mission, fleet, phase 8
        launches[name] += n
    for sym, n in fleet_entries.items():
        entry_launches[sym] += n
    print(f"phase fleet: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    depth_launches, depth_entries = phase_depth(dev, mission_kernels, depth0)
    del depth0
    orbit_launches, orbit_entries, _ = phase_orbits(dev, mission_kernels)
    for got in (depth_launches, orbit_launches):
        for name, n in got.items():
            launches[name] += n
    for got in (depth_entries, orbit_entries):
        for sym, n in got.items():
            entry_launches[sym] += n
    print(f"phase depth and orbits: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_lm_cuda_vs_cpu(dev, kernel["flash_attention"])
    print(f"phase lm cuda vs cpu: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_train_step(dev)
    phase_train_throughput(dev)
    train_launches, train_entries, trained = phase_trained_mission(dev, mission_kernels)
    for name, n in train_launches.items():
        launches[name] += n
    for sym, n in train_entries.items():
        entry_launches[sym] += n
    print(f"phase counter training: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    for phase in (lambda: phase_reference_path(dev, mission_kernels),
                  lambda: phase_mixed_fleet(dev, mission_kernels),
                  lambda: phase_tile_search(dev, mission_kernels, trained[0]),
                  lambda: phase_examples(dev, mission_kernels, trained)):
        got, got_entries = phase()
        for name, n in got.items():
            launches[name] += n
        for sym, n in got_entries.items():
            entry_launches[sym] += n
    print(f"phase reference path, tile search and examples: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    got, got_entries = phase_legacy(dev, mission_kernels)
    for name, n in got.items():
        launches[name] += n
    for sym, n in got_entries.items():
        entry_launches[sym] += n
    phase_analysis()
    phase_guard(dev)
    print(f"phase legacy, analysis and guard: {time.perf_counter() - t0:.1f} s", flush=True)

    replaces = {"tile_moments": "src/repro/kernels/tile_moments.py:33",
                "kmeans_assign": "src/repro/kernels/kmeans_assign.py:29",
                "iou_matrix": "src/repro/kernels/iou.py:30",
                "flash_attention": "src/repro/kernels/flash_attention.py:64",
                "int8_matmul": "src/repro/kernels/int8_matmul.py:43"}
    sources = {"tile_moments": "tile_moments", "kmeans_assign": "kmeans_assign",
               "iou_matrix": "iou", "flash_attention": "flash_attention",
               "int8_matmul": "int8_matmul"}
    line = {"kernels": [
        dict(name=name, route="cuda",
             source=f"src/repro_torch/csrc/{sources[name]}.cu",
             replaces=replaces[name], launches=launches[sources[name]],
             **{k: v for k, v in rows[name].items() if k != "entries"},
             entries=[dict(entry=sym, launches=entry_launches[sym], **row)
                      for sym, row in rows[name]["entries"].items()])
        for name in replaces]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
