#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository's sources; it imports
nothing of JAX or of the reference package ``repro``. Phases:

1. device: the card's name and power limit, torch/CUDA versions, and
   the build of every hand-written kernel from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, in parallel), with ptxas's registers and
   spills of each kernel entry (a spill, a serialized ``wgmma`` or an
   ignored ``setmaxnreg`` in the tensor-core ``flash_attention``, a
   missing instantiation of it at D 64, 128 or 192, or a spill or a
   missing entry of either backward library (the CUDA-core one's 12, the
   tensor-core one's prep and its dkdv and dq at D 64, 80, 128 and 192,
   the last dkdv on two warpgroups), fails the run);
2. kernels: each kernel against its plain PyTorch version on the card,
   at the shapes its path gives it and at ragged ones (a bf16
   ``flash_attention`` also against the plain version on its inputs
   upcast to float32, within one bf16 rounding; every case checks which
   entry of its library it launched; the prefill's attention of
   qwen3-8b (D 128) and of deepseek-v2-lite (D 192) and a qwen3-8b
   projection's int8 product run on both routes, deepseek's shape timed
   beside ``scaled_dot_product_attention``; ViT-L/16's (197 tokens, D
   64) and ViT-H/14's (257 tokens, D 80, zero-padded to 128) attention at
   batch 128, the latter on both routes; the diffusion models' D 64
   attention (the UNet's cross-attention of 4096 queries to 77 keys and
   its self-attention at 4096 tokens, the mid block's 64 tokens, DiT-S/2
   at 4096 tokens, a ragged 200 x 77 case); the dedup's
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
   never calls); ``flash_attention``'s backward (the ``prep``, ``dkdv``
   and ``dq`` entries of ``csrc/flash_attention_bwd_sm90.cu`` for bf16 at
   D 64, 80 and 128, and its D 192 entries, reading the forward's
   log-sum-exp, or of
   ``csrc/flash_attention_bwd.cu`` otherwise, one launch each a call,
   checked) against ``ref.attention_bwd`` at every attention shape of
   phase 15's steps (ViT-L/16's 197 tokens, ViT-H/14's 257 at D 80,
   DiT-S/2's 256, the UNet's level 0 self-attention, its cross-attention
   to 77 keys, 64 and 16 queries; bf16), ragged float32 and bf16 ones,
   and phase 16's causal GQA attention of phi4-mini-3.8b ((1, 4096, 24 /
   8, 128) bf16) and qwen3-8b ((1, 4096, 32 / 8, 128)) with ragged causal
   GQA cases (Sq = Skv, Sq < Skv, Sq > Skv; float32 and bf16, D 64, 80,
   128), deepseek-v2-lite-16b's causal MLA attention ((1, 4096, 16, 192)
   bf16, the D 192 entries) with a ragged causal and a ragged non-causal
   D 192 case, two calls bit-equal, each entry also timed alone, beside the
   backward of ``scaled_dot_product_attention`` (``is_causal``,
   ``enable_gqa`` where the case has them); every tensor-core case at D <=
   128 also forced onto the CUDA-core entries (checked the same, and
   slower: checked); and
   ``int8_matmul``'s one path, ``ops.int8_matmul`` at the kernel bench's
   shape, on the tensor-core entry;
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
   against ``forward_train`` over prompt and generated tokens; then
   phi4-mini-3.8b at full width (32 layers, tied embeddings over 200064
   tokens) prefills the same 2 x 4096 tokens (flash once a layer, on the
   tensor-core entry, checked) and decodes one token, both logits held
   against ``forward_train``;
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
12. MoE and MLA serving: (a) qwen2-moe-a2.7b at full width as published
   (60 routed experts padded to 64, capacity factor 1.25; seeded random
   bf16 weights drawn on the card) prefills 2 prompts of 4096 tokens and
   decodes 32 greedy tokens: ``flash_attention`` once a layer in the
   prefill, all on its tensor-core entry, none in decode; a second
   prefill's logits, and decode from its cache, bit-equal (checked);
   ``LaunchGuard`` over decode steps 3-32: no kernel library loaded, no
   new allocator segment (checked), syncs by site printed; prefill and
   decode tokens/s, the decode step against its byte bound, peak memory,
   the share of routed copies dropped at capacity (by layer) and
   torch.profiler's view of a decode step; (b) a drop-free copy of it
   (capacity factor n_routed) decodes 8 steps after 2 x 256 prompt
   tokens, held against ``forward_train`` at each (row, position) whose
   top-k expert sets agree in every layer; (c) its MoE layer 0 on 256
   tokens, card against CPU: kept copies equal, outputs and aux within
   stated limits; (d) deepseek-v2-lite-16b at full width as (a), its
   prefill on the tensor-core entry too (q/k heads of 192), the dense
   layer 0's prefill attention on the model's own q, k and zero-padded
   v held against the plain version on float32 upcast inputs (rtol
   2^-7, atol 1e-5; the padded columns exactly 0), the last decode step
   run again naive (the expanded cache) against the absorbed one, whole
   and for layer 0's attention alone; (e) both
   reduced in float32, card against CPU as phase 7 (deepseek absorbed
   and naive).
13. vision serving: ViT-L/16, ViT-H/14, ConvNeXt-B and ResNet-152 at
   full width (seeded random bf16 weights drawn on the card) on
   ``serve_b128`` (128 images of 224 px): images/s, ms a batch, the share
   of the bf16 FLOP bound, peak memory and ``flash_attention`` launches
   by entry (one a layer on the tensor-core entry for the ViTs, none for
   the convnets; checked); a second forward bit-equal and ``LaunchGuard``
   over a steady forward (0 builds, 0 new segments; checked);
   torch.profiler's attention share of ViT-H/14's forward; ViT-L/16 at
   ``cls_384``'s resolution (577 tokens, position embeddings resized),
   batch 64; layer 0's attention of each ViT on its own q, k and v
   against the plain version on float32 upcasts (rtol 2^-7, atol 1e-5);
   each model at full width in float32 on 2 images, card against CPU
   (ResNet also ``train=True`` with its updated running statistics),
   within VISION_F32_RTOL.
14. diffusion serving: DiT-S/2 and the SD-1.5 UNet at full width
   (seeded random bf16 weights drawn on the card, DiT's adaLN-Zero leaves
   drawn nonzero) (a) on ``gen_fast`` uncut (16 latents of 512 px, 4 DDIM
   steps; class ids, or a seeded (16, 77, 768) text context): ms a step
   (CUDA events), ms a sample and images/s, the share of the bf16 FLOP
   bound (``diffusion_gflop``), peak memory, ``flash_attention`` launches
   by entry (12 a DiT forward, 32 a UNet forward: 16 self, 16 cross; all
   on the tensor-core entry; checked), a second sample from the same
   noise bit-equal and ``LaunchGuard`` over a steady step (0 builds, 0
   new segments; checked), torch.profiler's view of one UNet step; (b)
   ``gen_1024``: DiT-S/2's 50 steps, the UNet's first GEN1024_UNET_STEPS
   of its 50-step table (16384 tokens at level 0); (c) DiT's layer 0
   self-attention and the UNet's first self- and cross-attention (4096
   queries against 77 keys) on the model's own q, k and v against the
   plain version on float32 upcasts (rtol 2^-7, atol 1e-5); (d) each
   model in float32 on 2 latents of 256 px, one DDIM step, card against
   CPU within DIFFUSION_F32_RTOL.
15. vision and diffusion training (``launch/steps.py``): ViT-L/16,
   ViT-H/14, ConvNeXt-B and ResNet-152 on ``cls_224`` (224 px) and
   DiT-S/2 and the SD-1.5 UNet on ``train_256`` (32 x 32 latents, fixed
   timesteps and noise), at full width (seeded bf16 weights drawn on the
   card, ``remat`` as the configs give it) at batch ZOO_BATCH (256, uncut):
   ZOO_STEPS AdamW steps on one batch, the loss falling
   (checked); ms a step (CUDA events), images/s, the share of the bf16
   bound (3x the forward's FLOPs), peak memory; ``flash_attention``
   launches by entry in a step (each attention's forward twice, once in
   the remat recompute, on the tensor-core entry, and each backward entry
   once; checked); warm-up steps until the allocator settles (checked),
   then ``LaunchGuard`` over a steady step (0 builds, 0 new segments;
   checked); each reduced config in float32, one step's loss
   and gradients card against CPU (checked).
16. LM training (``launch/steps.py`` ``lm_train``, ``models/lm.py``
   ``loss_fn``, ``launch/train.py``): phi4-mini-3.8b at full width and
   depth (3.84 B parameters) on one 4096-token row, qwen3-8b at full
   width cut to LM_TRAIN_LAYERS layers on two rows as two micro-batches
   (``grad_accum`` 2), and the MoE LMs at full width on one row, depth
   cut to LM_TRAIN_LAYERS: qwen2-moe-a2.7b (60 routed experts padded to
   64, capacity factor 1.25) and deepseek-v2-lite-16b (its dense layer 0
   and MoE layers, MLA: the flash backward's D 192 entries, one set a
   layer; the drop share of a step's MoE layers printed), train_4k's
   sequence (seeded bf16 weights drawn on
   the card, seeded tokens, labels the tokens rolled by one, ``remat``
   "dots_saveable", donated steps with AdamW in place): LM_TRAIN_STEPS
   steps on one batch, the loss falling (checked); ms a step (CUDA
   events), tokens/s, the share of the bf16 bound (the reference's
   ``model_flops``: 3x the forward's), peak memory; flash launches by
   entry in a step (the forward twice a layer and micro-batch, with the
   remat recompute, on the tensor-core entry; ``prep``, ``dkdv``, ``dq``
   of the head dim's entries once; checked); peak memory under the card's
   80 GB (checked); warm-up steps until the allocator settles, then
   ``LaunchGuard`` over a steady step (0 builds, 0 new segments;
   checked); step 1 run again from the seed, its loss and every leaf of
   the new state bit-equal (checked), after the embedding gather's
   backward is checked bit-equal over repeated tokens; each reduced
   config in float32, ``loss_fn``'s gradients card (the CUDA-core causal
   GQA kernels) against CPU (checked); ``python -m
   repro_torch.launch.train --steps 20`` twice over one checkpoint folder,
   the second (``--compress``) resuming from step 10 (checked).

It prints a ``{"kernels": [...]}`` line (each kernel at its main shape,
with an ``entries`` list giving each entry of its library at the entry's
first phase 2 case, the backward's entries also at the causal GQA
``train_4k`` shapes (``causal_gqa``), and its launches on the main paths: the Mission's
runs of phase 3, the fleet's of phase 6, the depth and orbital runs of
phase 8, serve's Missions of phase 9, phase 10's runs, phase 11's
monolith runs, the LM prefills of phases 5, 12a and 12d, the ViT
forwards of phase 13, the diffusion samples of phase 14a-b, the first
training step of each model in phases 15 and 16 and ``int8_matmul``'s one
path;
``flash_attention``'s entries include its backward's twelve, from
``csrc/flash_attention_bwd.cu`` and ``csrc/flash_attention_bwd_sm90.cu``),
then the
``nvidia-smi`` name and power limit, and last ``{"ok": true, "device":
{...}}``. Any failure exits non-zero before that last line.
"""
from __future__ import annotations

import gc
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
# phase 12b: a drop-free copy of qwen2-moe (capacity factor n_routed):
# B 2 x 256 prompt tokens, 8 decode steps, then the forward
MOE_CHECK_PROMPT, MOE_CHECK_STEPS = 256, 8
# phase 12b: relative norm of decode logits against the forward's at each
# (row, position) where no layer's top-k expert set differs between the
# two. bf16 noise (as phase 5's) flips near-ties: 12% of (layer, row,
# position), 10 of the 18 (row, position), up to 0.20 there; without a
# flip measured 7.7e-3 to 1.74e-2 on the H100 (PERF.md), so about twice
# that
MOE_DECODE_RTOL = 0.035
# phase 12c: one MoE layer card vs CPU on 256 tokens at the published
# capacity. A token's copies may differ only where its k-th and (k+1)-th
# router probabilities lie within MOE_ROUTE_GAP (float32 router products
# summed in another order; the smallest gap measured 5.6e-6, no copy
# differed). Outputs: relative norm, measured 8.8e-4 (cuBLAS and the
# CPU's bf16 products round 4.5% of values otherwise); aux: measured 1e-7
MOE_LAYER_TOKENS = 256
MOE_ROUTE_GAP = 1e-6
MOE_LAYER_RTOL, MOE_AUX_ATOL = 2e-3, 1e-6
# phase 12d: deepseek's last decode step naive against absorbed, the
# logits' relative norm: the two round q_lat and k_nope to bf16 at other
# places, and the difference grows through 26 MoE layers whose routing
# it flips: measured 9.04e-2 on the H100, so about twice that. Layer 0's
# attention alone (no routing between the paths): measured 4.8e-3
MLA_ABSORB_RTOL = 0.2
MLA_LAYER_RTOL = 1e-2
# phase 13: the vision models at VISION_SHAPES' serve_b128 (batch 128, 224
# px), bf16; ViT-L/16 also at cls_384's resolution, batch 64
VISION_ARCHS = ("vit-l16", "vit-h14", "convnext-b", "resnet-152")
VISION_REPS = 5
# phase 13: full width in float32 on 2 images, card against CPU: the
# logits' relative norm. Float32 sums in another order through up to 152
# layers (TF32 off), a few ulps a layer: 1e-4 (measured 1.1e-6 to 1.5e-6
# on the H100)
VISION_F32_RTOL = 1e-4
# phase 13: ResNet's train=True forward normalizes each channel by its
# batch statistics, over 98 values in the last stage at 2 images, and so
# amplifies float32 noise: on the CPU a one-ulp change of the input moves
# its logits by 3.5e-4 and its running statistics by 2.2e-4 (card vs CPU
# measured 2.9e-4 and 1.7e-4 on the H100). The gate: card vs CPU within
# this factor of the CPU's own change under such a perturbation, made in
# the same run
VISION_TRAIN_SENS = 4.0
# phase 14: DiT-S/2 and the SD-1.5 UNet at DIFFUSION_SHAPES' gen_fast (16
# latents of 512 px, 4 DDIM steps) and gen_1024 (4 of 1024 px, 50 steps;
# the UNet runs the 50-step table's first GEN1024_UNET_STEPS: a whole
# sample is 50 of its ~127 ms steps on the H100)
DIFFUSION_ARCHS = ("dit-s2", "unet-sd15")
GEN1024_UNET_STEPS = 4
# phase 14d: full width in float32 on 2 latents of 256 px, one DDIM step,
# card against CPU: the relative norm of eps and of the step's output.
# Float32 sums in another order through 12 layers or 25 res and 16
# transformer blocks (TF32 off), as phase 13's 1e-4 (measured 1.2e-6 and
# 5.1e-6 on the H100)
DIFFUSION_F32_RTOL = 1e-4
# phase 15: the six models' training steps at full width (bf16, seeded
# weights drawn on the card, remat as the configs give it): the vision
# models at VISION_SHAPES' cls_224 (224 px, batch 256), DiT-S/2 and the
# UNet at DIFFUSION_SHAPES' train_256 (256 px: 32 x 32 latents, batch
# 256). Each fits the card's 80 GB at 256 (ViT-H/14 peaks highest), so
# no batch is cut
ZOO_ARCHS = VISION_ARCHS + DIFFUSION_ARCHS
ZOO_SHAPE = {"vision": "cls_224", "diffusion": "train_256"}
ZOO_BATCH = 256
# phase 15: ZOO_STEPS steps on one fixed batch (fixed t and noise): step 1
# counts the flash launches by entry, then the allocator cache is emptied
# and warm-up steps refill it until ZOO_SETTLED steps in a row allocate no
# new segment (at least GUARD_WARMUP steps, at most ZOO_WARMUP_MAX; the
# counts are printed). The steps donate their state, as the reference's
# cells do: the new parameters and moments are written into the old
# tensors, so a step that allocates nothing leaves the cache as it found
# it and the next repeats it. One step then runs under LaunchGuard and
# the rest are timed by CUDA events; the loss must fall from step 1 to
# the last
ZOO_STEPS = 10
# phase 16 (and phase 2's causal GQA backward cases): LM_SHAPES' train_4k
# sequence, kept; its batch of 256 cut to what one card holds. phi4-mini-3.8b
# at full width and depth (3.84 B parameters: 46 GB of bf16 weights, bf16
# gradients and float32 AdamW moments) takes one 4096-token row; qwen3-8b at
# full width takes LM_TRAIN_LAYERS of its 36 layers (the state and a float32
# accumulator, 16 bytes a parameter, reckon to ~8 layers) and two rows as
# two micro-batches (grad_accum 2), the accumulation path of lm_train. The
# MoE LMs take one row each and LM_TRAIN_LAYERS of their layers, as
# LM_TRAIN_CUT reckons them. Each trains LM_TRAIN_STEPS donated steps on one
# batch, as phase 15 (warm-up until the allocator settles, one step under
# LaunchGuard, the rest timed)
LM_TRAIN_SEQ = 4096
LM_TRAIN_ARCHS = ("phi4-mini-3.8b", "qwen3-8b", "qwen2-moe-a2.7b", "deepseek-v2-lite-16b")
LM_TRAIN_ACCUM = {"phi4-mini-3.8b": 1, "qwen3-8b": 2, "qwen2-moe-a2.7b": 1,
                  "deepseek-v2-lite-16b": 1}
LM_TRAIN_LAYERS = {"qwen3-8b": 8, "qwen2-moe-a2.7b": 6, "deepseek-v2-lite-16b": 7}
# why each depth: the state is 12 bytes a parameter (bf16 weights and
# gradients, float32 moments) beside the embedding and head and the loss's
# float32 (4096, vocab) logits, ~4 copies of them in its backward
LM_TRAIN_CUT = {
    "qwen3-8b": "state and float32 accumulator 16 B a parameter: ~8 layers fit",
    "qwen2-moe-a2.7b": "a layer ~605 M parameters (64 padded experts of 3 x 2048 x 1408, "
                       "4 shared), 7.3 GB of state; embed and head 0.62 B parameters, "
                       "7.5 GB; ~10 GB of logits at vocab 151936: 6 layers reckon to ~61 GB",
    "deepseek-v2-lite-16b": "the dense layer 0 (~81 M parameters, 1 GB) and 6 MoE layers of "
                            "~585 M parameters (64 experts, 2 shared, MLA), 7.0 GB of state "
                            "each; embed and head 0.42 B parameters, 5 GB; ~7 GB of logits at "
                            "vocab 102400: ~55 GB"}
LM_TRAIN_STEPS = 10
# phase 16: the reduced configs in float32, loss_fn's gradients card vs CPU,
# each leaf within LM_F32_GRAD_TOL of its own largest magnitude (the
# transformers' tolerance of phase 15; float32 sums in another order, TF32
# off) and the loss within ZOO_F32_LOSS_RTOL
LM_F32_GRAD_TOL = 1e-4
ZOO_SETTLED, ZOO_WARMUP_MAX = 2, 6
# phase 15: the reduced configs in float32, one step card vs CPU (ViT-H/14
# with heads of 80, its own head dim, at d_model 160, so that the float32
# kernels run D 80; the reduced ViT-L/16 has heads of 16): the loss
# relative, and every gradient leaf within its family's tolerance of its
# largest magnitude. Only the leaves zoo_zero_grad names, whose gradient
# is 0 in exact arithmetic, are held to ZOO_ZERO_GRAD of the tree's
# largest gradient instead: in the reduced UNet (16 and 32 channels,
# GroupNorm groups of one channel) the time embedding reaches each res
# block as a per-channel constant that the next GroupNorm removes, so
# t_w1, t_b1, t_w2, t_b2 and every temb_w, temb_b hold float32 noise on
# both sides (under 1e-6 of the tree's largest gradient; checked).
# Transformers: float32 products in another order
# (TF32 off), measured 1.1e-6 (ViT-L), 1.2e-6 (ViT-H at D 80) and 4.4e-5
# (DiT, t_w1) on the H100; the
# convnets and the UNet: cuDNN's float32 backward, which phase 9 holds at
# 2e-2 at the counters' full width, measured 1.0e-6 to 5.2e-6 here
ZOO_F32_LOSS_RTOL = 1e-5
ZOO_F32_GRAD_TOL = {"vit": 1e-4, "dit": 1e-4, "convnext": 1e-3, "resnet": 1e-3, "unet": 1e-3}
ZOO_ZERO_GRAD = 1e-2
ZOO_ZERO_NOISE = 1e-6


def zoo_zero_grad(cfg, path: str) -> bool:
    """Whether a gradient leaf of a reduced config is 0 in exact
    arithmetic: the reduced UNet's time-embedding leaves (see above)."""
    leaf = path.rsplit("/", 1)[-1]
    return cfg.kind == "unet" and (leaf.startswith("temb_") or leaf in ("t_w1", "t_b1", "t_w2",
                                                                         "t_b2"))
# phase 2: flash_attention's backward (csrc/flash_attention_bwd_sm90.cu and
# csrc/flash_attention_bwd.cu) against ref.attention_bwd. float32: atol and
# rtol FLASH_BWD_F32_TOL, the forward's contract. bf16: each of dq, dk, dv
# within relative norm FLASH_BWD_BF16_RNORM of the plain version in bf16 (it
# rounds the scaled q, the weights and their gradient to bf16 where the
# kernels keep float32), and within FLASH_BWD_UPCAST_RNORM of the plain
# gradient of the inputs upcast to float32: the kernels round their outputs
# once, and read the forward's bf16 output for Delta = rowsum(dO * O), which
# moves dq and dk near 0 by more than an elementwise rtol of 2^-7 allows
# (the CUDA-core route, float32 inside, on the CPU emulation: relative norm
# 1.7e-3, dv elementwise within 3.9e-3 of each value; on the H100 1.658e-3
# to 1.846e-3, the largest at the 16-query mid block, every dv elementwise
# within 3.88e-3): the gate is twice the largest. The tensor-core route
# also rounds P and dS to bf16 for their products (2.2e-3 to 2.7e-3 in its
# emulation, tests/test_torch_flash_bwd_tc.py) under the same gate
FLASH_BWD_F32_TOL = 2e-5
FLASH_BWD_BF16_RNORM = 3e-2
FLASH_BWD_UPCAST_RNORM = 3.7e-3


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
    # route), deepseek-v2-lite's prefill shape on the tensor cores, both on
    # the CUDA-core route (forced, to time the designs in one run), bf16
    # shapes of the tensor-core route (ragged, D 64 and 192, Hq = Hkv, Sq <
    # Skv), then the f32 shapes of tests/test_kernels.py and ragged ones,
    # and bf16 with D 96 (the CUDA-core route)
    tc, cc = flash_attention.TENSOR_CORE, flash_attention.CUDA_CORE
    bf16, f32 = torch.bfloat16, torch.float32
    main = (2, 4096, 4096, 32, 8, 128)
    # deepseek-v2-lite's prefill (phase 12d): q/k heads of 128 + 64 (v
    # zero-padded to 192 there, random here), Hq = Hkv = 16
    mla = (2, 4096, 4096, 16, 16, 192)
    # ViT-L/16's and ViT-H/14's attention at serve_b128 (phase 13): 197
    # tokens, heads of 64; 257 tokens, heads of 80 (zero-padded to 128 by
    # the wrapper on the tensor-core route)
    vit_l, vit_h = (128, 197, 197, 16, 16, 64), (128, 257, 257, 16, 16, 80)
    # the diffusion models' attention (phase 14), all D 64 non-causal: the
    # UNet's gen_fast cross-attention (4096 queries, 77 keys: a partial
    # last key tile) and level 0 self-attention, its mid block (64 tokens,
    # half a query tile), DiT-S/2 at gen_1024, and a ragged cross case
    diffusion = [(16, 4096, 77, 5, 5, 64), (16, 4096, 4096, 5, 5, 64),
                 (16, 64, 64, 20, 20, 64), (4, 4096, 4096, 6, 6, 64), (2, 200, 77, 4, 4, 64)]
    attn = [(main, bf16, True, tc), (mla, bf16, True, tc), (mla, bf16, True, cc),
            (main, bf16, True, cc), (vit_l, bf16, False, tc), (vit_h, bf16, False, tc),
            (vit_h, bf16, False, cc)] + [(shape, bf16, False, tc) for shape in diffusion] + [
            ((1, 200, 200, 4, 2, 128), bf16, True, tc),
            ((2, 256, 256, 4, 2, 64), bf16, False, tc),
            ((1, 384, 384, 8, 8, 128), bf16, True, tc),
            ((1, 128, 384, 4, 2, 128), bf16, False, tc),
            ((1, 200, 200, 4, 2, 192), bf16, True, tc),
            ((1, 128, 384, 4, 4, 192), bf16, False, tc)]
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
                enable_gqa=True), time_library=dt == bf16,
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
    ``flash_attention`` or ``int8_matmul`` or any entry of its backward
    spills, if ptxas serializes a ``wgmma`` or ignores a ``setmaxnreg``, if
    an instantiation of ``flash_tc_kernel`` (one a head dim of
    ``TENSOR_CORE_D``) or of the tensor-core backward's (one a head dim of
    ``TENSOR_CORE_BWD_D``) is missing from the report, or if a backward
    library reports another number of entries."""
    from repro_torch.kernels.flash_attention import TENSOR_CORE_BWD_D, TENSOR_CORE_D
    # flash_attention's backward libraries -> their kernel entries:
    # csrc/flash_attention_bwd.cu's 3 kernels x (float32, bf16) x (DP 64,
    # 128), csrc/flash_attention_bwd_sm90.cu's prep and its dkdv and dq at
    # each head dim of TENSOR_CORE_BWD_D, causal and not (dkdv at D 192 the
    # two-warpgroup kernel); none may spill
    bwd_libs = {"flash_attention_bwd": 3 * 2 * 2,
                "flash_attention_bwd_sm90": 1 + 2 * 2 * len(TENSOR_CORE_BWD_D)}
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
                if TC_ENTRY in entry or INT8_TC_ENTRY in entry or name in bwd_libs:
                    check("0 bytes spill stores, 0 bytes spill loads" in spill,
                          f"ptxas: {entry} spills ({spill})")
            if "wgmma" in line and "serializ" in line:
                fail(f"ptxas serializes wgmma: {line}")
            if "setmaxnreg" in line and "ignored" in line:
                fail(f"ptxas ignores setmaxnreg: {line}")
            if "warning" in line.lower():
                print(f"ptxas {name} {entry}: {line}", flush=True)
    if "flash_attention" in logs:
        entries = [line.split("'")[1] for line in logs["flash_attention"].splitlines()
                   if "Compiling entry function" in line and TC_ENTRY in line]
        for d in TENSOR_CORE_D:   # the mangled template arguments <D, 64>
            check(any(f"ILi{d}ELi64E" in e for e in entries),
                  f"ptxas reported no {TC_ENTRY}<{d}, 64> (entries {entries})")
    if "int8_matmul" in logs:
        check(INT8_TC_ENTRY in logs["int8_matmul"], "ptxas reported no int8 tensor-core entry")
    for name, want in bwd_libs.items():
        if name not in logs:
            continue
        entries = [line.split("'")[1] for line in logs[name].splitlines()
                   if "Compiling entry function" in line]
        check(len(entries) == want and all("bwd_" in e for e in entries),
              f"ptxas reported {len(entries)} entries of {name}, not {want}: {entries}")
    if "flash_attention_bwd_sm90" in logs:   # each tensor-core kernel at each head dim
        log = logs["flash_attention_bwd_sm90"]
        for d in TENSOR_CORE_BWD_D:
            dkdv = "bwd_dkdv_wg2_tc_kernel" if d == 192 else "bwd_dkdv_tc_kernel"
            for kern in (dkdv, "bwd_dq_tc_kernel"):
                for causal in (0, 1):   # the mangled <D, kCausal>
                    check(f"{kern}ILi{d}ELb{causal}E" in log,
                          f"ptxas reported no {kern}<{d}, {bool(causal)}>")


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
            lib_ms = (cuda_ms(case["library"], reps=20)
                      if (i == 0 or case.get("time_library")) and "library" in case else None)
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
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
        torch.cuda.empty_cache()
    for name, why in LIBRARY_NOTE.items():
        print(f"kernel {name}: library_ms {why}")
    return rows


def flash_bwd_cases():
    """Phase 2's cases of flash_attention's backward, (label, (B, Sq, Skv,
    Hq, Hkv, D), dtype, causal): each attention of phase 15's steps at its
    batch (bf16, non-causal, Hq == Hkv), ragged float32 and bf16 cases,
    then phase 16's causal GQA attention of phi4-mini-3.8b (24 / 8 heads)
    and qwen3-8b (32 / 8) and deepseek-v2-lite-16b's causal MLA attention
    (16 heads of 192) at LM_TRAIN_SEQ tokens a row, ragged causal GQA cases
    (Sq = Skv, Sq < Skv, Sq > Skv; float32 and bf16, D 64 to 192), and last
    a ragged non-causal D 192 case."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    bl = bh = bd = bu = ZOO_BATCH
    s = LM_TRAIN_SEQ
    cases = [("vit-l16 cls_224", (bl, 197, 197, 16, 16, 64), bf16),
             ("vit-h14 cls_224 (D 80)", (bh, 257, 257, 16, 16, 80), bf16),
             ("dit-s2 train_256", (bd, 256, 256, 6, 6, 64), bf16),
             ("unet-sd15 train_256 level 0 self", (bu, 1024, 1024, 5, 5, 64), bf16),
             ("unet-sd15 train_256 level 0 cross (77 keys)", (bu, 1024, 77, 5, 5, 64), bf16),
             ("unet-sd15 train_256 level 2 (64 queries)", (bu, 64, 64, 20, 20, 64), bf16),
             ("unet-sd15 train_256 mid block (16 queries)", (bu, 16, 16, 20, 20, 64), bf16),
             ("ragged", (2, 200, 200, 4, 4, 64), f32), ("ragged D 80", (2, 197, 77, 3, 3, 80), f32),
             ("one query", (1, 1, 100, 2, 2, 16), f32),
             ("ragged D 128", (2, 130, 65, 4, 4, 128), f32),
             ("ragged D 128", (2, 100, 300, 4, 4, 128), bf16),
             ("ragged D 80", (2, 197, 77, 3, 3, 80), bf16),
             ("one query", (1, 1, 100, 2, 2, 64), bf16), ("D 96", (2, 130, 70, 2, 2, 96), bf16)]
    causal = [("phi4-mini-3.8b train_4k causal GQA", (1, s, s, 24, 8, 128), bf16),
              ("qwen3-8b train_4k causal GQA", (1, s, s, 32, 8, 128), bf16),
              ("deepseek-v2-lite-16b train_4k causal MLA (D 192)", (1, s, s, 16, 16, 192), bf16),
              ("ragged causal GQA", (2, 200, 200, 6, 2, 64), f32),
              ("ragged causal GQA Sq < Skv", (2, 130, 260, 4, 2, 128), f32),
              ("ragged causal GQA", (2, 200, 200, 6, 2, 64), bf16),
              ("ragged causal GQA D 80", (2, 197, 197, 6, 2, 80), bf16),
              ("ragged causal GQA Sq < Skv", (2, 130, 260, 4, 2, 128), bf16),
              ("ragged causal GQA Sq > Skv", (2, 260, 130, 4, 2, 128), bf16),
              ("ragged causal D 192", (2, 200, 200, 4, 4, 192), bf16)]
    # after the causal ones, so that the D 192 entries' first case is deepseek's
    last = [("ragged D 192", (2, 130, 70, 2, 2, 192), bf16, False)]
    return [(*c, False) for c in cases] + [(*c, True) for c in causal] + last


def causal_pairs(sq: int, skv: int, causal: bool) -> int:
    """(query, key) pairs the attention reads: every pair, or under the
    top-left causal mask row r's keys 0..r (at most Skv)."""
    if not causal:
        return sq * skv
    n = min(sq, skv)
    return n * (n + 1) // 2 + (sq - n) * skv


def bwd_entry_ms(q, k, v, o, do, lse, route, reps: int, causal: bool = False) -> dict:
    """Each entry's device ms in ``flash_attention_bwd`` on ``route``, by a
    CUDA event recorded after each of its launches, over ``reps`` calls
    queued behind ``torch.cuda._sleep``."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    lib = fa.BWD_TC_KERNEL if route == fa.TENSOR_CORE else fa.BWD_KERNEL
    marks, launch = [], lib.launch

    def marked(symbol, *args):
        launch(symbol, *args)
        marks.append((symbol, torch.cuda.Event(enable_timing=True)))
        marks[-1][1].record()

    def call():
        fa.flash_attention_bwd(q, k, v, o, do, lse, causal=causal, route=route)
    call()   # warm-up
    start = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start.record()
    lib.launch = marked   # on the instance, for these calls only
    try:
        for _ in range(reps):
            call()
    finally:
        del lib.launch
    torch.cuda.synchronize()
    ms = dict.fromkeys(fa.BWD_ENTRIES, 0.0)
    prev = start
    for symbol, event in marks:
        ms[next(e for e in fa.BWD_ENTRIES if f"_{e}_" in symbol)] += prev.elapsed_time(event) / reps
        prev = event
    return ms


def rnorm(got, want) -> float:
    return ((got.double() - want.double()).norm() / want.double().norm()).item()


def bwd_symbols(route, dt, d) -> dict:
    """flash_attention_bwd's entries on ``route`` at head dim ``d`` ->
    {entry: symbol}."""
    from repro_torch.kernels import flash_attention as fa
    if route == fa.TENSOR_CORE:
        return dict(fa.bwd_tc_symbols(d))
    return {e: fa.BWD_SYMBOLS[e, dt] for e in fa.BWD_ENTRIES}


def phase_flash_bwd(dev, rows, cases=None):
    """Phase 2, flash_attention's backward: each case (``cases``, default
    :func:`flash_bwd_cases`) on its route
    (``choose_bwd_route``: bf16 at D 64, 80, 128 and 192 on the tensor-core
    entries, reading the forward's log-sum-exp; the rest on the CUDA-core
    ones) against ``ref.attention_bwd`` (one launch of each of its three
    entries, checked; two calls bit-equal, checked; the tolerances above),
    timed with CUDA events beside its bound, the plain version and the
    backward of ``scaled_dot_product_attention`` on the same inputs
    (autograd through it, the forward outside the timing), each entry also
    alone. A tensor-core case at D <= 128 also runs forced onto the
    CUDA-core entries (the same checks), timed the same way; D 192 has no
    CUDA-core kernel. The bound counts the five
    products the gradient needs (s, dP, dV, dK, dQ: 10 B Hq D operations a
    (query, key) pair the mask leaves, ``causal_pairs``, at the inputs'
    type's peak) and each input and output once; an entry's, the products
    it runs (CUDA cores: prep 1, dkdv 4, dq 3, 8 in all; tensor cores: prep
    0, dkdv 4, dq 3, 7 in all) and its bytes. The entries of the first case
    of each route add to ``rows["flash_attention"]``; each entry's
    ``causal_gqa`` holds its rows of the causal ``train_4k`` cases
    (phi4-mini-3.8b's and qwen3-8b's; deepseek-v2-lite-16b's for the D 192
    entries, whose bound counts the padded D 192), or of its first causal
    case where it runs none of those. -> {label: {route:
    ms, "sdpa": ms, "bound": ms}} of each case."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    entry_rows, causal_rows, times = {}, {}, {}
    for label, (b, sq, skv, h, hkv, d), dt, causal in cases or flash_bwd_cases():
        q, do = (torch.randn((b, sq, h, d), generator=g, device=dev).to(dt) for _ in range(2))
        k, v = (torch.randn((b, skv, hkv, d), generator=g, device=dev).to(dt) for _ in range(2))
        route = fa.choose_bwd_route(dt, d)
        with torch.no_grad():   # the forward's output (and lse) as the Function saves them
            if route == fa.TENSOR_CORE:
                o, lse = fa._forward(q, k, v, causal, None, with_lse=True)
                o = o.contiguous()
            else:
                o, lse = fa.flash_attention(q, k, v, causal=causal).contiguous(), None
        shape = (f"{label}: q{(b, sq, h, d)} kv{(b, skv, hkv, d)} {str(dt)[6:]}"
                 f"{' causal' if causal else ''}")
        routes = [route] + ([fa.CUDA_CORE] if route == fa.TENSOR_CORE
                            and d <= fa.CUDA_CORE_MAX_BWD_D else [])
        t_plain = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t_plain[0].record()
        want = ref.attention_bwd(q, k, v, o, do, causal=causal)
        t_plain[1].record()
        torch.cuda.synchronize()
        exact = (None if dt == torch.float32 else
                 ref.attention_bwd(*(t.float() for t in (q, k, v, o)), do.float(), causal=causal))
        big = b * h * sq * skv * d > 2e10
        plain_ms = (t_plain[0].elapsed_time(t_plain[1]) if big else
                    cuda_ms(lambda: ref.attention_bwd(q, k, v, o, do, causal=causal), reps=3,
                            warmup=1))
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=h != hkv)
        dot = do.transpose(1, 2)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                     retain_graph=True), reps=5, warmup=1)
        del qt, kt, vt, out
        es = q.element_size()
        unit = 2.0 * b * h * causal_pairs(sq, skv, causal) * d
        rate = BF16_FLOPS if dt == torch.bfloat16 else FP32_FLOPS
        io = 4 * (b * sq * h * d + b * skv * hkv * d) * es   # q, o, do, dq; k, v, dk, dv
        b_ms, b_by = bound_ms(io, 5 * unit, rate)
        route_ms = {}
        for r in routes:
            lib = fa.BWD_TC_KERNEL if r == fa.TENSOR_CORE else fa.BWD_KERNEL
            syms = bwd_symbols(r, dt, d)

            def call():
                return fa.flash_attention_bwd(q, k, v, o, do, lse, causal=causal, route=r)
            before = dict(lib.symbol_launches)
            got = call()
            again = call()
            torch.cuda.synchronize()
            took = {s_: n - before[s_] for s_, n in lib.symbol_launches.items()
                    if n != before[s_]}
            check(took == {s_: 2 for s_ in syms.values()},
                  f"flash bwd {shape} {r}: launched {took}")
            same = all(bit_equal(a, b_) for a, b_ in zip(got, again))
            del again
            errs = [(a.float() - w.float()).abs().max().item() for a, w in zip(got, want)]
            if dt == torch.float32:
                ok = all(torch.allclose(a, w, atol=FLASH_BWD_F32_TOL, rtol=FLASH_BWD_F32_TOL)
                         for a, w in zip(got, want))
                detail = (f"max_abs_err dq/dk/dv {', '.join(f'{e:.3e}' for e in errs)} (atol, "
                          f"rtol {FLASH_BWD_F32_TOL:.0e})")
            else:
                rn = [rnorm(a, w) for a, w in zip(got, want)]
                up = [rnorm(a, w) for a, w in zip(got, exact)]
                rel = [((a.float() - w).abs() / (w.abs() + 1e-3 * w.abs().max())).max().item()
                       for a, w in zip(got, exact)]
                ok = max(rn) <= FLASH_BWD_BF16_RNORM and max(up) <= FLASH_BWD_UPCAST_RNORM
                detail = (f"max_abs_err dq/dk/dv {', '.join(f'{e:.3e}' for e in errs)}; relative "
                          f"norm against the plain version {', '.join(f'{x:.3e}' for x in rn)} "
                          f"(limit {FLASH_BWD_BF16_RNORM:.0e}), against float32 upcast inputs "
                          f"{', '.join(f'{x:.3e}' for x in up)} (limit "
                          f"{FLASH_BWD_UPCAST_RNORM:.0e}); elementwise relative (atol 1e-3 of "
                          f"the max) {', '.join(f'{x:.3e}' for x in rel)}")
            got = None
            torch.cuda.empty_cache()
            ms = cuda_ms(call, reps=3 if big else 10, warmup=1)
            entry_ms = bwd_entry_ms(q, k, v, o, do, lse, r, reps=3 if big else 10,
                                    causal=causal)
            route_ms[r] = ms
            versus = ("" if r == route else
                      f" (the {route} route {route_ms[route]:.4f}, {ms / route_ms[route]:.2f}x "
                      f"faster)")
            print(f"kernel flash_attention_bwd {shape} {r}: {detail}; two calls bit-equal "
                  f"{same}; ms {ms:.4f} (prep {entry_ms['prep']:.4f}, dkdv "
                  f"{entry_ms['dkdv']:.4f}, dq {entry_ms['dq']:.4f}){versus} plain_ms "
                  f"{plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) share {b_ms / ms:.3f} library_ms "
                  f"{lib_ms:.4f} (SDPA's backward)", flush=True)
            check(ok, f"flash bwd {shape} {r}: off the plain version ({detail})")
            check(same, f"flash bwd {shape} {r}: two calls differ")
            tc = r == fa.TENSOR_CORE
            lse_io = 8 * b * h * (fa.lse_stride(sq) if tc else sq)   # lse and Delta
            entry_io = {"prep": (2 * b * sq * h * d * es + lse_io // 2 if tc else
                                 (3 * b * sq * h * d + b * skv * hkv * d) * es + lse_io),
                        "dkdv": (2 * b * sq * h * d + 4 * b * skv * hkv * d) * es + lse_io,
                        "dq": (3 * b * sq * h * d + 2 * b * skv * hkv * d) * es + lse_io}
            products = {"prep": 0 if tc else 1, "dkdv": 4, "dq": 3}
            source = f"src/repro_torch/csrc/{'flash_attention_bwd_sm90' if tc else 'flash_attention_bwd'}.cu"
            for e, sym in syms.items():
                e_ms, e_by = bound_ms(entry_io[e], products[e] * unit, rate)
                row = dict(shape=shape, source=source, max_abs_err=max(errs), ms=entry_ms[e],
                           plain_ms=plain_ms, bound_ms=e_ms, bound_by=e_by, library_ms=lib_ms,
                           backward_ms=ms, backward_bound_ms=b_ms)
                entry_rows.setdefault(sym, row)
                kept = causal_rows.setdefault(sym, []) if causal else None
                if causal and ("train_4k" in label or not kept):
                    kept.append(row)
        times[label + (" causal" if causal else "") + f" {str(dt)[6:]}"] = dict(
            route_ms, sdpa=lib_ms, bound=b_ms, plain=plain_ms)
        if len(routes) == 2:
            print(f"flash_attention_bwd {shape}: tensor cores {route_ms[fa.TENSOR_CORE]:.4f} ms, "
                  f"CUDA cores {route_ms[fa.CUDA_CORE]:.4f} ms, SDPA's backward {lib_ms:.4f} ms, "
                  f"bound {b_ms:.4f} ms", flush=True)
            check(route_ms[fa.TENSOR_CORE] < route_ms[fa.CUDA_CORE],
                  f"flash bwd {shape}: the tensor-core route is not faster than the CUDA-core "
                  f"one ({route_ms})")
        del q, k, v, o, do, lse, want, exact
        torch.cuda.empty_cache()
    for sym, row in entry_rows.items():
        rows["flash_attention"]["entries"].setdefault(sym, row)
    for sym, kept in causal_rows.items():   # copies: an entry's own row may be among them
        rows["flash_attention"]["entries"][sym]["causal_gqa"] = [dict(r) for r in kept]
    return times


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
    cache = extended_cache(cfg, pre, s + steps, dev)
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
    block_s = min(synced(lambda: lm._block(layer0, cfg, x, positions, "train", False))[1]
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
    for sym, n in phi4_serving(dev, flash).items():
        launches += n
        routes[sym] = routes.get(sym, 0) + n
    return launches, routes


def phi4_serving(dev, flash):
    """phi4-mini-3.8b at full width (32 layers, d_model 3072, 24 / 8 heads,
    tied embeddings over 200064 tokens; seeded bf16 weights) once through
    the serving path: prefill of LM_BATCH prompts of LM_PROMPT seeded
    tokens (flash once a layer, on the tensor-core entry, checked), one
    greedy decode step, and the logits of both against ``forward_train``
    over prompt and token (relative norm within LM_DECODE_RTOL, checked)
    -> flash launches by entry in the prefill."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config("phi4-mini-3.8b")
    b, s = LM_BATCH, LM_PROMPT
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    params = lm.init(g, cfg, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=g, device=dev)
    before = dict(flash.symbol_launches)
    (logits, pre), prefill_s = synced(lambda: lm.prefill(params, cfg, prompt))
    took = {sym: n - before[sym] for sym, n in flash.symbol_launches.items() if n != before[sym]}
    check(took == {TC_SYMBOL: cfg.n_layers},
          f"phi4-mini prefill's flash launches by entry {took}, not {cfg.n_layers} on {TC_SYMBOL}")
    cache = extended_cache(cfg, pre, s + 1, dev)
    del pre
    tok = logits.argmax(-1, keepdim=True)
    (log1, _), decode_s = synced(lambda: lm.decode_step(params, cfg, tok, cache, s))
    check(flash.symbol_launches == {sym: before[sym] + took.get(sym, 0) for sym in before},
          "phi4-mini decode launched flash_attention")
    with torch.no_grad():
        full, _ = lm.forward_train(params, cfg, torch.cat([prompt, tok], dim=1))
    want = full[:, s - 1:].float()
    del full
    got = torch.stack([logits, log1], dim=1).float()
    rel = ((got - want).norm(dim=(0, 2)) / want.norm(dim=(0, 2))).tolist()
    print(f"phi4-mini-3.8b serving: {cfg.n_params / 1e9:.3f} B params; prefill B {b} x {s}: "
          f"{prefill_s:.4f} s ({b * s / prefill_s:.1f} tokens/s), flash launches by entry "
          f"{took}; one decode step {1e3 * decode_s:.4f} ms; logits against forward_train, "
          f"relative norm prefill {rel[0]:.4e}, decode {rel[1]:.4e} (limit {LM_DECODE_RTOL})",
          flush=True)
    check(all(math.isfinite(x) for x in rel) and max(rel) <= LM_DECODE_RTOL,
          f"phi4-mini decode logits off the forward's by {max(rel):.4e}")
    del params, cache, got, want, logits, log1
    torch.cuda.empty_cache()
    return took


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
    return kernels


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def extended_cache(cfg, pre, total, dev):
    """A zeroed cache of ``total`` positions holding the prefill's cache
    ``pre`` in its first positions (axis 2 of every leaf)."""
    from repro_torch.models import lm
    b = next(iter(next(iter(pre.values())).values())).shape[1]
    cache = lm.init_cache(cfg, b, total, device=dev)
    for name, stack in cache.items():
        for kk, c in stack.items():
            c[:, :, :pre[name][kk].shape[2]] = pre[name][kk]
    return cache


def phase_lm_cuda_vs_cpu(dev, flash, arch="qwen3-8b", absorb=True):
    """Reduced ``arch`` in float32: prefill of 6 tokens and 3 decode steps
    (MLA's ``absorb`` path) on the card (the kernel) and on the CPU (the
    plain version); logits within 1e-4 (float32 sums in another order),
    ``flash_attention_f32`` launched once a layer on the card, never on
    the CPU."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import lm

    cfg = reduced(get_config(arch))
    p_cpu = lm.init(torch.Generator().manual_seed(SEED), cfg, device="cpu")
    tokens = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (2, 9))
    runs = {}
    for device, p in (("cpu", p_cpu), (dev, lm.from_numpy(p_cpu, dev))):
        t = torch.from_numpy(tokens).to(device)
        before = flash.symbol_launches["flash_attention_f32"]
        log, pre = lm.prefill(p, cfg, t[:, :6])
        launched = flash.symbol_launches["flash_attention_f32"] - before
        cache = extended_cache(cfg, pre, 9, device)
        logits = [log]
        for pos in range(6, 9):
            log, cache = lm.decode_step(p, cfg, t[:, pos:pos + 1], cache, pos, absorb=absorb)
            logits.append(log)
        runs[str(device)] = (torch.stack(logits).cpu(), launched)
    (want, cpu_launched), (got, gpu_launched) = runs["cpu"], runs[str(dev)]
    err = (got - want).abs().max().item()
    what = cfg.name + ("" if cfg.mla is None else f" ({'absorbed' if absorb else 'naive'} decode)")
    print(f"lm cuda vs cpu: reduced {what} prefill + 3 decode steps, logits max_abs_err "
          f"{err:.3e}; flash_attention_f32 (CUDA-core) launches on the card {gpu_launched}, "
          f"on the CPU {cpu_launched}", flush=True)
    check(gpu_launched == cfg.n_layers and cpu_launched == 0, f"{what}: flash_attention dispatch")
    check(torch.allclose(got, want, atol=1e-4, rtol=1e-4),
          f"{what}: CUDA and CPU logits differ by {err}")


# ---------------------------------------------------------------------------
# phase 12: MoE and MLA serving
# ---------------------------------------------------------------------------

class MoeProbe:
    """While active, wraps ``moe._dispatch`` (which ``moe_block`` looks up
    at each call): sums each call's routed (token, k) copies and the
    dropped ones on the card (no sync), and keeps its ``meta`` (order,
    slot, valid, topw, tok) and top-k expert ids (G, S, k) if ``keep``.
    The wrapper adds a few small launches a MoE layer, so timed runs go
    without it."""

    def __init__(self, keep=False):
        self.keep = keep
        self.dropped, self.copies, self.metas, self.topi = [], 0, [], []

    def __enter__(self):
        from repro_torch.models import moe
        self._orig = orig = moe._dispatch

        import torch

        def dispatch(xg, probs, k, n_exp, cap):
            buf, meta = orig(xg, probs, k, n_exp, cap)
            self.dropped.append((~meta[2]).sum())
            self.copies += meta[2].numel()
            if self.keep:
                self.metas.append(meta)
                self.topi.append(torch.topk(probs, k, dim=-1).indices)
            return buf, meta
        moe._dispatch = dispatch
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._dispatch = self._orig
        return False

    def drop_share(self) -> float:
        import torch
        return float(torch.stack(self.dropped).sum()) / self.copies

    def drop_shares(self, n_layers: int) -> list:
        """The share dropped by MoE layer, over the calls recorded (one a
        layer a forward)."""
        import torch
        per = torch.stack(self.dropped).reshape(-1, n_layers).sum(0).float()
        return (per * n_layers / self.copies).tolist()


def serve_full_width(dev, flash, arch, symbol):
    """12a / 12d: ``arch`` at full width as published (seeded random bf16
    weights drawn on the card): a warm-up prefill, then prefill of
    LM_BATCH x LM_PROMPT tokens and LM_STEPS greedy decode steps (MLA:
    absorbed), steps 1-2 the warm-up after an emptied allocator cache,
    steps 3-LM_STEPS under one ``LaunchGuard`` with CUDA events a step.

    Checks: ``flash_attention`` launches once a layer in the prefill, all
    on ``symbol``, none in decode; 0 builds and 0 new allocator segments
    over the guarded steps; a second prefill of the prompt gives
    bit-equal logits, and decode from its cache the same tokens' logits
    bit for bit (both with ``MoeProbe`` on, which gives the drop shares).
    -> (params, cfg, prompt, flash launches by entry in the serving run,
    the last decode step's (token, cache, position, logits))."""
    import torch
    from repro_torch.analysis import LaunchGuard
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = get_config(arch)
    b, s, steps = LM_BATCH, LM_PROMPT, LM_STEPS
    g = torch.Generator(device=dev).manual_seed(SEED)
    params, init_s = synced(lambda: lm.init(g, cfg, device=dev))
    torch.cuda.empty_cache()
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=g, device=dev)
    lm.prefill(params, cfg, prompt[:, :256])  # warm-up: cuBLAS handles, kernel load
    print(f"{arch}: {cfg.n_layers} layers d_model {cfg.d_model}, {cfg.n_params / 1e9:.3f} B "
          f"params ({cfg.n_active_params / 1e9:.3f} B active a token), "
          f"{weight_bytes / 1e9:.2f} GB of weights drawn in {init_s:.2f} s; B {b} prompt {s} "
          f"decode {steps}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    flash.reset()
    (logits, pre), prefill_s = synced(lambda: lm.prefill(params, cfg, prompt))
    routes = {k: n for k, n in flash.symbol_launches.items() if n}
    check(flash.launches == cfg.n_layers and routes == {symbol: cfg.n_layers},
          f"{arch} prefill: flash_attention launches by entry {routes}, not {cfg.n_layers} "
          f"on {symbol}")
    cache = extended_cache(cfg, pre, s + steps, dev)
    del pre
    # logits and tokens of every step in buffers made before the loop, so
    # the guarded steps allocate only what a step frees again
    outs = logits.new_empty((steps + 1, *logits.shape))
    outs[0] = logits
    tokens = torch.empty((steps, b, 1), dtype=torch.int64, device=dev)

    def step(i):
        torch.argmax(outs[i], -1, keepdim=True, out=tokens[i])
        outs[i + 1] = lm.decode_step(params, cfg, tokens[i], cache, s + i)[0]

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    warm_s = [synced(lambda: step(i))[1] for i in range(GUARD_WARMUP)]
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps - GUARD_WARMUP + 1)]
    with LaunchGuard(f"{arch} decode steps {GUARD_WARMUP + 1}-{steps}") as guard:
        events[0].record()
        for i in range(GUARD_WARMUP, steps):
            step(i)
            events[i - GUARD_WARMUP + 1].record()
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(e) for a, e in zip(events, events[1:])]
    check(flash.launches == cfg.n_layers and {k: n for k, n in flash.symbol_launches.items()
                                              if n} == routes, f"{arch}: decode launched flash")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"guard {guard.label}: builds {guard.builds} new segments {guard.new_segments} syncs "
          f"{guard.syncs}; launches by entry {json.dumps(guard.launches)}; syncs by site "
          f"{json.dumps(guard.sync_sites)}", flush=True)
    guard.assert_steady_state()
    decode_ms = sum(step_ms) / len(step_ms)
    bound = 1e3 * weight_bytes / HBM_BYTES_PER_S
    print(f"{arch} prefill: {prefill_s:.4f} s, {b * s / prefill_s:.1f} tokens/s; flash_attention "
          f"launches {flash.launches} by entry {routes}", flush=True)
    print(f"{arch} decode: {decode_ms:.4f} ms/step over the guarded steps (warm-up steps "
          f"{', '.join(f'{1e3 * t:.4f}' for t in warm_s)} ms; median "
          f"{sorted(step_ms)[len(step_ms) // 2]:.4f}), {1e3 * b / decode_ms:.1f} tokens/s; byte "
          f"bound (all weights read once) {bound:.4f} ms, share {bound / decode_ms:.3f}; peak "
          f"memory {peak_gb:.2f} GB", flush=True)

    # the same prompt again, and decode from its cache: bit for bit
    with MoeProbe() as pre_probe:
        again, pre = lm.prefill(params, cfg, prompt)
    check(bit_equal(again, logits), f"{arch}: a second prefill's logits differ")
    cache2 = extended_cache(cfg, pre, s + steps, dev)
    del pre
    with MoeProbe() as dec_probe:
        same = all(bit_equal(lm.decode_step(params, cfg, tokens[i], cache2, s + i)[0], outs[i + 1])
                   for i in range(steps))
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    by_layer = [round(x, 4) for x in pre_probe.drop_shares(n_moe)]
    print(f"{arch}: second prefill bit-equal True; decode from its cache bit-equal {same}; "
          f"routed copies dropped at capacity: prefill {pre_probe.drop_share():.4f} of "
          f"{pre_probe.copies} (by MoE layer {by_layer}), decode {dec_probe.drop_share():.4f} "
          f"of {dec_probe.copies}", flush=True)
    check(same, f"{arch}: decode from the second prefill's cache differs")
    del cache2
    profile_step(f"{arch} decode", lambda: lm.decode_step(params, cfg, tokens[-1], cache,
                                                          s + steps - 1))
    return params, cfg, prompt, routes, (tokens[-1], cache, s + steps - 1, outs[-1])


def moe_decode_vs_forward(dev, params, cfg, prompt):
    """12b: a drop-free copy of ``cfg`` (``capacity_factor = n_routed``,
    the reduced config's rule; every width and the weights kept): prefill
    of B x MOE_CHECK_PROMPT tokens, MOE_CHECK_STEPS greedy decode steps,
    then ``forward_train`` over prompt and generated tokens. Under the
    published capacity decode and forward drop different copies by
    design. Prints the share of (layer, row, position) whose top-k expert
    sets differ between decode and forward (bf16 noise flips near-ties).
    Checks the relative norm of the logits at each (row, position) where
    no layer's set differs against MOE_DECODE_RTOL, and that at least a
    quarter of them have no flip."""
    import dataclasses
    import torch
    from repro_torch.models import lm

    free = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_routed)))
    b, s, steps = prompt.shape[0], MOE_CHECK_PROMPT, MOE_CHECK_STEPS
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    with MoeProbe(keep=True) as probe:
        log, pre = lm.prefill(params, free, prompt[:, :s])
        cache = extended_cache(free, pre, s + steps, dev)
        del pre
        outs, tokens = [log], []
        for i in range(steps):
            tokens.append(outs[-1].argmax(-1, keepdim=True))
            outs.append(lm.decode_step(params, free, tokens[-1], cache, s + i)[0])
        seq = torch.cat([prompt[:, :s]] + tokens, dim=1)
        full, _ = lm.forward_train(params, free, seq)
    check(probe.drop_share() == 0.0, "the drop-free copy dropped copies")
    want = full[:, s - 1:].float()
    got = torch.stack(outs, dim=1).float()
    del full
    # routing by (layer, row, position): the prefill's last position, each
    # decode step, and the forward (one group each, rows one after another)
    topi = [t.reshape(b, -1, cfg.moe.top_k).sort(-1).values for t in probe.topi]
    pre_t, dec_t, fwd_t = topi[:n_moe], topi[n_moe:-n_moe], topi[-n_moe:]
    routed = torch.stack([torch.cat([pre_t[j][:, s - 1:]] + dec_t[j::n_moe], dim=1)
                          for j in range(n_moe)])       # (layer, b, steps + 1, k)
    fwd = torch.stack([f[:, s - 1:] for f in fwd_t])
    flips = (routed != fwd).any(-1)                      # (layer, b, position)
    # relative norm per (row, position), held where no layer's top-k set
    # differs: a flipped expert is a different function, not noise
    rel = (got - want).norm(dim=-1) / want.norm(dim=-1)  # (b, position)
    clean = ~flips.any(0)
    worst = rel[clean].max().item() if bool(clean.any()) else float("nan")
    print(f"{cfg.name} 12b (capacity factor {free.moe.capacity_factor:g}, drop-free): decode vs "
          f"forward relative norm by (row, position) {[[round(r, 5) for r in row] for row in rel.tolist()]}; "
          f"top-k sets differ at {flips.float().mean().item():.4f} of (layer, row, position), "
          f"{int((~clean).sum())} of {clean.numel()} (row, position) have a flip; max "
          f"{worst:.4e} over the {int(clean.sum())} without (limit {MOE_DECODE_RTOL}), "
          f"{rel.max().item():.4e} over all; argmax agrees at "
          f"{(got.argmax(-1) == want.argmax(-1)).float().mean().item():.3f}", flush=True)
    check(got.shape == want.shape and bool(torch.isfinite(got).all()), "12b: bad logits")
    check(int(clean.sum()) >= clean.numel() // 4,
          f"12b: only {int(clean.sum())} (row, position) without a flip")
    check(worst <= MOE_DECODE_RTOL, f"12b: decode logits off the forward's by {worst:.4e}")


def moe_layer_card_vs_cpu(dev, params, cfg, prompt):
    """12c: MoE layer 0 at full width and the published capacity on
    MOE_LAYER_TOKENS tokens (so copies drop), on the card and on the CPU
    from the same bf16 weights and inputs (``ln2`` of the prompt's
    embeddings). Checks: the kept (token, expert, slot) copies are equal,
    but for copies of tokens at a near-tie of the router (k-th and
    (k+1)-th probability within MOE_ROUTE_GAP, counted); the outputs of
    the tokens whose copies agree within MOE_LAYER_RTOL (relative norm);
    aux within MOE_AUX_ATOL."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import lm, moe

    layer = lm._map(lambda a: a[0], params["blocks_moe"])
    x = L.rmsnorm(params["embed"][prompt[:, :MOE_LAYER_TOKENS // prompt.shape[0]]],
                  layer["ln2"], cfg.norm_eps)
    k, tokens = cfg.moe.top_k, x.shape[0] * x.shape[1]
    runs = []
    for device in (dev, torch.device("cpu")):
        p = lm._map(lambda a: a.to(device), layer["moe"])
        with MoeProbe(keep=True) as probe:
            out, aux = moe.moe_block(p, cfg, x.to(device))
        _, slot, valid, _, tok = (t.cpu() for t in probe.metas[0][:5])
        topi = probe.topi[0].cpu()
        v = valid.reshape(-1)
        runs.append(dict(
            out=out.cpu().reshape(tokens, -1), aux=aux.item(), drop=probe.drop_share(),
            kept=set(zip(tok.reshape(-1)[v].tolist(), slot.reshape(-1)[v].tolist())),
            topi=topi.reshape(tokens, k).sort(-1).values))
    gpu, cpu = runs
    probs = torch.softmax(x.cpu().reshape(tokens, -1).float() @ layer["moe"]["router"].cpu(), -1)
    top = probs.sort(-1, descending=True).values
    gap = top[:, k - 1] - top[:, k]
    cap = moe.capacity(cfg.moe, moe._group_shape(tokens)[1])
    differ = gpu["kept"] ^ cpu["kept"]
    touched = sorted({t for t, _ in differ})
    agree = torch.ones(tokens, dtype=torch.bool)
    agree[touched] = False
    o, co = gpu["out"][agree].float(), cpu["out"][agree].float()
    rel = ((o - co).norm() / co.norm()).item()
    rerouted = int((gpu["topi"] != cpu["topi"]).any(-1).sum())
    print(f"{cfg.name} 12c: one MoE layer on {tokens} tokens (capacity {cap} a group), card vs "
          f"CPU: kept (token, expert, slot) {len(gpu['kept'])} / {len(cpu['kept'])}, "
          f"differing {len(differ)} of {len(touched)} tokens; tokens rerouted {rerouted}; "
          f"near-ties under {MOE_ROUTE_GAP:g}: {int((gap < MOE_ROUTE_GAP).sum())} (smallest gap "
          f"{gap.min().item():.3e}); dropped {gpu['drop']:.4f} / {cpu['drop']:.4f}; output "
          f"relative norm {rel:.4e} over {int(agree.sum())} tokens (limit {MOE_LAYER_RTOL}), "
          f"bit-equal {(gpu['out'] == cpu['out']).float().mean().item():.4f}; aux "
          f"{gpu['aux']:.7f} / {cpu['aux']:.7f} (limit {MOE_AUX_ATOL})", flush=True)
    check(gpu["drop"] > 0, "12c: no copy dropped at the published capacity")
    check(all(bool(gap[t] < MOE_ROUTE_GAP) for t in touched),
          "12c: kept copies differ away from a near-tie of the router")
    check(bool(torch.isfinite(gpu["out"].float()).all()) and rel <= MOE_LAYER_RTOL,
          f"12c: card and CPU outputs differ by {rel:.4e}")
    check(abs(gpu["aux"] - cpu["aux"]) <= MOE_AUX_ATOL, "12c: aux differs")


def mla_prefill_attention(dev, flash, params, cfg, prompt):
    """12d: the dense layer 0's prefill attention at full width on the
    model's own inputs: ``lm._mla_attend`` over the prompt's ``ln1``
    embeddings, its call of ``ops.attention`` recorded (q/k heads of
    nope + rope, v zero-padded to that width). Checks: one launch, on
    the tensor-core entry; the output against ``ref.attention`` on the
    inputs upcast to float32 within FLASH_BF16_RTOL / FLASH_BF16_ATOL;
    the padded columns exactly 0. No routing lies between the two, as it
    does in the whole-model gates."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    m = cfg.mla
    layer = lm._map(lambda a: a[0], params["blocks_dense"])
    h = L.rmsnorm(params["embed"][prompt], layer["ln1"], cfg.norm_eps)
    positions = torch.arange(prompt.shape[1], dtype=torch.int32, device=dev)[None, :]
    calls, attention = [], ops.attention

    def recorded(q, k, v, **kw):
        out = attention(q, k, v, **kw)
        calls.append((q, k, v, kw, out))
        return out

    flash.reset()
    ops.attention = recorded
    try:
        lm._mla_attend(layer["attn"], cfg, h, positions, "train")
    finally:
        ops.attention = attention
    torch.cuda.synchronize()
    took = {k: n for k, n in flash.symbol_launches.items() if n}
    check(len(calls) == 1 and took == {TC_SYMBOL: 1},
          f"12d layer 0: {len(calls)} ops.attention calls, flash launches {took}")
    q, k, v, kw, got = calls[0]
    vd = m.v_head_dim
    check(tuple(q.shape[-1:]) == (m.qk_nope_head_dim + m.qk_rope_head_dim,)
          and bool((v[..., vd:] == 0).all()), "12d layer 0: not MLA's padded attention")
    want = ref.attention(q.float(), k.float(), v.float(), **kw)
    diff = (got.float() - want).abs()
    pad_zero = bool((got[..., vd:] == 0).all()) and bool((want[..., vd:] == 0).all())
    print(f"{cfg.name} 12d layer 0 prefill attention q{tuple(q.shape)} v{tuple(v.shape)}: "
          f"against float32 upcast inputs max_abs_err {diff.max().item():.3e}, relative norm "
          f"{(diff.norm() / want.norm()).item():.3e} (rtol {FLASH_BF16_RTOL:.3e}, atol "
          f"{FLASH_BF16_ATOL:.0e}); columns {vd}-{q.shape[-1] - 1} exactly 0: {pad_zero}; "
          f"launches {took}", flush=True)
    check(torch.allclose(got.float(), want, atol=FLASH_BF16_ATOL, rtol=FLASH_BF16_RTOL),
          f"12d layer 0: prefill attention off the float32 version by {diff.max().item()}")
    check(pad_zero, "12d layer 0: the padded columns of the attention are not 0")
    del calls, q, k, v, got, want, diff
    torch.cuda.empty_cache()


def phase_moe_serving(dev, flash):
    """Phase 12: qwen2-moe (12a-12c) and deepseek-v2-lite (12d) at full
    width, then the reduced configs card vs CPU (12e) -> flash launches
    by entry in 12a and 12d's serving runs."""
    import torch
    entries = {}
    t0 = time.perf_counter()
    params, cfg, prompt, routes, _ = serve_full_width(dev, flash, "qwen2-moe-a2.7b", TC_SYMBOL)
    entries.update(routes)
    print(f"phase 12a: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    moe_decode_vs_forward(dev, params, cfg, prompt)
    print(f"phase 12b: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    moe_layer_card_vs_cpu(dev, params, cfg, prompt)
    print(f"phase 12c: {time.perf_counter() - t0:.1f} s", flush=True)
    del params, prompt
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    params, cfg, prompt, routes, (tok, cache, pos, absorbed) = serve_full_width(
        dev, flash, "deepseek-v2-lite-16b", TC_SYMBOL)
    for sym, n in routes.items():
        entries[sym] = entries.get(sym, 0) + n
    mla_prefill_attention(dev, flash, params, cfg, prompt)
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    naive, _ = lm.decode_step(params, cfg, tok, cache, pos, absorb=False)
    rel = ((naive.float() - absorbed.float()).norm() / absorbed.float().norm()).item()
    # the dense layer 0's attention alone, both ways, on its decode input
    # and cache: no MoE routing between the two paths
    layer = lm._map(lambda a: a[0], params["blocks_dense"])
    c0 = lm._map(lambda a: a[0], cache["blocks_dense"])
    h = L.rmsnorm(params["embed"][tok], layer["ln1"], cfg.norm_eps)
    at = torch.full(tok.shape, pos, dtype=torch.int32, device=dev)
    a_abs, a_naive = (lm._mla_attend(layer["attn"], cfg, h, at, "decode", c0, pos, absorb=a)
                      for a in (True, False))
    rel0 = ((a_naive.float() - a_abs.float()).norm() / a_abs.float().norm()).item()
    m = cfg.mla
    mla_bytes = 2 * (m.kv_lora_rank + m.qk_rope_head_dim)
    gqa_bytes = 2 * 2 * cfg.n_kv_heads * cfg.head_dim
    print(f"{cfg.name} 12d: the last step naive (expanded cache) vs absorbed: logits relative "
          f"norm {rel:.4e} (limit {MLA_ABSORB_RTOL}), argmax agrees "
          f"{(naive.argmax(-1) == absorbed.argmax(-1)).float().mean().item():.3f}; layer 0's "
          f"attention alone {rel0:.4e} (limit {MLA_LAYER_RTOL}); cache "
          f"{mla_bytes} bytes a token a layer ({mla_bytes * cfg.n_layers} over {cfg.n_layers} "
          f"layers) against {gqa_bytes} for a GQA cache of the same widths", flush=True)
    check(rel0 <= MLA_LAYER_RTOL, f"12d: layer 0's naive and absorbed attention differ by {rel0:.4e}")
    check(rel <= MLA_ABSORB_RTOL, f"12d: naive and absorbed decode differ by {rel:.4e}")
    del params, prompt, cache, tok, absorbed, naive, c0, layer
    torch.cuda.empty_cache()
    print(f"phase 12d: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    for arch, absorb in (("qwen2-moe-a2.7b", True), ("deepseek-v2-lite-16b", True),
                         ("deepseek-v2-lite-16b", False)):
        phase_lm_cuda_vs_cpu(dev, flash, arch, absorb)
    print(f"phase 12e: {time.perf_counter() - t0:.1f} s", flush=True)
    return entries


# ---------------------------------------------------------------------------
# phase 13: vision serving
# ---------------------------------------------------------------------------

def vision_gflop(cfg, img_res: int) -> float:
    """Matmul and conv GFLOP of one image's forward, the reference's
    formulas (repro/launch/steps.py ``_vit_fwd_flops``,
    ``_convnext_fwd_flops``, ``_resnet_fwd_flops``)."""
    if cfg.kind == "vit":
        t = (img_res // cfg.patch) ** 2 + 1
        d, f = cfg.d_model, cfg.d_ff
        patch = 2.0 * (img_res // cfg.patch) ** 2 * cfg.patch ** 2 * 3 * d
        blk = 2.0 * t * (4 * d * d + 2 * d * f) + 4.0 * t * t * d
        return (patch + cfg.n_layers * blk + 2.0 * d * cfg.n_classes) / 1e9
    if cfg.kind == "convnext":
        r = img_res // 4
        total = 2.0 * r * r * 4 * 4 * 3 * cfg.dims[0]
        for i, (dep, dim) in enumerate(zip(cfg.depths, cfg.dims)):
            total += dep * 2.0 * r * r * (49 * dim + 8 * dim * dim)
            if i + 1 < len(cfg.dims):
                total += 2.0 * (r // 2) ** 2 * 4 * dim * cfg.dims[i + 1]
                r //= 2
        return (total + 2.0 * cfg.dims[-1] * cfg.n_classes) / 1e9
    w, r = cfg.width, img_res // 2
    total = 2.0 * r * r * 49 * 3 * w
    r //= 2  # maxpool
    c_in = w
    for i, dep in enumerate(cfg.depths):
        mid = w * (2 ** i)
        out = mid * 4
        if i > 0:
            r //= 2
        for b in range(dep):
            total += 2.0 * r * r * (c_in * mid + 9 * mid * mid + mid * out)
            if b == 0:
                total += 2.0 * r * r * c_in * out  # projection
            c_in = out
    return (total + 2.0 * c_in * cfg.n_classes) / 1e9


def vision_model(cfg):
    from repro_torch.models import convnext, resnet, vit
    return {"vit": vit, "convnext": convnext, "resnet": resnet}[cfg.kind]


def vision_forward(mod, cfg, params, images, train=False):
    """Logits (and for ResNet the new running statistics, else None)."""
    if cfg.kind == "resnet":
        return mod.forward(*params, cfg, images, train=train)
    return mod.forward(params, cfg, images), None


def attention_vs_upcast(label, flash, q, k, v):
    """One non-causal ``ops.attention`` call on the model's own bf16 q, k
    and v: one launch, on the tensor-core entry; the output against
    ``ref.attention`` on the inputs upcast to float32 within
    FLASH_BF16_RTOL / FLASH_BF16_ATOL (checked) -> the output."""
    import torch
    from repro_torch.kernels import ops, ref
    flash.reset()
    got = ops.attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    took = {s: n for s, n in flash.symbol_launches.items() if n}
    want = ref.attention(q.float(), k.float(), v.float(), causal=False)
    diff = (got.float() - want).abs()
    print(f"{label} q{tuple(q.shape)} kv{tuple(k.shape)}: against float32 upcast inputs "
          f"max_abs_err {diff.max().item():.3e}, relative norm "
          f"{(diff.norm() / want.norm()).item():.3e} (rtol {FLASH_BF16_RTOL:.3e}, atol "
          f"{FLASH_BF16_ATOL:.0e}); launches {took}", flush=True)
    check(took == {TC_SYMBOL: 1}, f"{label}: flash launches {took}")
    check(got.shape == q.shape and torch.allclose(got.float(), want, atol=FLASH_BF16_ATOL,
                                                  rtol=FLASH_BF16_RTOL),
          f"{label}: attention off the float32 version by {diff.max().item()}")
    del want, diff
    torch.cuda.empty_cache()
    return got


def vit_layer0_attention(dev, flash, params, cfg, images):
    """Layer 0's attention on the model's own q, k and v (``vit.embed``,
    ``vit.attention_inputs``) against the float32 version."""
    from repro_torch.models import vit
    layer = {k: a[0] for k, a in params["blocks"].items()}
    q, k, v = vit.attention_inputs(layer, cfg, vit.embed(params, cfg, images))
    attention_vs_upcast(f"{cfg.name} layer 0 attention", flash, q, k, v)


def vision_serve(dev, flash, arch):
    """One model at full width on serve_b128 (bf16, seeded weights drawn
    on the card): a warm-up forward, the counted forward (flash launches
    by entry: one a layer on the tensor-core entry for a ViT, none for a
    convnet; checked), VISION_REPS timed forwards (CUDA events), a second
    forward bit-equal, ``LaunchGuard`` over a steady forward after an
    emptied allocator cache and 2 warm-ups (checked) -> (flash launches
    by entry in the counted forward, params, images)."""
    import torch
    from repro_torch import tree
    from repro_torch.analysis import LaunchGuard
    from repro_torch.configs import get_config, get_shape

    cfg = get_config(arch)
    shape = get_shape(arch, "serve_b128")
    b, res = shape.global_batch, shape.img_res
    mod = vision_model(cfg)
    g = torch.Generator(device=dev).manual_seed(SEED)
    params, init_s = synced(lambda: mod.init(g, cfg, device=dev))
    weight_gb = sum(t.numel() * t.element_size() for t in tree.leaves(params)) / 1e9
    images = torch.randn((b, res, res, 3), generator=g, device=dev)
    vision_forward(mod, cfg, params, images)   # warm-up: cuBLAS, cuDNN, kernel load
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash.reset()
    (logits, _), first_s = synced(lambda: vision_forward(mod, cfg, params, images))
    routes = {k: n for k, n in flash.symbol_launches.items() if n}
    want = {TC_SYMBOL: cfg.n_layers} if cfg.kind == "vit" else {}
    check(routes == want, f"{arch}: flash_attention launches by entry {routes}, not {want}")
    check(logits.shape == (b, cfg.n_classes) and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()), f"{arch}: bad logits")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    events = [torch.cuda.Event(enable_timing=True) for _ in range(VISION_REPS + 1)]
    events[0].record()
    for e in events[1:]:
        vision_forward(mod, cfg, params, images)
        e.record()
    torch.cuda.synchronize()
    ms = [a.elapsed_time(e) for a, e in zip(events, events[1:])]
    mean_ms = sum(ms) / len(ms)
    gflop = vision_gflop(cfg, res) * b
    bound = 1e3 * gflop * 1e9 / BF16_FLOPS
    again, _ = vision_forward(mod, cfg, params, images)
    same = bit_equal(again, logits)
    del again
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for _ in range(GUARD_WARMUP):
        vision_forward(mod, cfg, params, images)
    torch.cuda.synchronize()
    with LaunchGuard(f"{arch} serve_b128 forward") as guard:
        vision_forward(mod, cfg, params, images)
    torch.cuda.synchronize()
    print(f"{arch}: {cfg.n_params / 1e6:.1f} M params, {weight_gb:.3f} GB of bf16 weights drawn "
          f"in {init_s:.2f} s; serve_b128 (B {b}, {res} px): {mean_ms:.4f} ms a batch (runs "
          f"{', '.join(f'{t:.4f}' for t in ms)}; first {1e3 * first_s:.4f} ms host-timed), "
          f"{1e3 * b / mean_ms:.1f} images/s; {gflop / 1e3:.4f} TFLOP a batch, bf16 bound "
          f"{bound:.4f} ms, share {bound / mean_ms:.3f}; peak memory {peak_gb:.2f} GB; "
          f"flash_attention launches by entry {routes}; second forward bit-equal {same}",
          flush=True)
    print(f"guard {guard.label}: builds {guard.builds} new segments {guard.new_segments} syncs "
          f"{guard.syncs}; launches by entry {json.dumps(guard.launches)}", flush=True)
    check(same, f"{arch}: a second forward's logits differ")
    guard.assert_steady_state()
    return routes, params, images


def vision_cuda_vs_cpu(dev, arch):
    """Full width in float32 on 2 images: the same seeded weights (drawn
    on the card, copied to the CPU) and images on the card and on the
    CPU; the logits' relative norm within VISION_F32_RTOL; ResNet also
    ``train=True``: logits and every running-statistic leaf within
    VISION_TRAIN_SENS times the CPU's own change when every input pixel
    moves by one float32 ulp."""
    import dataclasses
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch), param_dtype="float32")
    mod = vision_model(cfg)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    p_gpu = mod.init(g, cfg, device=dev)
    images = torch.randn((2, cfg.img_res, cfg.img_res, 3), generator=g, device=dev)
    p_cpu, img_cpu = tree.from_numpy(p_gpu, "cpu"), images.cpu()

    def rel(a, b):
        return ((a.cpu().double() - b.double()).norm() / b.double().norm()).item()
    modes = (False, True) if cfg.kind == "resnet" else (False,)
    for train in modes:
        (got, s_gpu), (want, s_cpu) = (vision_forward(mod, cfg, p, x, train)
                                       for p, x in ((p_gpu, images), (p_cpu, img_cpu)))
        errs = [rel(got, want)]
        limit, why = VISION_F32_RTOL, ""
        if train:
            errs += [rel(a, b) for a, b in zip(tree.leaves(s_gpu), tree.leaves(s_cpu))]
            ulp = torch.where(torch.rand(img_cpu.shape, generator=torch.Generator().manual_seed(
                SEED)) < 0.5, -(2.0 ** -23), 2.0 ** -23)
            moved, s_moved = vision_forward(mod, cfg, p_cpu, img_cpu * (1 + ulp), True)
            sens = max([rel(moved, want)] + [rel(a, b) for a, b in zip(tree.leaves(s_moved),
                                                                       tree.leaves(s_cpu))])
            limit = VISION_TRAIN_SENS * sens
            why = (f" = {VISION_TRAIN_SENS:g} x the CPU's own change under a one-ulp input "
                   f"perturbation, {sens:.3e}")
        print(f"{arch} float32 card vs CPU (2 images{', train=True' if train else ''}): "
              f"logits relative norm {errs[0]:.3e}"
              + (f", {len(errs) - 1} running-statistic leaves max {max(errs[1:]):.3e}"
                 if train else "") + f" (limit {limit:.3e}{why})", flush=True)
        check(max(errs) <= limit, f"{arch}{' train=True' if train else ''}: card and CPU "
                                  f"differ by {max(errs):.3e}")
    del p_gpu, images
    torch.cuda.empty_cache()


def phase_vision_serving(dev, flash):
    """Phase 13 -> flash launches by entry in the four serve_b128
    forwards (the main path's)."""
    import torch
    from repro_torch.configs import get_config, get_shape
    entries = {}
    for arch in VISION_ARCHS:
        t0 = time.perf_counter()
        routes, params, images = vision_serve(dev, flash, arch)
        for sym, n in routes.items():
            entries[sym] = entries.get(sym, 0) + n
        cfg = get_config(arch)
        if cfg.kind == "vit":
            vit_layer0_attention(dev, flash, params, cfg, images)
        if arch == "vit-h14":
            mod = vision_model(cfg)
            kernels = profile_step(f"{arch} serve_b128 forward",
                                   lambda: mod.forward(params, cfg, images))
            busy = sum(e.self_device_time_total for e in kernels)
            attn = sum(e.self_device_time_total for e in kernels if "flash" in e.key)
            print(f"{arch} serve_b128: flash_attention {attn / 1e3:.4f} ms of {busy / 1e3:.4f} "
                  f"ms of device time ("
                  + (f"{attn / busy:.3f})" if busy else "not measured: the profiler saw no "
                     "device time)"), flush=True)
        if arch == "vit-l16":
            shape = get_shape(arch, "cls_384")
            mod = vision_model(cfg)
            x = torch.randn((shape.global_batch, shape.img_res, shape.img_res, 3),
                            generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
            mod.forward(params, cfg, x)
            flash.reset()
            out, took_s = synced(lambda: mod.forward(params, cfg, x))
            took = {k: n for k, n in flash.symbol_launches.items() if n}
            tokens = (shape.img_res // cfg.patch) ** 2 + 1
            print(f"{arch} at cls_384's resolution ({shape.img_res} px, {tokens} tokens), B "
                  f"{shape.global_batch}: {1e3 * took_s:.4f} ms, "
                  f"{shape.global_batch / took_s:.1f} images/s; flash launches {took}",
                  flush=True)
            check(took == {TC_SYMBOL: cfg.n_layers} and out.shape == (shape.global_batch,
                                                                      cfg.n_classes)
                  and bool(torch.isfinite(out).all()), f"{arch} cls_384: launches {took}")
            del x, out
        del params, images
        torch.cuda.empty_cache()
        print(f"phase 13 {arch}: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    for arch in VISION_ARCHS:
        vision_cuda_vs_cpu(dev, arch)
    print(f"phase 13 card vs CPU: {time.perf_counter() - t0:.1f} s", flush=True)
    return entries


# ---------------------------------------------------------------------------
# phase 14: diffusion serving
# ---------------------------------------------------------------------------

def diffusion_gflop(cfg, img_res: int) -> float:
    """Matmul, conv and attention GFLOP of one latent's forward, the
    reference's formulas (repro/launch/steps.py ``_dit_fwd_flops``,
    ``_unet_fwd_flops``). The UNet's is the reference's own
    approximation: it prices the transformer blocks' projections as 8
    c x c products a token, counts the cross-attention's k and v
    products a block, and leaves out norms and elementwise work."""
    lr = img_res // cfg.latent_factor
    if cfg.kind == "dit":
        t = (lr // cfg.patch) ** 2
        d = cfg.d_model
        # adaLN conditioning is per image (B, 6d), not per token
        blk = 2.0 * t * (4 * d * d + 8 * d * d) + 4.0 * t * t * d + 2.0 * 6 * d * d
        io = 2.0 * t * (cfg.patch ** 2 * cfg.latent_ch * d * 3)
        return (cfg.n_layers * blk + io) / 1e9
    ch = cfg.ch
    chans = [ch * m for m in cfg.ch_mult]

    def res_block(hw, cin, cout):
        f = 2.0 * hw * 9 * (cin * cout + cout * cout) + 2.0 * hw * 4 * ch * cout
        return f + (2.0 * hw * cin * cout if cin != cout else 0.0)

    def attn_block(hw, c):
        proj = 2.0 * hw * c * c * (3 + 1 + 1 + 1 + 2)
        sa = 4.0 * hw * hw * c
        ca = 4.0 * hw * cfg.ctx_len * c + 2.0 * cfg.ctx_len * cfg.ctx_dim * c * 2
        return proj + sa + ca + 2.0 * hw * (8 * c * c + 4 * c * c)

    total = 2.0 * lr * lr * 9 * cfg.latent_ch * ch
    r, prev = lr, ch
    for lvl, c in enumerate(chans):
        for _ in range(cfg.n_res_blocks):
            total += res_block(r * r, prev, c)
            if lvl in cfg.attn_levels:
                total += attn_block(r * r, c)
            prev = c
        if lvl + 1 < len(chans):
            r //= 2
            total += 2.0 * r * r * 9 * c * c
    total += 2 * res_block(r * r, chans[-1], chans[-1]) + attn_block(r * r, chans[-1])
    for lvl in reversed(range(len(chans))):
        c = chans[lvl]
        for _ in range(cfg.n_res_blocks + 1):
            total += res_block(r * r, c + prev, c)
            if lvl in cfg.attn_levels:
                total += attn_block(r * r, c)
            prev = c
        if lvl > 0:
            r *= 2
            total += 2.0 * r * r * 9 * c * c
    return (total + 2.0 * lr * lr * 9 * ch * cfg.latent_ch) / 1e9


def diffusion_model(cfg):
    from repro_torch.models import dit, unet
    return dit if cfg.kind == "dit" else unet


def diffusion_flash_per_forward(cfg) -> int:
    """flash_attention launches a forward: one a DiT layer; a self- and a
    cross-attention a UNet transformer block (n_res_blocks a level on the
    way down, n_res_blocks + 1 on the way up, one in the mid block)."""
    if cfg.kind == "dit":
        return cfg.n_layers
    return 2 * (len(cfg.attn_levels) * (2 * cfg.n_res_blocks + 1) + 1)


def attention_shapes(fn) -> list:
    """(Sq, Skv) of each ``ops.attention`` call in ``fn()``, through a
    wrapper put in its place for the call (kept out of the timed runs)."""
    from repro_torch.kernels import ops
    seen, attention = [], ops.attention

    def probe(q, k, v, causal=False):
        seen.append((q.shape[1], k.shape[1]))
        return attention(q, k, v, causal=causal)
    ops.attention = probe
    try:
        fn()
    finally:
        ops.attention = attention
    return seen


def diffusion_eps(cfg, params, cond):
    """The sampler's eps_fn(x, t) of a model and its conditioning (class
    ids or a text context): DiT's eps without its sigma."""
    mod = diffusion_model(cfg)
    if cfg.kind == "dit":
        return lambda x, t: mod.forward(params, cfg, x, t, cond)[0]
    return lambda x, t: mod.forward(params, cfg, x, t, cond)


def diffusion_setup(dev, cfg, b, res, seed):
    """Seeded weights drawn on ``dev`` (DiT's adaLN-Zero leaves, which
    ``init`` zeroes, drawn as the rest, truncated normals of 0.02: with
    them at 0 the model's output is exactly 0 and no check would see its
    blocks), starting noise (B, res / 8, res / 8, 4) float32 and the
    conditioning (class ids, or a (B, 77, 768) text context) -> (params,
    noise, conditioning)."""
    import torch
    from repro_torch.models import dit
    from repro_torch.models import layers as L
    mod = diffusion_model(cfg)
    g = torch.Generator(device=dev).manual_seed(seed)
    params = mod.init(g, cfg, device=dev)
    if cfg.kind == "dit":
        block_leaves, top_leaves = dit.ADALN_ZERO
        for tree_, keys in ((params["blocks"], block_leaves), (params, top_leaves)):
            for k in keys:
                tree_[k] = L.truncated_normal(g, tuple(tree_[k].shape), 0.02, tree_[k].dtype)
    lr = res // cfg.latent_factor
    noise = torch.randn((b, lr, lr, cfg.latent_ch), generator=g, device=dev)
    if cfg.kind == "dit":
        return params, noise, torch.randint(0, cfg.n_classes, (b,), generator=g, device=dev)
    return params, noise, torch.randn((b, cfg.ctx_len, cfg.ctx_dim), generator=g, device=dev)


def diffusion_gen(dev, flash, arch, shape_name, n_steps=None):
    """One model at full width on a DIFFUSION_SHAPES gen cell (bf16,
    seeded weights drawn on the card): a warm-up step, then the counted
    sample (``n_steps`` of the cell's table, all by default; flash
    launches by entry checked: ``diffusion_flash_per_forward`` a step,
    all on the tensor-core entry), each step timed by CUDA events, the
    samples finite and moved off the noise -> (launches by entry, ms of
    each step, peak GB, params, noise, eps_fn)."""
    import torch
    from repro_torch.configs import get_config, get_shape
    from repro_torch.models import diffusion
    cfg = get_config(arch)
    shape = get_shape(arch, shape_name)
    b, res = shape.global_batch, shape.img_res
    n = n_steps or shape.steps
    ts = diffusion.timesteps(shape.steps)
    params, noise, cond = diffusion_setup(dev, cfg, b, res, SEED)
    eps_fn = diffusion_eps(cfg, params, cond)
    diffusion.ddim_step(eps_fn, noise, ts[0], ts[1])   # warm-up: cuBLAS, cuDNN, kernel load
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash.reset()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    events[0].record()
    x = noise
    for i in range(n):
        x = diffusion.ddim_step(eps_fn, x, ts[i], ts[i + 1])
        events[i + 1].record()
    torch.cuda.synchronize()
    ms = [a.elapsed_time(e) for a, e in zip(events, events[1:])]
    routes = {k: v for k, v in flash.symbol_launches.items() if v}
    want = {TC_SYMBOL: diffusion_flash_per_forward(cfg) * n}
    check(routes == want, f"{arch} {shape_name}: flash launches by entry {routes}, not {want}")
    check(x.shape == noise.shape and x.dtype == torch.float32 and bool(torch.isfinite(x).all())
          and (x - noise).abs().max().item() > 0.1, f"{arch} {shape_name}: bad sample")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mean_ms = sum(ms) / len(ms)
    gflop = diffusion_gflop(cfg, res) * b
    bound = 1e3 * gflop * 1e9 / BF16_FLOPS
    cut = "" if n == shape.steps else f" (the first {n} of its {shape.steps} steps)"
    print(f"{arch} {shape_name} (B {b}, {res} px, {(res // cfg.latent_factor) ** 2} latent "
          f"pixels, {shape.steps} steps){cut}: {mean_ms:.4f} ms a step (steps "
          f"{', '.join(f'{t:.4f}' for t in ms)}), {sum(ms):.4f} ms for {n} steps"
          + (f", {1e3 * b / sum(ms):.2f} images/s" if n == shape.steps else "")
          + f"; {gflop / 1e3:.4f} TFLOP a step, bf16 bound {bound:.4f} ms, share "
          f"{bound / mean_ms:.3f}; peak memory {peak_gb:.2f} GB; flash_attention launches by "
          f"entry {routes}", flush=True)
    return routes, ms, params, noise, eps_fn


def diffusion_serve(dev, flash, arch):
    """Phase 14a: gen_fast uncut (16 latents of 512 px, 4 DDIM steps):
    ``diffusion_gen``, a second sample from the same noise bit-equal,
    ``LaunchGuard`` over a steady step after an emptied allocator cache
    and 2 warm-up steps (checked), and for the UNet one step under
    torch.profiler -> (flash launches by entry, params, noise, eps_fn)."""
    import torch
    from repro_torch import tree
    from repro_torch.analysis import LaunchGuard
    from repro_torch.configs import get_config, get_shape
    from repro_torch.models import diffusion
    cfg = get_config(arch)
    n = get_shape(arch, "gen_fast").steps
    routes, ms, params, noise, eps_fn = diffusion_gen(dev, flash, arch, "gen_fast")
    weight_gb = sum(t.numel() * t.element_size() for t in tree.leaves(params)) / 1e9
    first = diffusion.sample(eps_fn, noise, n)
    again = diffusion.sample(eps_fn, noise, n)
    same = bit_equal(again, first)
    del first, again
    ts = diffusion.timesteps(n)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for _ in range(GUARD_WARMUP):
        diffusion.ddim_step(eps_fn, noise, ts[0], ts[1])
    torch.cuda.synchronize()
    with LaunchGuard(f"{arch} gen_fast DDIM step") as guard:
        diffusion.ddim_step(eps_fn, noise, ts[0], ts[1])
    torch.cuda.synchronize()
    n_tree = sum(t.numel() for t in tree.leaves(params))
    print(f"{arch}: {n_tree / 1e6:.1f} M params ({cfg.n_params / 1e6:.1f} M by the "
          f"reference's count), {weight_gb:.3f} GB of bf16 weights; gen_fast: {sum(ms):.4f} ms a sample of {noise.shape[0]}; "
          f"second sample bit-equal {same}", flush=True)
    print(f"guard {guard.label}: builds {guard.builds} new segments {guard.new_segments} syncs "
          f"{guard.syncs}; launches by entry {json.dumps(guard.launches)}", flush=True)
    check(same, f"{arch}: a second sample from the same noise differs")
    guard.assert_steady_state()
    t = torch.full((noise.shape[0],), ts[0], dtype=torch.int32, device=dev)
    calls = attention_shapes(lambda: eps_fn(noise, t))
    n_self = sum(sq == skv for sq, skv in calls)
    n_cross = sum(skv == cfg.ctx_len for _, skv in calls) if cfg.kind == "unet" else 0
    print(f"{arch} forward: {len(calls)} attention calls, {n_self} self-attention (Sq = Skv), "
          f"{n_cross} cross-attention (Skv {cfg.ctx_len})", flush=True)
    n = diffusion_flash_per_forward(cfg)
    want = (n, 0) if cfg.kind == "dit" else (n // 2, n // 2)
    check(len(calls) == sum(want) and (n_self, n_cross) == want,
          f"{arch}: attention calls {calls}, not {want[0]} self and {want[1]} cross")
    if cfg.kind == "unet":
        kernels = profile_step(f"{arch} gen_fast DDIM step",
                               lambda: diffusion.ddim_step(eps_fn, noise, ts[0], ts[1]))
        busy = sum(e.self_device_time_total for e in kernels)
        attn = sum(e.self_device_time_total for e in kernels if "flash" in e.key)
        print(f"{arch} gen_fast step: flash_attention {attn / 1e3:.4f} ms of {busy / 1e3:.4f} "
              f"ms of device time ("
              + (f"{attn / busy:.3f})" if busy else "not measured: the profiler saw no "
                 "device time)"), flush=True)
    return routes, params, noise, eps_fn


def diffusion_layer0_attention(dev, flash, params, cfg, noise):
    """Phase 14c: the first attention of each kind on the model's own q,
    k and v against the float32 version (``attention_vs_upcast``): DiT's
    layer 0 self-attention; the UNet's first transformer block (level 0,
    4096 tokens, 5 heads), its self-attention and its cross-attention to
    the 77 context keys (Sq 4096 >> Skv 77, a partial last key tile)."""
    import torch
    from repro_torch.models import dit, unet
    from repro_torch.models import layers as L
    b = noise.shape[0]
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    t = torch.full((b,), 999, dtype=torch.int32, device=dev)
    if cfg.kind == "dit":
        y = torch.randint(0, cfg.n_classes, (b,), generator=g, device=dev)
        x, cond = dit.embed(params, cfg, noise, t, y)
        p = {k: a[0] for k, a in params["blocks"].items()}
        ada = L.silu(cond) @ p["ada_w"] + p["ada_b"]
        sh1, sc1 = torch.chunk(ada, 6, dim=-1)[:2]
        q, k, v = dit.attention_inputs(dit._modulate(dit._ln(x), sh1, sc1), p["wqkv"],
                                       cfg.n_heads)
        attention_vs_upcast(f"{cfg.name} layer 0 self-attention", flash, q, k, v)
        return
    ctx = torch.randn((b, cfg.ctx_len, cfg.ctx_dim), generator=g, device=dev)
    blk = params["down"][0]["blocks"][0]
    h = L.conv2d(noise.to(params["conv_in"].dtype), params["conv_in"])
    h = unet._res(blk["res"], h, unet.time_embedding(params, cfg, t))
    p = blk["attn"]
    tokens = unet.xformer_tokens(p, h)
    a = attention_vs_upcast(f"{cfg.name} block 0 self-attention", flash,
                            *unet.self_attention_inputs(p, tokens))
    tokens = tokens + a.reshape(tokens.shape) @ p["sa_o"]
    attention_vs_upcast(f"{cfg.name} block 0 cross-attention", flash,
                        *unet.cross_attention_inputs(p, tokens, ctx))


def diffusion_cuda_vs_cpu(dev, arch):
    """Phase 14d: full width in float32 on 2 latents of 256 px, one DDIM
    step (999 -> 749 of a 4-step table): the same seeded weights (drawn
    on the card, copied to the CPU), noise and conditioning on the card
    and on the CPU; the eps and the step's output within
    DIFFUSION_F32_RTOL (relative norm)."""
    import dataclasses
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models import diffusion
    cfg = dataclasses.replace(get_config(arch), param_dtype="float32")
    p_gpu, noise, cond = diffusion_setup(dev, cfg, 2, 256, SEED + 1)
    ts = diffusion.timesteps(4)

    def run(p, x, c):
        eps_fn = diffusion_eps(cfg, p, c)
        t = torch.full((2,), ts[0], dtype=torch.int32, device=x.device)
        return eps_fn(x, t), diffusion.ddim_step(eps_fn, x, ts[0], ts[1])

    got = run(p_gpu, noise, cond)
    want = run(tree.from_numpy(p_gpu, "cpu"), noise.cpu(), cond.cpu())
    errs = [((a.cpu().double() - w.double()).norm() / w.double().norm()).item()
            for a, w in zip(got, want)]
    print(f"{arch} float32 card vs CPU (2 latents of 256 px, one DDIM step {ts[0]} -> "
          f"{ts[1]}): eps relative norm {errs[0]:.3e}, step output {errs[1]:.3e} (limit "
          f"{DIFFUSION_F32_RTOL:.0e})", flush=True)
    check(max(errs) <= DIFFUSION_F32_RTOL, f"{arch}: card and CPU differ by {max(errs):.3e}")
    del p_gpu, noise, cond, got
    torch.cuda.empty_cache()


def phase_diffusion_serving(dev, flash):
    """Phase 14 -> flash launches by entry in the gen_fast and gen_1024
    samples (the main path's)."""
    import torch
    from repro_torch.configs import get_config
    entries = {}

    def count(routes):
        for sym, n in routes.items():
            entries[sym] = entries.get(sym, 0) + n
    for arch in DIFFUSION_ARCHS:
        t0 = time.perf_counter()
        routes, params, noise, _ = diffusion_serve(dev, flash, arch)
        count(routes)
        diffusion_layer0_attention(dev, flash, params, get_config(arch), noise)
        del params, noise
        torch.cuda.empty_cache()
        print(f"phase 14a/c {arch}: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        steps = None if arch == "dit-s2" else GEN1024_UNET_STEPS
        count(diffusion_gen(dev, flash, arch, "gen_1024", steps)[0])
        torch.cuda.empty_cache()
        print(f"phase 14b {arch}: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    for arch in DIFFUSION_ARCHS:
        diffusion_cuda_vs_cpu(dev, arch)
    print(f"phase 14d card vs CPU: {time.perf_counter() - t0:.1f} s", flush=True)
    return entries


# ---------------------------------------------------------------------------
# phase 15: vision and diffusion training
# ---------------------------------------------------------------------------

def lm_train_gflop(cfg, b: int, s: int) -> float:
    """A training step's GFLOP by the reference's ``model_flops``
    (repro/launch/steps.py): 3x the forward's, 2 FLOPs an active
    parameter a token plus causal attention's used half, L B S^2 H
    (qk + v head dims)."""
    if cfg.mla is None:
        qk = v = cfg.head_dim
    else:
        qk, v = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim, cfg.mla.v_head_dim
    fwd = 2.0 * cfg.n_active_params * b * s + cfg.n_layers * b * s * s * cfg.n_heads * (qk + v)
    return 3.0 * fwd / 1e9


def zoo_attentions(cfg):
    """-> (flash_attention calls a training forward makes, those the
    remat recompute makes again): one a ViT or DiT layer, the UNet's
    ``diffusion_flash_per_forward`` (its mid block's self- and
    cross-attention are not rematerialized, as in the reference), none in
    a convnet."""
    if cfg.kind in ("convnext", "resnet"):
        return 0, 0
    n = cfg.n_layers if cfg.kind in ("vit", "dit") else diffusion_flash_per_forward(cfg)
    if cfg.remat == "none":
        return n, 0
    return n, n - 2 if cfg.kind == "unet" else n


def zoo_gflop(cfg, res: int) -> float:
    """The forward's matmul, conv and attention GFLOP of one image of
    ``res`` px (``vision_gflop``, ``diffusion_gflop``)."""
    return (vision_gflop if cfg.family == "vision" else diffusion_gflop)(cfg, res)


def zoo_setup(dev, cfg, b, res, seed):
    """Seeded weights on ``dev`` (ResNet's with its running statistics;
    DiT's adaLN-Zero leaves drawn as ``diffusion_setup`` draws them), the
    optimizer and one fixed batch of ``res`` px images -> (run(state) ->
    (state, loss), state), ``state`` the trees a step updates."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import diffusion
    g = torch.Generator(device=dev).manual_seed(seed)
    if cfg.family == "diffusion":
        opt_init, step = steps.diffusion_train(cfg, donate=True)
        params, latents, cond = diffusion_setup(dev, cfg, b, res, seed)
        batch = (latents, cond, *diffusion.draw_train_inputs(latents, g))
    else:
        opt_init, step = steps.vision_train(cfg, donate=True)
        params = vision_model(cfg).init(g, cfg, device=dev)
        batch = (torch.randn((b, res, res, 3), generator=g, device=dev),
                 torch.randint(0, cfg.n_classes, (b,), generator=g, device=dev))
    if cfg.kind == "resnet":
        params, bn = params
        state = (params, bn, opt_init(params))
    else:
        state = (params, opt_init(params))

    def run(st):
        *st, loss = step(*st, *batch)
        return tuple(st), loss
    return run, state


def zoo_train(dev, kernels, arch):
    """One model's training at full width on its training shape: ZOO_STEPS
    steps on one batch (see ZOO_STEPS), flash launches by entry in step 1
    checked against the attentions a step (each forward once and again in
    the remat recompute, each backward entry once), 0 builds and 0 new
    segments under LaunchGuard, the loss falling -> launches by entry in
    step 1 (the main path's)."""
    import torch
    from repro_torch import tree
    from repro_torch.analysis import LaunchGuard
    from repro_torch.configs import get_config, get_shape
    from repro_torch.kernels import flash_attention as fa
    cfg = get_config(arch)
    shape = get_shape(arch, ZOO_SHAPE[cfg.family])
    b = ZOO_BATCH
    check(shape.global_batch == b, f"{arch}: {shape.name} holds batch {shape.global_batch}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (step, state), init_s = synced(lambda: zoo_setup(dev, cfg, b, shape.img_res, SEED))
    n_params = sum(t.numel() for t in tree.leaves(state[0]))
    for k in kernels:
        k.reset()
    state, loss = step(state)
    losses = [loss]
    torch.cuda.synchronize()
    took = {s_: n for k in kernels for s_, n in k.symbol_launches.items() if n}
    n_attn, n_again = zoo_attentions(cfg)
    want = {} if not n_attn else {
        TC_SYMBOL: n_attn + n_again, **{sym: n_attn for sym in fa.BWD_TC_SYMBOLS.values()}}
    check(took == want, f"{arch}: flash launches by entry in a step {took}, not {want}")
    first_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    warm_segments = []

    def segments():
        return torch.cuda.memory_stats(dev).get("segment.all.allocated", 0)
    while (len(warm_segments) < GUARD_WARMUP
           or any(warm_segments[-ZOO_SETTLED:])) and len(warm_segments) < ZOO_WARMUP_MAX:
        seg0 = segments()
        state, loss = step(state)
        losses.append(loss)
        warm_segments.append(segments() - seg0)
    torch.cuda.synchronize()
    print(f"{arch} warm-up: new allocator segments in steps 2-{len(losses)}: {warm_segments}",
          flush=True)
    check(not any(warm_segments[-ZOO_SETTLED:]),
          f"{arch}: the allocator did not settle in {ZOO_WARMUP_MAX} warm-up steps (new "
          f"segments a step {warm_segments})")
    with LaunchGuard(f"{arch} {shape.name} training step") as guard:
        state, loss = step(state)
        losses.append(loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_timed = ZOO_STEPS - len(losses)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n_timed + 1)]
    events[0].record()
    for e in events[1:]:
        state, loss = step(state)
        losses.append(loss)
        e.record()
    torch.cuda.synchronize()
    ms = [a.elapsed_time(e) for a, e in zip(events, events[1:])]
    mean_ms = sum(ms) / len(ms)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = torch.stack(losses).tolist()
    gflop = 3 * zoo_gflop(cfg, shape.img_res) * b
    bound = 1e3 * gflop * 1e9 / BF16_FLOPS
    print(f"{arch} train {shape.name} (B {b}, {shape.img_res} px, remat {cfg.remat}, "
          f"no batch cut): "
          f"{n_params / 1e6:.1f} M params drawn in {init_s:.2f} s; {mean_ms:.4f} ms a step (steps "
          f"{', '.join(f'{t:.4f}' for t in ms)}), {1e3 * b / mean_ms:.1f} images/s; "
          f"{gflop / 1e3:.4f} TFLOP a step (3 x the forward's), bf16 bound {bound:.4f} ms, "
          f"share {bound / mean_ms:.3f}; peak memory {peak_gb:.2f} GB (step 1 {first_peak:.2f}); "
          f"flash launches by entry in a step {took}; losses "
          f"{', '.join(f'{x:.6f}' for x in losses)}", flush=True)
    print(f"guard {guard.label}: builds {guard.builds} new segments {guard.new_segments} syncs "
          f"{guard.syncs}; launches by entry {json.dumps(guard.launches)}", flush=True)
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"{arch}: the loss did not fall over {ZOO_STEPS} steps: {losses}")
    guard.assert_steady_state()
    del state, step
    torch.cuda.empty_cache()
    return took


def zoo_cuda_vs_cpu(dev, arch):
    """The reduced config in float32: one step's loss and gradients on the
    card (the float32 flash kernels, forward and backward, for the
    attention) and on the CPU (the plain version), from the same seeded
    weights and batch -> the largest gradient error over the leaves'
    tolerances."""
    import dataclasses
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import steps
    from repro_torch.models import diffusion
    cfg = reduced(get_config(arch))
    if arch == "vit-h14":   # its own head dim, D 80
        cfg = dataclasses.replace(cfg, d_model=160, d_ff=320)
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    if cfg.family == "vision":
        p = vision_model(cfg).init(g, cfg, device=dev)
        batch = (torch.randn((8, cfg.img_res, cfg.img_res, 3), generator=g, device=dev),
                 torch.randint(0, cfg.n_classes, (8,), generator=g, device=dev))
        loss_fn = steps.vision_loss(cfg)
    else:
        p, latents, cond = diffusion_setup(dev, cfg, 3, cfg.img_res, SEED + 4)
        batch = (latents, cond, *diffusion.draw_train_inputs(latents, g))
        loss_fn = steps.diffusion_loss(cfg)
    runs = []
    for d in (dev, "cpu"):
        pd, bd = tree.from_numpy(p, d), [x.to(d) for x in batch]
        if cfg.kind == "resnet":
            params, state = pd
            runs.append(steps.value_and_grad(lambda q: loss_fn(q, state, *bd), params))
        else:
            runs.append(steps.value_and_grad(lambda q: loss_fn(q, *bd), pd))
    (loss, grads, aux), (loss_c, grads_c, aux_c) = runs
    loss_err = abs(loss.item() - loss_c.item()) / abs(loss_c.item())
    paths, want = tree.flatten_with_paths(grads_c)
    top = max(w.abs().max().item() for w in want)
    zero = {path: w.abs().max().item() / top for path, w in zip(paths, want)
            if zoo_zero_grad(cfg, path)}
    check(all(x < ZOO_ZERO_NOISE for x in zero.values()),
          f"{arch}: a leaf taken as 0 in exact arithmetic is not: {zero}")
    errs = {path: (a.cpu() - w).abs().max().item()
            / (ZOO_ZERO_GRAD * top if path in zero else max(w.abs().max().item(), 1e-30))
            for path, a, w in zip(paths, tree.leaves(grads), want)}
    if aux is not None:
        errs.update({f"running statistics {i}": rnorm(a.cpu(), w) for i, (a, w) in
                     enumerate(zip(tree.leaves(aux), tree.leaves(aux_c)))})
    worst = max(errs, key=errs.get)
    tol = ZOO_F32_GRAD_TOL[cfg.kind]
    print(f"{arch} reduced float32 step card vs CPU: loss {loss.item():.7e} / "
          f"{loss_c.item():.7e} (rel {loss_err:.2e}, limit {ZOO_F32_LOSS_RTOL:.0e}); {len(errs)} "
          f"gradient leaves{' and statistics' if aux is not None else ''} within "
          f"{errs[worst]:.3e} of each leaf's max (worst {worst}; limit {tol:.0e})", flush=True)
    check(loss_err <= ZOO_F32_LOSS_RTOL and errs[worst] <= tol,
          f"{arch}: reduced step card vs CPU differs (loss {loss_err:.2e}, {worst} "
          f"{errs[worst]:.2e})")
    return errs[worst]


def phase_zoo_training(dev, kernels):
    """Phase 15 -> flash launches by entry in the six models' first
    steps (the main path's)."""
    entries = {}
    for arch in ZOO_ARCHS:
        t0 = time.perf_counter()
        for sym, n in zoo_train(dev, kernels, arch).items():
            entries[sym] = entries.get(sym, 0) + n
        print(f"phase 15 {arch}: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    for arch in ZOO_ARCHS:
        zoo_cuda_vs_cpu(dev, arch)
    print(f"phase 15 card vs CPU: {time.perf_counter() - t0:.1f} s", flush=True)
    return entries


# ---------------------------------------------------------------------------
# phase 16: LM training
# ---------------------------------------------------------------------------

def lm_train_config(arch):
    """Phase 16's config of ``arch`` and its cut: full width, the depth
    of qwen3-8b and the MoE LMs cut to LM_TRAIN_LAYERS (why: LM_TRAIN_CUT)
    -> (config, the cuts as text)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    cuts = [f"batch {LM_TRAIN_ACCUM[arch]} rows of 256 (train_4k's)"]
    layers = LM_TRAIN_LAYERS.get(arch)
    if layers is not None:
        cuts.append(f"{layers} of {cfg.n_layers} layers ({LM_TRAIN_CUT[arch]})")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg, "; ".join(cuts)


def attention_head_dim(cfg) -> int:
    """The head dim an LM's training attention runs at: MLA's q/k heads
    (nope + rope, v zero-padded to it), else ``head_dim``."""
    return (cfg.head_dim if cfg.mla is None
            else cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim)


def state_digest(trees) -> list:
    """Each leaf's sum of its bit patterns (int64) and of its values
    (float64), reduced on the card: equal digests of two runs stand for
    equal bits without a second copy of a 46 GB state."""
    import torch
    from repro_torch import tree
    out = []
    for x in tree.leaves(trees):
        bits = x.view(torch.int16 if x.element_size() == 2 else torch.int32)
        out.append((int(torch.sum(bits, dtype=torch.int64)),
                    float(torch.sum(x, dtype=torch.float64))))
    return out


def lm_train_setup(dev, cfg, accum, seed):
    """Seeded bf16 weights (``lm.init`` on the card), ``lm_train``'s donated
    step with ``grad_accum``, one fixed batch of ``accum`` rows of
    LM_TRAIN_SEQ seeded tokens, labels = roll(tokens, -1) -> (run(state) ->
    (state, loss), state)."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import lm
    g = torch.Generator(device=dev).manual_seed(seed)
    params = lm.init(g, cfg, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (accum, LM_TRAIN_SEQ), generator=g, device=dev)
    labels = torch.roll(tokens, -1, dims=1)
    opt_init, step = steps.lm_train(cfg, grad_accum=accum, donate=True)

    def run(st):
        *st, loss = step(*st, tokens, labels)
        return tuple(st), loss
    return run, (params, opt_init(params))


def lm_train_cell(dev, kernels, arch):
    """One LM's training at full width: LM_TRAIN_STEPS donated steps on one
    batch (step 1 counts the flash launches by entry: each layer's forward
    twice, once in the remat recompute, and each backward entry once, a
    micro-batch, the entries of the attention's head dim, D 192 for MLA;
    an MoE model's drop share in it, through ``MoeProbe``; then warm-up
    steps until the allocator settles, a step under LaunchGuard, the rest
    timed by CUDA events), the loss falling, the peak under the card's 80
    GB, and step 1 run again from the same seed, its loss and every leaf
    of the new state bit-equal (``state_digest``); one more step under
    torch.profiler (after a warm-up step) -> launches by entry in step 1
    (the main path's)."""
    import torch
    from repro_torch.analysis import LaunchGuard
    from repro_torch.configs import get_shape
    from repro_torch.kernels import flash_attention as fa
    cfg, cuts = lm_train_config(arch)
    accum = LM_TRAIN_ACCUM[arch]
    shape = get_shape(arch, "train_4k")
    check(shape.seq_len == LM_TRAIN_SEQ, f"{arch}: train_4k's sequence is {shape.seq_len}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (step, state), init_s = synced(lambda: lm_train_setup(dev, cfg, accum, SEED))
    state_gb = (sum(t.numel() * t.element_size() for t in _leaves(state[0]))
                + 2 * 4 * sum(t.numel() for t in _leaves(state[0]))) / 1e9
    for k in kernels:
        k.reset()
    with MoeProbe() as probe:   # a few small launches a MoE layer, no sync
        state, loss = step(state)
    losses = [loss]
    torch.cuda.synchronize()
    first_digest = state_digest((state[0], state[1].mu, state[1].nu))
    took = {s_: n for k in kernels for s_, n in k.symbol_launches.items() if n}
    n = cfg.n_layers * accum
    want = {TC_SYMBOL: 2 * n,
            **{sym: n for sym in fa.bwd_tc_symbols(attention_head_dim(cfg)).values()}}
    check(took == want, f"{arch}: flash launches by entry in a step {took}, not {want}")
    drops = ""
    if cfg.moe is not None:   # the forward's calls, a MoE layer each, then the recompute's
        n_moe = cfg.n_layers - cfg.moe.first_dense_layers
        per_call = probe.copies / len(probe.dropped)
        layer_share = [float(x) / per_call for x in probe.dropped[:n_moe]]
        drops = (f"; dropped at capacity {probe.drop_share():.4f} of the routed copies (by MoE "
                 f"layer {', '.join(f'{x:.4f}' for x in layer_share)})")
    first_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    warm_segments = []

    def segments():
        return torch.cuda.memory_stats(dev).get("segment.all.allocated", 0)
    while (len(warm_segments) < GUARD_WARMUP
           or any(warm_segments[-ZOO_SETTLED:])) and len(warm_segments) < ZOO_WARMUP_MAX:
        seg0 = segments()
        state, loss = step(state)
        losses.append(loss)
        warm_segments.append(segments() - seg0)
    torch.cuda.synchronize()
    print(f"{arch} warm-up: new allocator segments in steps 2-{len(losses)}: {warm_segments}",
          flush=True)
    check(not any(warm_segments[-ZOO_SETTLED:]),
          f"{arch}: the allocator did not settle in {ZOO_WARMUP_MAX} warm-up steps (new "
          f"segments a step {warm_segments})")
    with LaunchGuard(f"{arch} train_4k training step") as guard:
        state, loss = step(state)
        losses.append(loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_timed = LM_TRAIN_STEPS - len(losses)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n_timed + 1)]
    events[0].record()
    for e in events[1:]:
        state, loss = step(state)
        losses.append(loss)
        e.record()
    torch.cuda.synchronize()
    ms = [a.elapsed_time(e) for a, e in zip(events, events[1:])]
    mean_ms = sum(ms) / len(ms)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = torch.stack(losses).tolist()
    tokens = accum * LM_TRAIN_SEQ
    gflop = lm_train_gflop(cfg, accum, LM_TRAIN_SEQ)
    bound = 1e3 * gflop * 1e9 / BF16_FLOPS
    print(f"{arch} train train_4k (S {LM_TRAIN_SEQ}, {accum} row(s), grad_accum {accum}, remat "
          f"{cfg.remat}; cut: {cuts}): {cfg.n_params / 1e9:.3f} B params drawn in {init_s:.2f} s, "
          f"{state_gb:.2f} GB of bf16 weights and float32 moments; {mean_ms:.4f} ms a step "
          f"(steps {', '.join(f'{t:.4f}' for t in ms)}), {1e3 * tokens / mean_ms:.1f} tokens/s; "
          f"{gflop / 1e3:.4f} TFLOP a step (the reference's model_flops), bf16 bound "
          f"{bound:.4f} ms, share {bound / mean_ms:.3f}; peak memory {peak_gb:.2f} GB (step 1 "
          f"{first_peak:.2f}); flash launches by entry in a step {took}{drops}; losses "
          f"{', '.join(f'{x:.6f}' for x in losses)}", flush=True)
    check(max(peak_gb, first_peak) < 80, f"{arch}: peak memory {peak_gb:.2f} GB a step, "
          f"{first_peak:.2f} in step 1")
    print(f"guard {guard.label}: builds {guard.builds} new segments {guard.new_segments} syncs "
          f"{guard.syncs}; launches by entry {json.dumps(guard.launches)}", flush=True)
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"{arch}: the loss did not fall over {LM_TRAIN_STEPS} steps: {losses}")
    guard.assert_steady_state()
    box = [state]

    def one_step():
        box[0] = step(box[0])[0]
    profile_step(f"{arch} training step", one_step)
    del state, step, box
    gc.collect()   # nothing of the old state may outlive it: the rerun draws a new one
    torch.cuda.empty_cache()
    # step 1 again, from the same seed
    step, state = lm_train_setup(dev, cfg, accum, SEED)
    state, loss = step(state)
    again = state_digest((state[0], state[1].mu, state[1].nu))
    same = loss.item() == losses[0] and again == first_digest
    print(f"{arch}: step 1 run again from the seed: loss {loss.item():.7f} / {losses[0]:.7f}, "
          f"{len(again)} leaves' digests equal {again == first_digest}", flush=True)
    check(same, f"{arch}: a rerun of step 1 differs")
    del state, step
    torch.cuda.empty_cache()
    return took


def embedding_backward_is_deterministic(dev):
    """The embedding gather's backward at phi4-mini's width, 4096 tokens
    drawn from 64 ids (each repeated ~64 times), twice: the gradients of
    the (200064, 3072) bf16 table bit-equal (its CUDA route sorts the
    indices and sums each id's rows in order, with no atomics)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    table = torch.randn((200064, 3072), generator=g, device=dev).bfloat16().requires_grad_()
    ids = torch.randint(0, 64, (1, LM_TRAIN_SEQ), generator=g, device=dev) * 3001
    dy = torch.randn((1, LM_TRAIN_SEQ, 3072), generator=g, device=dev).bfloat16()
    grads = [torch.autograd.grad(table[ids], table, dy)[0] for _ in range(2)]
    same = bit_equal(grads[0], grads[1])
    print(f"embedding gather backward, {LM_TRAIN_SEQ} tokens of 64 ids: two runs bit-equal {same}",
          flush=True)
    check(same, "the embedding gather's backward is not deterministic on the card")
    del table, grads, dy
    torch.cuda.empty_cache()


def lm_train_cuda_vs_cpu(dev, flash_kernels, arch):
    """The reduced config in float32: ``loss_fn``'s loss and gradients on the
    card (the CUDA-core flash kernels with the causal mask and GQA,
    forward and backward, once a layer each) and on the CPU (the plain
    version), from the same seeded weights and tokens -> the largest leaf
    error over its own max."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import steps
    from repro_torch.models import lm
    cfg = reduced(get_config(arch))
    p = lm.init(torch.Generator().manual_seed(SEED + 6), cfg, device="cpu")
    tokens = np.random.default_rng(SEED + 6).integers(0, cfg.vocab_size, (2, 64))
    runs = []
    for d in (dev, "cpu"):
        t = torch.from_numpy(tokens).to(d)
        before = {s_: n for k in flash_kernels for s_, n in k.symbol_launches.items()}
        runs.append(steps.value_and_grad(lambda q: lm.loss_fn(q, cfg, t, torch.roll(t, -1, 1)),
                                         tree.from_numpy(p, d)))
        took = {s_: n - before[s_] for k in flash_kernels for s_, n in k.symbol_launches.items()
                if n != before[s_]}
        want = ({} if d == "cpu" else
                {s_: cfg.n_layers for s_ in ("flash_attention_f32", *(
                    f"flash_attention_bwd_{e}_f32" for e in ("prep", "dkdv", "dq")))})
        check(took == want, f"{arch} reduced float32 on {d}: flash launches {took}, not {want}")
    (loss, grads, _), (loss_c, grads_c, _) = runs
    loss_err = abs(loss.item() - loss_c.item()) / abs(loss_c.item())
    paths, want = tree.flatten_with_paths(grads_c)
    errs = {path: (a.cpu() - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
            for path, a, w in zip(paths, tree.leaves(grads), want)}
    worst = max(errs, key=errs.get)
    print(f"{arch} reduced float32 loss_fn card vs CPU: loss {loss.item():.7e} / "
          f"{loss_c.item():.7e} (rel {loss_err:.2e}, limit {ZOO_F32_LOSS_RTOL:.0e}); {len(errs)} "
          f"gradient leaves within {errs[worst]:.3e} of each leaf's max (worst {worst}; limit "
          f"{LM_F32_GRAD_TOL:.0e})", flush=True)
    check(loss_err <= ZOO_F32_LOSS_RTOL and errs[worst] <= LM_F32_GRAD_TOL,
          f"{arch}: reduced step card vs CPU differs (loss {loss_err:.2e}, {worst} "
          f"{errs[worst]:.2e})")
    return errs[worst]


def lm_train_cli():
    """``python -m repro_torch.launch.train --steps 20`` (reduced qwen3-8b,
    the reference's defaults) on the card twice over one ``--ckpt-dir``:
    the first run checkpoints at steps 10 and 20; step 20's checkpoint is
    removed, as a crash before its commit would leave the folder, and the
    second run (``--compress``: the int8 codec on the card) resumes from
    step 10 and runs 10 steps (checked from the printed report)."""
    import os
    import shutil
    folder = ROOT / "build" / "lm_train_ckpt"
    shutil.rmtree(folder, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--steps", "20", "--ckpt-dir",
           str(folder)]
    lines = []
    for extra in ([], ["--compress"]):
        out = subprocess.run(cmd + extra, env=env, capture_output=True, text=True, timeout=300)
        check(out.returncode == 0, f"launch.train failed: {out.stderr[-2000:]}")
        lines.append(out.stdout.strip().splitlines()[-1])
        print(f"python -m repro_torch.launch.train --steps 20 {' '.join(extra)}: {lines[-1]}",
              flush=True)
        shutil.rmtree(folder / "step_00000020", ignore_errors=True)
    shutil.rmtree(folder, ignore_errors=True)
    fields = [dict(f.split("=") for f in line.split()) for line in lines]
    check(fields[0]["steps"] == "20" and fields[0]["resumed_from"] == "None"
          and fields[1]["steps"] == "10" and fields[1]["resumed_from"] == "10"
          and all(math.isfinite(float(f[k])) for f in fields for k in ("first_loss", "last_loss"))
          and all(f["rejected"] == "0" for f in fields),
          f"launch.train's runs: {lines}")


def phase_lm_training(dev, kernels):
    """Phase 16 -> flash launches by entry in the two models' first steps
    (the main path's)."""
    entries = {}
    embedding_backward_is_deterministic(dev)
    for arch in LM_TRAIN_ARCHS:
        t0 = time.perf_counter()
        for sym, n in lm_train_cell(dev, kernels, arch).items():
            entries[sym] = entries.get(sym, 0) + n
        print(f"phase 16 {arch}: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    for arch in LM_TRAIN_ARCHS:
        lm_train_cuda_vs_cpu(dev, kernels, arch)
    lm_train_cli()
    print(f"phase 16 card vs CPU and launch.train: {time.perf_counter() - t0:.1f} s", flush=True)
    return entries


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
    phase_flash_bwd(dev, rows)
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
    t0 = time.perf_counter()
    moe_entries = phase_moe_serving(dev, kernel["flash_attention"])
    launches["flash_attention"] += sum(moe_entries.values())
    for sym, n in moe_entries.items():
        entry_launches[sym] = entry_launches.get(sym, 0) + n
    print(f"phase moe and mla serving: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    vision_entries = phase_vision_serving(dev, kernel["flash_attention"])
    launches["flash_attention"] += sum(vision_entries.values())
    for sym, n in vision_entries.items():
        entry_launches[sym] = entry_launches.get(sym, 0) + n
    print(f"phase vision serving: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    diffusion_entries = phase_diffusion_serving(dev, kernel["flash_attention"])
    launches["flash_attention"] += sum(diffusion_entries.values())
    for sym, n in diffusion_entries.items():
        entry_launches[sym] = entry_launches.get(sym, 0) + n
    print(f"phase diffusion serving: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    bwd_libs = [kernel["flash_attention_bwd"], kernel["flash_attention_bwd_sm90"]]
    zoo_entries = phase_zoo_training(dev, [kernel["flash_attention"], *bwd_libs])
    # the row's top-level count is csrc/flash_attention.cu's (the forward);
    # the backward libraries' launches stand under their own entries
    launches["flash_attention"] += sum(n for sym, n in zoo_entries.items()
                                       if not any(sym in k.symbol_launches for k in bwd_libs))
    for sym, n in zoo_entries.items():
        entry_launches[sym] = entry_launches.get(sym, 0) + n
    print(f"phase zoo training: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    lm_entries = phase_lm_training(dev, [kernel["flash_attention"], *bwd_libs])
    launches["flash_attention"] += sum(n for sym, n in lm_entries.items()
                                       if not any(sym in k.symbol_launches for k in bwd_libs))
    for sym, n in lm_entries.items():
        entry_launches[sym] = entry_launches.get(sym, 0) + n
    print(f"phase lm training: {time.perf_counter() - t0:.1f} s", flush=True)

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
             entries=[dict(entry=sym, launches=entry_launches.get(sym, 0), **row)
                      for sym, row in rows[name]["entries"].items()])
        for name in replaces]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
