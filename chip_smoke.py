#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository's sources; it imports
nothing of JAX or of the reference package ``repro``. Phases:

1. device: the card's name and power limit, torch/CUDA versions, and
   the build of every hand-written kernel from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, in parallel), with ptxas's registers and
   spills of each kernel entry;
2. kernels: each kernel against its plain PyTorch version on the card,
   at the shapes its path gives it and at ragged ones (a bf16
   ``flash_attention`` also against the plain version on its inputs
   upcast to float32, within one bf16 rounding), timed with CUDA
   events beside the plain version, the least time the card could take
   (``bound_ms``) and, where one PyTorch call computes the same function,
   that call (``library_ms``, a yardstick the port never calls); and
   ``int8_matmul``'s one path, ``ops.int8_matmul`` at the kernel bench's
   shape;
3. the Mission at full width: the ``targetfuse-space`` and
   ``targetfuse-ground`` counters (seeded random weights) on xview-like
   traffic, every selection policy, with every kernel's launch count
   from this run;
4. CUDA against CPU: the same reduced-config Mission on the card
   (kernels) and on the CPU (plain versions), per-tile predictions equal;
5. LM serving at full width: qwen3-8b (36 layers, d_model 4096, seeded
   random bf16 weights) prefills 2 prompts of 4096 tokens and decodes 32
   greedy tokens; ``flash_attention`` launches once a layer in the
   prefill; decode logits are held against ``forward_train`` over prompt
   and generated tokens;
6. CUDA against CPU: reduced qwen3 in float32, prefill and 3 decode
   steps on the card (kernel) and on the CPU (plain version).

It prints a ``{"kernels": [...]}`` line, then the ``nvidia-smi`` name and
power limit, and last ``{"ok": true, "device": {...}}``. Any failure
exits non-zero before that last line.
"""
from __future__ import annotations

import json
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
# holds and a CUDA-core attention kernel finishes in the time limit
LM_BATCH, LM_PROMPT, LM_STEPS = 2, 4096, 32
# phase 5: relative norm of decode logits against the full forward's at
# each generated position. bf16 activations through 36 layers, and the
# prefill's kernel keeps p in float32 where the decode's plain version
# rounds it to bf16: measured 1.6e-2 to 1.7e-2 at every position on the
# H100, so about twice that (PERF.md)
LM_DECODE_RTOL = 0.03
# phase 2: a bf16 flash_attention output against the plain version on
# the inputs upcast to float32, the arithmetic the kernel does: the
# kernel's one rounding of its output to bf16 is at most 2**-8 of the
# value, so twice that relative, and float32 sums in another order
FLASH_BF16_RTOL, FLASH_BF16_ATOL = 2.0 ** -7, 1e-5


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
    from repro_torch.kernels import (flash_attention, int8_matmul, iou, kmeans_assign, ref,
                                     tile_moments)

    g = torch.Generator(device=dev).manual_seed(SEED)
    cases = {"tile_moments": [], "kmeans_assign": [], "iou_matrix": [],
             "flash_attention": [], "int8_matmul": []}
    for shape in [(256, 416, 416, 3), (130, 64, 64, 3)]:
        t = torch.rand(shape, generator=g, device=dev)
        n, h, w, c = shape
        cases["tile_moments"].append(dict(
            shape=str(shape), kernel=lambda t=t: tile_moments.tile_moments(t),
            plain=lambda t=t: ref.tile_moments(t), atol=1e-4,
            bytes=t.numel() * 4 + n * 3 * c * 4, flops=7 * t.numel()))
    for n, k in [(1024, 512), (1024, 1), (1024, 64), (1000, 1), (1000, 64),
                 (1000, 512), (128, 1), (128, 64), (128, 512)]:
        x = torch.randn((n, 9), generator=g, device=dev)
        cent = torch.randn((k, 9), generator=g, device=dev)
        if k > 1:
            cent[k // 2] = cent[0]   # duplicate centroid: ties go to index 0
            cent[-1] = x[3]          # an exact hit
        x[5] = x[3]
        cases["kmeans_assign"].append(dict(
            shape=f"x({n}, 9) c({k}, 9)",
            kernel=lambda x=x, c=cent: kmeans_assign.kmeans_assign(x, c),
            plain=lambda x=x, c=cent: ref.kmeans_assign(x, c), atol=1e-4,
            bytes=(n + k) * 9 * 4 + n * 8, flops=2 * n * k * 9 + 3 * n * k))
    for b, n, m in [(64, 128, 128), (None, 200, 300)]:
        lead = () if b is None else (b,)
        bx = torch.rand((*lead, n + m, 4), generator=g, device=dev) * 50
        bx[..., 2:] = bx[..., :2] + bx[..., 2:].abs() + 0.01
        a, bb = bx[..., :n, :].contiguous(), bx[..., n:, :].contiguous()
        if b is not None:
            bb = a           # NMS: the candidates against themselves
            m = n
        bs = b or 1
        cases["iou_matrix"].append(dict(
            shape=f"{tuple(a.shape)} x {tuple(bb.shape)}",
            kernel=lambda a=a, bb=bb: iou.iou_matrix(a, bb),
            plain=lambda a=a, bb=bb: ref.iou_matrix(a, bb), atol=1e-5,
            bytes=bs * (n + m) * 16 + bs * n * m * 4, flops=12 * bs * n * m))

    # the LM prefill's shape first (qwen3-8b, B 2, S 4096), then the f32
    # shapes of tests/test_kernels.py and ragged ones
    attn = [((2, 4096, 32, 8, 128), torch.bfloat16, True)]
    attn += [(shape, torch.float32, causal)
             for shape in [(1, 128, 1, 1, 128), (2, 256, 4, 2, 128), (1, 384, 8, 8, 128),
                           (2, 128, 6, 2, 256)] for causal in (False, True)]
    attn += [((1, 200, 4, 2, 128), torch.float32, True),
             ((2, 200, 4, 2, 16), torch.float32, False),
             ((1, 200, 4, 2, 100), torch.float32, True),
             ((1, 200, 4, 2, 128), torch.bfloat16, True)]
    for (b, s, hq, hkv, d), dt, causal in attn:
        q = torch.randn((b, s, hq, d), generator=g, device=dev).to(dt)
        k, v = (torch.randn((b, s, hkv, d), generator=g, device=dev).to(dt) for _ in range(2))
        tol = 3e-2 if dt == torch.bfloat16 else 2e-5
        flops = 4 * b * hq * s * s * d / (2 if causal else 1)
        cases["flash_attention"].append(dict(
            shape=f"q{(b, s, hq, d)} kv{(b, s, hkv, d)} {str(dt)[6:]} causal={causal}",
            kernel=lambda q=q, k=k, v=v, c=causal: flash_attention.flash_attention(
                q, k, v, causal=c),
            plain=lambda q=q, k=k, v=v, c=causal: ref.attention(q, k, v, causal=c),
            library=lambda q=q, k=k, v=v, c=causal: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=c,
                enable_gqa=True),
            upcast=None if dt == torch.float32 else (
                lambda q=q, k=k, v=v, c=causal: ref.attention(q.float(), k.float(), v.float(),
                                                              causal=c)),
            atol=tol, rtol=tol, bytes=2 * (q.numel() + k.numel()) * q.element_size(),
            flops=flops, rate=BF16_FLOPS if dt == torch.bfloat16 else FP32_FLOPS))
    # the kernel bench's shape first, then those of tests/test_kernels.py,
    # then every product at +-127 * -127 over K 4096: |acc| = 66,064,384,
    # past float32's 24-bit integers, so only an exact int32 sum agrees
    extreme = (torch.full((3, 4096), -127, dtype=torch.int8, device=dev),
               torch.full((4096, 2), -127, dtype=torch.int8, device=dev),
               torch.ones(3, device=dev), torch.ones(2, device=dev))
    extreme[0][1] = 127
    extreme[1][::3, 1] = 126
    for m, k, n in [(256, 512, 256), (128, 128, 128), (100, 200, 150), (256, 512, 384),
                    (1, 64, 1), (3, 4096, 2)]:
        args = extreme if k == 4096 else int8_args(g, dev, m, k, n)
        cases["int8_matmul"].append(dict(
            shape=f"({m}, {k}) x ({k}, {n})",
            kernel=lambda a=args: int8_matmul.int8_matmul(*a),
            plain=lambda a=args: ref.int8_matmul(*a),
            library=lambda a=args: torch._int_mm(a[0], a[1]), exact=True,
            bytes=m * k + k * n + 4 * (m + n) + 4 * m * n, flops=2 * m * k * n, rate=INT8_OPS))
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


def ptxas_report(logs: dict):
    """Registers, spills and shared memory of every kernel entry, from
    ptxas's report in this run's build."""
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


def int8_args(g, dev, m, k, n):
    import torch
    return (torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8),
            torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8),
            torch.rand(m, generator=g, device=dev) + 0.1,
            torch.rand(n, generator=g, device=dev) + 0.1)


LIBRARY_NOTE = {
    "tile_moments": "null: no one PyTorch call computes mean, stddev and cube-root skew",
    "kmeans_assign": "null: torch.cdist gives the distances but not the argmin (two calls)",
    "iou_matrix": "null: no batched box IoU in PyTorch (torchvision's box_iou is 2-D and "
                  "not installed)",
    "flash_attention": "scaled_dot_product_attention(is_causal, enable_gqa) on (B, H, S, D) "
                       "views, at the first shape",
    "int8_matmul": "torch._int_mm, the int32 product without the scales, at the first shape",
}


def phase_kernels(dev):
    import torch
    rows = {}
    for name, cases in kernel_cases(dev).items():
        for i, case in enumerate(cases):
            got, want = case["kernel"](), case["plain"]()
            torch.cuda.synchronize()
            if name == "kmeans_assign":
                check(torch.equal(got[0], want[0]),
                      f"{name} {case['shape']}: assignments differ")
                err = (got[1] - want[1]).abs().max().item()
                check(torch.allclose(got[1], want[1], atol=case["atol"], rtol=1e-4),
                      f"{name} {case['shape']}: distances off by {err}")
            elif case.get("exact"):
                err = (got - want).abs().max().item()
                check(torch.equal(got, want), f"{name} {case['shape']}: not bit-equal ({err})")
            else:
                err = (got.float() - want.float()).abs().max().item()
                check(torch.allclose(got.float(), want.float(), atol=case["atol"],
                                     rtol=case.get("rtol", 1e-4)),
                      f"{name} {case['shape']}: off by {err}")
            if case.get("upcast") is not None:
                check_upcast(name, case, got)
            del got, want
            ms = cuda_ms(case["kernel"], reps=20)
            host_ms = cuda_ms(case["kernel"], reps=20, hold=False)
            plain_ms = cuda_ms(case["plain"], reps=5, warmup=1)
            b_ms, b_by = bound_ms(case["bytes"], case["flops"], case.get("rate", FP32_FLOPS))
            lib_ms = cuda_ms(case["library"], reps=20) if i == 0 and "library" in case else None
            print(f"kernel {name} {case['shape']}: max_abs_err {err:.3e} "
                  f"ms {ms:.4f} (with host launch {host_ms:.4f}) "
                  f"plain_ms {plain_ms:.4f} bound_ms {b_ms:.4f} "
                  f"({b_by}) share {b_ms / ms:.3f}"
                  + ("" if lib_ms is None else f" library_ms {lib_ms:.4f}"), flush=True)
            if i == 0:
                rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        torch.cuda.empty_cache()
    for name, why in LIBRARY_NOTE.items():
        print(f"kernel {name}: library_ms {why}")
    return rows


def int8_path(dev, kernel):
    """``int8_matmul``'s one path, as the reference's kernel bench drives
    it: ``ops.int8_matmul`` at 256 x 512 x 256 -> launches in that run."""
    import torch
    from repro_torch.kernels import ops
    args = int8_args(torch.Generator(device=dev).manual_seed(SEED + 1), dev, 256, 512, 256)
    kernel.launches = 0
    out = ops.int8_matmul(*args)
    torch.cuda.synchronize()
    check(out.shape == (256, 256) and bool(torch.isfinite(out).all()), "int8 path: bad output")
    print(f"int8 path: ops.int8_matmul (256, 512) x (512, 256), {kernel.launches} launch",
          flush=True)
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
    synchronized on both sides, so the time is the stage's own."""

    def __init__(self, stage, times: dict):
        self.stage, self.times, self.name = stage, times, stage.name

    def run(self, mission, seg, window=None):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.stage.run(mission, seg, window)
        torch.cuda.synchronize()
        self.times[self.name] = self.times.get(self.name, 0.0) + time.perf_counter() - t0


def phase_full_width(dev, kernels):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import mission as M
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.data.synthetic import DATASETS

    cfgs = (get_config("targetfuse-space"), get_config("targetfuse-ground"))
    space, ground = counters(cfgs, dev)
    frames = scene_frames(DATASETS["xview"], XVIEW_SCENES, XVIEW_REVISITS, SEED)
    n_tiles = len(frames) * (DATASETS["xview"].scene_px // 128) ** 2
    print(f"full width: {len(frames)} xview frames, {n_tiles} tiles; "
          f"space {cfgs[0].widths} ground {cfgs[1].widths} at "
          f"{cfgs[0].input_size} px", flush=True)

    def pcfg(method):
        return PipelineConfig(method=method, score_thresh=0.25, seed=SEED)

    M.Mission(space, ground, pcfg("targetfuse"), device=dev).run(frames)  # warm-up
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    per_policy = {}
    for method in POLICIES:
        before = {k.name: k.launches for k in kernels}
        torch.cuda.reset_peak_memory_stats()
        stages = {}
        m = M.Mission(space, ground, pcfg(method), device=dev,
                      ingest_stages=[Timed(st, stages) for st in M.default_ingest_stages()],
                      contact_stages=[Timed(st, stages) for st in M.default_contact_stages()])
        t0 = time.perf_counter()
        m.ingest(frames)
        t1 = time.perf_counter()
        m.contact_window()
        t2 = time.perf_counter()
        r = m.result()
        launches = {k.name: k.launches - before[k.name] for k in kernels}
        check(r.tiles_total == n_tiles, f"{method}: {r.tiles_total} tiles")
        check(np.isfinite(r.per_tile_pred).all() and r.per_tile_pred.shape == (n_tiles,),
              f"{method}: bad predictions")
        per_policy[method] = dict(
            ingest_s=t1 - t0, contact_s=t2 - t1,
            tiles_per_s=n_tiles / (t2 - t0),
            max_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            launches=launches, stages_s=stages, cmae=r.cmae,
            total_pred=r.total_pred, total_true=r.total_true,
            processed=r.tiles_processed_space, downlinked=r.tiles_downlinked)
        print(f"mission {method}: " + json.dumps(per_policy[method]), flush=True)
    tf = per_policy["targetfuse"]["launches"]
    check(all(v > 0 for v in tf.values()), f"targetfuse missed a kernel: {tf}")
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
# phases 5 and 6: LM serving
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
    (B 32, S 32768): at B 32 the KV cache alone is 155 GB in bf16, and a
    CUDA-core attention kernel at 32k takes too long for the time limit.

    Checks: ``flash_attention`` launches once a layer in the prefill and
    not in the decode; the logits of the prefill's last position and of
    every decode step agree with ``forward_train`` over prompt and
    generated tokens within LM_DECODE_RTOL (relative norm per position).
    -> flash_attention launches in the serving run.
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
    flash.launches = 0
    (logits, pre), prefill_s = synced(lambda: lm.prefill(params, cfg, prompt))
    prefill_launches = flash.launches
    check(prefill_launches == cfg.n_layers,
          f"prefill launched flash_attention {prefill_launches} times, not {cfg.n_layers}")
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
    check(launches == prefill_launches, "decode launched flash_attention")
    profile_decode(lambda: lm.decode_step(params, cfg, tokens[-1], cache, s + steps - 1))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    decode_ms = 1e3 * sum(step_s) / steps
    print(f"lm prefill: {prefill_s:.4f} s, {b * s / prefill_s:.1f} tokens/s; flash_attention "
          f"launches {prefill_launches} ({cfg.n_layers} layers)", flush=True)
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
    return launches


def profile_decode(step):
    """One decode step (the last one again) under torch.profiler: the
    device time by kernel, and the share of the step's wall time the
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
    print(f"lm decode profile: wall {wall_us / 1e3:.4f} ms, device busy "
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
        before = flash.launches
        log, pre = lm.prefill(p, cfg, t[:, :6])
        launched = flash.launches - before
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
          f"{err:.3e}; flash_attention launches on the card {gpu_launched}, on the CPU "
          f"{cpu_launched}", flush=True)
    check(gpu_launched == cfg.n_layers and cpu_launched == 0, "flash_attention dispatch")
    check(torch.allclose(got, want, atol=1e-4, rtol=1e-4), f"CUDA and CPU logits differ by {err}")


# ---------------------------------------------------------------------------

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
    print(f"phase kernels: {time.perf_counter() - t0:.1f} s", flush=True)
    mission_kernels = [kernel[n] for n in ("tile_moments", "kmeans_assign", "iou")]
    t0 = time.perf_counter()
    launches.update(phase_full_width(dev, mission_kernels))
    print(f"phase full-width mission: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_cuda_vs_cpu(dev)
    print(f"phase cuda vs cpu: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches["flash_attention"] = phase_lm_serving(dev, kernel["flash_attention"])
    print(f"phase lm serving: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_lm_cuda_vs_cpu(dev, kernel["flash_attention"])
    print(f"phase lm cuda vs cpu: {time.perf_counter() - t0:.1f} s", flush=True)

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
             replaces=replaces[name], launches=launches[sources[name]], **rows[name])
        for name in replaces]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
