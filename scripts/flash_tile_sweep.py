#!/usr/bin/env python3
"""Build variants of the tensor-core ``flash_attention`` and time them.

    python3 scripts/flash_tile_sweep.py

Needs one CUDA card and ``nvcc``. Builds ``src/repro_torch/csrc/
flash_attention.cu`` once per variant of its build switches (``VARIANTS``:
``-DFLASH_TC_BK`` keys a tile, ``-DFLASH_TC_STAGES`` K/V stages,
``-DFLASH_TC_WG_FROM_D`` the least head dim whose block has a whole
producer warpgroup with ``setmaxnreg``; one ``nvcc`` each, in parallel,
into ``build/kernels/sweep/``), prints ptxas's registers and spills of
each tensor-core entry, holds ``flash_attention_bf16_sm90`` of every
variant against the plain version (bf16 within 3e-2; against float32
upcast inputs within rtol 2^-7, atol 1e-5) at the LM prefills' shapes
(qwen3-8b at D 128 and deepseek-v2-lite at D 192, B 2, S 4096, causal)
and at ragged ones, and times each variant at the prefill shapes with
CUDA events, in turns (every variant, then again in reverse order),
beside the CUDA-core route and ``scaled_dot_product_attention``. A
variant whose shared memory at a head dim exceeds a block's 227 KB is
skipped at that head dim. Exits non-zero if a build fails or a result
disagrees.
"""
from __future__ import annotations

import ctypes
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# name -> (keys a tile, stages, least D with a producer warpgroup)
VARIANTS = {"bk64": (64, 2, 192),          # the default build
            "bk128": (128, 2, 192),
            "bk64-3stages": (64, 3, 192),
            "bk64-wg-all": (64, 2, 64),     # D 64 and 128 on the D 192 layout
            "bk128-wg-all": (128, 2, 64)}
# b, sq, skv, hq, hkv, d, causal
MAIN = [(2, 4096, 4096, 32, 8, 128, True), (2, 4096, 4096, 16, 16, 192, True)]
RAGGED = [(1, 200, 200, 4, 2, 128, True), (2, 256, 256, 4, 2, 64, False),
          (1, 128, 384, 4, 4, 128, False), (1, 333, 333, 8, 2, 64, True),
          (1, 200, 200, 4, 2, 192, True), (1, 128, 384, 4, 4, 192, False)]
BF16_FLOPS = 989e12
SMEM_LIMIT = 232448  # bytes of dynamic shared memory a block may have
TC_BQ = 128          # query rows a block (kTcBQ)


def smem_bytes(d: int, bk: int, stages: int) -> int:
    """tc_smem_bytes<D, BK>() of the source."""
    return (TC_BQ + 2 * stages * bk) * d * 2 + 8 * (1 + 2 * stages) + 1024


def build(variant, out: Path) -> subprocess.Popen:
    from repro_torch.kernels import _build
    bk, stages, wg_from = variant
    cmd = [_build._nvcc(), *_build.FLAGS, f"-DFLASH_TC_BK={bk}", f"-DFLASH_TC_STAGES={stages}",
           f"-DFLASH_TC_WG_FROM_D={wg_from}", "-o", str(out),
           str(_build.CSRC / "flash_attention.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas_lines(log: str):
    """ptxas's report for the tensor-core kernel entries and every
    warning of the build."""
    entry, out = "", []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "warning" in line.lower() or ("flash_tc" in entry and (
                "spill" in line or ": Used " in line)):
            out.append(f"{entry[:60]}: {line.strip()}")
    return out


def launch(lib, q, k, v, causal):
    import torch
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = lib.flash_attention_bf16_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, b, sq, skv, hq, hkv, d,
        int(causal), 0, 1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bf16_sm90 failed with CUDA error {err}")
    return out


def cuda_ms(fn, reps=20):
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build, flash_attention, ref
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    sweep = _build.BUILD_DIR / "sweep"
    sweep.mkdir(parents=True, exist_ok=True)
    procs = {name: (build(v, sweep / f"libflash-{name}.so"), sweep / f"libflash-{name}.so")
             for name, v in VARIANTS.items()}
    libs, ok = {}, True
    for name, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log}", flush=True)
            ok = False
            continue
        for line in ptxas_lines(log):
            print(f"ptxas {name} {line}", flush=True)
        lib = ctypes.CDLL(str(path))
        lib.flash_attention_bf16_sm90.argtypes = flash_attention._TC_ARGS
        lib.flash_attention_bf16_sm90.restype = ctypes.c_int
        libs[name] = lib
    if not ok:
        sys.exit(1)

    def fits(name, d):
        bk, stages, _ = VARIANTS[name]
        return smem_bytes(d, bk, stages) <= SMEM_LIMIT

    g = torch.Generator(device="cuda").manual_seed(0)
    for shape in MAIN + RAGGED:
        b, sq, skv, hq, hkv, d, causal = shape
        q = torch.randn((b, sq, hq, d), generator=g, device="cuda").bfloat16()
        k, v = (torch.randn((b, skv, hkv, d), generator=g, device="cuda").bfloat16()
                for _ in range(2))
        want = ref.attention(q, k, v, causal=causal).float()
        up = ref.attention(q.float(), k.float(), v.float(), causal=causal)
        run = [name for name in libs if fits(name, d)]
        for name in libs:
            if name not in run:
                print(f"{name} {shape}: skipped, {smem_bytes(d, *VARIANTS[name][:2])} bytes "
                      f"of shared memory", flush=True)
                continue
            got = launch(libs[name], q, k, v, causal).float()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            diff = (got - up).abs()
            rel = (diff / up.abs().clamp(min=1e-5 / 2 ** -7)).max().item()
            good = (torch.allclose(got, want, atol=3e-2, rtol=3e-2)
                    and torch.allclose(got, up, atol=1e-5, rtol=2 ** -7))
            ok &= good
            print(f"{name} {shape}: max_abs_err {err:.3e} against float32 inputs "
                  f"{diff.max().item():.3e} (max relative {rel:.3e}) "
                  f"{'ok' if good else 'FAIL'}", flush=True)
        if shape in MAIN:
            flops = 4 * b * hq * sq * skv * d / (2 if causal else 1)
            times = {name: [] for name in run}
            for name in run + run[::-1]:
                times[name].append(cuda_ms(lambda lib=libs[name]: launch(lib, q, k, v, causal)))
            for name, ts in times.items():
                print(f"{name} D {d} prefill shape: {' / '.join(f'{t:.4f}' for t in ts)} ms, "
                      f"{flops / min(ts) / 1e9:.1f} TFLOP/s, bound "
                      f"{flops / BF16_FLOPS * 1e3:.4f} ms", flush=True)
            core = cuda_ms(lambda: flash_attention.flash_attention(
                q, k, v, causal=causal, route=flash_attention.CUDA_CORE), reps=5)
            sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=causal,
                enable_gqa=True))
            print(f"D {d} prefill shape: CUDA-core route {core:.4f} ms, "
                  f"scaled_dot_product_attention {sdpa:.4f} ms", flush=True)
        del q, k, v, want, up
    if not ok:
        sys.exit(1)
    print("sweep ok", flush=True)


if __name__ == "__main__":
    main()
