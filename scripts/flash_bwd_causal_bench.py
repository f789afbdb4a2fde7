#!/usr/bin/env python3
"""Check and time ``flash_attention``'s causal GQA backward on the card.

    python3 scripts/flash_bwd_causal_bench.py [--all]

Needs one CUDA card and ``nvcc``. Builds every kernel library of the port
(``chip_smoke.py``'s phase 1: one ``nvcc`` a source, in parallel, and
ptxas's registers and spills of each entry, a spill failing the run), then
runs ``chip_smoke.phase_flash_bwd`` on the causal cases of
``chip_smoke.flash_bwd_cases``: the attention of phi4-mini-3.8b (24 / 8
heads) and qwen3-8b (32 / 8) at 4096 tokens a row in bf16, and ragged
causal GQA cases in float32 and bf16, Sq = Skv, Sq < Skv and Sq > Skv.
``--all`` runs every case of phase 2's backward list (phase 15's
non-causal shapes too). Each case on its route (and a tensor-core case
forced onto the CUDA-core entries), against ``ref.attention_bwd`` (bf16:
relative norm 3.7e-3 of the float32-upcast gradient; float32: 2e-5), two
calls bit-equal, timed with CUDA events beside the bound and SDPA's
backward (``is_causal`` and ``enable_gqa`` where the case has them).
Exits non-zero if a build fails or a check does not hold.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main():
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build, ops
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    cs.ptxas_report(_build.build_all(ops.KERNELS))
    cases = [c for c in cs.flash_bwd_cases() if c[3] or "--all" in sys.argv[1:]]
    times = cs.phase_flash_bwd(torch.device("cuda"), {"flash_attention": {"entries": {}}}, cases)
    for label, t in times.items():
        print(f"{label}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items()), flush=True)
    print(smi)


if __name__ == "__main__":
    main()
