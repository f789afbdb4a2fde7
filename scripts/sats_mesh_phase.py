"""Run chip_smoke.py's phase 19 alone on the GPU machine: the fleet's
``sats`` mesh on a one-rank NCCL group, its recount pipeline included.

Builds the three Mission kernels (tile_moments, kmeans_assign, iou), then
calls ``chip_smoke.phase_sats_mesh`` and prints what it prints, with the
card's name and power limit first.

    python3 scripts/sats_mesh_phase.py
"""
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts src/ on the path)


def main():
    import torch
    from repro_torch.kernels import _build, ops
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = [k for k in ops.KERNELS if k.name in ("tile_moments", "kmeans_assign", "iou")]
    t0 = time.perf_counter()
    _build.build_all(kernels)
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    launches, entries = chip_smoke.phase_sats_mesh(torch.device("cuda"), kernels, smi)
    print(f"launches {launches}; by entry {entries}", flush=True)
    print(smi)


if __name__ == "__main__":
    main()
