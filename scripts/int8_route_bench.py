#!/usr/bin/env python3
"""Time ``int8_matmul``'s routes at a qwen3-8b projection, on one or more trees.

    python3 scripts/int8_route_bench.py [ROOT ...]

Needs one CUDA card and ``nvcc``. Each ROOT (default: this checkout) is a
checkout of the repository. For each, in a process of its own, its
``src/repro_torch`` is imported, its ``int8_matmul`` library built from
its own sources into its own ``build/kernels/``, and every route its
wrapper has (``int8_matmul.SYMBOLS``; a tree without routes has the
dp4a kernel alone) is held bit-equal against ``ref.int8_matmul`` and
timed with CUDA events at the gate/up projection over one 4096-token
prompt, 4096 x 4096 x 12288, beside ``torch._int_mm`` (the int32
product without the scales). Name a tree twice, in turns (parent,
change, change, parent), to see the spread. Prints one JSON line per
tree and route, then ``nvidia-smi``'s name and power limit; exits
non-zero if a build fails or a result disagrees.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
M, K, N = 4096, 4096, 12288


def one(root: Path):
    sys.path.insert(0, str(HERE))
    import torch
    from chip_smoke import INT8_OPS, bound_ms, cuda_ms  # puts this checkout's src first
    sys.path.insert(0, str(root / "src"))               # so the tree's own goes before it
    from repro_torch.kernels import int8_matmul, ref
    assert Path(int8_matmul.__file__).is_relative_to(root), int8_matmul.__file__

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    args = (torch.randint(-127, 128, (M, K), generator=g, device=dev, dtype=torch.int8),
            torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8),
            torch.rand(M, generator=g, device=dev) + 0.1,
            torch.rand(N, generator=g, device=dev) + 0.1)
    want = ref.int8_matmul(*args)
    routes = getattr(int8_matmul, "SYMBOLS", {None: "int8_matmul_s8"})
    b_ms, b_by = bound_ms(M * K + K * N + 4 * (M + N) + 4 * M * N, 2 * M * K * N, INT8_OPS)
    lib_ms = cuda_ms(lambda: torch._int_mm(args[0], args[1]), reps=20)
    for route, symbol in routes.items():
        def call(r=route):
            return int8_matmul.int8_matmul(*args) if r is None else \
                int8_matmul.int8_matmul(*args, route=r)
        before = int8_matmul.KERNEL.symbol_launches.get(symbol, int8_matmul.KERNEL.launches)
        got = call()
        torch.cuda.synchronize()
        after = int8_matmul.KERNEL.symbol_launches.get(symbol, int8_matmul.KERNEL.launches)
        if after != before + 1 or not torch.equal(got, want):
            print(f"FAIL: {root} route {route}: launched {after - before} of {symbol}, "
                  f"bit-equal {torch.equal(got, want)}", file=sys.stderr)
            sys.exit(1)
        ms = cuda_ms(call, reps=10)
        print(json.dumps(dict(root=str(root), route=route, symbol=symbol, shape=[M, K, N],
                              ms=ms, bound_ms=b_ms, bound_by=b_by, share=b_ms / ms,
                              tops=2 * M * K * N / ms / 1e9, int_mm_ms=lib_ms,
                              bit_equal=True)), flush=True)


def main():
    if sys.argv[1:2] == ["--one"]:
        one(Path(sys.argv[2]).resolve())
        return
    roots = [Path(r).resolve() for r in sys.argv[1:]] or [HERE]
    for root in roots:
        subprocess.run([sys.executable, __file__, "--one", str(root)], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
