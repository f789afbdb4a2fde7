#!/usr/bin/env python3
"""Where the tensor-core ``int8_matmul``'s time goes: knock parts out.

    python3 scripts/int8_tc_ablation.py

Needs one CUDA card and ``nvcc``. Builds ``src/repro_torch/csrc/
int8_matmul.cu`` as it is and with parts of ``int8_tc_kernel`` taken out
(one ``nvcc`` each, in parallel, into ``build/kernels/ablation/``):
the in-kernel transpose of the w tile, the wgmma products, both, the
epilogue's stores, or the overlap of the transpose with the products
(``serial`` waits for the products first). Times each at the gate/up
projection over one 4096-token prompt, 4096 x 4096 x 12288, with CUDA
events, twice in turns; only the unchanged build must be bit-equal to
``ref.int8_matmul`` (the others compute something else). Prints one
line per build and round, then ``nvidia-smi``'s name and power limit.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

M, K, N = 4096, 4096, 12288
_NO_TRANSPOSE = ("void transpose_w(const uint8_t* raw, uint8_t* wt, int tid) {",
                 "void transpose_w(const uint8_t* raw, uint8_t* wt, int tid) {\n"
                 "  if (tid >= 0) return;")
_NO_PRODUCTS = [("    wgmma_s8(d0, sw128_desc", "    if (s_x == 1) wgmma_s8(d0, sw128_desc"),
                ("    wgmma_s8(d1, sw128_desc", "    if (s_x == 1) wgmma_s8(d1, sw128_desc")]
VARIANTS = {
    "as_is": [],
    "no_transpose": [_NO_TRANSPOSE],
    "no_products": _NO_PRODUCTS,
    "no_products_no_transpose": _NO_PRODUCTS + [_NO_TRANSPOSE],
    "no_epilogue": [("  store_half(acc0, xs", "  if (m < 0) store_half(acc0, xs"),
                    ("  store_half(acc1, xs", "  if (m < 0) store_half(acc1, xs")],
    "serial": [("    if (t + 1 < n_steps) {  // transpose",
                "    wgmma_wait_all();\n    if (t + 1 < n_steps) {  // transpose")],
}


def main():
    import torch
    from chip_smoke import INT8_OPS, bound_ms, cuda_ms  # puts src on the path
    from repro_torch.kernels import _build, ref

    src = (_build.CSRC / "int8_matmul.cu").read_text()
    out = _build.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for a, b in subs:
            if a not in text:
                sys.exit(f"FAIL: {name}: the source no longer has {a!r}")
            text = text.replace(a, b)
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, "-o", str(out / f"lib{name}.so"),
             str(out / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    fns = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            sys.exit(f"FAIL: nvcc for {name}:\n{log}")
        fn = ctypes.CDLL(str(out / f"lib{name}.so")).int8_matmul_s8_sm90
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(-127, 128, (M, K), generator=g, device=dev, dtype=torch.int8)
    w = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
    xs, ws = torch.rand(M, generator=g, device=dev) + 0.1, torch.rand(N, generator=g, device=dev) + 0.1
    want = ref.int8_matmul(x, w, xs, ws)
    b_ms, b_by = bound_ms(M * K + K * N + 4 * (M + N) + 4 * M * N, 2 * M * K * N, INT8_OPS)
    print(f"int8 tc ablation at ({M}, {K}) x ({K}, {N}): bound {b_ms:.4f} ms ({b_by})")
    for rnd in range(2):
        for name, fn in fns.items():
            o = torch.full((M, N), float("nan"), device=dev)
            stream = torch.cuda.current_stream().cuda_stream

            def call(fn=fn, o=o):
                return fn(x.data_ptr(), w.data_ptr(), xs.data_ptr(), ws.data_ptr(),
                          o.data_ptr(), M, K, N, stream)
            if call() != 0:
                sys.exit(f"FAIL: {name} did not launch")
            torch.cuda.synchronize()
            equal = torch.equal(o, want)
            if name == "as_is" and not equal:
                sys.exit("FAIL: the unchanged kernel is not bit-equal")
            print(f"round {rnd} {name}: {cuda_ms(call, reps=10):.4f} ms"
                  + (" (bit-equal)" if name == "as_is" else ""), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
