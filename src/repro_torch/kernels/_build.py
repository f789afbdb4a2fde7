"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with
``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes``. A build happens at first use, keyed by a hash of the source
and the flags, into ``build/kernels/`` at the root of the checkout;
:func:`build_all` starts one ``nvcc`` per source, all at once. Nothing
here runs when the module is imported, so the CPU tests import it
without ``nvcc`` or a GPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# no --use_fast_math: it would change division, sqrtf and cbrtf;
# --ptxas-options=-v reports each kernel's registers, spills and shared memory
FLAGS = ("-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
         "-gencode=arch=compute_90a,code=sm_90a", "--ptxas-options=-v")

P = ctypes.c_void_p  # every pointer and the stream
I = ctypes.c_int     # every size


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return path


class _Build:
    """One running nvcc: writes a temporary file, renamed when it ends."""

    def __init__(self, name: str, source: Path, out: Path):
        self.name, self.out = name, out
        self.tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *FLAGS, "-o", str(self.tmp), str(source)]
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)

    def finish(self) -> str:
        """Wait for nvcc -> its output (ptxas's report included)."""
        log, _ = self.proc.communicate()
        if self.proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.name}:\n{log}")
        os.replace(self.tmp, self.out)
        return log


class CudaKernel:
    """One kernel's source, its built library and its launch count.

    ``launches`` is a plain integer that :meth:`launch` raises by one
    each time the kernel is launched, so a run can show that it went
    through the kernel; a caller may reset it to 0.
    """

    def __init__(self, name: str, symbols: dict):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.symbols = symbols  # C symbol -> ctypes argtypes
        self.launches = 0
        self._lib = None

    def lib_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def start_build(self):
        """Start nvcc unless the library is built; -> a build or None."""
        out = self.lib_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        return _Build(self.name, self.source, out)

    def load(self):
        """The loaded library, built first if needed."""
        if self._lib is None:
            build = self.start_build()
            if build is not None:
                build.finish()
            lib = ctypes.CDLL(str(self.lib_path()))
            for sym, argtypes in self.symbols.items():
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def launch(self, symbol: str, *args) -> None:
        """Call a C entry point, which returns ``cudaGetLastError()``."""
        err = getattr(self.load(), symbol)(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}: {symbol} failed with CUDA "
                               f"error {err}")
        self.launches += 1


def build_all(kernels) -> dict:
    """Build every kernel's library in parallel (one nvcc each), then
    load them all -> {name: nvcc's output} of the kernels built here
    (those already built are left out)."""
    builds = [b for b in (k.start_build() for k in kernels) if b is not None]
    errors, logs = [], {}
    for b in builds:
        try:
            logs[b.name] = b.finish()
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in kernels:
        k.load()
    return logs
