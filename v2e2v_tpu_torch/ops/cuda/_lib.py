"""Build the package's CUDA sources with ``nvcc`` and load them with ``ctypes``.

All sources under ``v2e2v_tpu_torch/csrc/`` go through ONE ``nvcc`` command
into one shared library with a plain C interface (no PyTorch headers, so it
builds in seconds). The library lands in ``build/kernels/`` at the repo root,
named by a hash of the sources and flags, and is built at first use in a
process; a later process with the same sources loads it as it is.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


@dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an earlier process built it
    log: str  # nvcc's output, -Xptxas -v included

    def check(self, err: int, what: str) -> None:
        if err != 0:
            msg = self.lib.v2e_error_string(err).decode()
            raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not cand.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return str(cand)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.v2e_ista_conv3x3.argtypes = [i, i, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.v2e_ista_conv3x3.restype = i
    lib.v2e_ista_conv3x3_smem_bytes.argtypes = [i]
    lib.v2e_ista_conv3x3_smem_bytes.restype = i
    lib.v2e_error_string.argtypes = [i]
    lib.v2e_error_string.restype = ctypes.c_char_p


@functools.cache
def load() -> KernelLibrary:
    """Build (if needed) and load the kernel library; raises if nvcc fails."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode() + src.read_bytes())
    out = BUILD_DIR / f"libv2e2v_kernels_{digest.hexdigest()[:16]}.so"
    log_path = out.with_suffix(".log")
    seconds = 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
        log_path.write_text(log)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _declare(lib)
    log = log_path.read_text() if log_path.exists() else ""
    return KernelLibrary(lib=lib, path=out, build_seconds=seconds, log=log)
