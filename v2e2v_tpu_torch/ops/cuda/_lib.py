"""Build the package's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Every source under ``v2e2v_tpu_torch/csrc/`` is compiled by its own ``nvcc``
process, all started together, and one more ``nvcc`` links the objects into
one shared library with a plain C interface (no PyTorch headers, so it builds
in seconds). The library lands in ``build/kernels/`` at the repo root, named by
a hash of the sources, the shared headers (``*.cuh``) and the flags, and is
built at first use in a process; a later process with the same files loads it
as it is.
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
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


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


def check_aligned(what: str, **tensors) -> None:
    """The convs of K1, K2 and K4 and K4's scale kernel read 16-byte rows
    (``cp.async`` or 16-byte loads; the float32 conv also stores 16-byte
    vectors): raise if a tensor does not start on a 16-byte boundary (a view
    at an odd offset)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must start on a 16-byte boundary for the "
                             f"{str(t.dtype).split('.')[1]} kernel "
                             f"(data_ptr % 16 = {t.data_ptr() % 16})")


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
    lib.v2e_conv3x3_tile_w.argtypes = [i, i, i, i]
    lib.v2e_conv3x3_tile_w.restype = i
    lib.v2e_conv3x3_smem_bytes.argtypes = [i]
    lib.v2e_conv3x3_smem_bytes.restype = i
    lib.v2e_conv3x3_tc_smem_bytes.argtypes = [i]
    lib.v2e_conv3x3_tc_smem_bytes.restype = i
    lib.v2e_core_conv3x3.argtypes = [i, i, p, p, i, p, p, i, p, p, p, p, i, i, i, i, p]
    lib.v2e_core_conv3x3.restype = i
    lib.v2e_core_lstc_cell.argtypes = [i, p, p, p, p, p, p, i, i, p]
    lib.v2e_core_lstc_cell.restype = i
    lib.v2e_core_lstm_cell.argtypes = [i, p, p, p, p, i, i, p]
    lib.v2e_core_lstm_cell.restype = i
    lib.v2e_emulator_iters.argtypes = [*[p] * 11, ctypes.c_float, *[p] * 3, *[i] * 6, p]
    lib.v2e_emulator_iters.restype = i
    lib.v2e_qconv3x3.argtypes = [p, p, i, i, i, p, p, p, p, p, i, i, i, i, i, p]
    lib.v2e_qconv3x3.restype = i
    lib.v2e_qconv3x3_smem_bytes.argtypes = [i]
    lib.v2e_qconv3x3_smem_bytes.restype = i
    n = ctypes.c_longlong
    lib.v2e_qscale.argtypes = [p, n, p, n, i, p, p, p]
    lib.v2e_qscale.restype = i
    lib.v2e_qscale_work_words.argtypes = []
    lib.v2e_qscale_work_words.restype = i
    lib.v2e_error_string.argtypes = [i]
    lib.v2e_error_string.restype = ctypes.c_char_p


def _run_nvcc(cmds: list[list[str]]) -> str:
    """Run the nvcc commands all at once; returns their output in order, or
    raises with it if one fails."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    return "".join(outs)


@functools.cache
def load() -> KernelLibrary:
    """Build (if needed) and load the kernel library; raises if nvcc fails."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode() + src.read_bytes())
    out = BUILD_DIR / f"libv2e2v_kernels_{digest.hexdigest()[:16]}.so"
    log_path = out.with_suffix(".log")
    seconds = 0.0
    if not out.exists():
        work = BUILD_DIR / f"{out.stem}.{os.getpid()}"
        work.mkdir(parents=True, exist_ok=True)
        objs = [work / f"{src.stem}.o" for src in sources]
        nvcc = _nvcc()
        t0 = time.perf_counter()
        log = _run_nvcc([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                         for src, obj in zip(sources, objs)])
        tmp = work / out.name
        log += _run_nvcc([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
        seconds = time.perf_counter() - t0
        log_path.write_text(log)
        os.replace(tmp, out)
        shutil.rmtree(work, ignore_errors=True)
    lib = ctypes.CDLL(str(out))
    _declare(lib)
    log = log_path.read_text() if log_path.exists() else ""
    return KernelLibrary(lib=lib, path=out, build_seconds=seconds, log=log)
