"""Native (C++) data-path runtime, loaded with ctypes (port of ``v2e2v_tpu/runtime``).

``ev_io.cpp`` is the port's own copy of the JAX package's source. It is built
at first use with ``g++ -O3 -march=native`` into ``build/runtime/`` at the
repo root, under a name that hashes the source, the flags and the host's CPU
flags (a ``-march=native`` library is not portable between hosts: a stale one
can raise SIGILL). Callers fall back to the numpy paths when the toolchain or
the build is missing (``available()``), as the JAX package's callers do.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "ev_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "runtime"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]


class NativeUnavailable(RuntimeError):
    pass


def _host_fingerprint() -> str:
    """The CPU's ``flags`` line: the build is keyed to it."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line.strip()
    except OSError:
        pass
    return "unknown"


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode() + _host_fingerprint().encode())
    return BUILD_DIR / f"ev_io_{digest.hexdigest()[:16]}.so"


@functools.cache
def _load() -> ctypes.CDLL:
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.so")
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC)], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, out)  # atomic: concurrent processes each load a whole file
    lib = ctypes.CDLL(str(out))
    lib.ev_parse_txt.restype = ctypes.c_long
    lib.ev_parse_txt.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_double))]
    lib.ev_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
    lib.ev_voxelize.restype = ctypes.c_long
    lib.ev_voxelize.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
    ]
    lib.ev_preprocess_std.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_float,
    ]
    return lib


@functools.cache
def available() -> bool:
    """True when the library builds (or is built) and loads; a failed build
    is not tried again in the process."""
    try:
        _load()
        return True
    except (OSError, subprocess.SubprocessError):  # no g++, a failed build or load
        return False


def parse_events_txt(path: str) -> np.ndarray:
    """Parse a ``t x y p`` event table into float64 ``[N, 4]`` (``strtod``)."""
    lib = _load()
    out = ctypes.POINTER(ctypes.c_double)()
    n = lib.ev_parse_txt(path.encode(), ctypes.byref(out))
    if n < 0:
        raise NativeUnavailable(f"native parse failed ({n}) for {path!r}")
    if n == 0:
        return np.zeros((0, 4), np.float64)
    try:
        arr = np.ctypeslib.as_array(out, shape=(n, 4)).copy()
    finally:
        lib.ev_free(out)
    return arr


def voxelize_events(
    events: np.ndarray,
    num_bins: int,
    width: int,
    height: int,
    preprocess: bool = False,
    hot_pixel_threshold: float = 0.0,
) -> np.ndarray:
    """Native events -> voxel grid (reference semantics); optional fused
    hot-pixel filter (``hot_pixel_threshold > 0``) and non-zero mean/std
    normalisation, its sums in float64.

    Raises IndexError when an event's coordinates fall outside the grid, the
    numpy path's contract (``np.add.at``)."""
    lib = _load()
    events = np.ascontiguousarray(events, dtype=np.float64)
    grid = np.empty((num_bins, height, width), np.float32)
    oob = lib.ev_voxelize(
        events.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(events), num_bins, width, height,
        grid.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if oob:
        raise IndexError(
            f"{oob}/{len(events)} events outside {width}x{height}: does "
            "--image_dim match the dataset resolution?"
        )
    if preprocess:
        lib.ev_preprocess_std(
            grid.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            grid.size,
            np.float32(hot_pixel_threshold),
        )
    return grid
