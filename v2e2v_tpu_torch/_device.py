"""Device choice for the package's entry points."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``None`` means the CUDA card; the CPU runs only when asked for.

    There is no fallback: without a card and without ``device="cpu"`` this
    raises.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def make_first_cpu_vml_call() -> None:
    """Make the process's first MKL VML call here and discard its result.

    torch's CPU ``log``, ``exp`` and ``tanh`` call MKL's VML on each intra-op
    thread. The first VML call of a process came out inexact on one or more
    threads' shares of the elements in about 1 of 10 fresh processes (``log``
    up to 1549 ulp from the float64 value, ``tanh`` up to 4e-5), with or
    without JAX in the process; the calls after it, of the same or another
    VML function, were exact (``scripts/probe_first_vml_call.py``). The
    package makes that call when it is imported, on enough elements for
    every thread to take a share, so no result of the port comes from it.
    """
    torch.ones(max(1 << 16, 4096 * torch.get_num_threads())).log_()


@contextlib.contextmanager
def float32_math():
    """TF32 off in cuDNN's convs and in matmuls for the block, then the old
    settings back. torch lets cuDNN round float32 conv inputs to TF32 by
    default; the port's float32 paths hold the JAX package's float32 numbers
    (SSIM's ``blur(x^2) - mu^2`` cancels catastrophically at TF32's 10-bit
    mantissa). A backward pass reads the settings when it runs, so run it
    inside the block too."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
