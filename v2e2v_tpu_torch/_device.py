"""Device choice for the package's entry points."""

from __future__ import annotations

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
