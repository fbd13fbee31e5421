"""Platform choice, tracing and NaN debugging of the port's CLIs (port of
``v2e2v_tpu/utils/profiling.py``).

- ``apply_platform_override``: the JAX CLIs honour ``V2E2V_PLATFORM``
  (``cpu`` forces the CPU); the port's CLIs read the same variable: ``cpu``
  runs on the CPU, ``cuda`` or ``gpu`` (or no value) on the CUDA card,
  raising without one.
- ``maybe_profile``: a ``torch.profiler`` trace of a whole region into
  ``--profile_dir``, one file per process, as ``jax.profiler`` writes one per
  JAX process.
- ``enable_nan_debugging``: JAX's ``jax_debug_nans`` ("abort on the first
  NaN"). Autograd's anomaly mode finds NaNs that a backward pass makes; the
  train steps (``training/steps.py``) also raise ``FloatingPointError`` on
  the first step whose loss, a gradient or an updated weight holds a NaN
  while the mode is on, and read nothing back from the device while it is
  off.
"""

from __future__ import annotations

import contextlib
import os

import torch

from .._device import resolve_device


def apply_platform_override() -> torch.device:
    """Returns the device the CLI runs on, from ``V2E2V_PLATFORM``."""
    platform = os.environ.get("V2E2V_PLATFORM", "").strip().lower()
    if platform == "cpu":
        return torch.device("cpu")
    if platform in ("", "cuda", "gpu"):
        return resolve_device(None)
    raise ValueError(f"V2E2V_PLATFORM={platform!r}: the port runs on 'cpu' or 'cuda'")


@contextlib.contextmanager
def maybe_profile(profile_dir: str | None, device: torch.device | str = "cpu"):
    """Trace the region into ``profile_dir`` when it is set, else do nothing.

    The trace records the host's ops, and the card's kernels when ``device``
    is a CUDA device, over the whole region; it is written when the region
    exits, on an exception too, as ``rank<r>.<time>.pt.trace.json`` (``r``
    the process's rank, 0 without a process group), which TensorBoard and
    ``chrome://tracing`` read. No shapes and no stacks: the profiler holds
    every event of the region in memory."""
    if not profile_dir:
        yield
        return
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    handler = tensorboard_trace_handler(profile_dir, worker_name=f"rank{rank}")
    with profile(activities=activities, on_trace_ready=handler, record_shapes=False,
                 with_stack=False, profile_memory=False):
        yield


def enable_nan_debugging(enabled: bool = True) -> None:
    """Turn autograd's anomaly mode on or off. While it is on, the train
    steps check each step for NaNs (not infinities, as ``jax_debug_nans``)."""
    torch.autograd.set_detect_anomaly(enabled)


def nan_debugging() -> bool:
    """Whether ``enable_nan_debugging`` is on."""
    return torch.is_anomaly_enabled()
