"""The device of the port's CLIs (port of ``apply_platform_override`` in
``v2e2v_tpu/utils/profiling.py``).

The JAX CLIs honour ``V2E2V_PLATFORM`` (``cpu`` forces the CPU). The port's
CLIs read the same variable: ``cpu`` runs on the CPU, ``cuda`` or ``gpu`` (or
no value) on the CUDA card, raising without one. Profiling (``--profile_dir``)
is not ported.
"""

from __future__ import annotations

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
