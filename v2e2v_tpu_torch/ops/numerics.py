"""Numerics of the slice (port of ``v2e2v_tpu/ops/numerics.py``)."""

from __future__ import annotations

import torch


def softshrink(x: torch.Tensor, lambd: torch.Tensor) -> torch.Tensor:
    """Soft-thresholding ``relu(x - l) - relu(-x - l)``; ``lambd`` is a
    per-channel vector broadcast over the last (channel) axis of NHWC input."""
    return torch.relu(x - lambd) - torch.relu(-x - lambd)
