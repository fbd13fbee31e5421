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
