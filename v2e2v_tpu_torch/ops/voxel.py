"""Events -> normalised voxel grid (port of ``v2e2v_tpu/ops/voxel.py``).

The request front end of the E2V slice: ``events_to_voxel_grid`` bins a
packet of events into a ``(num_bins, H, W)`` grid with one ``index_add_``
(the JAX package's ``method='scatter', layout='ref'`` path), and
``event_preprocess`` normalises it per sample (its ``mode='std'``).
"""

from __future__ import annotations

import torch


def events_to_voxel_grid(
    t: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    p: torch.Tensor,
    n_valid: int | torch.Tensor,
    *,
    num_bins: int,
    width: int,
    height: int,
) -> torch.Tensor:
    """Voxelize ``[N]`` event arrays with a static capacity ``N``.

    Events are sorted by ``t``; entries at index ``>= n_valid`` are padding.
    Timestamps are cast to float32 BEFORE the first stamp is subtracted, as
    in the JAX package; polarity 0 maps to -1, and each event is split
    bilinearly between its two neighbouring bins. Returns a float32
    ``(num_bins, height, width)`` grid on the events' device.
    """
    device = t.device
    capacity = t.shape[0]
    grid_size = num_bins * height * width
    t = t.to(torch.float32)
    n_valid = torch.as_tensor(n_valid, device=device, dtype=torch.int64)
    is_valid = torch.arange(capacity, device=device) < n_valid

    first_stamp = t[0]
    last_stamp = t[(n_valid - 1).clamp(min=0)]
    delta_t = last_stamp - first_stamp
    delta_t = torch.where(delta_t == 0, torch.ones_like(delta_t), delta_t)

    ts = (num_bins - 1) * (t - first_stamp) / delta_t
    pols = p.to(torch.float32)
    pols = torch.where(pols == 0, -torch.ones_like(pols), pols)

    tis_f = torch.floor(ts)
    dts = ts - tis_f
    tis = tis_f.to(torch.int64)
    base = x.to(torch.int64) + y.to(torch.int64) * width
    bin_stride = width * height

    left_idx = base + tis * bin_stride
    right_idx = left_idx + bin_stride
    left_ok = is_valid & (tis < num_bins) & (tis >= 0)
    right_ok = is_valid & ((tis + 1) < num_bins) & (tis >= 0)
    # masked or out-of-grid entries go to one spare cell past the grid
    left_ok = left_ok & (left_idx >= 0) & (left_idx < grid_size)
    right_ok = right_ok & (right_idx >= 0) & (right_idx < grid_size)
    spare = torch.full_like(left_idx, grid_size)
    zero = torch.zeros_like(pols)
    idx = torch.cat([torch.where(left_ok, left_idx, spare), torch.where(right_ok, right_idx, spare)])
    val = torch.cat([
        torch.where(left_ok, pols * (1.0 - dts), zero),
        torch.where(right_ok, pols * dts, zero),
    ])
    grid = torch.zeros(grid_size + 1, dtype=torch.float32, device=device)
    grid.index_add_(0, idx, val)
    return grid[:grid_size].reshape(num_bins, height, width)


def event_preprocess(voxel: torch.Tensor) -> torch.Tensor:
    """Per-sample 'std' normalisation of the non-zero voxels.

    Leading dims are batch; statistics reduce over the trailing
    ``[bins, H, W]``. The std is ``sqrt(E[x^2] - mean^2)`` over the non-zero
    count (not ``torch.std``); a grid with no events is returned unchanged.
    """
    red = (-3, -2, -1)
    nonzero = voxel != 0
    num_nonzeros = nonzero.sum(dim=red, keepdim=True)
    denom = num_nonzeros.clamp(min=1).to(torch.float32)
    mean = voxel.sum(dim=red, keepdim=True) / denom
    stddev = torch.sqrt(
        ((voxel**2).sum(dim=red, keepdim=True) / denom - mean**2).clamp(min=0.0)
    )
    normalized = nonzero.to(torch.float32) * (voxel - mean) / (stddev + 1e-8)
    return torch.where(num_nonzeros > 0, normalized, voxel)
