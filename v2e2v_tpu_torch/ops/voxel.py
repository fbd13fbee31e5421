"""Events -> normalised voxel grid (port of ``v2e2v_tpu/ops/voxel.py``).

The device path, the request front end of stream serving:
``events_to_voxel_grid`` bins a packet of events into a ``(num_bins, H, W)``
grid, or the parity-packed ``(H/2, W/2, 4 num_bins)`` one that
``cista_sequence(..., input_packed=True)`` reads, with one ``index_add_``
(the JAX package's ``method='scatter'`` path), and ``event_preprocess`` normalises it per sample.

``add_noise_to_voxel`` is the training augmentation, drawn from a
``torch.Generator``.

The host path, the evaluation CLI's data readers: ``events_to_voxel_grid_np``
and ``event_preprocess_np`` are the JAX package's numpy functions as they
are, and ``voxelize_and_preprocess_np`` makes its choice between the native
runtime (``v2e2v_tpu_torch.runtime``) and numpy.
"""

from __future__ import annotations

import numpy as np
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
    layout: str = "ref",
) -> torch.Tensor:
    """Voxelize ``[N]`` event arrays with a static capacity ``N``.

    Events are sorted by ``t``; entries at index ``>= n_valid`` are padding.
    Timestamps are cast to float32 BEFORE the first stamp is subtracted, as
    in the JAX package; polarity 0 maps to -1, and each event is split
    bilinearly between its two neighbouring bins. Returns a float32
    ``(num_bins, height, width)`` grid on the events' device, or with
    ``layout='parity'`` (even ``height`` and ``width``) the same values as
    ``(height/2, width/2, 4 num_bins)``, channels in ``(y % 2, x % 2, bin)``
    order (``ops/fused.space_to_depth`` of the ``[H, W, num_bins]`` grid):
    only the flat index differs.
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
    xs, ys = x.to(torch.int64), y.to(torch.int64)
    if layout == "ref":
        base = xs + ys * width
        bin_stride = width * height
    elif layout == "parity":
        if height % 2 or width % 2:
            raise ValueError("layout='parity' requires even height/width")
        # flat index into [H/2, W/2, 4 nb], channel order (y%2, x%2, bin)
        base = ((torch.div(ys, 2, rounding_mode="floor") * (width // 2)
                 + torch.div(xs, 2, rounding_mode="floor")) * (4 * num_bins)
                + (ys % 2 * 2 + xs % 2) * num_bins)
        bin_stride = 1
    else:
        raise ValueError(f"unknown layout: {layout!r}")

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
    if layout == "parity":
        return grid[:grid_size].reshape(height // 2, width // 2, 4 * num_bins)
    return grid[:grid_size].reshape(num_bins, height, width)


def event_preprocess(
    voxel: torch.Tensor,
    mode: str = "std",
    filter_hot_pixel: bool = False,
    hot_pixel_threshold: float | None = None,
) -> torch.Tensor:
    """Per-sample normalisation of a voxel grid on its device.

    Leading dims are batch; statistics reduce over the trailing
    ``[bins, H, W]``. ``filter_hot_pixel`` first zeroes the voxels whose
    magnitude exceeds the threshold (default ``20 / num_bins`` on the device,
    as in the JAX package). ``mode='std'``: the non-zero voxels to zero mean
    and unit std, the std being ``sqrt(E[x^2] - mean^2)`` over the non-zero
    count (not ``torch.std``); a grid with no events is returned unchanged.
    ``mode='maxmin'``: ``(v - min) / (max - min + 1e-8)``. Any other mode
    leaves the values as they are.
    """
    red = (-3, -2, -1)
    if filter_hot_pixel:
        num_bins = voxel.shape[-3]
        thr = 20.0 / num_bins if hot_pixel_threshold is None else hot_pixel_threshold
        voxel = torch.where(voxel.abs() > thr, torch.zeros_like(voxel), voxel)
    if mode == "maxmin":
        vmin = voxel.amin(dim=red, keepdim=True)
        vmax = voxel.amax(dim=red, keepdim=True)
        return (voxel - vmin) / (vmax - vmin + 1e-8)
    if mode != "std":
        return voxel
    nonzero = voxel != 0
    num_nonzeros = nonzero.sum(dim=red, keepdim=True)
    denom = num_nonzeros.clamp(min=1).to(torch.float32)
    mean = voxel.sum(dim=red, keepdim=True) / denom
    stddev = torch.sqrt(
        ((voxel**2).sum(dim=red, keepdim=True) / denom - mean**2).clamp(min=0.0)
    )
    normalized = nonzero.to(torch.float32) * (voxel - mean) / (stddev + 1e-8)
    return torch.where(num_nonzeros > 0, normalized, voxel)


def add_noise_to_voxel(
    generator: torch.Generator,
    voxel: torch.Tensor,
    noise_std: float = 1.0,
    noise_fraction: float = 0.1,
    rows: tuple[int, slice, int] | None = None,
    cols: tuple[int, slice, int] | None = None,
) -> torch.Tensor:
    """Training augmentation (reference ``event_process.py:8-13``): Gaussian
    noise of ``noise_std`` on a random ``noise_fraction`` of the entries (all
    of them at 1.0). Draws come from ``generator``, on its own device, first
    the normals then the mask's uniforms, and move to ``voxel``'s device; JAX
    draws from a key instead, so the numbers differ and the law is the same.
    ``rows = (dim, share, n)``: ``voxel`` is the rows ``share`` along ``dim``
    of a tensor of ``n`` rows there (a rank's share of a global batch), and
    gets those rows of the whole tensor's draws; ``cols``, of the same form,
    cuts the columns of a rank's block on the spatial axis likewise. Returns
    a new tensor."""
    g = generator
    shape = list(voxel.shape)
    cuts = [c for c in (rows, cols) if c is not None]
    for dim, _, n in cuts:
        shape[dim] = n
    noise = noise_std * torch.randn(shape, generator=g, device=g.device, dtype=voxel.dtype)
    if noise_fraction < 1.0:
        keep = torch.rand(shape, generator=g, device=g.device)
        noise = torch.where(keep < noise_fraction, noise, 0.0)
    for dim, share, _ in cuts:
        noise = noise.narrow(dim, share.start, share.stop - share.start)
    return voxel + noise.to(voxel.device)


def events_to_voxel_grid_np(
    events: np.ndarray, num_bins: int, width: int, height: int
) -> np.ndarray:
    """Host (numpy) voxelisation of ``[N, 4]`` rows ``[t, x, y, p]`` sorted by
    ``t``: stamps in float64 normalised to ``[0, num_bins - 1]`` (a window of
    one stamp counts as ``deltaT = 1``), polarity 0 -> -1, each event split
    bilinearly between its two bins. Does not mutate its input. Raises
    IndexError for events outside the grid."""
    voxel_grid = np.zeros((num_bins, height, width), np.float32).ravel()
    if len(events) == 0:
        return voxel_grid.reshape(num_bins, height, width)

    events = np.asarray(events, dtype=np.float64)
    last_stamp = events[-1, 0]
    first_stamp = events[0, 0]
    delta_t = last_stamp - first_stamp
    if delta_t == 0:
        delta_t = 1.0

    ts = (num_bins - 1) * (events[:, 0] - first_stamp) / delta_t
    xs = events[:, 1].astype(np.int64)
    ys = events[:, 2].astype(np.int64)
    pols = events[:, 3].copy()
    pols[pols == 0] = -1  # polarity should be +1 / -1

    tis = np.floor(ts).astype(np.int64)
    dts = ts - tis
    vals_left = pols * (1.0 - dts)
    vals_right = pols * dts

    valid = tis < num_bins
    np.add.at(
        voxel_grid,
        xs[valid] + ys[valid] * width + tis[valid] * width * height,
        vals_left[valid],
    )
    valid = (tis + 1) < num_bins
    np.add.at(
        voxel_grid,
        xs[valid] + ys[valid] * width + (tis[valid] + 1) * width * height,
        vals_right[valid],
    )
    return voxel_grid.reshape(num_bins, height, width).astype(np.float32)


def event_preprocess_np(
    voxel: np.ndarray,
    mode: str = "std",
    filter_hot_pixel: bool = False,
    hot_pixel_threshold: float | None = None,
) -> np.ndarray:
    """Host voxel normalisation over the whole ``[bins, H, W]`` grid; the
    host's hot-pixel threshold default is ``25 / num_bins``."""
    voxel = np.array(voxel, dtype=np.float32)
    num_bins = voxel.shape[0]
    if filter_hot_pixel:
        thr = 25.0 / num_bins if hot_pixel_threshold is None else hot_pixel_threshold
        voxel[np.abs(voxel) > thr] = 0
    if mode == "maxmin":
        voxel = (voxel - voxel.min()) / (voxel.max() - voxel.min() + 1e-8)
    elif mode == "std":
        nonzero = voxel != 0
        num_nonzeros = nonzero.sum()
        if num_nonzeros > 0:
            mean = voxel.sum() / num_nonzeros
            stddev = np.sqrt((voxel**2).sum() / num_nonzeros - mean**2)
            voxel = nonzero.astype(np.float32) * (voxel - mean) / (stddev + 1e-8)
    return voxel


def voxelize_and_preprocess_np(
    events: np.ndarray,
    num_bins: int,
    width: int,
    height: int,
    filter_hot_pixel: bool = False,
) -> np.ndarray:
    """Host voxelisation + 'std' normalisation for the data readers.

    The native runtime serves when it builds (its normalisation sums in
    float64), else the numpy functions (float32 sums): the JAX package's
    choice, so each gives that package's numbers on the same host. The two
    differ by about 1e-4 relative. Events outside the grid raise IndexError
    on either path. ``voxelize_and_preprocess_np.served`` counts the calls
    each one served.
    """
    from .. import runtime

    if runtime.available():
        thr = 25.0 / num_bins if filter_hot_pixel else 0.0
        grid = runtime.voxelize_events(
            np.ascontiguousarray(events, np.float64),
            num_bins, width, height,
            preprocess=True, hot_pixel_threshold=thr,
        )
        voxelize_and_preprocess_np.served["native"] += 1
        return grid
    grid = events_to_voxel_grid_np(events, num_bins, width, height)
    voxelize_and_preprocess_np.served["numpy"] += 1
    return event_preprocess_np(grid, mode="std", filter_hot_pixel=filter_hot_pixel)


voxelize_and_preprocess_np.served = {"native": 0, "numpy": 0}
