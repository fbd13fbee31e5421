"""Image normalisation for evaluation (port of ``v2e2v_tpu/ops/image.py``).

``normalize_image_percentile`` is the reference's robust 1st/99th-percentile
normalisation; ``normalize_image_minmax_u8`` is the reference CLI's
prediction normalisation, ``np.uint8(cv2.normalize(img, None, 0, 255,
cv2.NORM_MINMAX))``, computed here without OpenCV and bit for bit as it.
``CropParameters`` is the Super-SloMo path's pad-to-2^k bookkeeping.
"""

from __future__ import annotations

from math import ceil, floor

import numpy as np
import torch


def normalize_image_percentile(image, low: float = 1.0, high: float = 99.0):
    """``(image - p_low) / (p_high - p_low + 1e-5)`` clamped to [0, 1], the
    percentiles linearly interpolated. Takes a numpy array or a tensor and
    returns the same kind."""
    if isinstance(image, np.ndarray):
        mini = np.percentile(image.ravel(), low)
        maxi = np.percentile(image.ravel(), high)
        out = (image - mini) / (maxi - mini + 1e-5)
        return np.clip(out, 0.0, 1.0)
    flat = image.reshape(-1)
    q = torch.tensor([low / 100.0, high / 100.0], dtype=flat.dtype, device=flat.device)
    mini, maxi = torch.quantile(flat, q)
    out = (image - mini) / (maxi - mini + 1e-5)
    return out.clamp(0.0, 1.0)


_TIE_BITS = np.uint64(1 << 28)  # float64 bits below a float32 mantissa at a tie
_LOW_BITS = np.uint64((1 << 29) - 1)


def _fma_f32(x: np.ndarray, a: np.float32, b: np.float32) -> np.ndarray:
    """``x * a + b`` for float32 ``x``, rounded to float32 once, as a fused
    multiply-add does. The product is exact in float64; the float64 sum is
    corrected where rounding it to float32 would be a second rounding at a
    tie (the sum's exact error, TwoSum, says which way to go)."""
    p = x.astype(np.float64) * np.float64(a)
    bb = np.float64(b)
    s = p + bb
    t = s - p
    err = (p - (s - t)) + (bb - t)
    tie = (s.view(np.uint64) & _LOW_BITS) == _TIE_BITS
    fix = tie & (err != 0)
    if fix.any():
        s = np.where(fix, np.nextafter(s, np.copysign(np.inf, err)), s)
    return s.astype(np.float32)


def normalize_image_minmax_u8(image: np.ndarray) -> np.ndarray:
    """``np.uint8(cv2.normalize(image, None, 0, 255, cv2.NORM_MINMAX))`` for a
    float32 image, bit for bit.

    OpenCV takes min and max as doubles, ``scale = 255 * (1 / (max - min))``
    (0 when ``max - min`` is not above DBL_EPSILON, so a constant image gives
    0 everywhere), rounds it to float32, ``shift = -(float)(min * scale)``,
    and converts with one fused multiply-add in float32 per pixel. The uint8
    cast then TRUNCATES, as the reference's numpy cast does (a rounding
    version biased eval MSE by about 1.3%).
    """
    image = np.asarray(image)
    if image.dtype != np.float32:
        raise TypeError(f"normalize_image_minmax_u8 takes a float32 image, got {image.dtype}")
    smin, smax = float(image.min()), float(image.max())
    span = smax - smin
    scale = 255.0 * (1.0 / span if span > np.finfo(np.float64).eps else 0.0)
    a = np.float32(scale)
    b = np.float32(0.0) - np.float32(smin * float(a))
    return np.uint8(_fma_f32(image, a, b))


def optimal_crop_size(max_size: int, max_subsample_factor: int) -> int:
    """Smallest integer >= max_size divisible by 2**max_subsample_factor."""
    k = 2**max_subsample_factor
    return int(k * ceil(max_size / k))


def _reflect_index(n: int, before: int, after: int, device) -> torch.Tensor:
    """Source indices of ``np.pad(..., mode="reflect")`` along an axis of
    ``n``: the reflection repeats for pads longer than ``n - 1``."""
    idx = torch.arange(-before, n + after, device=device)
    if n == 1:
        return torch.zeros_like(idx)
    idx = idx.remainder(2 * (n - 1))
    return torch.where(idx < n, idx, 2 * (n - 1) - idx)


class CropParameters:
    """Pad-to-2^k bookkeeping for encoder/decoder nets (the Super-SloMo path):
    reflect-pad the input up to the optimal crop size, and keep the
    ``iy0:iy1, ix0:ix1`` window that crops the network's output back."""

    def __init__(self, width: int, height: int, num_encoders: int):
        self.height = height
        self.width = width
        self.num_encoders = num_encoders
        self.width_crop_size = optimal_crop_size(width, num_encoders)
        self.height_crop_size = optimal_crop_size(height, num_encoders)

        self.padding_top = ceil(0.5 * (self.height_crop_size - height))
        self.padding_bottom = floor(0.5 * (self.height_crop_size - height))
        self.padding_left = ceil(0.5 * (self.width_crop_size - width))
        self.padding_right = floor(0.5 * (self.width_crop_size - width))

        cx = floor(self.width_crop_size / 2)
        cy = floor(self.height_crop_size / 2)
        self.ix0 = cx - floor(width / 2)
        self.ix1 = cx + ceil(width / 2)
        self.iy0 = cy - floor(height / 2)
        self.iy1 = cy + ceil(height / 2)

    def pad(self, x: torch.Tensor) -> torch.Tensor:
        """Reflect-pad channel-last ``[..., H, W, C]`` (ndim >= 3) or
        ``[..., H, W]`` input up to the crop size."""
        h_axis = x.ndim - 3 if x.ndim >= 3 else x.ndim - 2
        rows = _reflect_index(x.shape[h_axis], self.padding_top, self.padding_bottom, x.device)
        cols = _reflect_index(x.shape[h_axis + 1], self.padding_left, self.padding_right,
                              x.device)
        return x.index_select(h_axis, rows).index_select(h_axis + 1, cols)

    def crop(self, x: torch.Tensor) -> torch.Tensor:
        """Crop a padded channel-last (or 2D) output back to (height, width)."""
        if x.ndim >= 3:
            return x[..., self.iy0:self.iy1, self.ix0:self.ix1, :]
        return x[..., self.iy0:self.iy1, self.ix0:self.ix1]
