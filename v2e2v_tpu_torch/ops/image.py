"""Image normalisation for evaluation (port of ``v2e2v_tpu/ops/image.py``).

``normalize_image_percentile`` is the reference's robust 1st/99th-percentile
normalisation; ``normalize_image_minmax_u8`` is the reference CLI's
prediction normalisation, ``np.uint8(cv2.normalize(img, None, 0, 255,
cv2.NORM_MINMAX))``, computed here without OpenCV and bit for bit as it.
``CropParameters`` (Super-SloMo padding) is not ported.
"""

from __future__ import annotations

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
