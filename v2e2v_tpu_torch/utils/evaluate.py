"""Evaluation metrics (port of ``v2e2v_tpu/utils/evaluate.py``, numpy).

MSE/PSNR on [0, 1] images with a 100 dB ceiling; SSIM as skimage's
``structural_similarity`` with ``data_range=1`` (uniform 7x7 window, sample
covariance), computed in float64 with integral-image box filters. LPIPS is
``training/lpips.py``'s (the CLI reports NaN for it without its weights, as
the JAX CLI does).
"""

from __future__ import annotations

import math

import numpy as np


def mse(imgs1: np.ndarray, imgs2: np.ndarray) -> float:
    if imgs1.ndim == 4:
        imgs1 = np.squeeze(imgs1, axis=1)
        imgs2 = np.squeeze(imgs2, axis=1)
    return float(np.mean((imgs1 - imgs2) ** 2))


def psnr(imgs1: np.ndarray, imgs2: np.ndarray) -> float:
    err = mse(imgs1, imgs2)
    if err < 1.0e-10:
        return 100.0
    return 20 * math.log10(1.0 / math.sqrt(err))


def _box_filter(x: np.ndarray, win: int) -> np.ndarray:
    """VALID-mode win x win mean filter via integral images (no scipy)."""
    x = np.asarray(x, dtype=np.float64)
    c = np.cumsum(np.cumsum(x, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)))
    s = c[win:, win:] - c[:-win, win:] - c[win:, :-win] + c[:-win, :-win]
    return s / (win * win)


def ssim_single(
    img1: np.ndarray,
    img2: np.ndarray,
    data_range: float = 1.0,
    win_size: int = 7,
    k1: float = 0.01,
    k2: float = 0.03,
) -> float:
    """skimage-compatible SSIM: uniform window, sample covariance, edge crop."""
    img1 = np.asarray(img1, dtype=np.float64)
    img2 = np.asarray(img2, dtype=np.float64)
    npts = win_size**2
    cov_norm = npts / (npts - 1)  # sample covariance (skimage default)

    ux = _box_filter(img1, win_size)
    uy = _box_filter(img2, win_size)
    uxx = _box_filter(img1 * img1, win_size)
    uyy = _box_filter(img2 * img2, win_size)
    uxy = _box_filter(img1 * img2, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    a1 = 2 * ux * uy + c1
    a2 = 2 * vxy + c2
    b1 = ux**2 + uy**2 + c1
    b2 = vx + vy + c2
    s = (a1 * a2) / (b1 * b2)

    # skimage computes the full (reflect-padded) map then crops pad from each
    # side; with VALID box filters the remaining crop is zero for win=7 maps
    # already shrunk by win-1 — this matches skimage's mean over the cropped
    # region for images larger than ~3x the window.
    return float(s.mean())


def ssim(imgs1: np.ndarray, imgs2: np.ndarray) -> float:
    """Batch mean SSIM (reference :31-42)."""
    if imgs1.ndim == 4:
        imgs1 = np.squeeze(imgs1, axis=1)
        imgs2 = np.squeeze(imgs2, axis=1)
    if imgs1.ndim == 2:
        imgs1 = imgs1[None]
        imgs2 = imgs2[None]
    return float(
        np.mean([ssim_single(a, b) for a, b in zip(imgs1, imgs2)])
    )
