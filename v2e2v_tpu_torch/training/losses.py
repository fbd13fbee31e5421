"""Training losses (port of ``v2e2v_tpu/training/losses.py``).

The reference trains with ``LPIPS(vgg) + L1 + (1 - SSIM)`` on the final
reconstruction of each window ("many-to-one", ``train_e2v.py:117-120``), SSIM
being ``pytorch_msssim.SSIM(data_range=1, channel=1)``: an 11-tap Gaussian
window of sigma 1.5, and LPIPS the VGG16 one of ``training/lpips.py``, which
the trainers pass in when its weights are there; without them they train,
as the JAX trainers do, with ``L1 + (1 - SSIM)``. Images are NHWC.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .._device import float32_math
from ..parallel.spatial import Shard, gather_cols


def _gaussian_kernel1d(win_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    half = win_size // 2
    coords = np.arange(-half, half + 1, dtype=np.float64)
    g = np.exp(-(coords**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _gaussian_blur(x: torch.Tensor, win_size: int, sigma: float) -> torch.Tensor:
    """Separable depthwise Gaussian filter on NHWC, VALID padding.

    float32 with TF32 off is load-bearing: SSIM computes variances as
    ``blur(x^2) - mu^2``, a catastrophic cancellation, and at TF32's 10-bit
    mantissa near-constant windows give variances at the scale of the C2
    stabiliser: SSIM leaves [-1, 1] and its gradient turns to noise (the JAX
    package saw training diverge on the TPU for this; its blur runs at
    ``precision=HIGHEST``). The forward turns TF32 off here; a caller that
    differentiates on the card runs the backward under
    ``_device.float32_math`` too, as the train steps do.
    """
    c = x.shape[-1]
    k = torch.from_numpy(_gaussian_kernel1d(win_size, sigma)).to(x.device, x.dtype)
    kh = k.reshape(1, 1, win_size, 1).expand(c, 1, win_size, 1)
    kw = k.reshape(1, 1, 1, win_size).expand(c, 1, 1, win_size)
    with float32_math():
        y = F.conv2d(x.permute(0, 3, 1, 2), kh, groups=c)
        y = F.conv2d(y, kw, groups=c)
    return y.permute(0, 2, 3, 1)


def _ssim_map(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 1.0,
              win_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
              k2: float = 0.03) -> torch.Tensor:
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu1 = _gaussian_blur(img1, win_size, sigma)
    mu2 = _gaussian_blur(img2, win_size, sigma)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _gaussian_blur(img1 * img1, win_size, sigma) - mu1_sq
    sigma2_sq = _gaussian_blur(img2 * img2, win_size, sigma) - mu2_sq
    sigma12 = _gaussian_blur(img1 * img2, win_size, sigma) - mu12
    cs = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    return ((2 * mu12 + c1) / (mu1_sq + mu2_sq + c1)) * cs


def ssim(
    img1: torch.Tensor,
    img2: torch.Tensor,
    data_range: float = 1.0,
    win_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Gaussian-window SSIM on NHWC images (pytorch_msssim's): the scalar
    mean over batch, space and channels."""
    return torch.mean(_ssim_map(img1, img2, data_range, win_size, sigma, k1, k2))


def _per_sample_ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-sample SSIM ``[B]`` (the mean over space and channels per image)."""
    return torch.mean(_ssim_map(img1, img2), dim=(1, 2, 3))


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def many_to_one_loss(
    final_rec: torch.Tensor,
    gt: torch.Tensor,
    sample_weights: torch.Tensor | None = None,
    batch_weights: torch.Tensor | None = None,
    shard: Shard | None = None,
    lpips_fn=None,
) -> torch.Tensor:
    """The reference's training loss ``LPIPS + L1 + (1 - SSIM)``, without the
    LPIPS term when ``lpips_fn`` (``fn(pred, target) -> scalar``, the batch
    mean) is None.

    ``sample_weights [B]`` (optional): the weighted mean of the per-sample
    losses over ``max(sum(w), 1)`` instead of the batch mean. With 1.0 for
    real samples and 0.0 for padding, a padded tail batch gives the loss and
    gradients of the unpadded batch; all ones give the plain mean.
    ``batch_weights``: the weights of the whole batch when ``final_rec``,
    ``gt`` and ``sample_weights`` are one rank's rows of it; the denominator
    sums them, so the ranks' losses add up to the batch's.

    ``shard``: ``final_rec`` and ``gt`` are one rank's block of columns. SSIM's
    window reads across the cuts and the means are over the whole image, so
    both are gathered over the spatial group (``parallel/spatial.gather_cols``)
    and every rank of it computes the whole image's loss (LPIPS too, on the
    whole image); the gradient each rank gets is its own columns'.

    With ``sample_weights`` each sample's own LPIPS distance joins its loss:
    ``lpips_fn.per_sample`` gives them in one call where it has one
    (``training/lpips.Lpips``), else ``lpips_fn`` runs on each sample alone,
    as the JAX loss ``vmap``s it over batches of one."""
    if shard is not None:
        final_rec, gt = gather_cols(final_rec, shard), gather_cols(gt, shard)
    if sample_weights is None:
        loss = l1_loss(final_rec, gt) + (1.0 - ssim(final_rec, gt))
        if lpips_fn is not None:
            loss = loss + lpips_fn(final_rec, gt)
        return loss
    w = sample_weights.to(torch.float32)
    total = w if batch_weights is None else batch_weights.to(torch.float32)
    denom = torch.clamp(torch.sum(total), min=1.0)
    per_l1 = torch.mean(torch.abs(final_rec - gt), dim=(1, 2, 3))
    per = per_l1 + (1.0 - _per_sample_ssim(final_rec, gt))
    if lpips_fn is not None:
        per_sample = getattr(lpips_fn, "per_sample", None)
        per = per + (per_sample(final_rec, gt) if per_sample is not None else torch.stack(
            [lpips_fn(p[None], t[None]) for p, t in zip(final_rec, gt)]))
    return torch.sum(w * per) / denom
