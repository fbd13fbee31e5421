"""Numerics of the port (port of ``v2e2v_tpu/ops/numerics.py``).

The DVS emulator's per-pixel maths: the lin-log intensity mapping, intensity
rescaling, the intensity-dependent first-order IIR low-pass with the
``[0::2, 0::2]`` "sensing diversity" lattice, and the jittered leak current;
plus the ISTA shrinkage. All float32. Randomness comes from the caller: the
leak current takes its normals from the emulator's noise source
(``models/emulator.py``), never from a global generator.

Divisions are written out so that they round alike on every device and as
the JAX package's eager operations do. PyTorch on the card computes
``tensor / python_float`` as a product with the reciprocal, and
``python_float / tensor`` is a reciprocal times the float on every device
(``Tensor.__rtruediv__``): ``div_true`` and ``rdiv_true`` divide. Compiled
XLA code divides by a constant as a product with its float32 reciprocal
(``div_const``), which the port uses where the JAX package's result comes
from compiled code (``jnp.linspace``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

LIN_LOG_THRESHOLD = 20.0


def div_const(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` for a constant ``s`` as XLA computes it in float32:
    ``x * f32(1 / f32(s))``."""
    return x * float(np.float32(1.0) / np.float32(s))


def div_true(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` as a true float32 division on every device."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def rdiv_true(s: float, x: torch.Tensor) -> torch.Tensor:
    """``s / x`` as a true float32 division on every device."""
    return torch.full((), s, dtype=x.dtype, device=x.device) / x


def lin_log(x: torch.Tensor, threshold: float = LIN_LOG_THRESHOLD) -> torch.Tensor:
    """Linear below ``threshold``, log above, rounded to 1e-8 as the reference
    does (``emulator_utils.py:13-37``).

    float32's ``log`` of torch and of XLA differ by 1-2 ulp for some inputs
    (1.6% of uniform values in [0, 255] on the CPU, at most 9.5e-7), so above
    ``threshold`` this matches the JAX package to 2 ulp, not bit for bit; the
    linear branch (``x <= threshold``) is exact.
    """
    x = x.to(torch.float32)
    f = math.log(threshold) / threshold
    y = torch.where(x <= threshold, x * f, torch.log(torch.clamp(x, min=1e-12)))
    return div_true(torch.round(y * 1e8), 1e8)


def lin_log_np(x: np.ndarray, threshold: float = LIN_LOG_THRESHOLD) -> np.ndarray:
    """Float64 host version with exact reference rounding semantics."""
    x = np.asarray(x, dtype=np.float64)
    f = math.log(threshold) / threshold
    with np.errstate(divide="ignore"):
        y = np.where(x <= threshold, x * f, np.log(x))
    y = np.round(y * 1e8) / 1e8
    return y.astype(np.float32)


def rescale_intensity_frame(frame: torch.Tensor) -> torch.Tensor:
    """0-255 intensity -> ``(I + 20) / 275`` (``emulator_utils.py:40-45``)."""
    return div_true(frame + 20.0, 275.0)


def diversity_lattice_mask(h: int, w: int, device: torch.device | str) -> torch.Tensor:
    """``[H, W]`` boolean mask of the ``[0::2, 0::2]`` pixel lattice
    (``emulator_utils.py:87-89``)."""
    rows = torch.arange(h, device=device) % 2 == 0
    cols = torch.arange(w, device=device) % 2 == 0
    return rows[:, None] & cols[None, :]


def low_pass_filter_step(
    log_new_frame: torch.Tensor,
    lp_log_frame: torch.Tensor,
    inten01: torch.Tensor,
    delta_time: torch.Tensor,
    cutoff_hz: float,
    ql: float = 1.0,
    qs: float = 1.0,
) -> torch.Tensor:
    """One step of the intensity-dependent first-order IIR low-pass
    (``emulator_utils.py:48-102``).

    ``eps = inten01 * dt / tau`` with ``tau = 1 / (2 pi fc q)``; the
    ``[0::2, 0::2]`` lattice uses ``qs`` (eps = 1 when ``qs <= 0``), the rest
    ``ql``; eps is clamped to <= 1. ``cutoff_hz <= 0`` returns the input.
    Frames are ``[..., H, W]``; ``delta_time`` broadcasts against them.
    """
    if cutoff_hz <= 0:
        return log_new_frame

    def eps_for(q):
        if q <= 0:
            return torch.ones_like(inten01)
        tau = 1.0 / (math.pi * 2 * cutoff_hz * q)
        return inten01 * div_true(delta_time, tau)

    h, w = log_new_frame.shape[-2:]
    lattice = diversity_lattice_mask(h, w, log_new_frame.device)
    eps = torch.clamp(torch.where(lattice, eps_for(qs), eps_for(ql)), max=1.0)
    return (1.0 - eps) * lp_log_frame + eps * log_new_frame


def subtract_leak_current(
    noise,
    base_log_frame: torch.Tensor,
    leak_rate_hz: float,
    delta_time: torch.Tensor,
    pos_thres: torch.Tensor,
    leak_jitter_fraction: float,
    noise_rate_array: torch.Tensor,
) -> torch.Tensor:
    """Subtract the jittered leak current (``emulator_utils.py:105-125``).

    The per-pixel rate is ``leak_rate_hz * noise_rate_array * (1 - jitter *
    N(0, 1))``, with the normals drawn as ``noise.normal("leak", ...)``; the
    decrement is ``dt * rate * pos_thres``.
    """
    rand = noise.normal("leak", tuple(noise_rate_array.shape), noise_rate_array.device)
    curr_leak_rate = leak_rate_hz * noise_rate_array * (1.0 - leak_jitter_fraction * rand)
    return base_log_frame - delta_time * curr_leak_rate * pos_thres


def softshrink(x: torch.Tensor, lambd: torch.Tensor) -> torch.Tensor:
    """Soft-thresholding ``relu(x - l) - relu(-x - l)``; ``lambd`` is a
    per-channel vector broadcast over the last (channel) axis of NHWC input."""
    return torch.relu(x - lambd) - torch.relu(-x - lambd)
