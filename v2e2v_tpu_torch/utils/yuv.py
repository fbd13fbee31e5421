"""A video frame's YCbCr planes -> the gray that the JAX package's video
readers see: ``cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)`` of the BGR frame
that ``cv2.VideoCapture`` returns, bit for bit.

OpenCV's FFmpeg backend turns a decoded frame into BGR24 with
``sws_scale`` at the frame's own size. For an MJPEG frame (``yuvj420p``:
full-range BT.601, chroma at half width and half height) swscale takes its
unscaled YUV 4:2:0 -> RGB converter, which on x86 is the SIMD one
(``libswscale/x86/yuv_2_rgb.asm``): each chroma sample serves its 2 x 2
luma samples, and each term is a 16-bit ``pmulhw`` product,

    B = sat(Y + ((8 (Cb - 128) * ub) >> 16))
    G = sat(Y + ((8 (Cb - 128) * ug) >> 16) + ((8 (Cr - 128) * vg) >> 16))
    R = sat(Y + ((8 (Cr - 128) * vr) >> 16))

with the coefficients that ``yuv2rgb.c::ff_yuv2rgb_c_init_tables`` derives
from the BT.601 inverse table for full range (below). The formula was found
by decoding AVIs of flat DC-only MJPEG frames that feed chosen (Y, Cb, Cr)
triples through ``cv2.VideoCapture``, and holds on every triple tried.
``COLOR_BGR2GRAY`` on 8-bit samples is OpenCV's fixed point: in OpenCV 5
(the cv2 the JAX package was checked with) at 15 bits, 0.114, 0.587 and
0.299 as 3735, 19235 and 9798, rounded; every one of the 2^24 BGR triples
gives cv2's gray.

Only 4:2:0 frames of even height are converted: an odd height sends
swscale to its general scaler, whose chroma filter the port does not copy,
and other samplings take other converters. Both raise a ValueError naming
ROADMAP.md queue 1, item 4.
"""

from __future__ import annotations

import numpy as np

from .imgcodecs import ROADMAP

# ff_yuv2rgb_coeffs[SWS_CS_ITU601]: crv, cbu, cgu, cgv at 16 bits, limited range
_INV_TABLE_601 = (104597, 132201, 25675, 53279)


def _round_to_int16(f: int) -> int:
    """yuv2rgb.c::roundToInt16."""
    r = (f + (1 << 15)) >> 16
    return max(-0x8000, min(0x7FFF, r))


def _full_range(c: int) -> int:
    """``(c * 224) / 255`` in C (truncated toward zero)."""
    q = abs(c) * 224 // 255
    return q if c >= 0 else -q


_CRV, _CBU = _full_range(_INV_TABLE_601[0]), _full_range(_INV_TABLE_601[1])
_CGU, _CGV = _full_range(-_INV_TABLE_601[2]), _full_range(-_INV_TABLE_601[3])
VR, UB, UG, VG = (_round_to_int16(c << 13) for c in (_CRV, _CBU, _CGU, _CGV))

_C = np.arange(256, dtype=np.int32)
# each chroma value's term, pmulhw((c - 128) << 3, coeff)
_B_U = ((_C - 128) * 8 * UB) >> 16
_G_U = ((_C - 128) * 8 * UG) >> 16
_G_V = ((_C - 128) * 8 * VG) >> 16
_R_V = ((_C - 128) * 8 * VR) >> 16

R2Y, G2Y, B2Y, GRAY_SHIFT = 9798, 19235, 3735, 15


def _upsample(plane: np.ndarray, h: int, w: int) -> np.ndarray:
    """Each chroma sample repeated over its 2 x 2 luma samples."""
    return plane.repeat(2, axis=0).repeat(2, axis=1)[:h, :w]


def _check_yuvj420(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, path: str = "<frame>") -> None:
    h, w = y.shape
    if cb.shape != ((h + 1) // 2, (w + 1) // 2) or cr.shape != cb.shape:
        raise ValueError(f"{path}: chroma planes {cb.shape} and {cr.shape} for a {h}x{w} luma "
                         f"plane: only 4:2:0 MJPEG frames are converted ({ROADMAP})")
    if h % 2:
        raise ValueError(f"{path}: a frame of odd height {h}: swscale converts it through its "
                         f"general scaler, which the port does not copy ({ROADMAP})")


def yuvj420_to_bgr(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                   path: str = "<frame>") -> np.ndarray:
    """``[H, W]`` Y and ``[H/2, W/2]`` Cb, Cr (rounded up) -> ``[H, W, 3]``
    uint8 BGR, as swscale's unscaled converter gives it to OpenCV."""
    _check_yuvj420(y, cb, cr, path)
    h, w = y.shape
    yi = y.astype(np.int32)
    u, v = _upsample(cb, h, w), _upsample(cr, h, w)
    out = np.empty((h, w, 3), np.uint8)
    out[..., 0] = np.clip(yi + _B_U[u], 0, 255)
    out[..., 1] = np.clip(yi + _G_U[u] + _G_V[v], 0, 255)
    out[..., 2] = np.clip(yi + _R_V[v], 0, 255)
    return out


def bgr_to_gray(bgr: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)`` on uint8."""
    b, g, r = (bgr[..., k].astype(np.int32) for k in range(3))
    return ((b * B2Y + g * G2Y + r * R2Y + (1 << (GRAY_SHIFT - 1))) >> GRAY_SHIFT).astype(np.uint8)


def yuvj420_to_gray(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                    path: str = "<frame>") -> np.ndarray:
    """``bgr_to_gray(yuvj420_to_bgr(y, cb, cr))``."""
    return bgr_to_gray(yuvj420_to_bgr(y, cb, cr, path))
