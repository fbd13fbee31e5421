"""A video frame's YCbCr planes -> the gray that the JAX package's video
readers see: ``cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)`` of the BGR frame
that ``cv2.VideoCapture`` returns, bit for bit.

OpenCV's FFmpeg backend turns a decoded frame into BGR24 with ``sws_scale``
(``SWS_BICUBIC``) at the frame's own size. FFmpeg's MJPEG decoder gives a
full-range BT.601 frame (``yuvj420p``, ``yuvj422p``, ``yuvj444p``,
``yuvj411p``, ``yuvj440p``) or ``gray``, and swscale converts each by one
of three routes, found by probing cv2 5.0.0 (swscale 9.5, on x86):

- 4:2:0 and 4:2:2 of an even height take the unscaled converter, on x86 the
  SIMD one (``libswscale/x86/yuv_2_rgb.asm``): each chroma sample serves its
  2 x 2 (4:2:2: 2 x 1) luma samples, and each term is a 16-bit ``pmulhw``
  product,

      B = sat(Y + ((8 (Cb - 128) * ub) >> 16))
      G = sat(Y + ((8 (Cb - 128) * ug) >> 16) + ((8 (Cr - 128) * vg) >> 16))
      R = sat(Y + ((8 (Cr - 128) * vr) >> 16))

  with the coefficients that ``yuv2rgb.c::ff_yuv2rgb_c_init_tables``
  derives from the BT.601 inverse table for full range (below). It was
  found by decoding AVIs of flat DC-only MJPEG frames that feed chosen (Y,
  Cb, Cr) triples through ``cv2.VideoCapture``.
- ``gray`` takes the palette converter: B = G = R = Y, every value of Y
  through unchanged (no range expansion).
- Every other frame (4:4:4, 4:1:1, 4:4:0, and 4:2:0 or 4:2:2 of an odd
  height) takes the general scaler (``general_bgr``): the chroma planes are
  resampled by ``utils.c::initFilter``'s bicubic filters (B = 0, C = 0.6,
  14-bit horizontal and 12-bit vertical taps, chroma sited at the centre)
  to half the width, or to the full width where the chroma is not subsampled
  or the width is odd (``SWS_FULL_CHR_H_INT``, forced then), and the frame's
  height; ``hScale8To15`` keeps 15 bits. Half-width chroma is converted by
  the x86 MMX output (``swscale_template.c``: the vertical taps by
  ``pmulhw`` over a rounder of 4, then the unscaled converter's formula at
  8x), except the last two rows, which swscale converts with the C output
  (``output.c::yuv2rgb_X_c_template``: chroma rounded to 8 bits, the
  lookup tables of ``fill_table``). Full-width chroma goes through the C
  ``yuv2rgb_write_full`` at 30 bits.

Frames so small that swscale cuts its chroma filter to the plane (under 7
chroma samples where it doubles them, under 11 where it halves them) take
the same routes with the cut filter (``initFilter``'s ``srcW - 2``); a row
whose vertical chroma filter has one tap or two, the second in 0..4096,
takes ``yuv2packed1`` with that tap as its uvalpha (the MMX output reads
the first row alone under 2048 and the two rows' mean from it on, the C one
weights them), every other row ``yuv2packedX``. Full-width chroma is forced
by the format (4:4:4) or an odd width, not by the planes' shapes: a one-row
4:4:0 frame keeps half-width chroma.

FFmpeg's ``mpeg4`` decoder gives ``yuv420p`` of unspecified range, which
swscale converts at limited range (``yuv420p_to_bgr``): the same routes
with ``ff_yuv2rgb_c_init_tables``' limited-range coefficients (the inverse
table's chroma ones, Y's gain 255/219 and offset 16), Y through a signed
``pmulhw`` of 8 Y - 128 in the x86 outputs (8 Y + 4 - 128 after the MMX
vertical rounder), the C rows' luma table 1.5 levels low (``yoffs`` 326),
and MPEG-4's left-sited chroma at horizontal position 64 in the general
scaler's filter. All found by probing with crafted streams and raw I420.
FFmpeg's ``vp8`` decoder gives limited-range ``yuv420p`` of unspecified
chroma siting, which takes the same routes with the chroma centred (128,
``VP8_H_POS``), found by probing clips of odd heights; frames after a key
frame whose ``clamping_type`` bit is 1 (FFmpeg's ``fullrange``) are
converted at full range, found with crafted streams read on one thread.

``COLOR_BGR2GRAY`` on 8-bit samples is OpenCV's fixed point: in OpenCV 5 (the
cv2 the JAX package was checked with) at 15 bits, 0.114, 0.587 and 0.299 as
3735, 19235 and 9798, rounded; every one of the 2^24 BGR triples gives cv2's
gray.

Other samplings raise a ValueError naming ROADMAP.md queue 1, item 4.
"""

from __future__ import annotations

import functools

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

def _check_planes(y, cb, cr, hsub: int, vsub: int, path: str) -> None:
    h, w = y.shape
    want = (-(-h >> vsub), -(-w >> hsub))
    if cb.shape != want or cr.shape != want:
        raise ValueError(f"{path}: chroma planes {cb.shape} and {cr.shape} for a {h}x{w} luma "
                         f"plane, not {want} ({ROADMAP})")


def _unscaled(y, cb, cr, vsub: int, limited: bool = False) -> np.ndarray:
    """swscale's unscaled x86 converter (4:2:0 with ``vsub`` 1, 4:2:2 with 0),
    full range or, with ``limited``, limited range."""
    h, w = y.shape
    if limited:
        yi, bu, gu, gv, rv = _LIM_Y[y], _LIM_B_U, _LIM_G_U, _LIM_G_V, _LIM_R_V
    else:
        yi, bu, gu, gv, rv = y.astype(np.int32), _B_U, _G_U, _G_V, _R_V
    u = cb.repeat(1 << vsub, axis=0).repeat(2, axis=1)[:h, :w]
    v = cr.repeat(1 << vsub, axis=0).repeat(2, axis=1)[:h, :w]
    out = np.empty((h, w, 3), np.uint8)
    out[..., 0] = np.clip(yi + bu[u], 0, 255)
    out[..., 1] = np.clip(yi + gu[u] + gv[v], 0, 255)
    out[..., 2] = np.clip(yi + rv[v], 0, 255)
    return out


# ------------------------------------------------------------- the general scaler

# the C output's tables (yuv2rgb.c::fill_table at full range): the chroma
# terms added to Y, for chroma rounded to 8 bits
_C_R = ((_C * _CRV) >> 16) - (_CRV >> 9)
_C_B = ((_C * _CBU) >> 16) - (_CBU >> 9)
_C_G = ((_C * _CGU) >> 16) - (_CGU >> 9), ((_C * _CGV) >> 16) - (_CGV >> 9)
# yuv2rgb_write_full's 30-bit coefficients (c->yuv2rgb_*_coeff) and Y's
FULL_V2R, FULL_U2B = _round_to_int16(_CRV << 13), _round_to_int16(_CBU << 13)
FULL_U2G, FULL_V2G = _round_to_int16(_CGU << 13), _round_to_int16(_CGV << 13)
FULL_Y = _round_to_int16((1 << 16) << 13)
MMX_V_ROUNDER = 4  # the MMX vertical filter's rounder, at 8x
SIZE_FACTOR = 4  # bicubic's taps per unit of scale (utils.c::scale_algorithms)
H_ALIGN, V_ALIGN = 4, 2  # x86's filter size alignment, horizontal and vertical


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncated toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


# limited range (yuv420p of unspecified range): ff_yuv2rgb_c_init_tables
# keeps the inverse table's chroma coefficients, takes Y's 255/219 gain
# (cy) and its offset of 16 (oy), and the x86 converters apply them at 8x
_CY = ((1 << 16) * 255) // 219
LIM_Y_COEFF, LIM_Y_OFFSET = _round_to_int16(_CY << 13), _round_to_int16((16 << 16) << 3)
LIM_VR, LIM_UB, LIM_UG, LIM_VG = (_round_to_int16(c << 13) for c in (
    _INV_TABLE_601[0], _INV_TABLE_601[1], -_INV_TABLE_601[2], -_INV_TABLE_601[3]))
# the horizontal siting of MPEG-4's chroma (AVCHROMA_LOC_LEFT) as swscale's
# filter takes it: found by probing, where 128 (centred) is 11 levels off
MPEG4_H_POS = 64
VP8_H_POS = 128  # VP8's chroma, of unspecified siting, centred
# the C output's tables at limited range (fill_table): the chroma
# coefficients over cy, each chroma value's offset into the luma table
# y_table, whose entry for Y is clip(((326 + Y) cy - (400 << 16) + 2^15) >> 16)
# (yoffs 326 and yb = -(384 << 16) - oy: 1.5 levels below (Y - 16) 255/219)
def _over_cy(c: int) -> int:
    return _cdiv((c << 16) + 0x8000, _CY)


_LRV, _LBU = _over_cy(_INV_TABLE_601[0]), _over_cy(_INV_TABLE_601[1])
_LGU, _LGV = _over_cy(-_INV_TABLE_601[2]), _over_cy(-_INV_TABLE_601[3])
_LC_R = ((_C * _LRV) >> 16) - (_LRV >> 9)
_LC_B = ((_C * _LBU) >> 16) - (_LBU >> 9)
_LC_G = ((_C * _LGU) >> 16) - (_LGU >> 9), ((_C * _LGV) >> 16) - (_LGV >> 9)
LIM_TABLE_Y0 = 326 * _CY - (400 << 16)


def _lim_y_table(k: np.ndarray) -> np.ndarray:
    return np.clip((k * _CY + LIM_TABLE_Y0 + 0x8000) >> 16, 0, 255)


# yuv2rgb_write_full's Y offset (at 9 fractional bits) and coefficient
LIM_FULL_Y_OFFSET = _round_to_int16((16 << 16) << 9)
_Y8 = np.arange(256, dtype=np.int64)
# the unscaled converter's Y term: pmulhw of 8 Y - 128, signed (Y under 16
# pulls the chroma terms down before the final clip)
_LIM_Y = ((_Y8 * 8 - LIM_Y_OFFSET) * LIM_Y_COEFF) >> 16
_LIM_B_U = ((_C - 128) * 8 * LIM_UB) >> 16
_LIM_G_U = ((_C - 128) * 8 * LIM_UG) >> 16
_LIM_G_V = ((_C - 128) * 8 * LIM_VG) >> 16
_LIM_R_V = ((_C - 128) * 8 * LIM_VR) >> 16


@functools.lru_cache(maxsize=64)
def bicubic_filter(src: int, dst: int, one: int, align: int,
                   src_pos: int = 128) -> tuple[np.ndarray, np.ndarray]:
    """``utils.c::initFilter`` for ``SWS_BICUBIC`` (default B = 0, C = 0.6)
    from ``src`` samples to ``dst``, the output sited at the centre
    (position 128 of 256) and the source at ``src_pos``: each output's first
    input and its taps, summing to ``one`` (``1 << 14`` horizontal,
    ``1 << 12`` vertical), the filter's size a multiple of ``align``, cut to
    ``src - 2`` taps on a tiny plane."""
    inc = ((src << 16) + (dst >> 1)) // dst
    if abs(inc - 0x10000) < 10 and src_pos == 128:  # the same size and siting: one tap
        return np.arange(dst), np.full((dst, 1), one, np.int64)
    ratio = src // dst
    fone = 1 << (54 - min(ratio.bit_length() - 1 if ratio else 0, 8))
    size = 1 + SIZE_FACTOR if inc <= 1 << 16 else 1 + (SIZE_FACTOR * src + dst - 1) // dst
    size = max(min(size, src - 2), 1)  # cut to the plane: tiny planes
    c_q, b_q = int(0.6 * (1 << 24)), 0
    x_in_src = ((128 * inc) >> 7) - ((src_pos * 0x10000) >> 7)  # 2^17 a source sample
    filt, pos = [], []
    for _ in range(dst):
        xx = _cdiv(x_in_src - (size - 2) * (1 << 16), 1 << 17)
        pos.append(xx)
        row = []
        for j in range(size):
            d = abs((xx + j) * (1 << 17) - x_in_src) << 13
            if inc > 1 << 16:
                d = d * dst // src
            if d >= 1 << 31:
                coeff = 0
            else:
                dd = (d * d) >> 30
                ddd = (dd * d) >> 30
                if d < 1 << 30:
                    coeff = ((12 * (1 << 24) - 9 * b_q - 6 * c_q) * ddd
                             + (-18 * (1 << 24) + 12 * b_q + 6 * c_q) * dd
                             + (6 * (1 << 24) - 2 * b_q) * (1 << 30))
                else:
                    coeff = ((-b_q - 6 * c_q) * ddd + (6 * b_q + 30 * c_q) * dd
                             + (-12 * b_q - 48 * c_q) * d + (8 * b_q + 24 * c_q) * (1 << 30))
            row.append(_cdiv(coeff, (1 << 54) // fone))
        filt.append(row)
        x_in_src += 2 * inc
    # the size reduction: near-zero taps shifted out on the left, the
    # longest run of taps left after the near-zero ones on the right cut
    cut = 0.002 * fone
    kept = 0
    for i in range(dst - 1, -1, -1):
        acc = 0
        for _ in range(size):
            acc += abs(filt[i][0])
            if acc > cut or (i < dst - 1 and pos[i] >= pos[i + 1]):
                break
            filt[i] = filt[i][1:] + [0]
            pos[i] += 1
        acc, n = 0, size
        for j in range(size - 1, 0, -1):
            acc += abs(filt[i][j])
            if acc > cut:
                break
            n -= 1
        kept = max(kept, n)
    if kept == 1 and align == 2:  # x86: a vertical filter of one tap stays one
        align = 1
    size_in, size = size, (kept + align - 1) // align * align
    filt = [(f + [0] * size)[:size] if size > size_in else f[:size] for f in filt]
    # the borders: taps before the first sample folded onto it, taps past
    # the last onto the last, the window shifted inside the plane
    for i in range(dst):
        f = filt[i]
        if pos[i] < 0:
            for j in range(1, size):
                left = max(j + pos[i], 0)
                f[left] += f[j]
                f[j] = 0
            pos[i] = 0
        if pos[i] + size > src:
            shift = pos[i] + min(size - src, 0)
            acc = sum(f[j] for j in range(size) if pos[i] + j >= src)
            f = [0 if pos[i] + j >= src else f[j] for j in range(size)]
            f = [0 if j < shift else f[j - shift] for j in range(size)]
            pos[i] -= shift
            f[src - 1 - pos[i]] += acc
            filt[i] = f
    out = np.zeros((dst, size), np.int64)
    for i in range(dst):
        total = max((sum(filt[i]) + one // 2) // one, 1)
        err = 0
        for j in range(size):
            v = filt[i][j] + err
            out[i, j] = _cdiv(v + (total >> 1) if v >= 0 else v - (total >> 1), total)
            err = v - int(out[i, j]) * total
    return np.asarray(pos, np.int64), out


def _hscale(plane: np.ndarray, dst: int, src_pos: int = 128) -> np.ndarray:
    """``hScale8To15`` of each row to ``dst`` samples: 15-bit int64."""
    pos, taps = bicubic_filter(plane.shape[1], dst, 1 << 14, H_ALIGN, src_pos)
    idx = np.minimum(pos[:, None] + np.arange(taps.shape[1]), plane.shape[1] - 1)
    return np.minimum((plane.astype(np.int64)[:, idx] * taps).sum(-1) >> 7, 32767)


def _wrap16(a: np.ndarray) -> np.ndarray:
    return ((a + 0x8000) & 0xFFFF) - 0x8000


def _pmulhw(a, b) -> np.ndarray:
    return (a * b) >> 16


def _half_to_full(a: np.ndarray, w: int) -> np.ndarray:
    return a.repeat(2, axis=-1)[..., :w]


def _mmx_rgb(y: np.ndarray, u8: np.ndarray, v8: np.ndarray, limited: bool = False,
             y_round: int = 4) -> np.ndarray:
    """``swscale_template.c``'s YSCALEYUV2RGB on rows: chroma at 8x (half
    width; 16-bit words, so sums wrap), Y at 8 bits. At limited range Y
    goes through ``pmulhw`` too: 8 Y plus the vertical rounder (``y_round``,
    4 for ``yuv2packedX``, 0 for ``yuv2packed1``) less 8 x 16."""
    u8, v8 = _wrap16(u8 - 1024), _wrap16(v8 - 1024)
    w = y.shape[-1]
    if limited:
        yi = _pmulhw(y.astype(np.int64) * 8 + y_round - LIM_Y_OFFSET, LIM_Y_COEFF)
        ub, ug, vg, vr = LIM_UB, LIM_UG, LIM_VG, LIM_VR
    else:
        yi = y.astype(np.int64)
        ub, ug, vg, vr = UB, UG, VG, VR
    b = _half_to_full(_pmulhw(u8, ub), w)
    g = _half_to_full(_wrap16(_pmulhw(u8, ug) + _pmulhw(v8, vg)), w)
    r = _half_to_full(_pmulhw(v8, vr), w)
    return np.stack([yi + b, yi + g, yi + r], -1)


def _c_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray, limited: bool = False) -> np.ndarray:
    """``yuv2rgb_X_c_template``'s table lookups: chroma at 8 bits (half
    width). At limited range each sum indexes ``fill_table``'s luma table
    (``_lim_y_table``) rather than being Y itself."""
    u, v = np.clip(u, 0, 255), np.clip(v, 0, 255)
    w = y.shape[-1]
    yi = y.astype(np.int64)
    if limited:
        return np.stack([_lim_y_table(yi + _half_to_full(_LC_B[u], w)),
                         _lim_y_table(yi + _half_to_full(_LC_G[0][u] + _LC_G[1][v], w)),
                         _lim_y_table(yi + _half_to_full(_LC_R[v], w))], -1)
    return np.stack([yi + _half_to_full(_C_B[u], w),
                     yi + _half_to_full(_C_G[0][u] + _C_G[1][v], w),
                     yi + _half_to_full(_C_R[v], w)], -1)


def _full_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray, limited: bool = False) -> np.ndarray:
    """``yuv2rgb_write_full``: Y, U - 128 and V - 128 at 9 fractional bits,
    in int32 arithmetic, 30-bit saturation, >> 22."""
    if limited:
        yy = (y - LIM_FULL_Y_OFFSET) * LIM_Y_COEFF + (1 << 21)
        rgb = [yy + v * LIM_VR, yy + v * LIM_VG + u * LIM_UG, yy + u * LIM_UB]
    else:
        yy = y * FULL_Y + (1 << 21)
        rgb = [yy + v * FULL_V2R, yy + v * FULL_V2G + u * FULL_U2G, yy + u * FULL_U2B]
    rgb = [((c + 2 ** 31) % 2 ** 32) - 2 ** 31 for c in rgb]
    over = ((rgb[0] | rgb[1] | rgb[2]) & 0xC0000000) != 0
    rgb = [np.where(over, np.clip(c, 0, (1 << 30) - 1), c) >> 22 for c in rgb]
    return np.stack(rgb[::-1], -1)


def general_bgr(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, sub: tuple[int, int],
                path: str = "<frame>", limited: bool = False, h_pos: int = 128) -> np.ndarray:
    """swscale's general scaler from planar full-range (or, with
    ``limited``, limited-range) YCbCr at any subsampling to BGR24 at the
    luma plane's size (see the module's notes). ``h_pos``: the chroma
    samples' horizontal siting in the source (128 centred; MPEG-4's
    left-sited chroma reaches swscale as 64). ``sub``: the format's log2
    chroma subsampling (horizontal, vertical); swscale forces full-width
    chroma for 4:4:4 formats and odd widths."""
    h, w = y.shape
    ch, cw = cb.shape
    full = sub == (0, 0) or w % 2 == 1
    dst_w = w if full else -(-w // 2)
    u15, v15 = _hscale(cb, dst_w, h_pos), _hscale(cr, dst_w, h_pos)  # [ch, dst_w]
    vpos, vtaps = bicubic_filter(ch, h, 1 << 12, V_ALIGN)
    ntaps = vtaps.shape[1]
    rows = np.minimum(vpos[:, None] + np.arange(ntaps), ch - 1)  # [h, taps]
    y15 = y.astype(np.int64) << 7
    # a row whose vertical chroma filter has one tap, or two whose second
    # (its uvalpha) lies in 0..4096, takes yuv2packed1 (vscale.c's
    # packed_vscale); every other row yuv2packedX
    alpha = vtaps[:, 1:2] if ntaps == 2 else np.zeros((h, 1), np.int64)
    packed1 = (ntaps <= 2) & (alpha >= 0) & (alpha <= 4096)  # [h, 1]
    u0, v0 = u15[rows[:, 0]], v15[rows[:, 0]]
    u1, v1 = u15[rows[:, -1]], v15[rows[:, -1]]
    if full:  # yuv2rgb_full_1_c (its chroma weighted by uvalpha), else _X_c
        u = np.where(packed1, (u0 * (4096 - alpha) + u1 * alpha - (128 << 19)) >> 10,
                     ((1 << 9) - (128 << 19) + (u15[rows] * vtaps[..., None]).sum(1)) >> 10)
        v = np.where(packed1, (v0 * (4096 - alpha) + v1 * alpha - (128 << 19)) >> 10,
                     ((1 << 9) - (128 << 19) + (v15[rows] * vtaps[..., None]).sum(1)) >> 10)
        yy = np.where(packed1, y15 * 4, ((1 << 9) + y15 * 4096) >> 10)
        return _full_rgb(yy, u, v, limited).clip(0, 255).astype(np.uint8)
    # the MMX yuv2packed1 reads the first row alone under an uvalpha of
    # 2048 and the two rows' mean from it on; the C one (the last two rows)
    # weights them by uvalpha
    both = alpha >= 2048
    u8 = np.where(packed1, np.where(both, (u0 + u1) >> 5, u0 >> 4),
                  MMX_V_ROUNDER + _pmulhw(u15[rows], vtaps[..., None]).sum(1))
    v8 = np.where(packed1, np.where(both, (v0 + v1) >> 5, v0 >> 4),
                  MMX_V_ROUNDER + _pmulhw(v15[rows], vtaps[..., None]).sum(1))
    uc = np.where(packed1, (u0 * (4096 - alpha) + u1 * alpha + (1 << 18)) >> 19,
                  ((1 << 18) + (u15[rows] * vtaps[..., None]).sum(1)) >> 19)
    vc = np.where(packed1, (v0 * (4096 - alpha) + v1 * alpha + (1 << 18)) >> 19,
                  ((1 << 18) + (v15[rows] * vtaps[..., None]).sum(1)) >> 19)
    out = _mmx_rgb(y, u8, v8, limited, np.where(packed1, 0, MMX_V_ROUNDER))
    last = slice(max(h - 2, 0), h)
    out[last] = _c_rgb(y[last], uc[last], vc[last], limited)
    return out.clip(0, 255).astype(np.uint8)


# JPEG sampling factors of Y (the chroma components at 1 x 1) -> log2 of the
# chroma subsampling (horizontal, vertical)
SUBSAMPLING = {(1, 1): (0, 0), (2, 1): (1, 0), (2, 2): (1, 1), (4, 1): (2, 0), (1, 2): (0, 1)}
NAMES = {(1, 1): "4:4:4", (2, 1): "4:2:2", (2, 2): "4:2:0", (4, 1): "4:1:1", (1, 2): "4:4:0"}


def mjpeg_to_bgr(planes, factors, path: str = "<frame>") -> np.ndarray:
    """A decoded MJPEG frame's planes and sampling factors (``jpeg.MjpegFrame``)
    -> ``[H, W, 3]`` uint8 BGR as ``cv2.VideoCapture`` returns it."""
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=2)
    if len(planes) != 3 or factors[1:] != [(1, 1), (1, 1)] or factors[0] not in SUBSAMPLING:
        raise ValueError(f"{path}: sampling factors {factors}: the port converts gray, 4:4:4, "
                         f"4:2:2, 4:2:0, 4:1:1 and 4:4:0 MJPEG frames ({ROADMAP})")
    hsub, vsub = SUBSAMPLING[tuple(factors[0])]
    y, cb, cr = planes
    _check_planes(y, cb, cr, hsub, vsub, path)
    if hsub == 1 and y.shape[0] % 2 == 0:  # yuvj420p, yuvj422p of an even height
        return _unscaled(y, cb, cr, vsub)
    return general_bgr(y, cb, cr, (hsub, vsub), path)


def mjpeg_to_gray(planes, factors, path: str = "<frame>") -> np.ndarray:
    """``bgr_to_gray(mjpeg_to_bgr(...))``; a gray frame's plane as it is
    (B = G = R = Y, whose gray is Y)."""
    if len(planes) == 1:
        return planes[0]
    return bgr_to_gray(mjpeg_to_bgr(planes, factors, path))


def yuv420p_to_bgr(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                   path: str = "<frame>", h_pos: int = MPEG4_H_POS,
                   full_range: bool = False) -> np.ndarray:
    """Limited-range 4:2:0 planes (FFmpeg's ``yuv420p`` of unspecified
    range, as its ``mpeg4`` decoder gives them, and of limited range, as its
    ``vp8`` decoder does) -> ``[H, W, 3]`` uint8 BGR as ``cv2.VideoCapture``
    returns it: the unscaled converter at an even height, else the general
    scaler with the chroma at horizontal position ``h_pos`` (MPEG-4's
    ``MPEG4_H_POS`` or VP8's ``VP8_H_POS``). ``full_range``: the same routes
    at full range (VP8 after a key frame whose ``clamping_type`` is 1)."""
    _check_planes(y, cb, cr, 1, 1, path)
    if y.shape[0] % 2 == 0:
        return _unscaled(y, cb, cr, 1, limited=not full_range)
    return general_bgr(y, cb, cr, (1, 1), path, limited=not full_range, h_pos=h_pos)


def bgr_to_gray(bgr: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)`` on uint8."""
    b, g, r = (bgr[..., k].astype(np.int32) for k in range(3))
    return ((b * B2Y + g * G2Y + r * R2Y + (1 << (GRAY_SHIFT - 1))) >> GRAY_SHIFT).astype(np.uint8)
