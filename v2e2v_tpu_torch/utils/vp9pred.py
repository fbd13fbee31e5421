"""VP9 prediction as FFmpeg's ``vp9`` decoder computes it
(``vp9recon.c``, ``vp9dsp_template.c``).

Intra: ``edges`` is ``check_intra_mode``: a mode whose above row or left
column is missing becomes its DC-127, DC-129, DC-128, left-DC or top-DC
variant (or V / H for TM); the row above runs to the 8-pixel-aligned frame
edge and repeats its last pixel past it (127 with no row above), the 4x4
blocks of D45 and D63 take the four pixels above-right only inside their
block and the frame (else the fourth repeated), the column on the left runs
to the aligned frame bottom (129 with none), the above-left pixel is
129 (127) without a left column (a row above). A block has a row above
below the frame's first row and a left column right of its tile's first
column. ``predict`` then is each of the ten predictors at 4x4 to 32x32
(libvpx's ``vpx_dsp/intrapred.c``, which FFmpeg's equal).

Inter: ``motion`` predicts many blocks at once from one reference plane:
the 8-tap regular, smooth or sharp filter or the bilinear one at 1/16
pixel (luma vectors doubled, 4:2:0 chroma at the vector), rows first, each
pass rounded at 7 bits and clamped to 8 bits, every reference pixel past the
frame's edge its nearest edge pixel (``emulated_edge_mc`` over the frame's
own size). Compound blocks average two predictions, rounding up.
"""

from __future__ import annotations

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from . import vp9tables as T

DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D117_PRED, D153_PRED, D207_PRED, D63_PRED, \
    TM_PRED = range(10)
LEFT_DC, TOP_DC, DC_128, DC_127, DC_129 = range(10, 15)
KERNELS = T.SUBPEL_FILTERS.astype(np.int32)  # [filter][16][8]

# check_intra_mode's mode_conv[mode][have_left][have_top]
CONV = {
    V_PRED: ((DC_127, V_PRED), (DC_127, V_PRED)),
    H_PRED: ((DC_129, DC_129), (H_PRED, H_PRED)),
    DC_PRED: ((DC_128, TOP_DC), (LEFT_DC, DC_PRED)),
    D45_PRED: ((DC_127, D45_PRED), (DC_127, D45_PRED)),
    D135_PRED: ((D135_PRED,) * 2,) * 2,
    D117_PRED: ((D117_PRED,) * 2,) * 2,
    D153_PRED: ((D153_PRED,) * 2,) * 2,
    D63_PRED: ((DC_127, D63_PRED), (DC_127, D63_PRED)),
    D207_PRED: ((DC_129, DC_129), (D207_PRED, D207_PRED)),
    TM_PRED: ((DC_129, V_PRED), (H_PRED, TM_PRED)),
}
NEEDS_TOP = {V_PRED, DC_PRED, D45_PRED, D135_PRED, D117_PRED, D153_PRED, D63_PRED, TM_PRED,
             TOP_DC}
NEEDS_LEFT = {H_PRED, DC_PRED, D135_PRED, D117_PRED, D153_PRED, D207_PRED, TM_PRED, LEFT_DC}
NEEDS_TOPLEFT = {D135_PRED, D117_PRED, D153_PRED, TM_PRED}
NEEDS_TOPRIGHT = {D45_PRED, D63_PRED}


def edges(plane: np.ndarray, mode: int, y: int, x: int, n: int, have_top: bool,
          have_left: bool, have_right: bool, avail_w: int, avail_h: int):
    """``check_intra_mode``: (mode, above row, left column, above-left) for
    the ``n`` x ``n`` block at (``y``, ``x``); ``avail_w`` / ``avail_h`` are
    the pixels to the aligned frame edge from ``x`` / ``y``."""
    mode = CONV[mode][have_left][have_top]
    top = left = None
    tl = 0
    if mode in NEEDS_TOP:
        need_tr = 4 if (n == 4 and mode in NEEDS_TOPRIGHT and have_right) else 0
        if have_top:
            row = plane[y - 1]
            if n + need_tr <= avail_w and (n != 4 or mode not in NEEDS_TOPRIGHT or have_right):
                top = row[x:x + n + need_tr].tolist()
            else:
                got = min(n, avail_w)
                top = row[x:x + got].tolist()
                top += [top[-1]] * (n - got)
        else:
            top = [127] * n
        if mode in NEEDS_TOPLEFT:
            tl = int(plane[y - 1, x - 1]) if (have_left and have_top) else (129 if have_top
                                                                            else 127)
        if n == 4 and mode in NEEDS_TOPRIGHT and len(top) == 4:
            if have_top and have_right and n + 4 <= avail_w:
                top += plane[y - 1, x + 4:x + 8].tolist()
            else:
                top += [top[3]] * 4
    if mode in NEEDS_LEFT:
        if have_left:
            got = min(n, avail_h)
            left = plane[y:y + got, x - 1].tolist()
            left += [left[-1]] * (n - got)
        else:
            left = [129] * n
    return mode, top, left, tl


def _avg2(a, b):
    return (a + b + 1) >> 1


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def predict(mode: int, n: int, top, left, tl: int) -> np.ndarray:
    """The ``n`` x ``n`` prediction (int32) of ``mode`` from its edges."""
    if mode == V_PRED:
        return np.tile(np.array(top[:n], np.int32), (n, 1))
    if mode == H_PRED:
        return np.tile(np.array(left, np.int32)[:, None], (1, n))
    if mode in (DC_PRED, LEFT_DC, TOP_DC):
        s = (sum(top) if mode != LEFT_DC else 0) + (sum(left) if mode != TOP_DC else 0)
        k = n.bit_length() - 1 + (mode == DC_PRED)
        return np.full((n, n), (s + (1 << (k - 1))) >> k, np.int32)
    if mode in (DC_128, DC_127, DC_129):
        return np.full((n, n), {DC_128: 128, DC_127: 127, DC_129: 129}[mode], np.int32)
    if mode == TM_PRED:
        t = np.array(top[:n], np.int32)
        lf = np.array(left, np.int32)
        return np.clip(lf[:, None] + t[None, :] - tl, 0, 255)
    d = [[0] * n for _ in range(n)]
    if mode == D45_PRED:
        a = top + [top[n - 1]] * (2 * n - len(top)) if n > 4 else top
        for r in range(n):
            for c in range(n):
                d[r][c] = _avg3(a[r + c], a[r + c + 1], a[r + c + 2]) \
                    if r + c + 2 < 2 * n else a[2 * n - 1]
    elif mode == D63_PRED:
        a = top + [top[n - 1]] * (2 * n - len(top)) if n > 4 else top
        if n == 4:
            A, B, C, D, E, F, G = a[:7]
            d = [[_avg2(A, B), _avg2(B, C), _avg2(C, D), _avg2(D, E)],
                 [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F)],
                 [_avg2(B, C), _avg2(C, D), _avg2(D, E), _avg2(E, F)],
                 [_avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F), _avg3(E, F, G)]]
        else:
            for c in range(n):
                d[0][c] = _avg2(a[c], a[c + 1])
                d[1][c] = _avg3(a[c], a[c + 1], a[c + 2])
            size = n - 2
            for r in range(2, n, 2):
                d[r] = d[0][r >> 1:(r >> 1) + size] + [a[n - 1]] * (n - size)
                d[r + 1] = d[1][r >> 1:(r >> 1) + size] + [a[n - 1]] * (n - size)
                size -= 1
    elif mode == D135_PRED:
        e = left[::-1] + [tl] + top[:n]
        v = [_avg3(e[k], e[k + 1], e[k + 2]) for k in range(2 * n - 1)]
        for r in range(n):
            d[r] = v[n - 1 - r:2 * n - 1 - r]
    elif mode == D117_PRED:
        a = [tl] + top[:n]  # a[i + 1] is above[i]
        for c in range(n):
            d[0][c] = _avg2(a[c], a[c + 1])
        d[1][0] = _avg3(left[0], tl, top[0])
        for c in range(1, n):
            d[1][c] = _avg3(a[c - 1], a[c], a[c + 1])
        d[2][0] = _avg3(tl, left[0], left[1])
        for r in range(3, n):
            d[r][0] = _avg3(left[r - 3], left[r - 2], left[r - 1])
        for r in range(2, n):
            for c in range(1, n):
                d[r][c] = d[r - 2][c - 1]
    elif mode == D153_PRED:
        d[0][0] = _avg2(tl, left[0])
        for r in range(1, n):
            d[r][0] = _avg2(left[r - 1], left[r])
        d[0][1] = _avg3(left[0], tl, top[0])
        d[1][1] = _avg3(tl, left[0], left[1])
        for r in range(2, n):
            d[r][1] = _avg3(left[r - 2], left[r - 1], left[r])
        a = [tl] + top[:n]
        for c in range(n - 2):
            d[0][c + 2] = _avg3(a[c], a[c + 1], a[c + 2])
        for r in range(1, n):
            for c in range(n - 2):
                d[r][c + 2] = d[r - 1][c]
    elif mode == D207_PRED:
        lf = left
        for r in range(n - 1):
            d[r][0] = _avg2(lf[r], lf[r + 1])
        d[n - 1][0] = lf[n - 1]
        for r in range(n - 2):
            d[r][1] = _avg3(lf[r], lf[r + 1], lf[r + 2])
        d[n - 2][1] = _avg3(lf[n - 2], lf[n - 1], lf[n - 1])
        d[n - 1][1] = lf[n - 1]
        for c in range(n - 2):
            d[n - 1][c + 2] = lf[n - 1]
        for r in range(n - 2, -1, -1):
            for c in range(n - 2):
                d[r][c + 2] = d[r + 1][c]
    return np.array(d, np.int32)


def motion(ref: np.ndarray, size: tuple, y0: np.ndarray, x0: np.ndarray, fy: np.ndarray,
           fx: np.ndarray, filt: np.ndarray, h: int, w: int) -> np.ndarray:
    """``[N]`` ``h`` x ``w`` predictions from ``ref`` (whose frame is
    ``size`` = (height, width)) at whole-pixel (``y0``, ``x0``) plus
    sixteenths (``fy``, ``fx``) with kernel set ``filt`` -> ``[N, h, w]``."""
    hh, ww = size
    rows = np.clip(y0[:, None] + np.arange(-3, h + 5), 0, hh - 1)
    cols = np.clip(x0[:, None] + np.arange(-3, w + 5), 0, ww - 1)
    win = ref[rows[:, :, None], cols[:, None, :]].astype(np.int32)  # [N, h + 8, w + 8]
    taps = sliding_window_view(win, 8, axis=2)[:, :, :w]  # [N, h + 8, w, 8]
    hor = np.clip((np.einsum("nrck,nk->nrc", taps, KERNELS[filt, fx]) + 64) >> 7, 0, 255)
    taps = sliding_window_view(hor, 8, axis=1)[:, :h]  # [N, h, w, 8]
    return np.clip((np.einsum("nrck,nk->nrc", taps, KERNELS[filt, fy]) + 64) >> 7, 0, 255)
