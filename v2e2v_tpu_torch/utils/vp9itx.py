"""VP9's inverse transforms in numpy, vectorised over the blocks of a frame:
the IDCT and IADST at 4, 8 and 16, the IDCT at 32 and the lossless 4x4
Walsh-Hadamard transform, in the integer arithmetic of FFmpeg's
``vp9dsp_template.c`` (the same as libvpx's ``vpx_dsp/inv_txfm.c``): each
rotation rounded at 14 bits, rows first, the first pass kept in 16 bits,
the second rounded by 4, 5, 6 and 6 bits (none for the WHT, whose first
pass shifts its input by 2).

FFmpeg keeps each pass's output in 16 bits (``dctcoef``), and its x86 SIMD
transforms keep theirs in 16-bit lanes, saturating where the C code wraps;
the two agree wherever no pass output leaves 16 bits. ``inverse`` computes
every value exactly (int64) and refuses, with a ValueError naming ROADMAP.md
queue 1, item 4, a block whose first or second pass leaves that range.
Probed with cv2 5.0.0 (x86) with ``base_q_idx`` rewritten to 255 on the
noise fixture (``tests/test_torch_vp9.py``, ``simd_range_coefficients``):
cv2 decodes it, and its frames match neither exact passes nor passes
wrapped to 16 bits (FFmpeg's C code) nor saturated: the x86 transforms part
from the C ones there. The encoders' streams never come near it (their
coefficients are bounded by the forward transform of 8-bit residuals;
``base_q_idx`` up to 250 on that clip stays inside).
"""

from __future__ import annotations

import numpy as np

from .vp9 import refused

COSPI = (16384, 16364, 16305, 16207, 16069, 15893, 15679, 15426, 15137, 14811, 14449, 14053,
         13623, 13160, 12665, 12140, 11585, 11003, 10394, 9760, 9102, 8423, 7723, 7005, 6270,
         5520, 4756, 3981, 3196, 2404, 1606, 804)
SINPI = (0, 5283, 9929, 13377, 15212)
DCT, ADST = 0, 1
# a transform type's (columns, rows) 1-D transforms (libvpx's TX_TYPE order:
# DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST)
TYPES = ((DCT, DCT), (ADST, DCT), (DCT, ADST), (ADST, ADST))
SHIFT = (4, 5, 6, 6)


def _rs(x):
    """``dct_const_round_shift``."""
    return (x + 8192) >> 14


def _rot(a, b, ca: int, cb: int):
    """(rs(a ca - b cb), rs(a cb + b ca)): a butterfly rotation."""
    c = COSPI
    return _rs(a * c[ca] - b * c[cb]), _rs(a * c[cb] + b * c[ca])


def idct4(x):
    c = COSPI
    s0 = _rs((x[0] + x[2]) * c[16])
    s1 = _rs((x[0] - x[2]) * c[16])
    s2 = _rs(x[1] * c[24] - x[3] * c[8])
    s3 = _rs(x[1] * c[8] + x[3] * c[24])
    return [s0 + s3, s1 + s2, s1 - s2, s0 - s3]


def _idct8_odd(x1, x3, x5, x7):
    c = COSPI
    s4, s7 = _rot(x1, x7, 28, 4)
    s5, s6 = _rot(x5, x3, 12, 20)
    t4, t5, t6, t7 = s4 + s5, s4 - s5, -s6 + s7, s6 + s7
    u5 = _rs((t6 - t5) * c[16])
    u6 = _rs((t5 + t6) * c[16])
    return t4, u5, u6, t7


def idct8(x):
    e = idct4([x[0], x[2], x[4], x[6]])
    o4, o5, o6, o7 = _idct8_odd(x[1], x[3], x[5], x[7])
    o = (o7, o6, o5, o4)
    return [e[i] + o[i] for i in range(4)] + [e[3 - i] - o[3 - i] for i in range(4)]


def _idct16_odd(x):
    """``x``: the 8 odd inputs x1, x3, ..., x15 -> step 8..15 after stage 6."""
    c = COSPI
    x1, x3, x5, x7, x9, x11, x13, x15 = x
    s8, s15 = _rot(x1, x15, 30, 2)
    s9, s14 = _rot(x9, x7, 14, 18)
    s10, s13 = _rot(x5, x11, 22, 10)
    s11, s12 = _rot(x13, x3, 6, 26)
    a8, a9, a10, a11 = s8 + s9, s8 - s9, -s10 + s11, s10 + s11
    a12, a13, a14, a15 = s12 + s13, s12 - s13, -s14 + s15, s14 + s15
    b9 = _rs(-a9 * c[8] + a14 * c[24])
    b14 = _rs(a9 * c[24] + a14 * c[8])
    b10 = _rs(-a10 * c[24] - a13 * c[8])
    b13 = _rs(-a10 * c[8] + a13 * c[24])
    c8, c9, c10, c11 = a8 + a11, b9 + b10, b9 - b10, a8 - a11
    c12, c13, c14, c15 = -a12 + a15, -b13 + b14, b13 + b14, a12 + a15
    d10 = _rs((-c10 + c13) * c[16])
    d13 = _rs((c10 + c13) * c[16])
    d11 = _rs((-c11 + c12) * c[16])
    d12 = _rs((c11 + c12) * c[16])
    return [c8, c9, d10, d11, d12, d13, c14, c15]


def idct16(x):
    e = idct8(x[0::2])
    d = _idct16_odd(x[1::2])
    return [e[i] + d[7 - i] for i in range(8)] + [e[7 - i] - d[i] for i in range(8)]


def _idct32_odd(x):
    """The 16 odd inputs x1, x3, ..., x31 -> step 16..31 after stage 7."""
    c = COSPI
    xi = {2 * k + 1: v for k, v in enumerate(x)}
    s = {}
    for (i, j), (a, b, ca, cb) in {
            (16, 31): (1, 31, 31, 1), (17, 30): (17, 15, 15, 17), (18, 29): (9, 23, 23, 9),
            (19, 28): (25, 7, 7, 25), (20, 27): (5, 27, 27, 5), (21, 26): (21, 11, 11, 21),
            (22, 25): (13, 19, 19, 13), (23, 24): (29, 3, 3, 29)}.items():
        s[i], s[j] = _rot(xi[a], xi[b], ca, cb)
    t = {}
    for k in (16, 20, 24, 28):
        t[k], t[k + 1] = s[k] + s[k + 1], s[k] - s[k + 1]
        t[k + 2], t[k + 3] = -s[k + 2] + s[k + 3], s[k + 2] + s[k + 3]
    u = dict(t)
    u[17] = _rs(-t[17] * c[4] + t[30] * c[28])
    u[30] = _rs(t[17] * c[28] + t[30] * c[4])
    u[18] = _rs(-t[18] * c[28] - t[29] * c[4])
    u[29] = _rs(-t[18] * c[4] + t[29] * c[28])
    u[21] = _rs(-t[21] * c[20] + t[26] * c[12])
    u[26] = _rs(t[21] * c[12] + t[26] * c[20])
    u[22] = _rs(-t[22] * c[12] - t[25] * c[20])
    u[25] = _rs(-t[22] * c[20] + t[25] * c[12])
    v = {16: u[16] + u[19], 17: u[17] + u[18], 18: u[17] - u[18], 19: u[16] - u[19],
         20: -u[20] + u[23], 21: -u[21] + u[22], 22: u[21] + u[22], 23: u[20] + u[23],
         24: u[24] + u[27], 25: u[25] + u[26], 26: u[25] - u[26], 27: u[24] - u[27],
         28: -u[28] + u[31], 29: -u[29] + u[30], 30: u[29] + u[30], 31: u[28] + u[31]}
    w = dict(v)
    w[18] = _rs(-v[18] * c[8] + v[29] * c[24])
    w[29] = _rs(v[18] * c[24] + v[29] * c[8])
    w[19] = _rs(-v[19] * c[8] + v[28] * c[24])
    w[28] = _rs(v[19] * c[24] + v[28] * c[8])
    w[20] = _rs(-v[20] * c[24] - v[27] * c[8])
    w[27] = _rs(-v[20] * c[8] + v[27] * c[24])
    w[21] = _rs(-v[21] * c[24] - v[26] * c[8])
    w[26] = _rs(-v[21] * c[8] + v[26] * c[24])
    y = {}
    for k in range(4):
        y[16 + k] = w[16 + k] + w[23 - k]
        y[23 - k] = w[16 + k] - w[23 - k]
        y[24 + k] = -w[24 + k] + w[31 - k]
        y[31 - k] = w[24 + k] + w[31 - k]
    z = dict(y)
    for k in range(4):
        z[20 + k] = _rs((-y[20 + k] + y[27 - k]) * c[16])
        z[27 - k] = _rs((y[20 + k] + y[27 - k]) * c[16])
    return [z[16 + k] for k in range(16)]


def idct32(x):
    e = idct16(x[0::2])
    z = _idct32_odd(x[1::2])
    return [e[i] + z[15 - i] for i in range(16)] + [e[15 - i] - z[i] for i in range(16)]


def iadst4(x):
    s = SINPI
    x0, x1, x2, x3 = x
    s0 = s[1] * x0 + s[4] * x2 + s[2] * x3
    s1 = s[2] * x0 - s[1] * x2 - s[4] * x3
    s2 = s[3] * (x0 - x2 + x3)
    s3 = s[3] * x1
    return [_rs(s0 + s3), _rs(s1 + s3), _rs(s2), _rs(s0 + s1 - s3)]


def iadst8(x):
    c = COSPI
    x0, x1, x2, x3, x4, x5, x6, x7 = x[7], x[0], x[5], x[2], x[3], x[4], x[1], x[6]
    s0, s1 = c[2] * x0 + c[30] * x1, c[30] * x0 - c[2] * x1
    s2, s3 = c[10] * x2 + c[22] * x3, c[22] * x2 - c[10] * x3
    s4, s5 = c[18] * x4 + c[14] * x5, c[14] * x4 - c[18] * x5
    s6, s7 = c[26] * x6 + c[6] * x7, c[6] * x6 - c[26] * x7
    x0, x1, x2, x3 = _rs(s0 + s4), _rs(s1 + s5), _rs(s2 + s6), _rs(s3 + s7)
    x4, x5, x6, x7 = _rs(s0 - s4), _rs(s1 - s5), _rs(s2 - s6), _rs(s3 - s7)
    s4, s5 = c[8] * x4 + c[24] * x5, c[24] * x4 - c[8] * x5
    s6, s7 = -c[24] * x6 + c[8] * x7, c[8] * x6 + c[24] * x7
    x0, x1, x2, x3 = x0 + x2, x1 + x3, x0 - x2, x1 - x3
    x4, x5, x6, x7 = _rs(s4 + s6), _rs(s5 + s7), _rs(s4 - s6), _rs(s5 - s7)
    x2, x3 = _rs(c[16] * (x2 + x3)), _rs(c[16] * (x2 - x3))
    x6, x7 = _rs(c[16] * (x6 + x7)), _rs(c[16] * (x6 - x7))
    return [x0, -x4, x6, -x2, x3, -x7, x5, -x1]


def iadst16(x):
    c = COSPI
    order = (15, 0, 13, 2, 11, 4, 9, 6, 7, 8, 5, 10, 3, 12, 1, 14)
    v = [x[i] for i in order]
    pairs = ((1, 31), (5, 27), (9, 23), (13, 19), (17, 15), (21, 11), (25, 7), (29, 3))
    s = []
    for k, (ca, cb) in enumerate(pairs):
        a, b = v[2 * k], v[2 * k + 1]
        s += [a * c[ca] + b * c[cb], a * c[cb] - b * c[ca]]
    v = [_rs(s[i] + s[i + 8]) for i in range(8)] + [_rs(s[i] - s[i + 8]) for i in range(8)]
    x8, x9, x10, x11, x12, x13, x14, x15 = v[8:]
    s8, s9 = x8 * c[4] + x9 * c[28], x8 * c[28] - x9 * c[4]
    s10, s11 = x10 * c[20] + x11 * c[12], x10 * c[12] - x11 * c[20]
    s12, s13 = -x12 * c[28] + x13 * c[4], x12 * c[4] + x13 * c[28]
    s14, s15 = -x14 * c[12] + x15 * c[20], x14 * c[20] + x15 * c[12]
    x0, x1, x2, x3 = v[0] + v[4], v[1] + v[5], v[2] + v[6], v[3] + v[7]
    x4, x5, x6, x7 = v[0] - v[4], v[1] - v[5], v[2] - v[6], v[3] - v[7]
    x8, x9, x10, x11 = _rs(s8 + s12), _rs(s9 + s13), _rs(s10 + s14), _rs(s11 + s15)
    x12, x13, x14, x15 = _rs(s8 - s12), _rs(s9 - s13), _rs(s10 - s14), _rs(s11 - s15)
    s4, s5 = x4 * c[8] + x5 * c[24], x4 * c[24] - x5 * c[8]
    s6, s7 = -x6 * c[24] + x7 * c[8], x6 * c[8] + x7 * c[24]
    s12, s13 = x12 * c[8] + x13 * c[24], x12 * c[24] - x13 * c[8]
    s14, s15 = -x14 * c[24] + x15 * c[8], x14 * c[8] + x15 * c[24]
    x0, x1, x2, x3 = x0 + x2, x1 + x3, x0 - x2, x1 - x3
    x4, x5, x6, x7 = _rs(s4 + s6), _rs(s5 + s7), _rs(s4 - s6), _rs(s5 - s7)
    x8, x9, x10, x11 = x8 + x10, x9 + x11, x8 - x10, x9 - x11
    x12, x13, x14, x15 = _rs(s12 + s14), _rs(s13 + s15), _rs(s12 - s14), _rs(s13 - s15)
    x2, x3 = _rs(-c[16] * (x2 + x3)), _rs(c[16] * (x2 - x3))
    x6, x7 = _rs(c[16] * (x6 + x7)), _rs(c[16] * (-x6 + x7))
    x10, x11 = _rs(c[16] * (x10 + x11)), _rs(c[16] * (-x10 + x11))
    x14, x15 = _rs(-c[16] * (x14 + x15)), _rs(c[16] * (x14 - x15))
    return [x0, -x8, x12, -x4, x6, x14, x10, x2, x3, x11, x15, x7, x5, -x13, x9, -x1]


IDCT = {4: idct4, 8: idct8, 16: idct16, 32: idct32}
IADST = {4: iadst4, 8: iadst8, 16: iadst16}


def _pass(fn, a: np.ndarray) -> np.ndarray:
    """One 1-D pass over the last axis of ``[..., n]``."""
    return np.stack(fn([a[..., i] for i in range(a.shape[-1])]), -1)


def _iwht(c: np.ndarray) -> np.ndarray:
    def one(a1, c1, d1, b1):
        a1 = a1 + c1
        d1 = d1 - b1
        e1 = (a1 - d1) >> 1
        b1 = e1 - b1
        c1 = e1 - c1
        a1 = a1 - b1
        d1 = d1 + c1
        return [a1, b1, c1, d1]

    rows = np.stack(one(*[c[..., i] >> 2 for i in range(4)]), -1)  # [N, 4 rows, 4]
    cols = np.stack(one(*[rows[:, i, :] for i in range(4)]), 1)
    return cols


def inverse(coefs: np.ndarray, tx: int, ttype: int, path: str = "<frame>") -> np.ndarray:
    """``[N, n * n]`` dequantised 16-bit coefficients (raster) of one size
    and type -> ``[N, n, n]`` residuals."""
    n = 4 << tx
    c = coefs.astype(np.int64).reshape(-1, n, n)
    if ttype == 4:
        return _iwht(c)
    cols, rows = TYPES[ttype]
    first = _pass((IDCT if rows == DCT else IADST)[n], c)  # each row
    second = _pass((IDCT if cols == DCT else IADST)[n], first.transpose(0, 2, 1))
    if (first.min(initial=0) < -32768 or first.max(initial=0) > 32767
            or second.min(initial=0) < -32768 or second.max(initial=0) > 32767):
        raise refused(path, "coefficients whose inverse transform leaves 16 bits")
    s = SHIFT[tx]
    return ((second + (1 << (s - 1))) >> s).transpose(0, 2, 1)
