"""An MPEG-4 Part 2 (ISO/IEC 14496-2) video decoder in numpy and plain
Python, bit for bit what FFmpeg's ``mpeg4`` decoder (``mpeg4videodec.c``,
``h263dec.c``, ``mpegvideo``) gives for the streams that FFmpeg's ``mpeg4``
encoder writes through ``cv2.VideoWriter`` (``mp4v`` in MP4, MOV and M4V;
``XVID``, ``FMP4``, ``DIVX``, ``DX50`` and ``mp4v`` in AVI).

``Mpeg4Decoder(config)`` takes the stream's header bytes (an MP4 ``esds``
DecoderSpecificInfo, or nothing when they lead the first AVI chunk) and
``decode(packet)`` returns each coded VOP's Y, Cb and Cr planes (4:2:0,
cropped to the picture, as FFmpeg's ``yuv420p``; limited range):

- headers: VO (``video_signal_type``), VOL, user data (the encoder's
  ``Lavc`` build string) and VOP (``vop_coding_type``,
  ``modulo_time_base``, ``vop_time_increment``, ``vop_coded``,
  ``vop_rounding_type``, ``intra_dc_vlc_thr``, ``vop_quant``,
  ``vop_fcode_forward``); VOS, GOV and other start codes are passed over,
  as FFmpeg passes them;
- I- and P-VOP macroblocks: ``not_coded`` MBs, MCBPC, CBPY, DQUANT, intra
  MBs inside P-VOPs, intra DC with ``dc_scaler`` and its prediction, AC
  prediction with its QP rescaling and the alternate scans, the TCOEF VLCs
  with escapes 1-3, H.263 dequantisation, 1MV with median prediction and
  ``f_code`` wrapping;
- motion compensation at half-pel under ``vop_rounding_type`` (chroma's
  no-rounding averages across and down as x86's inexact ``pavgb`` ones,
  FFmpeg's default outside its bit-exact mode), chroma vectors from luma
  as H.263 derives them (``mpegvideo_motion.c::mpeg_motion_internal``),
  and FFmpeg's edge emulation: every read clamped to the reference, whose
  edge is the macroblock grid's (``h_edge_pos``, ``v_edge_pos``; half of
  each for chroma), not the picture's: probed on a 74x48 clip (cv2 writes
  even sizes), whose last partial macroblocks' decoded samples past the
  picture are read as they lie;
- ``jpeg.idct_simple`` for intra blocks and ``jpeg.idct_simple_add`` for
  inter residuals (``ff_simple_idct_put`` / ``_add``).

The VLC and scan tables are ISO/IEC 14496-2 Annex B's (B-6 to B-17 and
figure 7-4's scans), written down here.

Refused, each with a ValueError naming ROADMAP.md queue 1, item 4: B-VOPs,
S-VOPs (sprites and GMC), quarter-pel, interlaced VOLs, OBMC, data
partitioning, resync markers and video packets, MPEG quantisation
(``quant_type`` 1), inter4v MBs, H.263's ``short_video_header``,
non-rectangular shapes, ``not_8_bit``, newpred, reduced-resolution VOPs,
scalability, complexity estimation, a signalled colour range or colour
description, and streams not written by FFmpeg's encoder (whose files
FFmpeg decodes with encoder-specific workarounds or another IDCT).
"""

from __future__ import annotations

import re

import numpy as np

from .imgcodecs import ROADMAP
from .jpeg import idct_simple, idct_simple_add

# ---------------------------------------------------------------- the tables

# Table B-16 (intra TCOEF) and B-17 (inter TCOEF): (code, length) for each
# (last, run, level) below, the escape '0000011' last; FFmpeg's intra_vlc and
# ff_inter_vlc order.
INTRA_VLC = (
    (0x2, 2), (0x6, 3), (0xF, 4), (0xD, 5), (0xC, 5), (0x15, 6), (0x13, 6), (0x12, 6),
    (0x17, 7), (0x1F, 8), (0x1E, 8), (0x1D, 8), (0x25, 9), (0x24, 9), (0x23, 9), (0x21, 9),
    (0x21, 10), (0x20, 10), (0xF, 10), (0xE, 10), (0x7, 11), (0x6, 11), (0x20, 11),
    (0x21, 11), (0x50, 12), (0x51, 12), (0x52, 12), (0xE, 4), (0x14, 6), (0x16, 7),
    (0x1C, 8), (0x20, 9), (0x1F, 9), (0xD, 10), (0x22, 11), (0x53, 12), (0x55, 12),
    (0xB, 5), (0x15, 7), (0x1E, 9), (0xC, 10), (0x56, 12), (0x11, 6), (0x1B, 8), (0x1D, 9),
    (0xB, 10), (0x10, 6), (0x22, 9), (0xA, 10), (0xD, 6), (0x1C, 9), (0x8, 10), (0x12, 7),
    (0x1B, 9), (0x54, 12), (0x14, 7), (0x1A, 9), (0x57, 12), (0x19, 8), (0x9, 10),
    (0x18, 8), (0x23, 11), (0x17, 8), (0x19, 9), (0x18, 9), (0x7, 10), (0x58, 12),
    (0x7, 4), (0xC, 6), (0x16, 8), (0x17, 9), (0x6, 10), (0x5, 11), (0x4, 11), (0x59, 12),
    (0xF, 6), (0x16, 9), (0x5, 10), (0xE, 6), (0x4, 10), (0x11, 7), (0x24, 11), (0x10, 7),
    (0x25, 11), (0x13, 7), (0x5A, 12), (0x15, 8), (0x5B, 12), (0x14, 8), (0x13, 8),
    (0x1A, 8), (0x15, 9), (0x14, 9), (0x13, 9), (0x12, 9), (0x11, 9), (0x26, 11),
    (0x27, 11), (0x5C, 12), (0x5D, 12), (0x5E, 12), (0x5F, 12), (0x3, 7))
INTRA_RUN = ((0,) * 27 + (1,) * 10 + (2,) * 5 + (3,) * 4 + (4,) * 3 + (5,) * 3 + (6,) * 3
             + (7,) * 3 + (8,) * 2 + (9,) * 2 + (10, 11, 12, 13, 14)
             + (0,) * 8 + (1,) * 3 + (2, 2, 3, 3, 4, 4, 5, 5, 6, 6) + tuple(range(7, 21)))
INTRA_LEVEL = (tuple(range(1, 28)) + tuple(range(1, 11)) + tuple(range(1, 6)) + (1, 2, 3, 4)
               + (1, 2, 3) * 4 + (1, 2) * 2 + (1,) * 5
               + tuple(range(1, 9)) + (1, 2, 3) + (1, 2) * 5 + (1,) * 14)
INTRA_LAST = 67  # the first (last = 1) entry

INTER_VLC = (
    (0x2, 2), (0xF, 4), (0x15, 6), (0x17, 7), (0x1F, 8), (0x25, 9), (0x24, 9), (0x21, 10),
    (0x20, 10), (0x7, 11), (0x6, 11), (0x20, 11), (0x6, 3), (0x14, 6), (0x1E, 8), (0xF, 10),
    (0x21, 11), (0x50, 12), (0xE, 4), (0x1D, 8), (0xE, 10), (0x51, 12), (0xD, 5), (0x23, 9),
    (0xD, 10), (0xC, 5), (0x22, 9), (0x52, 12), (0xB, 5), (0xC, 10), (0x53, 12), (0x13, 6),
    (0xB, 10), (0x54, 12), (0x12, 6), (0xA, 10), (0x11, 6), (0x9, 10), (0x10, 6), (0x8, 10),
    (0x16, 7), (0x55, 12), (0x15, 7), (0x14, 7), (0x1C, 8), (0x1B, 8), (0x21, 9), (0x20, 9),
    (0x1F, 9), (0x1E, 9), (0x1D, 9), (0x1C, 9), (0x1B, 9), (0x1A, 9), (0x22, 11),
    (0x23, 11), (0x56, 12), (0x57, 12), (0x7, 4), (0x19, 9), (0x5, 11), (0xF, 6), (0x4, 11),
    (0xE, 6), (0xD, 6), (0xC, 6), (0x13, 7), (0x12, 7), (0x11, 7), (0x10, 7), (0x1A, 8),
    (0x19, 8), (0x18, 8), (0x17, 8), (0x16, 8), (0x15, 8), (0x14, 8), (0x13, 8), (0x18, 9),
    (0x17, 9), (0x16, 9), (0x15, 9), (0x14, 9), (0x13, 9), (0x12, 9), (0x11, 9), (0x7, 10),
    (0x6, 10), (0x5, 10), (0x4, 10), (0x24, 11), (0x25, 11), (0x26, 11), (0x27, 11),
    (0x58, 12), (0x59, 12), (0x5A, 12), (0x5B, 12), (0x5C, 12), (0x5D, 12), (0x5E, 12),
    (0x5F, 12), (0x3, 7))
INTER_RUN = ((0,) * 12 + (1,) * 6 + (2,) * 4 + (3,) * 3 + (4,) * 3 + (5,) * 3 + (6,) * 3
             + (7, 7, 8, 8, 9, 9, 10, 10) + tuple(range(11, 27))
             + (0, 0, 0, 1, 1) + tuple(range(2, 41)))
INTER_LEVEL = (tuple(range(1, 13)) + tuple(range(1, 7)) + (1, 2, 3, 4) + (1, 2, 3) * 4
               + (1, 2) * 4 + (1,) * 16 + (1, 2, 3, 1, 2) + (1,) * 39)
INTER_LAST = 58

# Table B-6 (MCBPC of I-VOPs: intra, intra+q, stuffing) and B-7 (of P-VOPs:
# inter, intra, inter+q, intra+q, inter4v, stuffing, each for cbpc 0-3)
INTRA_MCBPC = ((1, 1), (1, 3), (2, 3), (3, 3), (1, 4), (1, 6), (2, 6), (3, 6), (1, 9))
INTER_MCBPC = ((1, 1), (3, 4), (2, 4), (5, 6), (3, 5), (4, 8), (3, 8), (3, 7), (3, 3), (7, 7),
               (6, 7), (5, 9), (4, 6), (4, 9), (3, 9), (2, 9), (2, 3), (5, 7), (4, 7), (5, 8),
               (1, 9))
# Table B-8 (CBPY, indexed by the intra pattern), B-12 (MVD magnitude 0-32)
CBPY = ((3, 4), (5, 5), (4, 5), (9, 4), (3, 5), (7, 4), (2, 6), (11, 4), (2, 5), (3, 6),
        (5, 4), (10, 4), (4, 4), (8, 4), (6, 4), (3, 2))
MVD = ((1, 1), (1, 2), (1, 3), (1, 4), (3, 6), (5, 7), (4, 7), (3, 7), (11, 9), (10, 9),
       (9, 9), (17, 10), (16, 10), (15, 10), (14, 10), (13, 10), (12, 10), (11, 10), (10, 10),
       (9, 10), (8, 10), (7, 10), (6, 10), (5, 10), (4, 10), (7, 11), (6, 11), (5, 11),
       (4, 11), (3, 11), (2, 11), (3, 12), (2, 12))
# Table B-13 and B-14: dct_dc_size of luminance and of chrominance, 0-12
DC_LUMA = ((3, 3), (3, 2), (2, 2), (2, 3), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7), (1, 8),
           (1, 9), (1, 10), (1, 11))
DC_CHROMA = ((3, 2), (2, 2), (1, 2), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7), (1, 8), (1, 9),
             (1, 10), (1, 11), (1, 12))

# figure 7-4's zigzag and alternate scans: scan index -> raster position
ZIGZAG = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
          41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
          30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)
ALT_HORIZONTAL = (0, 1, 2, 3, 8, 9, 16, 17, 10, 11, 4, 5, 6, 7, 15, 14, 13, 12, 19, 18, 24,
                  25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29, 30, 31, 34, 35, 40, 41, 48, 49,
                  42, 43, 36, 37, 38, 39, 44, 45, 46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54,
                  55, 60, 61, 62, 63)
ALT_VERTICAL = (0, 8, 16, 24, 1, 9, 2, 10, 17, 25, 32, 40, 48, 56, 57, 49, 41, 33, 26, 18, 3,
                11, 4, 12, 19, 27, 34, 42, 50, 58, 35, 43, 51, 59, 20, 28, 5, 13, 6, 14, 21,
                29, 36, 44, 52, 60, 37, 45, 53, 61, 22, 30, 7, 15, 23, 31, 38, 46, 54, 62, 39,
                47, 55, 63)

# dc_scaler of luminance and chrominance by QP (table 7-1), intra_dc_vlc_thr's
# QP bounds (table 6-21), DQUANT's steps (table 6-22)
Y_DC_SCALE = tuple(0 if q == 0 else 8 if q <= 4 else 2 * q if q <= 8 else q + 8 if q <= 24
                   else 2 * q - 16 for q in range(32))
C_DC_SCALE = tuple(0 if q == 0 else 8 if q <= 4 else (q + 13) // 2 if q <= 24 else q - 6
                   for q in range(32))
DC_THRESHOLD = (99, 13, 15, 17, 19, 21, 23, 0)
DQUANT = (-1, -2, 1, 2)

VO, USER_DATA, VOP = 0x1B5, 0x1B2, 0x1B6
I_VOP, P_VOP = 0, 1
VOP_NAMES = ("I", "P", "B", "S")
# the oldest libavcodec build whose streams FFmpeg decodes without a
# workaround: (major << 16) + (minor << 8) + micro past 4712 (FF_BUG_DC_CLIP)
# and outside 3621477-3752551 (FF_BUG_IEDGE)
LAVC_CLEAN = 4713


def _vlc(codes, bits: int) -> list:
    """A lookup of ``bits`` bits: the symbol (index into ``codes``) and its
    length for every prefix, None where no code starts."""
    table = [None] * (1 << bits)
    for sym, (code, n) in enumerate(codes):
        lo = code << (bits - n)
        for k in range(lo, lo + (1 << (bits - n))):
            table[k] = (sym, n)
    return table


def _tcoef(codes, runs, levels, first_last):
    """The TCOEF lookup (12 bits): (run, level, last, length) per code, and
    None for the escape; FFmpeg's max_level[last][run] and
    max_run[last][level] for escapes 1 and 2."""
    table = [None] * 4096
    for sym, (code, n) in enumerate(codes):
        lo = code << (12 - n)
        entry = "esc" if sym == len(codes) - 1 else (runs[sym], levels[sym], int(sym >= first_last), n)
        for k in range(lo, lo + (1 << (12 - n))):
            table[k] = entry
    max_level = [[0] * 64, [0] * 64]
    max_run = [[0] * 65, [0] * 65]
    for sym in range(len(codes) - 1):
        last = int(sym >= first_last)
        r, lv = runs[sym], levels[sym]
        max_level[last][r] = max(max_level[last][r], lv)
        max_run[last][lv] = max(max_run[last][lv], r)
    return table, max_level, max_run


_INTRA_TC = _tcoef(INTRA_VLC, INTRA_RUN, INTRA_LEVEL, INTRA_LAST)
_INTER_TC = _tcoef(INTER_VLC, INTER_RUN, INTER_LEVEL, INTER_LAST)
_INTRA_MCBPC = _vlc(INTRA_MCBPC, 9)
_INTER_MCBPC = _vlc(INTER_MCBPC, 9)
_CBPY = _vlc(CBPY, 6)
_MVD = _vlc(MVD, 12)
_DC = (_vlc(DC_LUMA, 11), _vlc(DC_CHROMA, 12))
_DC_BITS = (11, 12)


def _refuse(where: str, what: str) -> ValueError:
    return ValueError(f"{where}: {what}, which the port's MPEG-4 decoder does not read "
                      f"({ROADMAP})")


def _corrupt(where: str, what: str) -> ValueError:
    return ValueError(f"{where}: corrupt MPEG-4 video: {what} ({ROADMAP})")


class Bits:
    """An MSB-first bit reader over ``data``: ``words[k]`` is the 32 bits
    from byte ``k``, so a read of up to 25 bits is one lookup. Reads past
    the end see zero bytes (no code of the tables is all zeros)."""

    PAD = 16

    def __init__(self, data: bytes, pos: int = 0):
        self.data = bytes(data)
        b = np.frombuffer(self.data + bytes(self.PAD), np.uint8).astype(np.uint32)
        self.words = ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()
        self.size = 8 * len(data)
        self.pos = pos

    def read(self, n: int) -> int:
        """The next ``n`` bits, 0 to 25."""
        if n == 0:
            return 0
        p = self.pos
        self.pos = p + n
        return ((self.words[p >> 3] << (p & 7)) & 0xFFFFFFFF) >> (32 - n)

    def peek(self, n: int) -> int:
        p = self.pos
        return ((self.words[p >> 3] << (p & 7)) & 0xFFFFFFFF) >> (32 - n)

    def skip(self, n: int) -> None:
        self.pos += n

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def next_start_code(self) -> int | None:
        """Align, then find the next 0x000001xx; leave the reader after it
        and return xx's code (0x1xx), or None at the end."""
        self.align()
        data = self.data
        k = data.find(b"\x00\x00\x01", self.pos >> 3)
        if k < 0 or k + 3 >= len(data):
            self.pos = self.size
            return None
        self.pos = 8 * (k + 4)
        return 0x100 | data[k + 3]


def read_vlc(bits: Bits, table, n: int, where: str, what: str) -> int:
    """The symbol of the ``n``-bit lookup ``table`` (``_vlc``) at the reader."""
    e = table[bits.peek(n)]
    if e is None:
        raise _corrupt(where, f"an invalid {what} code at bit {bits.pos}")
    bits.pos += e[1]
    return e[0]


def read_motion(bits: Bits, pred: int, fcode: int, where: str) -> int:
    """``ff_h263_decode_motion`` (MPEG-4's and H.263's): the MVD's VLC, its
    residual bits, the predictor added and the sum wrapped to 5 + f_code
    bits (H.263's f_code 1: [-16, 15.5] pixels)."""
    code = read_vlc(bits, _MVD, 12, where, "MVD")
    if code == 0:
        return pred
    sign = bits.read(1)
    shift = fcode - 1
    val = code
    if shift:
        val = ((val - 1) << shift | bits.read(shift)) + 1
    if sign:
        val = -val
    val += pred
    n = 5 + fcode
    val &= (1 << n) - 1
    return val - (1 << n) if val >> (n - 1) else val


class Vol:
    """The VOL header's fields that the decoder uses."""

    width = height = 0
    object_type = 0
    time_bits = 1
    time_resolution = 0
    fixed_increment = 1  # fixed_vop_time_increment, 1 without fixed_vop_rate
    low_delay = 1
    quant_precision = 5


class Picture:
    """A decoded VOP: the planes at the macroblock grid's size."""

    def __init__(self, y: np.ndarray, cb: np.ndarray, cr: np.ndarray):
        self.y, self.cb, self.cr = y, cb, cr


class Mpeg4Decoder:
    """FFmpeg's ``mpeg4`` decoder for the streams the module's notes list."""

    def __init__(self, config: bytes = b"", where: str = "<stream>"):
        self.where = where
        self.vol: Vol | None = None
        self.lavc_build: int | None = None
        self.ref: Picture | None = None
        if config and self._headers(Bits(config)) is not None:
            raise _refuse(where, "a VOP inside the decoder configuration")

    # ------------------------------------------------------------- headers

    def _headers(self, bits: Bits):
        """Read start codes up to the first VOP; return the reader there,
        or None when the bytes hold headers only. Other start codes are
        passed over, as FFmpeg passes them."""
        if bits.size >= 22 and bits.peek(22) == 0x20:  # H.263's picture start code
            raise _refuse(self.where, "an H.263 short_video_header stream")
        while True:
            code = bits.next_start_code()
            if code is None:
                return None
            if 0x120 <= code <= 0x12F:
                if self.vol is None:
                    self.vol = self._vol(bits)
            elif code == USER_DATA:
                start = bits.pos >> 3
                data = bits.data
                end = data.find(b"\x00\x00\x01", start)
                self._user_data(data[start:end if end >= 0 else len(data)])
            elif code == VO:
                self._visual_object(bits)
            elif code == VOP:
                return bits

    def _user_data(self, body: bytes) -> None:
        """``decode_user_data``'s encoder detection: the ``Lavc`` build."""
        text = body.split(b"\x00", 1)[0].decode("latin-1")
        m = re.match(r"Lavc(\d+)\.(\d+)\.(\d+)", text)
        if m:
            major, minor, micro = map(int, m.groups())
            self.lavc_build = (major << 16) + (minor << 8) + micro
        if text.startswith(("DivX", "XviD")):
            raise _refuse(self.where, f"a stream written by {text[:4]} (user data {text[:16]!r}), "
                          "which FFmpeg decodes with that encoder's workarounds")

    def _visual_object(self, bits: Bits) -> None:
        if bits.read(1):
            bits.read(7)  # visual_object_verid, priority
        kind = bits.read(4)
        if kind in (1, 2) and bits.read(1):  # video_signal_type
            bits.read(3)
            video_range, colour = bits.read(1), bits.read(1)
            if video_range or colour:
                raise _refuse(self.where, "a signalled colour range or colour description")

    def _vol(self, bits: Bits) -> Vol:
        w = self.where
        v = Vol()
        bits.read(1)  # random_accessible_vol
        v.object_type = bits.read(8)
        verid = 1
        if bits.read(1):  # is_object_layer_identifier
            verid = bits.read(4)
            bits.read(3)
        if bits.read(4) == 15:  # aspect_ratio_info: extended PAR
            bits.skip(16)
        if bits.read(1):  # vol_control_parameters
            bits.read(2)  # chroma_format
            v.low_delay = bits.read(1)
            if bits.read(1):  # vbv_parameters
                bits.skip(15 + 1 + 15 + 1 + 15 + 1 + 3 + 11 + 1 + 15 + 1)
        shape = bits.read(2)
        if shape != 0:
            raise _refuse(w, f"a non-rectangular VOL (video_object_layer_shape {shape})")
        bits.read(1)
        v.time_resolution = bits.read(16)
        if v.time_resolution == 0:
            raise _corrupt(w, "vop_time_increment_resolution 0")
        v.time_bits = max((v.time_resolution - 1).bit_length(), 1)
        bits.read(1)
        if bits.read(1):  # fixed_vop_rate
            v.fixed_increment = bits.read(v.time_bits)
        bits.read(1)
        v.width = bits.read(13)
        bits.read(1)
        v.height = bits.read(13)
        bits.read(1)
        if v.width == 0 or v.height == 0:
            raise _corrupt(w, f"a {v.width}x{v.height} VOL")
        if bits.read(1):
            raise _refuse(w, "an interlaced VOL")
        if not bits.read(1):
            raise _refuse(w, "OBMC (obmc_disable 0)")
        if bits.read(1 if verid == 1 else 2):
            raise _refuse(w, "sprites or GMC (sprite_enable)")
        if bits.read(1):
            raise _refuse(w, "not_8_bit")
        if bits.read(1):
            raise _refuse(w, "MPEG quantisation (quant_type 1)")
        if verid != 1 and bits.read(1):
            raise _refuse(w, "quarter-pel motion (quarter_sample)")
        if not bits.read(1):
            raise _refuse(w, "complexity estimation headers")
        if not bits.read(1):
            raise _refuse(w, "resync markers and video packets (resync_marker_disable 0)")
        if bits.read(1):
            raise _refuse(w, "data partitioning")
        if verid != 1:
            if bits.read(1):
                raise _refuse(w, "newpred")
            if bits.read(1):
                raise _refuse(w, "reduced-resolution VOPs")
        if bits.read(1):
            raise _refuse(w, "scalability")
        return v

    def _check_encoder(self) -> None:
        b = self.lavc_build
        if b is None:
            raise _refuse(self.where, "a stream with no libavcodec user data (an encoder other "
                          "than FFmpeg's, which FFmpeg may decode with workarounds)")
        if b < LAVC_CLEAN or 3621476 < b < 3752552:
            raise _refuse(self.where, f"a stream of libavcodec build {b}, which FFmpeg decodes "
                          "with workarounds")

    def _vop(self, bits: Bits) -> dict | None:
        v = self.vol
        kind = bits.read(2)
        if kind != I_VOP and kind != P_VOP:
            raise _refuse(self.where, f"a {VOP_NAMES[kind]}-VOP")
        while bits.read(1):  # modulo_time_base
            if bits.pos >= bits.size:
                raise _corrupt(self.where, "a VOP header cut short")
        bits.read(1)
        bits.read(v.time_bits)  # vop_time_increment
        bits.read(1)
        if not bits.read(1):  # vop_coded 0: FFmpeg returns no frame
            return None
        rounding = bits.read(1) if kind == P_VOP else 0
        threshold = DC_THRESHOLD[bits.read(3)]
        quant = bits.read(v.quant_precision)
        if quant == 0:
            raise _corrupt(self.where, "vop_quant 0")
        fcode = 1
        if kind == P_VOP:
            fcode = bits.read(3)
            if fcode == 0:
                raise _corrupt(self.where, "vop_fcode_forward 0")
        return {"kind": kind, "rounding": rounding, "threshold": threshold, "quant": quant,
                "fcode": fcode}

    # -------------------------------------------------------------- frames

    def decode(self, packet: bytes) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """One packet (an MP4 sample or an AVI chunk) -> the planes of the
        frame it codes: one frame, or none for an uncoded VOP or a packet
        of headers alone."""
        vop = self.parse(packet)
        return [] if vop is None else [self.reconstruct(vop)]

    def parse(self, packet: bytes) -> _VopDecoder | None:
        """A packet's headers and its VOP's macroblocks, entropy-decoded
        (``decode``'s first half): the VOP, or None where no frame comes."""
        bits = Bits(packet)
        if self._headers(bits) is None:
            return None
        if self.vol is None:
            raise _corrupt(self.where, "a VOP before any VOL header")
        self._check_encoder()
        hdr = self._vop(bits)
        if hdr is None:
            return None
        if hdr["kind"] == P_VOP and self.ref is None:
            raise _corrupt(self.where, "a P-VOP with no picture before it")
        vop = _VopDecoder(self, bits, hdr)
        vop.parse()
        return vop

    def reconstruct(self, vop: _VopDecoder) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """A parsed VOP dequantised, through the IDCT and motion compensated
        (``decode``'s second half): its Y, Cb and Cr planes, cropped."""
        pic = vop.reconstruct()
        self.ref = pic
        h, w = self.vol.height, self.vol.width
        ch, cw = (h + 1) >> 1, (w + 1) >> 1
        return pic.y[:h, :w].copy(), pic.cb[:ch, :cw].copy(), pic.cr[:ch, :cw].copy()


# ----------------------------------------------------- one VOP's macroblocks

class _VopDecoder:
    def __init__(self, dec: Mpeg4Decoder, bits: Bits, hdr: dict):
        self.dec, self.bits, self.hdr = dec, bits, hdr
        v = dec.vol
        self.mbw, self.mbh = (v.width + 15) >> 4, (v.height + 15) >> 4
        self.where = dec.where

    def parse(self) -> None:
        """Every macroblock's syntax: modes, vectors and coefficients."""
        mbw, mbh = self.mbw, self.mbh
        hdr = self.hdr
        intra_vop = hdr["kind"] == I_VOP
        bits = self.bits
        qscale = hdr["quant"]
        threshold = hdr["threshold"]
        fcode = hdr["fcode"]
        # predictors on the block grids, each with a border row above and a
        # border column left: DC (1024 outside and for non-intra MBs), AC
        # (the first column's and the first row's levels 1-7), and the MVs
        lw, cwid = 2 * mbw + 1, mbw + 1
        dc = [[1024] * (lw * (2 * mbh + 1)), [1024] * (cwid * (mbh + 1)),
              [1024] * (cwid * (mbh + 1))]
        zero_ac = (0,) * 16
        ac = [[zero_ac] * (lw * (2 * mbh + 1)), [zero_ac] * (cwid * (mbh + 1)),
              [zero_ac] * (cwid * (mbh + 1))]
        mvs = [(0, 0)] * ((mbw + 2) * (mbh + 1))  # border: row above, a column each side
        qtab = [0] * (mbw * mbh)
        intra_blocks = []  # (mb index, block, raster levels, qscale)
        inter_blocks = []  # (mb index, block, [(raster position, value)])
        kinds = [0] * (mbw * mbh)  # 0 skipped, 1 inter, 2 intra
        mv_list = [(0, 0)] * (mbw * mbh)
        size = bits.size
        for mby in range(mbh):
            for mbx in range(mbw):
                mb = mby * mbw + mbx
                if bits.pos >= size:
                    raise _corrupt(self.where, f"the VOP ends at macroblock {mb}")
                if intra_vop:
                    while True:
                        sym = self._vlc(_INTRA_MCBPC, 9, "MCBPC")
                        if sym != 8:
                            break
                    dquant, intra = sym & 4, True
                    cbpc = sym & 3
                else:
                    while True:
                        if bits.read(1):  # not_coded
                            sym = None
                            break
                        sym = self._vlc(_INTER_MCBPC, 9, "MCBPC")
                        if sym != 20:
                            break
                    if sym is None:
                        kinds[mb] = 0
                        qtab[mb] = qscale
                        self._clean(dc, ac, mbx, mby, lw, cwid, zero_ac)
                        continue
                    if sym & 16:
                        raise _refuse(self.where, "an inter4v macroblock")
                    dquant, intra = sym & 8, bool(sym & 4)
                    cbpc = sym & 3
                if intra:
                    ac_pred = bits.read(1)
                    cbpy = self._vlc(_CBPY, 6, "CBPY")
                    if dquant:
                        qscale = min(max(qscale + DQUANT[bits.read(2)], 1), 31)
                    kinds[mb] = 2
                    qtab[mb] = qscale
                    cbp = (cbpy << 2) | cbpc
                    use_dc_vlc = qscale < threshold
                    for n in range(6):
                        levels = self._intra_block(n, mbx, mby, (cbp >> (5 - n)) & 1, ac_pred,
                                                   use_dc_vlc, qscale, qtab, dc, ac, lw, cwid)
                        intra_blocks.append((mb, n, levels, qscale))
                    continue
                cbpy = self._vlc(_CBPY, 6, "CBPY") ^ 15
                if dquant:
                    qscale = min(max(qscale + DQUANT[bits.read(2)], 1), 31)
                cbp = (cbpy << 2) | cbpc
                # the MV predictor: the median of left, above, above-right; in
                # the first row the left alone (0 for the first MB)
                k = (mby + 1) * (mbw + 2) + mbx + 1
                a = mvs[k - 1]
                if mby == 0:
                    px, py = a
                else:
                    b, c = mvs[k - (mbw + 2)], mvs[k - (mbw + 2) + 1]
                    px = sorted((a[0], b[0], c[0]))[1]
                    py = sorted((a[1], b[1], c[1]))[1]
                mx = self._motion(px, fcode)
                my = self._motion(py, fcode)
                mvs[k] = (mx, my)
                mv_list[mb] = (mx, my)
                kinds[mb] = 1
                qtab[mb] = qscale
                qmul, qadd = qscale << 1, (qscale - 1) | 1
                for n in range(6):
                    if (cbp >> (5 - n)) & 1:
                        inter_blocks.append((mb, n, self._inter_block(qmul, qadd)))
                self._clean(dc, ac, mbx, mby, lw, cwid, zero_ac)
        if bits.pos > size:
            raise _corrupt(self.where, "the VOP's macroblocks run past the end of its packet")
        self.kinds, self.mv_list = kinds, mv_list
        self.intra_blocks, self.inter_blocks = intra_blocks, inter_blocks

    # ---------------------------------------------------------- parsing

    def _vlc(self, table, n: int, what: str) -> int:
        return read_vlc(self.bits, table, n, self.where, what)

    def _motion(self, pred: int, fcode: int) -> int:
        return read_motion(self.bits, pred, fcode, self.where)

    @staticmethod
    def _clean(dc, ac, mbx, mby, lw, cwid, zero_ac) -> None:
        """``ff_clean_intra_table_entries``: a non-intra MB's predictors."""
        for dy in (0, 1):
            base = (2 * mby + 1 + dy) * lw + 2 * mbx + 1
            dc[0][base] = dc[0][base + 1] = 1024
            ac[0][base] = ac[0][base + 1] = zero_ac
        k = (mby + 1) * cwid + mbx + 1
        for c in (1, 2):
            dc[c][k] = 1024
            ac[c][k] = zero_ac

    def _escape(self, table, max_level, max_run, qmul, qadd):
        """An escaped TCOEF: (run, signed level as dequantised, last)."""
        bits = self.bits
        mode = bits.peek(2)
        if mode < 2:  # '0': escape 1, the level offset by max_level
            bits.pos += 1
            run, level, last, n = self._plain(table)
            level = (level + max_level[last][run]) * qmul + qadd
        elif mode == 2:  # '10': escape 2, the run offset by max_run
            bits.pos += 2
            run, level, last, n = self._plain(table)
            run += max_run[last][level] + 1
            level = level * qmul + qadd
        else:  # '11': escape 3, fixed-length
            bits.pos += 2
            last = bits.read(1)
            run = bits.read(6)
            if not bits.read(1):
                raise _corrupt(self.where, "a marker bit missing in a third escape")
            level = bits.read(12)
            if level >= 2048:
                level -= 4096
            if not bits.read(1):
                raise _corrupt(self.where, "a marker bit missing in a third escape")
            if level == 0:
                raise _corrupt(self.where, "a third escape of level 0")
            level = level * qmul + qadd if level > 0 else level * qmul - qadd
            if not -2048 <= level <= 2047:
                level = -2048 if level < 0 else 2047
            return run, level, last
        return run, -level if bits.read(1) else level, last

    def _plain(self, table):
        bits = self.bits
        e = table[bits.peek(12)]
        if e is None or e == "esc":
            raise _corrupt(self.where, f"an invalid TCOEF code at bit {bits.pos}")
        bits.pos += e[3]
        return e

    def _coefficients(self, tc, first: int, qmul: int, qadd: int, scan) -> list:
        """TCOEF codes from scan index ``first`` up to the last one: a list
        of (raster position, level dequantised by qmul, qadd)."""
        table, max_level, max_run = tc
        bits = self.bits
        words = bits.words
        out = []
        i = first - 1
        while True:
            p = bits.pos
            e = table[((words[p >> 3] << (p & 7)) & 0xFFFFFFFF) >> 20]
            if e is None:
                raise _corrupt(self.where, f"an invalid TCOEF code at bit {p}")
            if e == "esc":
                bits.pos = p + 7
                run, level, last = self._escape(table, max_level, max_run, qmul, qadd)
            else:
                run, level, last, n = e
                p += n
                sign = (words[p >> 3] >> (31 - (p & 7))) & 1
                bits.pos = p + 1
                level = level * qmul + qadd
                if sign:
                    level = -level
            i += run + 1
            if i > 63 or (i == 63 and not last):
                raise _corrupt(self.where, "a block of more than 64 coefficients")
            out.append((scan[i], level))
            if last:
                return out

    def _inter_block(self, qmul: int, qadd: int) -> list:
        return self._coefficients(_INTER_TC, 0, qmul, qadd, ZIGZAG)

    def _intra_block(self, n, mbx, mby, coded, ac_pred, use_dc_vlc, qscale, qtab, dc, ac,
                     lw, cwid) -> list:
        """One intra block's 64 levels in raster order, after DC and AC
        prediction (``mpeg4_decode_block``, ``ff_mpeg4_pred_dc``,
        ``ff_mpeg4_pred_ac``), before dequantisation."""
        bits = self.bits
        if n < 4:
            comp, scale = 0, Y_DC_SCALE[qscale]
            k = (2 * mby + 1 + (n >> 1)) * lw + 2 * mbx + 1 + (n & 1)
            wrap = lw
        else:
            comp, scale = n - 3, C_DC_SCALE[qscale]
            k = (mby + 1) * cwid + mbx + 1
            wrap = cwid
        dcv = dc[comp]
        a, b, c = dcv[k - 1], dcv[k - 1 - wrap], dcv[k - wrap]
        top = abs(a - b) < abs(b - c)  # else the left block predicts
        pred = c if top else a
        blk = [0] * 64
        if use_dc_vlc:
            size = self._vlc(_DC[comp > 0], _DC_BITS[comp > 0], "DC size")
            if size:
                level = bits.read(size)
                if not level >> (size - 1):
                    level -= (1 << size) - 1
                blk[0] = level
                if size > 8 and not bits.read(1):
                    raise _corrupt(self.where, "a marker bit missing after an intra DC")
        if coded:
            scan = (ALT_HORIZONTAL if top else ALT_VERTICAL) if ac_pred else ZIGZAG
            for pos, lv in self._coefficients(_INTRA_TC, int(use_dc_vlc), 1, 0, scan):
                blk[pos] = lv
        level = blk[0] + (pred + (scale >> 1)) // scale
        stored = level * scale
        if stored & ~2047:
            stored = 0 if stored < 0 else 2047
        dcv[k] = stored
        blk[0] = level
        acv = ac[comp]
        if ac_pred:
            mbw = self.mbw
            if top:
                nb = acv[k - wrap]
                same = mby == 0 or n in (2, 3)
                qn = qscale if same else qtab[(mby - 1) * mbw + mbx]
                for i in range(1, 8):
                    p = nb[8 + i]
                    blk[i] += p if qn == qscale else _rounded_div(p * qn, qscale)
            else:
                nb = acv[k - 1]
                same = mbx == 0 or n in (1, 3)
                qn = qscale if same else qtab[mby * mbw + mbx - 1]
                for i in range(1, 8):
                    p = nb[i]
                    blk[i << 3] += p if qn == qscale else _rounded_div(p * qn, qscale)
        acv[k] = (0, *(blk[i << 3] for i in range(1, 8)), 0, *blk[1:8])
        return blk

    # --------------------------------------------------- reconstruction

    def reconstruct(self) -> Picture:
        """The parsed VOP's picture at the macroblock grid's size."""
        ref = self.dec.ref if self.hdr["kind"] == P_VOP else None
        return reconstruct(ref, self.mbw, self.mbh, self.kinds, self.mv_list, self.intra_blocks,
                           self.inter_blocks, self.hdr["rounding"], self.where)


def reconstruct(ref: Picture | None, mbw: int, mbh: int, kinds, mv_list, intra_blocks,
                inter_blocks, rounding: int, where: str,
                dc_scales=(Y_DC_SCALE, C_DC_SCALE), out: Picture | None = None,
                idct=(idct_simple, idct_simple_add), predict=None) -> Picture:
    """A parsed picture's macroblocks -> its picture at the grid's size, as
    ``ff_mpv_reconstruct_mb`` builds it (shared with ``h263.py`` and
    ``msmpeg4.py``): every non-intra MB (``kinds`` 0 skipped, 1 inter; any
    other kind is left alone) predicted from ``ref`` by its vector in
    ``mv_list`` (none without ``ref``: an I picture), the inter residuals
    (``[(raster position, dequantised level)]`` per coded block) added
    through ``idct_simple_add``, and the intra blocks (raster levels and QP)
    dequantised as ``dct_unquantize_h263_intra`` does, the DC by
    ``dc_scales[luma or chroma][QP]``, then put by ``idct_simple``. ``out``
    takes the planes to write into (a picture built in parts), ``idct``
    another (put, add) pair and ``predict`` another motion compensation in
    ``_predict``'s place."""
    if out is None:
        out = Picture(np.zeros((mbh * 16, mbw * 16), np.uint8),
                      np.zeros((mbh * 8, mbw * 8), np.uint8), np.zeros((mbh * 8, mbw * 8), np.uint8))
    planes = (out.y, out.cb, out.cr)
    idct_put, idct_add = idct
    if ref is not None:
        (predict or _predict)(ref, planes, mbw, mbh, kinds, mv_list, rounding)
    if inter_blocks:
        coef = np.zeros((len(inter_blocks), 64), np.int64)
        for j, (_mb, _n, cs) in enumerate(inter_blocks):
            for pos, lv in cs:
                coef[j, pos] = lv
        pred = np.stack([_block_view(planes, mbw, mb, n) for mb, n, _ in inter_blocks])
        px = idct_add(coef, pred.reshape(-1, 64), where).reshape(-1, 8, 8)
        for j, (mb, n, _) in enumerate(inter_blocks):
            _block_view(planes, mbw, mb, n)[...] = px[j]
    if intra_blocks:
        coef = np.array([lv for _, _, lv, _ in intra_blocks], np.int64)
        q = np.array([qs for _, _, _, qs in intra_blocks], np.int64)[:, None]
        is_luma = np.array([n < 4 for _, n, _, _ in intra_blocks])
        scale = np.where(is_luma, np.take(dc_scales[0], q[:, 0]), np.take(dc_scales[1], q[:, 0]))
        deq = np.where(coef > 0, coef * 2 * q + ((q - 1) | 1),
                       np.where(coef < 0, coef * 2 * q - ((q - 1) | 1), 0))
        deq[:, 0] = coef[:, 0] * scale
        if np.abs(deq).max(initial=0) > 0x7FFF:
            raise ValueError(f"{where}: dequantised coefficients outside 16 bits, which the "
                             f"port's decoder does not read ({ROADMAP})")
        px = idct_put(deq, where).reshape(-1, 8, 8)
        for j, (mb, n, _, _) in enumerate(intra_blocks):
            _block_view(planes, mbw, mb, n)[...] = px[j]
    return out


def _block_view(planes, mbw: int, mb: int, n: int) -> np.ndarray:
    mby, mbx = divmod(mb, mbw)
    if n < 4:
        r, c = 16 * mby + 8 * (n >> 1), 16 * mbx + 8 * (n & 1)
        return planes[0][r:r + 8, c:c + 8]
    return planes[n - 3][8 * mby:8 * mby + 8, 8 * mbx:8 * mbx + 8]


def _predict(ref: Picture, planes, mbw: int, mbh: int, kinds, mv_list, rounding: int) -> None:
    """Motion compensation of every inter and skipped MB from the
    reference picture (``mpeg_motion_internal`` with ``put_pixels`` or,
    under ``vop_rounding_type`` 1, ``put_no_rnd_pixels``)."""
    sel = [mb for mb, k in enumerate(kinds) if 0 <= k < 2]
    if not sel:
        return
    mb = np.array(sel)
    mby, mbx = np.divmod(mb, mbw)
    mv = np.array([mv_list[m] for m in sel], np.int64).reshape(-1, 2)
    mx, my = mv[:, 0], mv[:, 1]
    src_x = 16 * mbx + (mx >> 1)
    src_y = 16 * mby + (my >> 1)
    luma = _mc(ref.y, src_x, src_y, mx & 1, my & 1, 16, rounding)
    # H.263's chroma vector: half-pel wherever the luma one is not a
    # whole even number of pixels, the source at half the luma one's
    hx, hy = ((mx & 3) != 0).astype(np.int64), ((my & 3) != 0).astype(np.int64)
    ucb = _mc(ref.cb, src_x >> 1, src_y >> 1, hx, hy, 8, rounding)
    ucr = _mc(ref.cr, src_x >> 1, src_y >> 1, hx, hy, 8, rounding)
    y, cb, cr = planes
    yv = y.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3)
    yv[mby, mbx] = luma
    cbv = cb.reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3)
    crv = cr.reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3)
    cbv[mby, mbx] = ucb
    crv[mby, mbx] = ucr


def _rounded_div(a: int, b: int) -> int:
    """FFmpeg's ROUNDED_DIV: C division of a +- b / 2, truncated."""
    n = a + (b >> 1) if a >= 0 else a - (b >> 1)
    q = abs(n) // b
    return q if n >= 0 else -q


def _mc(plane, sx, sy, hx, hy, size: int, rnd: int) -> np.ndarray:
    """``size`` x ``size`` half-pel predictions at (sx, sy) + (hx, hy) / 2
    from the reference ``plane`` (at the macroblock grid's size), rows and
    columns clamped to it: FFmpeg's edge emulation, whose edges lie at the
    grid's (``h_edge_pos``, ``v_edge_pos``; half of each for chroma)."""
    ph, pw = plane.shape
    k = np.arange(size + 1)
    cols = np.clip(sx[:, None] + k, 0, pw - 1)
    rows = np.clip(sy[:, None] + k, 0, ph - 1)
    p = plane[rows[:, :, None], cols[:, None, :]].astype(np.int32)  # [N, size+1, size+1]
    a = p[:, :size, :size]
    b = p[:, :size, 1:]
    c = p[:, 1:, :size]
    d = p[:, 1:, 1:]
    hx = hx[:, None, None]
    hy = hy[:, None, None]
    if rnd and size == 8:
        # chroma: x86's put_no_rnd_pixels8_{x2,y2}_mmxext (FFmpeg's default,
        # not its bit-exact mode), pavgb with one sample of each pair less
        # 1, saturated: the left one across, the odd row's (counted from
        # the block's first) down; (a + b) >> 1 but where that sample is 0.
        # The 16-wide luma ones are exact.
        odd = (np.arange(size)[:, None] & 1).astype(bool)
        dec = np.maximum(p - 1, 0)
        x2 = (dec[:, :size, :size] + b + 1) >> 1
        y2 = (np.where(odd, dec[:, :size, :size], a) + np.where(odd, c, dec[:, 1:, :size])
              + 1) >> 1
        out = np.where(hx & hy, (a + b + c + d + 1) >> 2, np.where(hx, x2, np.where(hy, y2, a)))
    else:
        out = np.where(hx & hy, (a + b + c + d + 2 - rnd) >> 2,
                       np.where(hx, (a + b + 1 - rnd) >> 1,
                                np.where(hy, (a + c + 1 - rnd) >> 1, a)))
    return out.astype(np.uint8)
