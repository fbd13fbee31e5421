"""VP8 video (RFC 6386) with numpy and plain Python, as FFmpeg's native
``vp8`` decoder (``libavcodec/vp8.c``, ``vp8dsp.c``, ``vpx_rac.h``) gives
it to OpenCV: ``Vp8Decoder(path).decode(frame)`` yields each shown frame's
``(Y, Cb, Cr)`` uint8 planes at the display size (chroma ``ceil(H / 2) x
ceil(W / 2)``).

What a WebP key frame needs is ``utils/vp8.py``'s, shared bit for bit: the
boolean decoder, the tokens and their contexts, the key frame's modes,
intra prediction and the loop filter. What video adds:

- state kept from frame to frame: the last, golden and altref frames with
  their sign biases, refreshed or copied as each frame's header says
  (``refresh_golden_frame``, ``refresh_alternate_frame``,
  ``copy_buffer_to_golden`` / ``_alternate``, ``refresh_last``); the
  coefficient, MV and intra mode probabilities and their updates, saved and
  restored around a frame that does not refresh them
  (``refresh_entropy_probs = 0``); the segmentation (its map, copied from
  the previous frame when not updated, and its quantizer and filter
  values) and the loop filter's reference and mode deltas, kept until
  updated; a key frame resets all but the segment map, as FFmpeg does (a
  map kept from a frame without segmentation is taken as zeros: FFmpeg
  reads that frame's unwritten map buffer, whose contents vary with its
  threads);
- inter frames' macroblocks: the reference (``prob_intra``, ``prob_last``,
  ``prob_gf``); ``find_near_mvs`` over the macroblocks above, to the left
  and above-left, their vectors negated across a sign bias, the counts as
  the mode contexts, ``best``, ``nearest`` and ``near`` clamped to 16
  pixels past the frame; ``NEARESTMV``, ``NEARMV``, ``ZEROMV``, ``NEWMV``
  (``best`` plus a vector read by the short or long tree) and ``SPLITMV``
  in its four partitionings with ``LEFT4x4``, ``ABOVE4x4``, ``ZERO4x4`` and
  ``NEW4x4`` sub-vectors under their contexts; intra macroblocks whose
  sub-block modes take the fixed probabilities of inter frames;
- prediction from the reference frame with every pixel beyond the
  macroblock grid's edge its nearest edge pixel (``emulated_edge_mc`` over
  the grid): the six-tap filters at version 0 (a horizontal pass over the
  rows the vertical pass needs, each pass rounded and clamped), bilinear
  ones at versions 1-3, luma at the quarter-pixel vector as eighths,
  chroma at the same vector as eighths of its plane (whole pixels at
  version 3), split chroma at the rounded mean of four luma sub-vectors
  (``(sum + 2 + sign) >> 2``); intra macroblocks after the inter ones, from
  the frame's unfiltered pixels;
- the loop filter (``vp8.loop_filter``) with each macroblock's level from
  its segment, reference and mode deltas (no clamp before the last), the
  high-edge-variance threshold of key or inter frames, and no inner edges
  for a macroblock without coefficients unless it is ``B_PRED`` or
  ``SPLITMV``.

A frame with ``show_frame = 0`` updates the references and yields nothing,
as FFmpeg returns no picture for it. ``full_range`` says whether the frame
last yielded follows a key frame whose ``clamping_type`` is 1, which FFmpeg
takes as full range (and swscale converts so). That is FFmpeg decoding on
one thread: with frame threads, each thread keeps the bit of the last key
frame it decoded itself, so cv2's range for such a stream depends on its
thread count (found with crafted streams; libvpx writes 0).

Refused, each with a ValueError naming ROADMAP.md queue 1, item 4:
key-frame scaling bits, a size change, an inter frame before any key
frame, and corrupt or truncated frames and partitions.

The dequantised coefficients wrap to 16 bits as FFmpeg's blocks hold them,
and the inverse transforms run as its x86 code runs them, in 16-bit lanes
(``_idct``, ``_iwht``), which differs from its C code only where a lane
overflows; found with crafted streams. FFmpeg takes a second-order block
of DC alone through its C code, ``(dc + 3) >> 3`` unwrapped; the port runs
the lanes there too, which differ only for a DC within 3 of 2^15.
"""

from __future__ import annotations

import copy
import time

import numpy as np

from .imgcodecs import ROADMAP
from .vp8 import (AC_TABLE, BANDS, COEFFS_PROBA0, COEFFS_UPDATE_PROBA, DC_PRED, DC_TABLE, H_PRED,
                  TM_PRED, V_PRED, _Bool, _qindex, intra_mb, key_frame_modes, loop_filter,
                  residuals, sub_block_mode)

YMODE_PROB = (112, 86, 140, 37)  # inter frames' defaults (RFC 6386 ymode_prob)
UVMODE_PROB = (162, 101, 204)
BMODE_PROB = (120, 90, 79, 133, 87, 85, 80, 111, 151)  # B_mode_prob, by tree node
B_PRED = 4  # an intra macroblock's luma "mode" when its sub-blocks have theirs
# vp8_mv_default_prob and vp8_mv_update_prob: is-short, sign, the short tree's
# seven, the long form's ten bits; rows then columns
MV_DEFAULT = ((162, 128, 225, 146, 172, 147, 214, 39, 156,
               128, 129, 132, 75, 145, 178, 206, 239, 254, 254),
              (164, 128, 204, 170, 119, 235, 140, 230, 228,
               128, 130, 130, 74, 148, 180, 203, 236, 254, 254))
MV_UPDATE = ((237, 246, 253, 253, 254, 254, 254, 254, 254,
              254, 254, 254, 254, 254, 250, 250, 252, 254, 254),
             (231, 243, 245, 253, 254, 254, 254, 254, 254,
              254, 254, 254, 254, 254, 251, 251, 254, 254, 254))
MODE_CONTEXTS = ((7, 1, 1, 143), (14, 18, 14, 107), (135, 64, 57, 68), (60, 56, 128, 65),
                 (159, 134, 128, 34), (234, 188, 128, 28))
SUBMV_PROB = ((147, 136, 18), (106, 145, 1), (179, 121, 1), (223, 1, 34), (208, 1, 1))
SPLIT_PROB = (110, 111, 150)
SPLIT_16x8, SPLIT_8x16, SPLIT_8x8, SPLIT_4x4, SPLIT_NONE = range(5)  # FFmpeg's order
# each 4x4 luma block's partition, per partitioning, and each partition's
# first block
MB_SPLITS = ((0,) * 8 + (1,) * 8, (0, 0, 1, 1) * 4, (0, 0, 1, 1) * 2 + (2, 2, 3, 3) * 2,
             tuple(range(16)), (0,) * 16)
FIRST_BLOCK = ((0, 8), (0, 2), (0, 2, 8, 10), tuple(range(16)))
SIXTAP = np.array([[0, 0, 128, 0, 0, 0], [0, -6, 123, 12, -1, 0], [2, -11, 108, 36, -8, 1],
                   [0, -9, 93, 50, -6, 0], [3, -16, 77, 77, -16, 3], [0, -6, 50, 93, -9, 0],
                   [1, -8, 36, 108, -11, 2], [0, -1, 12, 123, -6, 0]], np.int32)
# the loop filter's macroblock "modes" for its mode deltas (0: a 16x16 intra
# mode, which has none)
LF_NONE, LF_BPRED, LF_ZERO, LF_MV, LF_SPLIT = range(5)
LAST, GOLDEN, ALTREF = 1, 2, 3


def _refused(path: str, what: str) -> ValueError:
    return ValueError(f"{path}: VP8 video: {what} is not supported by the port's VP8 decoder "
                      f"({ROADMAP})")


def _default_coeff_probs() -> list:
    return [[[list(COEFFS_PROBA0[((t * 8 + b) * 3 + c) * 11:((t * 8 + b) * 3 + c) * 11 + 11])
              for c in range(3)] for b in range(8)] for t in range(4)]


class _MB:
    __slots__ = ("segment", "skip", "ref", "i4x4", "ymodes", "uvmode", "mv", "part", "bmv",
                 "lf_mode", "has_y2")

    def __init__(self):
        self.ref, self.part, self.mv = 0, SPLIT_16x8, (0, 0)  # FFmpeg's zeroed edge macroblock
        self.bmv = [(0, 0)] * 16
        self.i4x4, self.lf_mode = False, LF_NONE


_EDGE = _MB()


def _w16(a: np.ndarray) -> np.ndarray:
    """Wrapped to signed 16 bits, as FFmpeg's ``int16_t`` blocks and x86
    word lanes keep values."""
    return ((a + 32768) & 0xFFFF) - 32768


def _mul_20091(a):
    return _w16(((a * 20091) >> 16) + a)


def _mul_35468(a):
    """``vp8dsp.asm``'s ``pmulhw`` of the doubled word by 17734."""
    return (_w16(2 * a) * 17734) >> 16


def _idct(c: np.ndarray) -> np.ndarray:
    """``vp8dsp.asm::vp8_idct_add`` on ``[n, 16]`` coefficients (16-bit) ->
    ``[n, 4, 4]`` residuals: both passes in 16-bit lanes, the rounding 4
    added to the second pass's first input, an arithmetic shift by 3. It
    equals ``vp8_idct_add_c`` where no lane overflows."""
    def one_d(e0, e1, e2, e3):
        t0, t1 = _w16(e0 + e2), _w16(e0 - e2)
        x2 = _w16(_mul_35468(e1) - _mul_20091(e3))
        x3 = _w16(_mul_20091(e1) + _mul_35468(e3))
        return _w16(t0 + x3), _w16(t1 + x2), _w16(t1 - x2), _w16(t0 - x3)

    tmp = np.empty_like(c)
    for i in range(4):  # columns
        tmp[:, 4 * i:4 * i + 4] = np.stack(one_d(c[:, i], c[:, 4 + i], c[:, 8 + i],
                                                 c[:, 12 + i]), 1)
    out = np.empty((len(c), 4, 4), np.int64)
    for i in range(4):  # output rows
        out[:, i] = np.stack(one_d(_w16(tmp[:, i] + 4), tmp[:, 4 + i], tmp[:, 8 + i],
                                   tmp[:, 12 + i]), 1) >> 3
    return out


def _iwht(c: np.ndarray) -> np.ndarray:
    """``vp8dsp.asm::vp8_luma_dc_wht`` on ``[n, 16]`` second-order
    coefficients (16-bit) -> the 16 luma blocks' DCs: sums and differences
    in 16-bit lanes (so the exact sums wrapped), then shifted by 3."""
    tmp = np.empty_like(c)
    for i in range(4):
        a0, a1 = c[:, i] + c[:, 12 + i], c[:, 4 + i] + c[:, 8 + i]
        a2, a3 = c[:, 4 + i] - c[:, 8 + i], c[:, i] - c[:, 12 + i]
        tmp[:, i], tmp[:, 8 + i] = a0 + a1, a0 - a1
        tmp[:, 4 + i], tmp[:, 12 + i] = a3 + a2, a3 - a2
    out = np.empty_like(c)
    for i in range(4):
        dc = tmp[:, 4 * i] + 3
        a0, a1 = dc + tmp[:, 4 * i + 3], tmp[:, 4 * i + 1] + tmp[:, 4 * i + 2]
        a2, a3 = tmp[:, 4 * i + 1] - tmp[:, 4 * i + 2], dc - tmp[:, 4 * i + 3]
        out[:, 4 * i] = _w16(a0 + a1) >> 3
        out[:, 4 * i + 1] = _w16(a3 + a2) >> 3
        out[:, 4 * i + 2] = _w16(a0 - a1) >> 3
        out[:, 4 * i + 3] = _w16(a3 - a2) >> 3
    return out


def _mv_component(br: _Bool, p) -> int:
    """``read_mv_component``: one vector component, quarter pixels."""
    if br.bit(p[0]):  # the long form
        x = 0
        for i in range(3):
            x += br.bit(p[9 + i]) << i
        for i in range(9, 3, -1):
            x += br.bit(p[9 + i]) << i
        if not x & 0xFFF0 or br.bit(p[12]):
            x += 8
    else:
        b = br.bit(p[2])
        at = 3 + 3 * b
        x = 4 * b
        b = br.bit(p[at])
        x += 2 * b + br.bit(p[at + 1 + b])
    return -x if x and br.bit(p[1]) else x


def mc(ref: np.ndarray, y0: np.ndarray, x0: np.ndarray, fy: np.ndarray, fx: np.ndarray,
       size: int, bilinear: bool) -> np.ndarray:
    """``vp8dsp.c``'s motion compensation of ``[N]`` ``size`` x ``size``
    blocks whose top-left pixel sits at whole ``(y0, x0)`` plus eighths
    ``(fy, fx)`` of ``ref``, every pixel past its edges the nearest edge
    pixel -> ``[N, size, size]`` int32."""
    h, w = ref.shape
    rows = np.clip(y0[:, None] + np.arange(-2, size + 3), 0, h - 1)
    cols = np.clip(x0[:, None] + np.arange(-2, size + 3), 0, w - 1)
    win = ref[rows[:, :, None], cols[:, None, :]].astype(np.int32)  # [N, size + 5, size + 5]
    if bilinear:
        a, b = (8 - fx)[:, None, None], fx[:, None, None]
        hor = (a * win[:, :, 2:2 + size] + b * win[:, :, 3:3 + size] + 4) >> 3
        a, b = (8 - fy)[:, None, None], fy[:, None, None]
        return (a * hor[:, 2:2 + size] + b * hor[:, 3:3 + size] + 4) >> 3
    taps = SIXTAP[fx]
    hor = sum(taps[:, k, None, None] * win[:, :, k:k + size] for k in range(6))
    hor = np.clip((hor + 64) >> 7, 0, 255)
    taps = SIXTAP[fy]
    out = sum(taps[:, k, None, None] * hor[:, k:k + size] for k in range(6))
    return np.clip((out + 64) >> 7, 0, 255)


class Vp8Decoder:
    """A VP8 stream's state from frame to frame (see the module's notes)."""

    def __init__(self, path: str = "<stream>"):
        self.path = path
        self.size = None
        self.refs: dict[int, tuple] = {}
        self.sign_bias = [0, 0, 0, 0]
        self.seg_map = None
        self.clamping = 0  # the last key frame's clamping_type (FFmpeg's fullrange)
        self.full_range = False  # the range of the frame last yielded

    # ------------------------------------------------------------ header

    def _reset(self) -> None:
        """What a key frame resets (``vp8_decode_frame_header``)."""
        self.coeff_probs = _default_coeff_probs()
        self.ymode_prob, self.uvmode_prob = list(YMODE_PROB), list(UVMODE_PROB)
        self.mv_probs = [list(MV_DEFAULT[0]), list(MV_DEFAULT[1])]
        self.seg_abs, self.seg_quant, self.seg_filter = 0, [0] * 4, [0] * 4
        self.seg_probs = [255] * 3
        self.ref_delta, self.mode_delta = [0] * 4, [0] * 4

    def _header(self, br: _Bool, key: bool) -> dict:
        """The frame header from the first partition (``vp8_decode_frame_header``);
        the state it updates is the decoder's."""
        hdr = {}
        if key:
            br.bit(128)  # colour space
            hdr["clamping"] = br.bit(128)
        hdr["segmentation"] = br.bit(128)
        hdr["update_map"] = 0
        if hdr["segmentation"]:
            hdr["update_map"] = br.bit(128)
            if br.bit(128):  # update the segment data
                self.seg_abs = br.bit(128)
                self.seg_quant = [br.optional_signed(7) for _ in range(4)]
                self.seg_filter = [br.optional_signed(6) for _ in range(4)]
            if hdr["update_map"]:
                self.seg_probs = [br.literal(8) if br.bit(128) else 255 for _ in range(3)]
        hdr["simple"], hdr["level"], hdr["sharpness"] = br.bit(128), br.literal(6), br.literal(3)
        hdr["lf_deltas"] = br.bit(128)
        if hdr["lf_deltas"] and br.bit(128):
            for deltas in (self.ref_delta, self.mode_delta):
                for i in range(4):
                    if br.bit(128):
                        v = br.literal(6)
                        deltas[i] = -v if br.bit(128) else v
        hdr["num_parts"] = 1 << br.literal(2)
        base = br.literal(7)
        dy1_dc, dy2_dc, dy2_ac, duv_dc, duv_ac = (br.optional_signed(4) for _ in range(5))
        hdr["quant"] = []
        for s in range(4):
            q = base
            if hdr["segmentation"]:
                q = self.seg_quant[s] + (0 if self.seg_abs else base)
            y2_ac = max(8, (AC_TABLE[_qindex(q + dy2_ac)] * 101581) >> 16)
            hdr["quant"].append(((DC_TABLE[_qindex(q + dy1_dc)], AC_TABLE[_qindex(q)]),
                                 (DC_TABLE[_qindex(q + dy2_dc)] * 2, y2_ac),
                                 (min(DC_TABLE[_qindex(q + duv_dc)], 132),
                                  AC_TABLE[_qindex(q + duv_ac)])))
        if key:
            hdr["golden"] = hdr["altref"] = "current"
        else:
            g, a = br.bit(128), br.bit(128)
            hdr["golden"] = "current" if g else {1: LAST, 2: ALTREF}.get(br.literal(2))
            hdr["altref"] = "current" if a else {1: LAST, 2: GOLDEN}.get(br.literal(2))
            self.sign_bias[GOLDEN], self.sign_bias[ALTREF] = br.bit(128), br.bit(128)
        hdr["saved"] = None
        if not br.bit(128):  # refresh_entropy_probs = 0: restore after this frame
            hdr["saved"] = copy.deepcopy((self.coeff_probs, self.ymode_prob, self.uvmode_prob,
                                          self.mv_probs))
        hdr["refresh_last"] = True if key else br.bit(128)
        probs = self.coeff_probs
        for t in range(4):
            for b in range(8):
                for c in range(3):
                    for p in range(11):
                        if br.bit(COEFFS_UPDATE_PROBA[((t * 8 + b) * 3 + c) * 11 + p]):
                            probs[t][b][c][p] = br.literal(8)
        hdr["bands"] = [[probs[t][BANDS[n]] for n in range(17)] for t in range(4)]
        hdr["skip_prob"] = br.literal(8) if br.bit(128) else None
        if not key:
            hdr["prob_intra"], hdr["prob_last"], hdr["prob_gf"] = (br.literal(8) for _ in range(3))
            if br.bit(128):
                self.ymode_prob = [br.literal(8) for _ in range(4)]
            if br.bit(128):
                self.uvmode_prob = [br.literal(8) for _ in range(3)]
            for i in range(2):
                for j in range(19):
                    if br.bit(MV_UPDATE[i][j]):
                        v = br.literal(7) << 1
                        self.mv_probs[i][j] = v or 1
        return hdr

    def _partitions(self, data: bytes, at: int, count: int) -> list:
        """``setup_partitions``: the token partitions after the first one."""
        start = at + 3 * (count - 1)
        if start > len(data):
            raise _refused(self.path, "truncated partition sizes")
        parts = []
        for p in range(count - 1):
            size = int.from_bytes(data[at + 3 * p:at + 3 * p + 3], "little")
            if start + size > len(data):
                raise _refused(self.path, "a partition past the frame's end")
            parts.append(_Bool(data[start:start + size], self.path))
            start += size
        parts.append(_Bool(data[start:], self.path))
        return parts

    def start_frame(self, data: bytes) -> tuple:
        """The frame tag and, for a key frame, its start code and size (the
        state reset): (key, version, shown, the first partition's start and
        size)."""
        if len(data) < 3:
            raise _refused(self.path, "a truncated frame tag")
        tag = int.from_bytes(data[:3], "little")
        key, version, shown, first = not tag & 1, (tag >> 1) & 7, (tag >> 4) & 1, tag >> 5
        if version > 3:
            raise _refused(self.path, f"version {version}")
        at = 3
        if key:
            if len(data) < 10 or data[3:6] != b"\x9d\x01\x2a":
                raise _refused(self.path, "a key frame without its start code")
            width = int.from_bytes(data[6:8], "little")
            height = int.from_bytes(data[8:10], "little")
            if width >> 14 or height >> 14:
                raise _refused(self.path, f"key-frame scaling bits ({width >> 14}, "
                               f"{height >> 14})")
            if not width or not height:
                raise _refused(self.path, "a key frame of size 0")
            if self.size is not None and self.size != (height, width):
                raise _refused(self.path, f"a size change from {self.size} to "
                               f"{(height, width)}")
            self.size = (height, width)
            at = 10
            self._reset()
        elif not self.refs:
            raise _refused(self.path, "an inter frame before any key frame")
        if at + first > len(data):
            raise _refused(self.path, "a first partition past the frame's end")
        return key, version, shown, at, first

    def end_frame(self, hdr: dict, planes) -> None:
        """The probabilities restored if the frame did not refresh them, and
        the references it refreshes or copies."""
        if hdr["saved"] is not None:
            self.coeff_probs, self.ymode_prob, self.uvmode_prob, self.mv_probs = hdr["saved"]
        old = dict(self.refs)
        for which, how in ((GOLDEN, hdr["golden"]), (ALTREF, hdr["altref"])):
            if how == "current":
                self.refs[which] = planes
            elif how is not None:
                self.refs[which] = old[how]
        if hdr["refresh_last"]:
            self.refs[LAST] = planes

    # ------------------------------------------------------------ modes

    def _inter_modes(self, br: _Bool, hdr: dict, mb: _MB, mbs: list, mb_x: int, mb_y: int,
                     mb_w: int, mb_h: int) -> None:
        """``decode_mb_mode`` past the segment and skip flag, inter frame."""
        if not br.bit(hdr["prob_intra"]):  # an intra macroblock
            mb.ref, mb.part, mb.bmv = 0, SPLIT_NONE, [(0, 0)] * 16
            p = self.ymode_prob
            if not br.bit(p[0]):
                mode = DC_PRED
            elif not br.bit(p[1]):
                mode = H_PRED if br.bit(p[2]) else V_PRED
            else:
                mode = B_PRED if br.bit(p[3]) else TM_PRED
            mb.i4x4 = mode == B_PRED
            mb.ymodes = [sub_block_mode(br, BMODE_PROB) for _ in range(16)] if mb.i4x4 else [mode]
            p = self.uvmode_prob
            mb.uvmode = (DC_PRED if not br.bit(p[0]) else V_PRED if not br.bit(p[1])
                         else TM_PRED if br.bit(p[2]) else H_PRED)
            mb.lf_mode = LF_BPRED if mb.i4x4 else LF_NONE
            mb.has_y2 = not mb.i4x4
            return
        mb.ref = (ALTREF if br.bit(hdr["prob_gf"]) else GOLDEN) if br.bit(hdr["prob_last"]) \
            else LAST
        top = mbs[(mb_y - 1) * mb_w + mb_x] if mb_y else _EDGE
        left = mbs[mb_y * mb_w + mb_x - 1] if mb_x else _EDGE
        top_left = mbs[(mb_y - 1) * mb_w + mb_x - 1] if mb_x and mb_y else _EDGE
        near, cnt, idx = [(0, 0)] * 4, [0, 0, 0, 0], 0
        bias = self.sign_bias[mb.ref]
        for n, edge in enumerate((top, left, top_left)):
            if not edge.ref:
                continue
            mv = edge.mv
            if mv != (0, 0):
                if self.sign_bias[edge.ref] != bias:
                    mv = (-mv[0], -mv[1])
                if n == 0 or mv != near[idx]:
                    idx += 1
                    near[idx] = mv
                cnt[idx] += 1 if n == 2 else 2
            else:
                cnt[0] += 1 if n == 2 else 2
        # MVs may point 16 pixels past the frame, quarter pixels
        lo_x, hi_x = -64 * (mb_x + 1), 64 * (mb_w - mb_x)
        lo_y, hi_y = -64 * (mb_y + 1), 64 * (mb_h - mb_y)

        def clamp(v):
            return (min(max(v[0], lo_y), hi_y), min(max(v[1], lo_x), hi_x))

        mb.i4x4, mb.has_y2, mb.part = False, True, SPLIT_NONE
        if not br.bit(MODE_CONTEXTS[cnt[0]][0]):
            mb.mv, mb.lf_mode = (0, 0), LF_ZERO
        else:
            mb.lf_mode = LF_MV
            if cnt[3] and near[1] == near[3]:
                cnt[1] += 1
            if cnt[2] > cnt[1]:
                cnt[1], cnt[2] = cnt[2], cnt[1]
                near[1], near[2] = near[2], near[1]
            if not br.bit(MODE_CONTEXTS[cnt[1]][1]):
                mb.mv = clamp(near[1])
            elif not br.bit(MODE_CONTEXTS[cnt[2]][2]):
                mb.mv = clamp(near[2])
            else:
                best = clamp(near[1] if cnt[1] >= cnt[0] else near[0])
                split_ctx = (2 * ((left.lf_mode == LF_SPLIT) + (top.lf_mode == LF_SPLIT))
                             + (top_left.lf_mode == LF_SPLIT))
                if br.bit(MODE_CONTEXTS[split_ctx][3]):
                    self._split(br, mb, best, top, left)
                else:
                    mv_y = best[0] + _mv_component(br, self.mv_probs[0])
                    mb.mv = (mv_y, best[1] + _mv_component(br, self.mv_probs[1]))
        if mb.part == SPLIT_NONE:
            mb.bmv = [mb.mv] * 16

    def _split(self, br: _Bool, mb: _MB, best: tuple, top: _MB, left: _MB) -> None:
        """``decode_splitmvs``: the partitioning and each partition's vector;
        ``mb.bmv`` holds each 4x4 block's."""
        if not br.bit(SPLIT_PROB[0]):
            part = SPLIT_4x4
        elif not br.bit(SPLIT_PROB[1]):
            part = SPLIT_8x8
        else:
            part = SPLIT_16x8 + br.bit(SPLIT_PROB[2])
        splits = MB_SPLITS[part]
        parts = []
        for k in FIRST_BLOCK[part]:
            left_mv = left.bmv[k + 3] if not k & 3 else parts[splits[k - 1]]
            above = top.bmv[k + 12] if k <= 3 else parts[splits[k - 4]]
            if left_mv == above:
                p = SUBMV_PROB[4 if left_mv == (0, 0) else 3]
            elif above == (0, 0):
                p = SUBMV_PROB[2]
            else:
                p = SUBMV_PROB[1 if left_mv == (0, 0) else 0]
            if not br.bit(p[0]):
                parts.append(left_mv)
            elif not br.bit(p[1]):
                parts.append(above)
            elif not br.bit(p[2]):
                parts.append((0, 0))
            else:
                mv_y = best[0] + _mv_component(br, self.mv_probs[0])
                parts.append((mv_y, best[1] + _mv_component(br, self.mv_probs[1])))
        mb.part, mb.lf_mode, mb.has_y2 = part, LF_SPLIT, False
        mb.bmv = [parts[splits[b]] for b in range(16)]
        mb.mv = parts[-1]

    # ------------------------------------------------------------ frames

    def decode(self, data: bytes, stats: dict | None = None):
        """One frame's bytes -> its ``(Y, Cb, Cr)`` planes if it is shown
        (a generator of zero or one). ``stats`` adds seconds by stage and a
        frame, each under ``key`` or ``inter``."""
        t0 = time.perf_counter()
        key, version, shown, at, first = self.start_frame(data)
        br = _Bool(data[at:at + first], self.path)
        hdr = self._header(br, key)
        hdr["parts"] = self._partitions(data, at + first, hdr["num_parts"])
        mbs, coeffs, coded = self.macroblocks(br, hdr, key)
        t1 = time.perf_counter()
        height, width = self.size
        mb_w, mb_h = (width + 15) >> 4, (height + 15) >> 4
        planes = self._reconstruct(mbs, coeffs, mb_w, mb_h, version)
        t2 = time.perf_counter()
        if hdr["level"]:
            self._filter(planes, hdr, mbs, coded, key, mb_w, mb_h)
        t3 = time.perf_counter()
        self.end_frame(hdr, tuple(planes))
        if stats is not None:
            kind = "key" if key else "inter"
            for name, secs in (("tokens", t1 - t0), ("predict", t2 - t1), ("filter", t3 - t2)):
                stats[f"{name}_{kind}"] = stats.get(f"{name}_{kind}", 0.0) + secs
            stats[f"frames_{kind}"] = stats.get(f"frames_{kind}", 0) + 1
        if key:
            self.clamping = hdr["clamping"]
        if shown:
            self.full_range = bool(self.clamping)
            ch, cw = (height + 1) // 2, (width + 1) // 2
            yield tuple(np.ascontiguousarray(p[:h, :w], dtype=np.uint8)
                        for p, h, w in zip(planes, (height, ch, ch), (width, cw, cw)))

    def macroblocks(self, br: _Bool, hdr: dict, key: bool) -> tuple:
        """Every macroblock's modes (from ``br``, the first partition) and
        dequantised coefficients (from ``hdr["parts"]``): (macroblocks,
        ``[n, 400]`` coefficients, whether each has any coded)."""
        height, width = self.size
        mb_w, mb_h = (width + 15) >> 4, (height + 15) >> 4
        prev_map = self.seg_map
        seg_map = np.zeros(mb_w * mb_h, np.int64)
        mbs: list[_MB] = []
        coeffs = np.zeros((mb_w * mb_h, 400), np.int64)
        coded = np.zeros(mb_w * mb_h, bool)
        nz_top, nz_dc_top = [0] * mb_w, [0] * mb_w
        intra_top = [0] * (4 * mb_w)
        parts, bands, skip_prob = hdr["parts"], hdr["bands"], hdr["skip_prob"]
        for mb_y in range(mb_h):
            intra_left = [0] * 4
            nz_left = nz_dc_left = 0
            tokens = parts[mb_y & (len(parts) - 1)]
            for mb_x in range(mb_w):
                i = mb_y * mb_w + mb_x
                mb = _MB()
                if hdr["update_map"]:
                    p = self.seg_probs
                    seg = br.bit(p[2]) + 2 if br.bit(p[0]) else br.bit(p[1])
                elif hdr["segmentation"] and prev_map is not None:
                    seg = int(prev_map[i])
                else:
                    seg = 0
                seg_map[i] = mb.segment = seg
                mb.skip = br.bit(skip_prob) if skip_prob is not None else 0
                if key:
                    key_frame_modes(br, mb, intra_top, intra_left, mb_x)
                    mb.ref, mb.part, mb.bmv = 0, SPLIT_NONE, [(0, 0)] * 16
                    mb.has_y2 = not mb.i4x4
                    mb.lf_mode = LF_BPRED if mb.i4x4 else LF_NONE
                else:
                    self._inter_modes(br, hdr, mb, mbs, mb_x, mb_y, mb_w, mb_h)
                mbs.append(mb)
                if mb.skip:
                    nz_left = nz_top[mb_x] = 0
                    if mb.has_y2:
                        nz_dc_left = nz_dc_top[mb_x] = 0
                else:
                    block = [0] * 400
                    q_y1, q_y2, q_uv = hdr["quant"][seg]
                    y_nz, uv_nz, nz_left, nz_dc_left = residuals(
                        tokens, bands, mb.has_y2, block, nz_top, nz_dc_top, mb_x, nz_left,
                        nz_dc_left, q_y1, q_y2, q_uv)
                    coded[i] = y_nz or uv_nz or (mb.has_y2 and nz_dc_left)
                    coeffs[i] = block
                    tokens.check()
            br.check()
        self.seg_map = seg_map
        return mbs, coeffs, coded

    def _reconstruct(self, mbs: list, coeffs: np.ndarray, mb_w: int, mb_h: int,
                     version: int) -> list:
        """Prediction plus residuals of every macroblock, unfiltered: the
        inter ones at once, then the intra ones in raster order (they read
        their neighbours, inter or intra, of this frame)."""
        coeffs = _w16(coeffs)  # the dequantised coefficients as FFmpeg's int16_t blocks hold them
        y2 = np.array([mb.has_y2 for mb in mbs])
        if y2.any():
            coeffs[y2, 0:256:16] = _iwht(coeffs[y2, 384:400])
        residual = _idct(coeffs[:, :384].reshape(-1, 16)).reshape(len(mbs), 24, 4, 4)
        y_pl = np.zeros((16 * mb_h + 1, 16 * mb_w + 5), np.int64)
        uv_pl = [np.zeros((8 * mb_h + 1, 8 * mb_w + 1), np.int64) for _ in range(2)]
        for plane in (y_pl, *uv_pl):
            plane[0], plane[1:, 0] = 127, 129
        inter = [i for i, mb in enumerate(mbs) if mb.ref]
        if inter:
            self._inter(mbs, inter, residual, y_pl, uv_pl, mb_w, version)
        for i, mb in enumerate(mbs):
            if not mb.ref:
                intra_mb(y_pl, uv_pl, mb, i % mb_w, i // mb_w, mb_w, residual[i])
        return [y_pl[1:, 1:16 * mb_w + 1].astype(np.int32), uv_pl[0][1:, 1:].astype(np.int32),
                uv_pl[1][1:, 1:].astype(np.int32)]

    def _inter(self, mbs, inter, residual, y_pl, uv_pl, mb_w, version) -> None:
        bilinear = version != 0
        idx = np.array(inter)
        mb_y, mb_x = idx // mb_w, idx % mb_w
        bmv = np.array([mbs[i].bmv for i in inter], np.int64)  # [n, 16, 2] quarter pixels
        refs = np.array([mbs[i].ref for i in inter])
        # chroma: each 2x2 group of luma blocks' vectors, summed and rounded
        groups = bmv.reshape(-1, 2, 2, 2, 2, 2).sum(axis=(2, 4))  # [n, 2, 2, 2]
        uv_mv = (groups + 2 - (groups < 0)) >> 2
        if version == 3:
            uv_mv &= ~7
        split = np.array([mbs[i].part != SPLIT_NONE for i in inter])
        luma = np.zeros((len(inter), 16, 16), np.int32)
        chroma = np.zeros((2, len(inter), 8, 8), np.int32)
        for ref in (LAST, GOLDEN, ALTREF):
            planes = self.refs[ref]
            for is_split in (False, True):
                sel = np.nonzero((refs == ref) & (split == is_split))[0]
                if not len(sel):
                    continue
                if not is_split:  # one vector: 16x16 luma, 8x8 chroma
                    mv = bmv[sel, 0]
                    by, bx = 16 * mb_y[sel], 16 * mb_x[sel]
                    luma[sel] = mc(planes[0], by + (mv[:, 0] >> 2), bx + (mv[:, 1] >> 2),
                                   (mv[:, 0] & 3) * 2, (mv[:, 1] & 3) * 2, 16, bilinear)
                    cmv = uv_mv[sel, 0, 0]
                    for k in range(2):
                        chroma[k, sel] = mc(planes[1 + k], 8 * mb_y[sel] + (cmv[:, 0] >> 3),
                                            8 * mb_x[sel] + (cmv[:, 1] >> 3), cmv[:, 0] & 7,
                                            cmv[:, 1] & 7, 8, bilinear)
                    continue
                n = len(sel)
                mv = bmv[sel].reshape(-1, 2)  # [n * 16, 2]
                blk = np.tile(np.arange(16), n)
                by = np.repeat(16 * mb_y[sel], 16) + 4 * (blk >> 2)
                bx = np.repeat(16 * mb_x[sel], 16) + 4 * (blk & 3)
                out = mc(planes[0], by + (mv[:, 0] >> 2), bx + (mv[:, 1] >> 2),
                         (mv[:, 0] & 3) * 2, (mv[:, 1] & 3) * 2, 4, bilinear)
                luma[sel] = out.reshape(n, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4).reshape(n, 16, 16)
                cmv = uv_mv[sel].reshape(-1, 2)
                blk = np.tile(np.arange(4), n)
                cy = np.repeat(8 * mb_y[sel], 4) + 4 * (blk >> 1)
                cx = np.repeat(8 * mb_x[sel], 4) + 4 * (blk & 1)
                for k in range(2):
                    out = mc(planes[1 + k], cy + (cmv[:, 0] >> 3), cx + (cmv[:, 1] >> 3),
                             cmv[:, 0] & 7, cmv[:, 1] & 7, 4, bilinear)
                    chroma[k, sel] = out.reshape(n, 2, 2, 4, 4).transpose(0, 1, 3, 2, 4).reshape(
                        n, 8, 8)
        res = residual[idx]
        y_res = res[:, :16].reshape(-1, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4).reshape(-1, 16, 16)
        y_blocks = np.clip(luma + y_res, 0, 255)
        rows = (16 * mb_y)[:, None] + np.arange(1, 17)
        cols = (16 * mb_x)[:, None] + np.arange(1, 17)
        y_pl[rows[:, :, None], cols[:, None, :]] = y_blocks
        rows = (8 * mb_y)[:, None] + np.arange(1, 9)
        cols = (8 * mb_x)[:, None] + np.arange(1, 9)
        for k in range(2):
            c_res = res[:, 16 + 4 * k:20 + 4 * k].reshape(-1, 2, 2, 4, 4).transpose(
                0, 1, 3, 2, 4).reshape(-1, 8, 8)
            uv_pl[k][rows[:, :, None], cols[:, None, :]] = np.clip(chroma[k] + c_res, 0, 255)

    def _filter(self, planes, hdr, mbs, coded, key, mb_w, mb_h) -> None:
        """``filter_level_for_mb`` for every macroblock, then the filter."""
        n = len(mbs)
        level = np.empty(n, np.int64)
        for i, mb in enumerate(mbs):
            lv = hdr["level"]
            if hdr["segmentation"]:
                lv = self.seg_filter[mb.segment] + (0 if self.seg_abs else hdr["level"])
            if hdr["lf_deltas"]:
                lv += self.ref_delta[mb.ref]
                if mb.lf_mode:
                    lv += self.mode_delta[mb.lf_mode - 1]
            level[i] = min(max(lv, 0), 63)
        sharp = hdr["sharpness"]
        ilimit = level.copy()
        if sharp:
            ilimit = np.minimum(ilimit >> ((sharp + 3) >> 2), 9 - sharp)
        ilimit = np.maximum(ilimit, 1)
        if key:
            hev = np.where(level >= 40, 2, np.where(level >= 15, 1, 0))
        else:
            hev = np.where(level >= 40, 3, np.where(level >= 20, 2, np.where(level >= 15, 1, 0)))
        inner = np.array([bool(c) or mb.i4x4 or mb.lf_mode == LF_SPLIT
                          for mb, c in zip(mbs, coded)])
        shape = (mb_h, mb_w)
        loop_filter(planes, level.reshape(shape), ilimit.reshape(shape), hev.reshape(shape),
                    inner.reshape(shape), bool(hdr["simple"]))
