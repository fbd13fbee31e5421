"""A WMV2 (Windows Media Video 8) decoder in numpy and plain Python, bit for
bit what FFmpeg's ``wmv2`` decoder (``wmv2dec.c``, ``wmv2dsp.c``,
``wmv2.c`` on ``msmpeg4dec.c``) gives for the streams FFmpeg's ``wmv2``
encoder writes through ``cv2.VideoWriter``. It builds on ``msmpeg4.py``.

``Wmv2Decoder(width, height, config, where)`` takes the container's size
and extradata and ``decode(packet)`` returns each picture's Y, Cb and Cr
planes (4:2:0, cropped, limited range):

- the 4-byte extension header of the extradata (in an ASF or AVI
  ``BITMAPINFOHEADER`` after its 40 bytes, a Matroska ``V_MS/VFW/FOURCC``
  track's, a MOV ``glbl`` box): frame rate, bit rate, ``mspel_bit``,
  ``loop_filter``, ``abt_flag``, ``j_type_bit``, ``top_left_mv_flag``,
  ``per_mb_rl_bit`` and the slice code;
- picture headers: the type (I or P), an I-picture's 7-bit code, the
  quantiser; a P-picture whose skip map (by rows or columns) skips every
  macroblock gives no frame, as FFmpeg's ``FRAME_SKIPPED``; then
  ``ff_wmv2_decode_secondary_picture_header``: an I-picture's ``j_type``,
  ``per_mb_rl_table``, run/level and DC table indices; a P-picture's skip
  map of four types (none, one bit a macroblock, by rows, by columns), the
  non-intra table from ``decode012`` and the quantiser
  (``wmv2_get_cbp_table_index``), ``mspel``, ABT's ``per_mb_abt`` and
  ``abt_type``, the run/level, DC and motion vector table indices; the
  rounding mode flipping every P-picture;
- macroblocks: as WMV1's (``msmpeg4.py``), with the hybrid vector
  predictor (``wmv2_pred_motion``: a bit chooses the left or the top
  vector where they differ by 8 half-pels or more, under
  ``top_left_mv_flag`` and without ``mspel``), ``hshift`` after an odd
  vector under ``mspel``, per-macroblock ABT signalling and run/level
  tables;
- reconstruction: WMV2's own IDCT (``wmv2dsp.c``: W1-W7 2841, 2676, 2408,
  2048, 1609, 1108, 565, rows stored as 16 bits), not ``simple_idct``, for
  intra and inter blocks; motion compensation by ``mpeg4.reconstruct``'s
  half-pel prediction, or under ``mspel`` by ``ff_mspel_motion``: the luma
  through ``wmv2_mspel8_{h,v}_lowpass`` ((9 (b + c) - (a + d) + 8) >> 4)
  and their averages by ``dxy`` and ``hshift``, the source clipped to the
  picture as FFmpeg clips it, the chroma at half-pel.

The extradata that cv2's writer makes (probed): ``mspel_bit``, ``abt_flag``,
``j_type_bit`` and ``per_mb_rl_bit`` set, no loop filter, one slice; every
P-picture skip type 0, ``mspel`` 0, ABT 8x8 only, ``per_mb_rl_table`` 0.
The tests rewrite streams to reach the rest.

Refused, each with a ValueError naming ROADMAP.md queue 1, item 4: extradata
shorter than 4 bytes, the loop filter, ``j_type`` pictures (IntraX8), ABT
block types other than 8x8, and what ``msmpeg4.py`` refuses.
"""

from __future__ import annotations

import numpy as np

from .mpeg4 import Bits, _mc, _predict, reconstruct
from .msmpeg4 import (I_PICTURE, INTER, INTRA, P_PICTURE, Header, MsMpeg4Decoder, _corrupt,
                      _PictureDecoder, _refuse, decode012)

W0, W1, W2, W3, W4, W5, W6, W7 = 2048, 2841, 2676, 2408, 2048, 1609, 1108, 565
SKIP_NONE, SKIP_MPEG, SKIP_ROW, SKIP_COL = 0, 1, 2, 3
CBP_TABLE = ((0, 2, 1), (1, 0, 2), (2, 1, 0))  # wmv2_get_cbp_table_index's map


# ------------------------------------------------------------------- the IDCT

def _i32(x: np.ndarray) -> np.ndarray:
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _i16(x: np.ndarray) -> np.ndarray:
    return ((x + (1 << 15)) & 0xFFFF) - (1 << 15)


def _idct_values(deq: np.ndarray) -> np.ndarray:
    """``wmv2_idct_c`` on ``[N, 64]`` raster coefficients -> ``[N, 8, 8]``
    int16 values: the rows (stored as 16 bits), then the columns."""
    b = _i16(np.asarray(deq, np.int64).reshape(-1, 8, 8))

    def butterfly(b0, b1, b2, b3, b4, b5, b6, b7, rnd, shift, col):
        r = 4 if col else 0
        sh = 3 if col else 0
        a1 = (W1 * b1 + W7 * b7 + r) >> sh
        a7 = (W7 * b1 - W1 * b7 + r) >> sh
        a5 = (W5 * b5 + W3 * b3 + r) >> sh
        a3 = (W3 * b5 - W5 * b3 + r) >> sh
        a2 = (W2 * b2 + W6 * b6 + r) >> sh
        a6 = (W6 * b2 - W2 * b6 + r) >> sh
        a0 = (W0 * b0 + W0 * b4) >> sh
        a4 = (W0 * b0 - W0 * b4) >> sh
        s1 = _i32(181 * (a1 - a5 + a7 - a3) + 128) >> 8
        s2 = _i32(181 * (a1 - a5 - a7 + a3) + 128) >> 8
        return [(a0 + a2 + a1 + a5 + rnd) >> shift, (a4 + a6 + s1 + rnd) >> shift,
                (a4 - a6 + s2 + rnd) >> shift, (a0 - a2 + a7 + a3 + rnd) >> shift,
                (a0 - a2 - a7 - a3 + rnd) >> shift, (a4 - a6 - s2 + rnd) >> shift,
                (a4 + a6 - s1 + rnd) >> shift, (a0 + a2 - a1 - a5 + rnd) >> shift]

    rows = butterfly(*(b[:, :, k] for k in range(8)), 1 << 7, 8, False)
    b = _i16(np.stack(rows, axis=2))
    cols = butterfly(*(b[:, k, :] for k in range(8)), 1 << 13, 14, True)
    return _i16(np.stack(cols, axis=1))


def idct_put(deq: np.ndarray, where: str = "<bytes>") -> np.ndarray:
    """``wmv2_idct_put_c``: ``[N, 64]`` coefficients -> ``[N, 64]`` uint8,
    clipped to 0..255."""
    return np.clip(_idct_values(deq), 0, 255).astype(np.uint8).reshape(-1, 64)


def idct_add(deq: np.ndarray, pred: np.ndarray, where: str = "<bytes>") -> np.ndarray:
    """``wmv2_idct_add_c``: the transform added to ``[N, 64]`` uint8
    samples, clipped to 0..255."""
    out = _idct_values(deq).reshape(-1, 64) + pred.reshape(-1, 64).astype(np.int64)
    return np.clip(out, 0, 255).astype(np.uint8)


# ------------------------------------------------------------ mspel motion

def _h_lowpass(p: np.ndarray) -> np.ndarray:
    """``wmv2_mspel8_h_lowpass`` of ``[N, R, 11]`` samples (columns -1..9)
    -> ``[N, R, 8]``."""
    return np.clip((9 * (p[..., 1:9] + p[..., 2:10]) - (p[..., 0:8] + p[..., 3:11]) + 8) >> 4,
                   0, 255)


def _v_lowpass(p: np.ndarray) -> np.ndarray:
    """``wmv2_mspel8_v_lowpass`` of ``[N, 11, C]`` samples (rows -1..9)
    -> ``[N, 8, C]``."""
    return np.clip((9 * (p[:, 1:9] + p[:, 2:10]) - (p[:, 0:8] + p[:, 3:11]) + 8) >> 4, 0, 255)


def _avg(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a + b + 1) >> 1


def mspel8(ref: np.ndarray, sx: np.ndarray, sy: np.ndarray, dxy: np.ndarray) -> np.ndarray:
    """``put_mspel_pixels_tab[dxy]`` of 8x8 blocks at (sx, sy) of the luma
    ``ref``, its rows and columns clamped to it (FFmpeg's edge emulation)."""
    h, w = ref.shape
    k = np.arange(-1, 10)
    rows = np.clip(sy[:, None] + k, 0, h - 1)
    cols = np.clip(sx[:, None] + k, 0, w - 1)
    p = ref[rows[:, :, None], cols[:, None, :]].astype(np.int64)  # [N, 11, 11]: rows, cols -1..9
    src = p[:, 1:9, 1:9]
    half_h = _h_lowpass(p)  # [N, 11, 8]: rows -1..9
    out = src.copy()
    d = dxy[:, None, None]
    out = np.where(d == 1, _avg(src, half_h[:, 1:9]), out)
    out = np.where(d == 2, half_h[:, 1:9], out)
    out = np.where(d == 3, _avg(p[:, 1:9, 2:10], half_h[:, 1:9]), out)
    out = np.where(d == 4, _v_lowpass(p[:, :, 1:9]), out)
    hv = _v_lowpass(half_h)
    out = np.where(d == 5, _avg(_v_lowpass(p[:, :, 1:9]), hv), out)
    out = np.where(d == 6, hv, out)
    out = np.where(d == 7, _avg(_v_lowpass(p[:, :, 2:10]), hv), out)
    return out.astype(np.uint8)


def mspel_predict(ref, planes, mbw: int, mbh: int, kinds, mv_list, rounding: int, hshift,
                  width: int, height: int) -> None:
    """``ff_mspel_motion`` for every inter and skipped MB: the luma by the
    mspel filters, the chroma at half-pel (``rounding`` as ``_mc``)."""
    sel = [mb for mb, k in enumerate(kinds) if 0 <= k < 2]
    if not sel:
        return
    mb = np.array(sel)
    mby, mbx = np.divmod(mb, mbw)
    mv = np.array([mv_list[m] for m in sel], np.int64).reshape(-1, 2)
    mx, my = mv[:, 0], mv[:, 1]
    dxy = 2 * (((my & 1) << 1) | (mx & 1)) + np.array([hshift[m] for m in sel], np.int64)
    src_x = np.clip(16 * mbx + (mx >> 1), -16, width)
    src_y = np.clip(16 * mby + (my >> 1), -16, height)
    dxy = np.where((src_x <= -16) | (src_x >= width), dxy & ~3, dxy)
    dxy = np.where((src_y <= -16) | (src_y >= height), dxy & ~4, dxy)
    y, cb, cr = planes
    yv = y.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3)
    luma = np.empty((len(sel), 16, 16), np.uint8)
    for by in (0, 8):
        for bx in (0, 8):
            luma[:, by:by + 8, bx:bx + 8] = mspel8(ref.y, src_x + bx, src_y + by, dxy)
    yv[mby, mbx] = luma
    hx, hy = ((mx & 3) != 0).astype(np.int64), ((my & 3) != 0).astype(np.int64)
    cx = np.clip(8 * mbx + (mx >> 2), -8, width >> 1)
    cy = np.clip(8 * mby + (my >> 2), -8, height >> 1)
    hx = np.where(cx == width >> 1, 0, hx)
    hy = np.where(cy == height >> 1, 0, hy)
    for plane, src in ((cb, ref.cb), (cr, ref.cr)):
        v = plane.reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3)
        v[mby, mbx] = _mc(src, cx, cy, hx, hy, 8, rounding)


# -------------------------------------------------------------- the decoder

class Wmv2Decoder(MsMpeg4Decoder):
    """FFmpeg's ``wmv2`` decoder for the streams the module's notes list."""

    def __init__(self, width: int, height: int, config: bytes = b"", where: str = "<stream>"):
        super().__init__("wmv2", width, height, config, where)
        if len(config) < 4:
            raise _refuse(where, f"a WMV2 stream with {len(config)} bytes of extradata (4 "
                          "needed)")
        b = Bits(config[:4])
        b.read(5)  # frames a second
        self.bit_rate = b.read(11) * 1024
        self.mspel_bit, loop_filter, self.abt_flag, self.j_type_bit = (b.read(1) for _ in "1234")
        self.top_left_mv_flag, self.per_mb_rl_bit = b.read(1), b.read(1)
        code = b.read(3)
        if loop_filter:
            raise _refuse(where, "WMV2's loop filter")
        self.slice_height = self.mbh // code if code else 0
        self.skipped_frames = 0

    def header(self, bits: Bits) -> Header | None:
        """``ff_wmv2_decode_picture_header`` and the secondary header; None
        for a P-picture that skips every macroblock."""
        w = self.where
        h = Header()
        h.kind = bits.read(1)
        if h.kind == I_PICTURE:
            bits.read(7)
        h.quant = bits.read(5)
        if not h.quant:
            raise _corrupt(w, "a quantiser of 0")
        if h.kind == P_PICTURE and bits.peek(1) and self._all_skipped(bits):
            self.skipped_frames += 1
            return None
        self.inter_intra_pred = 0
        self.use_skip_mb_code = 0
        self.skip_map = None
        if h.kind == I_PICTURE:
            if self.j_type_bit and bits.read(1):
                raise _refuse(w, "a j_type picture (IntraX8)")
            self.per_mb_rl_table = bits.read(1) if self.per_mb_rl_bit else 0
            if not self.per_mb_rl_table:
                self.rl_chroma_table_index = decode012(bits)
                self.rl_table_index = decode012(bits)
            self.dc_table_index = bits.read(1)
            if (bits.size - bits.pos) * 8 < self.mbw * self.mbh:
                raise _corrupt(w, "an I-picture too short for its macroblocks")
            self.no_rounding = 1
        else:
            self.skip_map = self._skip_map(bits)
            self.cbp_table_index = CBP_TABLE[(h.quant > 10) + (h.quant > 20)][decode012(bits)]
            self.mspel = bits.read(1) if self.mspel_bit else 0
            self.per_mb_abt, self.abt_type = 0, 0
            if self.abt_flag:
                self.per_mb_abt = bits.read(1) ^ 1
                if not self.per_mb_abt:
                    self.abt_type = decode012(bits)
            self.per_mb_rl_table = bits.read(1) if self.per_mb_rl_bit else 0
            if not self.per_mb_rl_table:
                self.rl_table_index = self.rl_chroma_table_index = decode012(bits)
            if bits.size - bits.pos < 2:
                raise _corrupt(w, "a P-picture header cut short")
            self.dc_table_index = bits.read(1)
            self.mv_table_index = bits.read(1)
            self.no_rounding ^= 1
        return h

    def _all_skipped(self, bits: Bits) -> bool:
        """The FRAME_SKIPPED test: a row or column skip map whose every
        row or column flag is 1."""
        b = Bits(bits.data, bits.pos)
        kind = b.read(2)
        run = self.mbw if kind == SKIP_COL else self.mbh
        while run > 0:
            n = min(run, 25)
            if b.read(n) + 1 != 1 << n:
                return False
            run -= n
        return True

    def _skip_map(self, bits: Bits) -> list:
        """``parse_mb_skip``: each macroblock's skip flag."""
        mbw, mbh = self.mbw, self.mbh
        kind = bits.read(2)
        skip = [0] * (mbw * mbh)
        if kind == SKIP_MPEG:
            if bits.size - bits.pos < mbw * mbh:
                raise _corrupt(self.where, "a skip map cut short")
            skip = [bits.read(1) for _ in range(mbw * mbh)]
        elif kind in (SKIP_ROW, SKIP_COL):
            outer, inner = (mbh, mbw) if kind == SKIP_ROW else (mbw, mbh)
            for a in range(outer):
                if bits.pos >= bits.size:
                    raise _corrupt(self.where, "a skip map cut short")
                if bits.read(1):
                    flags = [1] * inner
                else:
                    flags = [bits.read(1) for _ in range(inner)]
                for b_, f in enumerate(flags):
                    skip[a * mbw + b_ if kind == SKIP_ROW else b_ * mbw + a] = f
        coded = len(skip) - sum(skip)
        if coded > bits.size - bits.pos:
            raise _corrupt(self.where, "a skip map leaving fewer bits than coded macroblocks")
        self.skip_kind = kind
        return skip

    def picture(self, bits: Bits, hdr: Header) -> _Wmv2Picture:
        return _Wmv2Picture(self, bits, hdr)


class _Wmv2Picture(_PictureDecoder):
    def __init__(self, dec: Wmv2Decoder, bits: Bits, hdr: Header):
        super().__init__(dec, bits, hdr)
        self.hshift = [0] * (self.mbw * self.mbh)

    def macroblock(self, mbx: int, mby: int, first_row: bool) -> None:
        """``wmv2_decode_mb``."""
        dec, bits, t, where = self.dec, self.bits, self.t, self.where
        mb = mby * self.mbw + mbx
        k = (mby + 1) * (self.mbw + 2) + mbx + 1
        if self.p_picture:
            if dec.skip_map[mb]:
                self.mvs[k] = (0, 0)
                self._clean(mbx, mby)
                return
            if bits.pos >= bits.size:
                raise _corrupt(where, f"the picture ends at macroblock {mb}")
            code = t["mb_non_intra"][dec.cbp_table_index].read(bits, where, "macroblock")
            intra, cbp = not code & 0x40, code & 0x3F
        else:
            if bits.pos >= bits.size:
                raise _corrupt(where, f"the picture ends at macroblock {mb}")
            intra = True
            cbp = self._predict_cbp(t["mb_intra"].read(bits, where, "macroblock"), mbx, mby)
        if not intra:
            px, py = self._wmv2_predictor(k, mbx, first_row)
            per_block_abt = 0
            if cbp:
                if dec.per_mb_rl_table:
                    dec.rl_table_index = dec.rl_chroma_table_index = decode012(bits)
                if dec.abt_flag and dec.per_mb_abt:
                    per_block_abt = bits.read(1)
                    if not per_block_abt:
                        dec.abt_type = decode012(bits)
            mv = self._motion(px, py)
            if (mv[0] | mv[1]) & 1 and dec.mspel:
                self.hshift[mb] = bits.read(1)
            self.mvs[k] = self.mv_list[mb] = mv
            self.kinds[mb] = INTER
            for n in range(6):
                if cbp >> (5 - n) & 1:
                    if per_block_abt:
                        dec.abt_type = decode012(bits)
                    if dec.abt_type:
                        raise _refuse(where, f"WMV2's ABT block type {dec.abt_type} (8x4 or 4x8)")
                    self._inter_blocks(mb, 1 << (5 - n))
            self._clean(mbx, mby)
            return
        self.ac_pred = bits.read(1)
        if dec.per_mb_rl_table and cbp:
            dec.rl_table_index = dec.rl_chroma_table_index = decode012(bits)
        self.mvs[k] = (0, 0)
        self.kinds[mb] = INTRA
        self._intra_blocks(mb, mbx, mby, cbp, first_row)

    def _wmv2_predictor(self, k: int, mbx: int, first_row: bool) -> tuple[int, int]:
        """``wmv2_pred_motion``: under ``top_left_mv_flag`` (no ``mspel``,
        not the first column or a slice's first row) a bit picks the left
        or the top vector where they differ by 8 or more; else H.263's."""
        dec, mvs, width = self.dec, self.mvs, self.mbw + 2
        a, b, c = mvs[k - 1], mvs[k - width], mvs[k - width + 1]
        diff = 0
        if mbx and not first_row and not dec.mspel and dec.top_left_mv_flag:
            diff = max(abs(a[0] - b[0]), abs(a[1] - b[1]))
        if diff >= 8:
            return b if self.bits.read(1) else a
        if first_row:
            return a
        return sorted((a[0], b[0], c[0]))[1], sorted((a[1], b[1], c[1]))[1]

    def reconstruct_into(self, ref, kinds, intra, inter) -> None:
        dec = self.dec
        rounding = dec.no_rounding if self.p_picture else 0
        predict = None
        if self.p_picture and dec.mspel:
            def predict(ref_, planes, mbw, mbh, kinds_, mv_list, rnd):
                mspel_predict(ref_, planes, mbw, mbh, kinds_, mv_list, rnd, self.hshift,
                              dec.width, dec.height)
        reconstruct(ref, self.mbw, self.mbh, kinds, self.mv_list, intra, inter, rounding,
                    self.where, (dec.y_dc, dec.c_dc), out=self.out, idct=(idct_put, idct_add),
                    predict=predict or _predict)

