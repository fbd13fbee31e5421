"""An MS-MPEG-4 v2, v3 (DivX ;-) 3) and WMV1 decoder in numpy and plain
Python, bit for bit what FFmpeg's ``msmpeg4v2``, ``msmpeg4v3`` and ``wmv1``
decoders (``msmpeg4dec.c``, ``msmpeg4.c``, ``h263dec.c``, ``mpegvideo``)
give for the streams FFmpeg's encoders of those names write through
``cv2.VideoWriter``. ``utils/wmv2.py`` builds WMV2 on it.

``MsMpeg4Decoder(codec, width, height, config, where)`` (``codec``
``"msmpeg4v2"``, ``"msmpeg4v3"`` or ``"wmv1"``; the size is the
container's: the stream holds none) and ``decode(packet)`` return each
picture's Y, Cb and Cr planes (4:2:0, cropped, limited range):

- picture headers: the picture type (I or P) and quantiser; in
  I-pictures the slice code (the picture cut into slices of
  ``mb_height / (code - 22)`` macroblock rows, which P-pictures keep), v3's
  and WMV1's run/level table indices (``decode012``) and
  ``dc_table_index``, WMV1's extension header (frame rate, bit rate,
  ``flipflop_rounding``) and ``per_mb_rl_table`` above 50 kbit/s; in
  P-pictures ``use_skip_mb_code``, the run/level, DC and motion vector
  table indices, and WMV1's ``inter_intra_pred`` (below 320x240 and at
  128 kbit/s or less); v2's and v3's extension header after an
  I-picture's macroblocks, read as ``ff_msmpeg4_decode_ext_header`` reads
  it (v3's ``flipflop_rounding``);
- macroblocks: I-macroblocks with v3's and WMV1's coded block prediction
  (``ff_msmpeg4_coded_block_pred``) or v2's ``cbpc`` and CBPY; skipped
  macroblocks; P-macroblocks by v2's macroblock type, ``cbpc``, CBPY and
  H.263 vectors wrapped to +-64 half-pels, or v3's and WMV1's non-intra
  table and motion vector tables (with their escape) on the H.263 median
  predictor; intra macroblocks in P-pictures with ``ac_pred``, WMV1's
  ``h263_aic_dir`` and per-macroblock run/level tables;
- blocks: the DC by v2's H.263-style sizes or the DC tables (with their
  escape), predicted from the left or top neighbour by FFmpeg's rule
  (``ff_msmpeg4_pred_dc``: x86's reciprocal division by the DC scale; v3's
  ``<=`` against WMV1's ``<``; WMV1's ``inter_intra_pred`` predicting from
  the sums of the decoded pixels beside the block), AC prediction with its
  scans, the run/level tables and their three escapes (v2's and v3's fixed
  third escape, WMV1's ``esc3_level_length`` and ``esc3_run_length`` read at
  the picture's first); slices resetting the predictors (v2, v3) and the
  vector predictor's first row;
- reconstruction by ``mpeg4.reconstruct``: H.263 dequantisation,
  ``jpeg.idct_simple`` / ``idct_simple_add`` and half-pel motion
  compensation, the rounding mode off in I-pictures and alternating
  picture by picture where ``flipflop_rounding`` is set (v3 and WMV1; 0 in
  v2), with x86's inexact ``pavgb`` no-rounding averages.

Refused, each with a ValueError naming ROADMAP.md queue 1, item 4: P-pictures
with no picture before them, a slice height of 0, B- and other picture
types, dequantised coefficients outside 16 bits, and corrupt pictures (an
invalid code, a block of more than 64 coefficients, a DC past FFmpeg's
bound, a picture whose data runs out or leaves more bits than FFmpeg's
padding allows), which FFmpeg conceals.
"""

from __future__ import annotations

import numpy as np

from . import msmpeg4tables as T
from .imgcodecs import ROADMAP, VIDEO_READS
from .mpeg4 import (_CBPY, _MVD, ALT_HORIZONTAL, ALT_VERTICAL, DC_CHROMA,
                    DC_LUMA, INTER_LAST, INTER_LEVEL, INTER_RUN, INTER_VLC, INTRA_LAST, INTRA_LEVEL,
                    INTRA_RUN, INTRA_VLC, ZIGZAG, Bits, Picture, read_vlc, reconstruct)

V2, V3, WMV1, WMV2 = 2, 3, 4, 5
VERSIONS = {"msmpeg4v2": V2, "msmpeg4v3": V3, "wmv1": WMV1, "wmv2": WMV2}
I_PICTURE, P_PICTURE = 0, 1
SKIP, INTER, INTRA = 0, 1, 2
DC_MAX = 119  # the DC tables' escape symbol
MBAC_BITRATE = 50 * 1024  # above it WMV1 signals per_mb_rl_table
II_BITRATE = 128 * 1024  # at most it (and below 320x240) WMV1 uses inter_intra_pred
DEFAULT_INTER_INDEX = 3  # the non-intra macroblock table of v3 and WMV1
MPEG1_DC_SCALE = (8,) * 32


def _refuse(where: str, what: str) -> ValueError:
    return ValueError(f"{where}: {what}, which the port's MS-MPEG-4 decoder does not read; "
                      f"{VIDEO_READS} ({ROADMAP})")


def _corrupt(where: str, what: str) -> ValueError:
    return ValueError(f"{where}: corrupt MS-MPEG-4 video: {what}; {VIDEO_READS} ({ROADMAP})")


# ----------------------------------------------------------------- the VLCs

class Vlc:
    """A (code, length) lookup: codes of up to ``bits`` bits in one table,
    longer ones by their length."""

    def __init__(self, codes, syms=None, bits: int = 10):
        self.bits = bits
        self.table = [None] * (1 << bits)
        longer: dict[int, dict[int, object]] = {}
        for k, (code, n) in enumerate(codes):
            code, n = int(code), int(n)
            sym = k if syms is None else syms[k]
            if n <= bits:
                lo = code << (bits - n)
                for j in range(lo, lo + (1 << (bits - n))):
                    self.table[j] = (sym, n)
            else:
                longer.setdefault(n, {})[code] = sym
        self.longer = sorted(longer.items())

    def read(self, b: Bits, where: str, what: str):
        e = self.table[b.peek(self.bits)]
        if e is not None:
            b.pos += e[1]
            return e[0]
        for n, codes in self.longer:
            sym = codes.get(_peek(b, n))
            if sym is not None:
                b.pos += n
                return sym
        raise _corrupt(where, f"an invalid {what} code at bit {b.pos}")


def _peek(b: Bits, n: int) -> int:
    """The next ``n`` bits, any ``n`` (``Bits.peek`` reads up to 25)."""
    if n <= 25:
        return b.peek(n)
    p = b.pos
    word = int.from_bytes(b.data[p >> 3:(p >> 3) + 5].ljust(5, b"\0"), "big")
    return (word >> (40 - (p & 7) - n)) & ((1 << n) - 1)


def from_lengths(lens) -> list[tuple[int, int]]:
    """``ff_vlc_init_from_lengths``' codes: assigned in order, each the last
    one plus one at its length."""
    out, code = [], 0
    for n in lens:
        n = int(n)
        out.append((code >> (32 - n), n))
        code += 1 << (32 - n)
    return out


class RlTable:
    """A run/level table (``RLTable``): the 12-bit lookup of (run, level,
    last, length) per code, (-1, 0, 0, length) for the escape, longer codes
    by length, and ``ff_rl_init``'s max_level[last][run] and
    max_run[last][level]."""

    BITS = 12

    def __init__(self, codes, runs, levels, last: int):
        n = len(runs)
        entries = [(int(runs[k]), int(levels[k]), int(k >= last)) for k in range(n)]
        entries.append((-1, 0, 0))
        self.table = [None] * (1 << self.BITS)
        self.longer: dict[int, dict[int, tuple]] = {}
        for (code, ln), (r, lv, la) in zip(codes, entries):
            code, ln = int(code), int(ln)
            e = (r, lv, la, ln)
            if ln <= self.BITS:
                lo = code << (self.BITS - ln)
                for j in range(lo, lo + (1 << (self.BITS - ln))):
                    self.table[j] = e
            else:
                self.longer.setdefault(ln, {})[code] = e
        self.longer = sorted(self.longer.items())
        self.max_level = [[0] * 65, [0] * 65]
        self.max_run = [[0] * 65, [0] * 65]
        for r, lv, la in entries[:-1]:
            self.max_level[la][r] = max(self.max_level[la][r], lv)
            self.max_run[la][lv] = max(self.max_run[la][lv], r)

    def entry(self, b: Bits, where: str) -> tuple:
        e = self.table[b.peek(self.BITS)]
        if e is None:
            for n, codes in self.longer:
                e = codes.get(b.peek(n))
                if e is not None:
                    break
            else:
                raise _corrupt(where, f"an invalid run/level code at bit {b.pos}")
        return e


_TABLES: dict = {}


def tables() -> dict:
    """The decoders' lookups, built once: ``rl`` (``ff_rl_table[0..5]``),
    ``dc`` [dc_table_index][chroma], ``mv`` [mv_table_index] (symbols (x, y)
    offset by 32, None for the escape), ``mb_intra``, ``mb_non_intra``
    [cbp_table_index], v2's ``v2_mb_type``, ``v2_cbpc`` and ``v2_dc``
    [chroma] (H.263's DC sizes, their bits inverted), ``inter_intra``."""
    if _TABLES:
        return _TABLES
    pairs = lambda a: [(int(c), int(n)) for c, n in np.asarray(a).reshape(-1, 2)]  # noqa: E731
    rl = [RlTable(pairs(T.RL0_VLC), T.RL0_RUN, T.RL0_LEVEL, T.RL0_LAST),
          RlTable(pairs(T.RL1_VLC), T.RL1_RUN, T.RL1_LEVEL, T.RL1_LAST),
          RlTable(INTRA_VLC, INTRA_RUN, INTRA_LEVEL, INTRA_LAST),
          RlTable(pairs(T.RL3_VLC), T.RL3_RUN, T.RL3_LEVEL, T.RL3_LAST),
          RlTable(pairs(T.RL4_VLC), T.RL4_RUN, T.RL4_LEVEL, T.RL4_LAST),
          RlTable(INTER_VLC, INTER_RUN, INTER_LEVEL, INTER_LAST)]
    mv = []
    for lens, syms in ((T.MV0_LENS, T.MV0_SYMS), (T.MV1_LENS, T.MV1_SYMS)):
        sym = [(int(v) >> 8, int(v) & 0xFF) if v else None for v in syms]
        mv.append(Vlc(from_lengths(lens), sym, 10))
    inverted = lambda codes: [(c ^ ((1 << n) - 1), n) for c, n in codes]  # noqa: E731
    _TABLES.update(
        rl=rl, mv=mv,
        dc=[[Vlc(pairs(T.DC[t][c]), None, 10) for c in (0, 1)] for t in (0, 1)],
        mb_intra=Vlc(pairs(T.MB_INTRA), None, 9),
        mb_non_intra=[Vlc(pairs(T.MB_NON_INTRA[t]), None, 10) for t in range(4)],
        v2_mb_type=Vlc(pairs(T.V2_MB_TYPE), None, 8),
        v2_cbpc=Vlc(pairs(T.V2_INTRA_CBPC), None, 3),
        v2_dc=[Vlc(inverted(DC_LUMA), None, 11), Vlc(inverted(DC_CHROMA), None, 12)],
        inter_intra=Vlc(pairs(T.INTER_INTRA), None, 3))
    return _TABLES


def decode012(b: Bits) -> int:
    """'0' -> 0, '10' -> 1, '11' -> 2."""
    return b.read(1) + b.read(1) if b.peek(1) else b.read(1)


def _ints(a) -> tuple[int, ...]:
    return tuple(int(x) for x in a)


def _fastdiv(a: int, scale: int) -> int:
    """``ff_msmpeg4_pred_dc``'s x86 division: the high word of a signed
    product with ``ff_inverse[scale]`` (ceil(2^32 / scale))."""
    return (a * -(-(1 << 32) // scale)) >> 32


# -------------------------------------------------------------- the decoder

class Header:
    """A picture header's fields."""

    kind = I_PICTURE
    quant = 0


class MsMpeg4Decoder:
    """FFmpeg's ``msmpeg4v2``, ``msmpeg4v3`` or ``wmv1`` decoder for the
    streams the module's notes list."""

    def __init__(self, codec: str, width: int, height: int, config: bytes = b"",
                 where: str = "<stream>"):
        # ``config``, the container's extradata, is read by WMV2 alone
        self.version = VERSIONS[codec]
        self.where = where
        if width <= 0 or height <= 0:
            raise _corrupt(where, f"a {width}x{height} stream")
        self.width, self.height = width, height
        self.mbw, self.mbh = (width + 15) >> 4, (height + 15) >> 4
        self.ref: Picture | None = None
        self.slice_height = 0
        self.flipflop_rounding = 0
        self.no_rounding = 0
        self.bit_rate = 0
        self.rl_table_index = self.rl_chroma_table_index = 0
        self.dc_table_index = self.mv_table_index = 0
        self.per_mb_rl_table = 0
        v = self.version
        if v == V2:
            self.y_dc, self.c_dc = MPEG1_DC_SCALE, MPEG1_DC_SCALE
            self.scans = (ZIGZAG, ZIGZAG, ALT_HORIZONTAL, ALT_VERTICAL)
        elif v == V3:
            self.y_dc, self.c_dc = _ints(T.OLD_FF_Y_DC_SCALE), _ints(T.WMV1_C_DC_SCALE)
            self.scans = (ZIGZAG, ZIGZAG, ALT_HORIZONTAL, ALT_VERTICAL)
        else:
            self.y_dc, self.c_dc = _ints(T.WMV1_Y_DC_SCALE), _ints(T.WMV1_C_DC_SCALE)
            self.scans = tuple(_ints(s) for s in T.WMV1_SCAN)

    # ------------------------------------------------------------- headers

    def header(self, bits: Bits) -> Header:
        """``ff_msmpeg4_decode_picture_header``."""
        w, v = self.where, self.version
        if bits.size * 8 < self.mbw * self.mbh:
            raise _corrupt(w, f"a picture of {bits.size} bits for {self.mbw * self.mbh} "
                           "macroblocks")
        h = Header()
        kind = bits.read(2)
        if kind > P_PICTURE:
            raise _corrupt(w, f"a picture of type {kind + 1}")
        h.kind = kind
        h.quant = bits.read(5)
        if not h.quant:
            raise _corrupt(w, "a quantiser of 0")
        self.use_skip_mb_code = 0
        self.inter_intra_pred = 0
        if kind == I_PICTURE:
            code = bits.read(5)
            if code < 0x17:
                raise _corrupt(w, f"a slice code of {code}")
            self.slice_height = self.mbh // (code - 0x16)
            if v == V2:
                self.rl_table_index = self.rl_chroma_table_index = 2
                self.dc_table_index = 0
            elif v == V3:
                self.rl_chroma_table_index = decode012(bits)
                self.rl_table_index = decode012(bits)
                self.dc_table_index = bits.read(1)
            else:
                self.ext_header(bits, 4)
                self.per_mb_rl_table = bits.read(1) if self.bit_rate > MBAC_BITRATE else 0
                if not self.per_mb_rl_table:
                    self.rl_chroma_table_index = decode012(bits)
                    self.rl_table_index = decode012(bits)
                self.dc_table_index = bits.read(1)
            self.no_rounding = 1
        else:
            self.use_skip_mb_code = bits.read(1)
            if v == V2:
                self.rl_table_index = self.rl_chroma_table_index = 2
                self.dc_table_index = self.mv_table_index = 0
            elif v == V3:
                self.rl_table_index = self.rl_chroma_table_index = decode012(bits)
                self.dc_table_index = bits.read(1)
                self.mv_table_index = bits.read(1)
            else:
                self.per_mb_rl_table = bits.read(1) if self.bit_rate > MBAC_BITRATE else 0
                if not self.per_mb_rl_table:
                    self.rl_table_index = self.rl_chroma_table_index = decode012(bits)
                self.dc_table_index = bits.read(1)
                self.mv_table_index = bits.read(1)
                self.inter_intra_pred = int(self.width * self.height < 320 * 240
                                            and self.bit_rate <= II_BITRATE)
            self.no_rounding = self.no_rounding ^ 1 if self.flipflop_rounding else 0
        return h

    def ext_header(self, bits: Bits, size: int) -> None:
        """``ff_msmpeg4_decode_ext_header`` with ``size`` bytes in the
        buffer: the frame rate, the bit rate and (v3 on) ``flipflop_rounding``
        where 17 to 24 bits are left (16 to 23 in v2), no flip-flop where
        fewer are."""
        left = size * 8 - bits.pos
        length = 17 if self.version >= V3 else 16
        if length <= left < length + 8:
            bits.read(5)  # frames a second
            self.bit_rate = bits.read(11) * 1024
            self.flipflop_rounding = bits.read(1) if self.version >= V3 else 0
        elif left < length + 8:
            self.flipflop_rounding = 0

    # -------------------------------------------------------------- frames

    def decode(self, packet: bytes) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """One packet (one coded picture) -> its planes."""
        pic = self.parse(packet)
        return [] if pic is None else [self.reconstruct(pic)]

    def parse(self, packet: bytes):
        """A packet's header and macroblocks, entropy-decoded and (where
        WMV1's ``inter_intra_pred`` reads decoded pixels) partly
        reconstructed: the picture, or None where FFmpeg gives no frame."""
        bits = Bits(packet)
        hdr = self.header(bits)
        if hdr is None:
            return None
        if hdr.kind == P_PICTURE and self.ref is None:
            raise _corrupt(self.where, "a P-picture with no picture before it")
        if not self.slice_height:
            raise _refuse(self.where, "a slice height of 0 macroblock rows")
        pic = self.picture(bits, hdr)
        try:
            pic.parse()
        except IndexError:  # a read far past the packet's end
            raise _corrupt(self.where, "the picture's macroblocks run past its packet") from None
        return pic

    def picture(self, bits: Bits, hdr: Header) -> _PictureDecoder:
        return _PictureDecoder(self, bits, hdr)

    def reconstruct(self, pic: _PictureDecoder) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """A parsed picture's remaining macroblocks reconstructed: its Y, Cb
        and Cr planes, cropped; kept as the reference."""
        pic.flush(self.mbw * self.mbh)
        self.ref = pic.out
        h, w = self.height, self.width
        ch, cw = (h + 1) >> 1, (w + 1) >> 1
        return pic.out.y[:h, :w].copy(), pic.out.cb[:ch, :cw].copy(), pic.out.cr[:ch, :cw].copy()


# -------------------------------------------------- one picture's macroblocks

class _PictureDecoder:
    def __init__(self, dec: MsMpeg4Decoder, bits: Bits, hdr: Header):
        self.dec, self.bits, self.hdr = dec, bits, hdr
        self.where = dec.where
        self.version = dec.version
        self.mbw, self.mbh = dec.mbw, dec.mbh
        self.qscale = hdr.quant
        self.p_picture = hdr.kind == P_PICTURE
        self.t = tables()
        self.esc3_level_length = self.esc3_run_length = 0
        mbw, mbh = self.mbw, self.mbh
        self.kinds = [SKIP] * (mbw * mbh)
        self.mv_list = [(0, 0)] * (mbw * mbh)
        self.intra_blocks: list = []
        self.inter_blocks: list = []
        self.mvs = [(0, 0)] * ((mbw + 2) * (mbh + 1))
        # DC and AC predictors (and v3's and WMV1's coded blocks) on the
        # block grids, each with a row above and a column left
        lw, cw = 2 * mbw + 1, mbw + 1
        self.lw, self.cw = lw, cw
        self.dc = [[1024] * (lw * (2 * mbh + 1)), [1024] * (cw * (mbh + 1)),
                   [1024] * (cw * (mbh + 1))]
        self.zero_ac = (0,) * 16
        self.ac = [[self.zero_ac] * (lw * (2 * mbh + 1)), [self.zero_ac] * (cw * (mbh + 1)),
                   [self.zero_ac] * (cw * (mbh + 1))]
        self.coded = [0] * (lw * (2 * mbh + 1))
        self.out = Picture(np.zeros((mbh * 16, mbw * 16), np.uint8),
                           np.zeros((mbh * 8, mbw * 8), np.uint8),
                           np.zeros((mbh * 8, mbw * 8), np.uint8))
        self.done = self.intra_done = self.inter_done = 0
        self.ac_pred = 0
        self.aic_dir = 0

    # ------------------------------------------------------------ slices

    def parse(self) -> None:
        """Every slice's macroblocks (``decode_slice``): ``slice_height``
        rows each, v2's and v3's predictors reset at each, then the
        trailing bits checked as ``decode_slice`` checks them."""
        dec, bits = self.dec, self.bits
        mbw, mbh = self.mbw, self.mbh
        row = 0
        while row < mbh:
            if row and self.version < WMV1:
                self._clean_row_above(row)
            end = min(row + dec.slice_height, mbh)
            for mby in range(row, end):
                for mbx in range(mbw):
                    self.macroblock(mbx, mby, mby == row)
            row = end
        left = bits.size - bits.pos
        extra = 7 + (17 if self.hdr.kind == I_PICTURE else 0)
        if left < 0:
            raise _corrupt(self.where, f"the macroblocks run {-left} bits past the picture")
        if left > extra:
            raise _corrupt(self.where, f"{left} bits left after the picture's macroblocks")
        if self.hdr.kind == I_PICTURE and self.version < WMV1:
            dec.ext_header(bits, bits.size // 8)

    def _clean_row_above(self, row: int) -> None:
        """``ff_mpeg4_clean_buffers`` at a slice's first macroblock: the
        DC and AC predictors of the row above reset."""
        lw, cw = self.lw, self.cw
        base = 2 * row * lw
        for k in range(base - 1, base + lw):
            self.dc[0][k] = 1024
            self.ac[0][k] = self.zero_ac
        base = row * cw
        for c in (1, 2):
            for k in range(base - 1, base + cw):
                self.dc[c][k] = 1024
                self.ac[c][k] = self.zero_ac

    # ------------------------------------------------------- macroblocks

    def macroblock(self, mbx: int, mby: int, first_row: bool) -> None:
        """``msmpeg4v12_decode_mb`` / ``msmpeg4v34_decode_mb``."""
        bits, t, where = self.bits, self.t, self.where
        mb = mby * self.mbw + mbx
        k = (mby + 1) * (self.mbw + 2) + mbx + 1
        if self.version > V2 and bits.pos >= bits.size:
            raise _corrupt(where, f"the picture ends at macroblock {mb}")
        if self.p_picture:
            if self.dec.use_skip_mb_code and bits.read(1):
                self.mvs[k] = (0, 0)
                self._clean(mbx, mby)
                return
            if self.version == V2:
                code = t["v2_mb_type"].read(bits, where, "macroblock type")
                intra, cbp = code >> 2, code & 3
            else:
                code = t["mb_non_intra"][DEFAULT_INTER_INDEX].read(bits, where, "macroblock")
                intra, cbp = not code & 0x40, code & 0x3F
        else:
            intra = True
            if self.version == V2:
                cbp = t["v2_cbpc"].read(bits, where, "cbpc")
            else:
                cbp = self._predict_cbp(t["mb_intra"].read(bits, where, "macroblock"), mbx, mby)
        if not intra:
            if self.version == V2:
                cbpy = read_vlc(bits, _CBPY, 6, where, "CBPY")
                cbp |= cbpy << 2
                if cbp & 3 != 3:
                    cbp ^= 0x3C
            elif self.dec.per_mb_rl_table and cbp:
                self.dec.rl_table_index = self.dec.rl_chroma_table_index = decode012(bits)
            px, py = self._predictor(k, first_row)
            mv = self._motion(px, py)
            self.mvs[k] = self.mv_list[mb] = mv
            self.kinds[mb] = INTER
            self._inter_blocks(mb, cbp)
            self._clean(mbx, mby)
            return
        self.ac_pred = bits.read(1)
        if self.version == V2:
            cbp |= read_vlc(bits, _CBPY, 6, where, "CBPY") << 2
        else:
            if self.dec.inter_intra_pred:
                self.aic_dir = t["inter_intra"].read(bits, where, "inter-intra direction")
            if self.dec.per_mb_rl_table and cbp:
                self.dec.rl_table_index = self.dec.rl_chroma_table_index = decode012(bits)
        self.mvs[k] = (0, 0)
        self.kinds[mb] = INTRA
        self._intra_blocks(mb, mbx, mby, cbp, first_row)

    def _predict_cbp(self, code: int, mbx: int, mby: int) -> int:
        """An I-macroblock's coded blocks: each luma block's bit against
        ``ff_msmpeg4_coded_block_pred`` (the left block's where the top-left
        and top agree, else the top's)."""
        lw, coded = self.lw, self.coded
        cbp = 0
        for n in range(6):
            val = code >> (5 - n) & 1
            if n < 4:
                k = (2 * mby + 1 + (n >> 1)) * lw + 2 * mbx + 1 + (n & 1)
                a, b, c = coded[k - 1], coded[k - 1 - lw], coded[k - lw]
                val ^= a if b == c else c
                coded[k] = val
            cbp |= val << (5 - n)
        return cbp

    def _predictor(self, k: int, first_row: bool) -> tuple[int, int]:
        """``ff_h263_pred_motion``: the left vector in a slice's first row,
        else the median of left, above and above right."""
        mvs, width = self.mvs, self.mbw + 2
        if first_row:
            return mvs[k - 1]
        a, b, c = mvs[k - 1], mvs[k - width], mvs[k - width + 1]
        return sorted((a[0], b[0], c[0]))[1], sorted((a[1], b[1], c[1]))[1]

    def _motion(self, px: int, py: int) -> tuple[int, int]:
        """v2's H.263 vectors (``msmpeg4v2_decode_motion``) or v3's and
        WMV1's table (``ff_msmpeg4_decode_motion``), wrapped to +-63."""
        bits, where = self.bits, self.where
        if self.version == V2:
            return self._v2_component(px), self._v2_component(py)
        sym = self.t["mv"][self.dec.mv_table_index].read(bits, where, "motion vector")
        if sym is None:
            sx, sy = bits.read(6), bits.read(6)
        else:
            sx, sy = sym
        mx, my = sx + px - 32, sy + py - 32
        mx = mx + 64 if mx <= -64 else mx - 64 if mx >= 64 else mx
        my = my + 64 if my <= -64 else my - 64 if my >= 64 else my
        return mx, my

    def _v2_component(self, pred: int) -> int:
        """``msmpeg4v2_decode_motion``: H.263's MVD on the predictor,
        wrapped to +-63 half-pels."""
        code = read_vlc(self.bits, _MVD, 12, self.where, "MVD")
        if not code:
            return pred
        val = pred - code if self.bits.read(1) else pred + code
        return val + 64 if val <= -64 else val - 64 if val >= 64 else val

    def _clean(self, mbx: int, mby: int) -> None:
        """``ff_clean_intra_table_entries``: a non-intra MB's predictors."""
        lw, cw, zero = self.lw, self.cw, self.zero_ac
        for dy in (0, 1):
            base = (2 * mby + 1 + dy) * lw + 2 * mbx + 1
            self.dc[0][base] = self.dc[0][base + 1] = 1024
            self.ac[0][base] = self.ac[0][base + 1] = zero
            self.coded[base] = self.coded[base + 1] = 0
        k = (mby + 1) * cw + mbx + 1
        for c in (1, 2):
            self.dc[c][k] = 1024
            self.ac[c][k] = zero

    # ------------------------------------------------------------ blocks

    def _inter_blocks(self, mb: int, cbp: int) -> None:
        dec = self.dec
        q = self.qscale
        rl = self.t["rl"][3 + dec.rl_table_index]
        run_diff = 0 if self.version == V2 else 1
        for n in range(6):
            if cbp >> (5 - n) & 1:
                coefs, _ = self._coefficients(rl, -1, q << 1, (q - 1) | 1, dec.scans[0], run_diff)
                self.inter_blocks.append((mb, n, coefs))

    def _intra_blocks(self, mb: int, mbx: int, mby: int, cbp: int, first_row: bool) -> None:
        blocks = []
        for n in range(6):
            blocks.append((mb, n, self._intra_block(n, mbx, mby, cbp >> (5 - n) & 1, first_row),
                           self.qscale))
        self.intra_blocks.extend(blocks)

    def _intra_block(self, n: int, mbx: int, mby: int, coded: int, first_row: bool) -> list:
        """``ff_msmpeg4_decode_block``'s intra path: one block's 64 levels in
        raster order, DC and AC predicted, before dequantisation."""
        dec = self.dec
        if n < 4:
            comp, scale = 0, dec.y_dc[self.qscale]
            k = (2 * mby + 1 + (n >> 1)) * self.lw + 2 * mbx + 1 + (n & 1)
            wrap = self.lw
        else:
            comp, scale = n - 3, dec.c_dc[self.qscale]
            k = (mby + 1) * self.cw + mbx + 1
            wrap = self.cw
        level, top = self._dc(n, comp, k, wrap, scale, mbx, mby, first_row)
        if level < 0 and dec.inter_intra_pred:
            level = 0
        if level > 256 * scale and not dec.inter_intra_pred:
            raise _corrupt(self.where, f"an intra DC of {level} at QP {self.qscale}")
        blk = [0] * 64
        blk[0] = level
        if coded:
            index = dec.rl_table_index if n < 4 else 3 + dec.rl_chroma_table_index
            scans = dec.scans
            scan = (scans[2] if top else scans[3]) if self.ac_pred else scans[1]
            coefs, _ = self._coefficients(self.t["rl"][index], 0, 1, 0, scan,
                                          int(self.version >= WMV1))
            for pos, lv in coefs:
                blk[pos] = lv
        acv = self.ac[comp]
        if self.ac_pred:  # ff_mpeg4_pred_ac: the neighbours share the picture's QP
            if top:
                nb = acv[k - wrap]
                for i in range(1, 8):
                    blk[i] += nb[8 + i]
            else:
                nb = acv[k - 1]
                for i in range(1, 8):
                    blk[i << 3] += nb[i]
        acv[k] = (0, *(blk[i << 3] for i in range(1, 8)), 0, *blk[1:8])
        return blk

    def _dc(self, n, comp, k, wrap, scale, mbx, mby, first_row) -> tuple[int, bool]:
        """``msmpeg4_decode_dc``: the DC level, predicted, and whether the
        top block predicted it (else the left); the predictor stored."""
        bits, where = self.bits, self.where
        if self.version == V2:
            size = self.t["v2_dc"][comp > 0].read(bits, where, "DC size")
            level = 0
            if size:
                level = bits.read(size)
                if not level >> (size - 1):
                    level -= (1 << size) - 1
                if size > 8 and not bits.read(1):
                    raise _corrupt(where, f"an invalid DC code at bit {bits.pos}")
                if not -256 <= level <= 255:
                    raise _corrupt(where, f"an invalid DC code at bit {bits.pos}")
        else:
            level = self.t["dc"][self.dec.dc_table_index][comp > 0].read(bits, where, "DC")
            if level == DC_MAX:
                level = bits.read(8)
                if bits.read(1):
                    level = -level
            elif level and bits.read(1):
                level = -level
        dcv = self.dc[comp]
        # (v2's and v3's first-slice-line rule, b = c = 1024 for the top
        # blocks, is what _clean_row_above leaves there)
        a, b, c = dcv[k - 1], dcv[k - 1 - wrap], dcv[k - wrap]
        half = scale >> 1
        a, b, c = _fastdiv(a + half, scale), _fastdiv(b + half, scale), _fastdiv(c + half, scale)
        if self.version <= V3:
            top = abs(a - b) <= abs(b - c)
        elif not self.dec.inter_intra_pred:
            top = abs(a - b) < abs(b - c)
        elif n == 1:
            top = False
        elif n == 2:
            top = True
        elif n == 3:
            top = abs(a - b) < abs(b - c)
        else:
            a, c = self._pixel_dcs(n, mbx, mby, scale)
            d = self.aic_dir
            top = d == 3 or (d == 1 and n == 0) or (d == 2 and n != 0)
        level += c if top else a
        dcv[k] = level * scale
        return level, top

    def _pixel_dcs(self, n: int, mbx: int, mby: int, scale: int) -> tuple[int, int]:
        """WMV1's ``inter_intra_pred`` predictors of block 0 and the chroma
        blocks: the sums of the decoded 8x8 blocks left and above (``get_dc``)
        by eight times the DC scale, or 1024's at the picture's edges."""
        self.flush(mby * self.mbw + mbx)
        plane = self.out.y if n < 4 else (self.out.cb, self.out.cr)[n - 4]
        r, c = (16 * mby, 16 * mbx) if n < 4 else (8 * mby, 8 * mbx)
        s8 = scale * 8
        inv = -(-(1 << 32) // s8)
        edge = (1024 + (scale >> 1)) // scale
        left = edge if mbx == 0 else ((int(plane[r:r + 8, c - 8:c].sum()) + (s8 >> 1)) * inv) >> 32
        top = edge if mby == 0 else ((int(plane[r - 8:r, c:c + 8].sum()) + (s8 >> 1)) * inv) >> 32
        return left, top

    def _coefficients(self, rl: RlTable, i: int, qmul: int, qadd: int, scan,
                      run_diff: int) -> tuple[list, int]:
        """The run/level codes of one block from scan index ``i`` + 1 to its
        last (``ff_msmpeg4_decode_block``'s loop): a list of (raster
        position, level x qmul +- qadd) and the last index."""
        bits, where = self.bits, self.where
        words = bits.words
        table = rl.table
        out = []
        while True:
            p = bits.pos
            e = table[((words[p >> 3] << (p & 7)) & 0xFFFFFFFF) >> 20]
            if e is None:
                e = rl.entry(bits, where)
            run, lv, last, n = e
            p += n
            if run >= 0:
                sign = (words[p >> 3] >> (31 - (p & 7))) & 1
                bits.pos = p + 1
                level = -(lv * qmul + qadd) if sign else lv * qmul + qadd
                i += run + 1
            else:
                esc = ((words[p >> 3] << (p & 7)) & 0xFFFFFFFF) >> 30
                if esc >= 2:  # '1': the level offset by max_level
                    bits.pos = p + 1
                    run, lv, last = self._plain(rl)
                    level = lv * qmul + qadd + rl.max_level[last][run] * qmul
                    i += run + 1
                    if bits.read(1):
                        level = -level
                elif esc == 1:  # '01': the run offset by max_run
                    bits.pos = p + 2
                    run, lv, last = self._plain(rl)
                    level = lv * qmul + qadd
                    i += run + 1 + rl.max_run[last][lv] + run_diff
                    if bits.read(1):
                        level = -level
                else:  # '00': fixed lengths
                    bits.pos = p + 2
                    last, run, level = self._escape3()
                    level = level * qmul + qadd if level > 0 else level * qmul - qadd
                    i += run + 1
                if not -0x8000 <= level <= 0x7FFF:
                    raise _refuse(where, "dequantised coefficients outside 16 bits")
            # FFmpeg ends a block whose index passes 63 ("ignoring overflow")
            if i > 63 or (i == 63 and not last):
                raise _corrupt(where, "a block of more than 64 coefficients")
            out.append((scan[i], level))
            if last:
                return out, i

    def _plain(self, rl: RlTable) -> tuple[int, int, int]:
        run, lv, last, n = rl.entry(self.bits, self.where)
        if run < 0:
            raise _corrupt(self.where, f"an escape after an escape at bit {self.bits.pos}")
        self.bits.pos += n
        return run, lv, last

    def _escape3(self) -> tuple[int, int, int]:
        """The third escape: v2's and v3's last, 6-bit run and signed 8-bit
        level; WMV1's and WMV2's last, then the run and the signed level at
        the lengths the picture's first third escape gives."""
        bits = self.bits
        last = bits.read(1)
        if self.version <= V3:
            run = bits.read(6)
            level = bits.read(8)
            return last, run, level - 256 if level >= 128 else level
        if not self.esc3_level_length:
            if self.qscale < 8:
                ll = bits.read(3)
                if not ll:
                    ll = 8 + bits.read(1)
            else:
                ll = 2
                while ll < 8 and not bits.peek(1):
                    ll += 1
                    bits.pos += 1
                if ll < 8:
                    bits.pos += 1
            self.esc3_level_length = ll
            self.esc3_run_length = bits.read(2) + 3
        run = bits.read(self.esc3_run_length)
        sign = bits.read(1)
        level = bits.read(self.esc3_level_length)
        return last, run, -level if sign else level

    # --------------------------------------------------- reconstruction

    def flush(self, upto: int) -> None:
        """Reconstruct the parsed macroblocks before ``upto`` not yet
        reconstructed, into ``out``."""
        lo = self.done
        if upto <= lo:
            return
        kinds = [k if lo <= m < upto else -1 for m, k in enumerate(self.kinds)]
        intra = [b for b in self.intra_blocks[self.intra_done:] if b[0] < upto]
        inter = [b for b in self.inter_blocks[self.inter_done:] if b[0] < upto]
        ref = self.dec.ref if self.p_picture else None
        self.reconstruct_into(ref, kinds, intra, inter)
        self.done = upto
        self.intra_done += len(intra)
        self.inter_done += len(inter)

    def reconstruct_into(self, ref, kinds, intra, inter) -> None:
        dec = self.dec
        reconstruct(ref, self.mbw, self.mbh, kinds, self.mv_list, intra, inter,
                    dec.no_rounding if self.p_picture else 0, self.where, (dec.y_dc, dec.c_dc),
                    out=self.out)
