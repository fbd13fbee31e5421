"""An H.263 (ITU-T H.263, baseline) and Sorenson H.263 decoder in numpy and
plain Python, bit for bit what FFmpeg's ``h263`` decoder
(``ituh263dec.c``, ``h263dec.c``, ``mpegvideo``) and ``flv`` decoder
(``flvdec.c::ff_flv_decode_picture_header`` on the same macroblock layer)
give for the streams FFmpeg's ``h263`` and ``flv`` encoders write through
``cv2.VideoWriter``.

``H263Decoder(flavour, where)`` (``flavour`` ``"h263"`` or ``"flv"``) and
``decode(packet)`` return each picture's Y, Cb and Cr planes (4:2:0, cropped
to the picture, limited range), as ``Mpeg4Decoder`` does:

- H.263 picture headers: the 22-bit picture start code, found at any byte
  of the packet as FFmpeg searches for it; TR; PTYPE with the five
  standard source formats (sub-QCIF 128x96, QCIF 176x144, CIF 352x288, 4CIF
  704x576, 16CIF 1408x1152), I and P; PQUANT. GOB headers (the 17-bit
  GBSC after stuffing zeros, GN, GFID, GQUANT), which FFmpeg's encoder
  writes where it codes a picture in slices: FFmpeg ends a slice where the
  next 16 bits are 0 after a macroblock and resumes at the GOB GN names
  (``gob_index`` macroblock rows a GOB: 1 up to 400 lines, 2 up to 800,
  else 4); the motion vector predictor takes the first macroblock row of
  every slice as the picture's first (``ff_h263_pred_motion``'s
  ``first_slice_line``);
- Sorenson H.263 picture headers: the 17-bit start code, the 5-bit
  version (0: H.263's escape; 1, what FFmpeg's encoder writes: a flag
  choosing a 7- or 11-bit escaped level), TR, the size (the presets, or
  8- or 16-bit width and height), the picture type (I, P, or disposable P,
  which is not kept as a reference and gives no frame before the first
  reference, as in FFmpeg), the deblocking flag (read and ignored) and
  the quantiser;
- macroblocks: COD, MCBPC (with stuffing), CBPY, DQUANT, MVD on the
  median (or first-row) predictor wrapped to [-16, 15.5] pixels, the intra
  DC as an 8-bit FLC (255 read as 128), AC and inter coefficients on the
  TCOEF table with the escapes above, ``dct_unquantize_h263`` (the DC by
  8), ``jpeg.idct_simple`` / ``idct_simple_add``, and half-pel motion
  compensation at rounding 0 with H.263's chroma vector, the reference's
  edges at the macroblock grid's (``mpeg4.reconstruct``).

The tables, the bit reader, the VLC and MVD readers and the reconstruction
are ``mpeg4.py``'s: MPEG-4 Part 2 took them from H.263.

Refused, each with a ValueError naming ROADMAP.md queue 1, item 4:
PLUSPTYPE (H.263+ and its annexes), PB-frames, unrestricted motion vectors
(Annex D), syntax-based arithmetic coding (Annex E), advanced prediction
(Annex F, OBMC and four vectors), continuous presence multipoint, PEI
extra information, inter4v macroblocks, a picture size that changes, a
P-picture with no picture before it, dequantised coefficients outside 16
bits, and corrupt pictures (which FFmpeg conceals).
"""

from __future__ import annotations

import numpy as np

from .imgcodecs import ROADMAP, VIDEO_READS
from .mpeg4 import (_CBPY, _INTER_MCBPC, _INTER_TC, _INTRA_MCBPC, DQUANT, ZIGZAG, Bits, Picture,
                    read_motion, read_vlc, reconstruct)

# ff_h263_format: PTYPE's source formats 1-5
FORMATS = {1: (128, 96), 2: (176, 144), 3: (352, 288), 4: (704, 576), 5: (1408, 1152)}
# flvdec.c: the size codes 2-6 (0 and 1 are 8- and 16-bit width and height)
FLV_SIZES = {2: (352, 288), 3: (176, 144), 4: (128, 96), 5: (320, 240), 6: (160, 120)}
I_PICTURE, P_PICTURE = 0, 1
PSC = 0x20  # the 22-bit picture start code; Sorenson's is its first 17 bits, 1
DC_SCALES = ((8,) * 32, (8,) * 32)  # ff_mpeg1_dc_scale_table, luma and chroma
SKIP, INTER, INTRA = 0, 1, 2


def _refuse(where: str, what: str) -> ValueError:
    return ValueError(f"{where}: {what}, which the port's H.263 decoder does not read; "
                      f"{VIDEO_READS} ({ROADMAP})")


def _corrupt(where: str, what: str) -> ValueError:
    return ValueError(f"{where}: corrupt H.263 video: {what}; {VIDEO_READS} ({ROADMAP})")


def gob_rows(height: int) -> int:
    """``H263_GOB_HEIGHT``: macroblock rows a GOB."""
    return 1 if height <= 400 else 2 if height <= 800 else 4


class Header:
    """A picture header's fields."""

    kind = I_PICTURE
    quant = 0
    width = height = 0
    droppable = False
    flv_version = 0  # Sorenson's version 1: the 7/11-bit escape


class H263Decoder:
    """FFmpeg's ``h263`` (``flavour`` ``"h263"``) or ``flv`` decoder for the
    streams the module's notes list."""

    def __init__(self, flavour: str = "h263", where: str = "<stream>"):
        self.flv = flavour == "flv"
        self.where = where
        self.ref: Picture | None = None
        self.size: tuple[int, int] | None = None
        self.log: list | None = None  # a list: each picture's Header and slices kept

    # ------------------------------------------------------------- headers

    def header(self, bits: Bits) -> Header:
        """The picture header, the reader left at the first macroblock."""
        h = self._flv_header(bits) if self.flv else self._h263_header(bits)
        if self.size is None:
            self.size = (h.width, h.height)
        elif self.size != (h.width, h.height):
            raise _refuse(self.where, f"a {h.width}x{h.height} picture in a stream of "
                          f"{self.size[0]}x{self.size[1]}")
        if bits.read(1):  # PEI
            raise _refuse(self.where, "PEI extra information in a picture header")
        return h

    def _h263_header(self, bits: Bits) -> Header:
        w = self.where
        data = bits.data
        k = data.find(b"\x00\x00")
        while k >= 0 and (k + 2 >= len(data) or data[k + 2] & 0xFC != 0x80):
            k = data.find(b"\x00\x00", k + 1)
        if k < 0:
            raise _corrupt(w, "no picture start code")
        bits.pos = 8 * k + 22
        h = Header()
        bits.read(8)  # TR
        if not bits.read(1):
            raise _corrupt(w, "a PTYPE marker bit of 0")
        if bits.read(1):
            raise _corrupt(w, "a PTYPE H.263 id bit of 1")
        bits.read(3)  # split screen, document camera, freeze picture release
        fmt = bits.read(3)
        if fmt in (6, 7):
            raise _refuse(w, "a PLUSPTYPE picture (H.263+, source format 7)" if fmt == 7 else
                          "source format 6 (which FFmpeg reads as PLUSPTYPE)")
        if fmt == 0:
            raise _corrupt(w, "the forbidden source format 0")
        h.width, h.height = FORMATS[fmt]
        h.kind = bits.read(1)
        if bits.read(1):
            raise _refuse(w, "unrestricted motion vectors (Annex D)")
        if bits.read(1):
            raise _refuse(w, "syntax-based arithmetic coding (Annex E)")
        if bits.read(1):
            raise _refuse(w, "advanced prediction (Annex F: OBMC and four vectors)")
        if bits.read(1):
            raise _refuse(w, "PB-frames (Annex G)")
        h.quant = bits.read(5)
        if h.quant == 0:
            raise _corrupt(w, "PQUANT 0")
        if bits.read(1):
            raise _refuse(w, "continuous presence multipoint (CPM)")
        return h

    def _flv_header(self, bits: Bits) -> Header:
        w = self.where
        h = Header()
        if bits.read(17) != 1:
            raise _corrupt(w, "no Sorenson H.263 picture start code")
        h.flv_version = bits.read(5)
        if h.flv_version > 1:
            raise _corrupt(w, f"a Sorenson H.263 version {h.flv_version}")
        bits.read(8)  # TR
        size = bits.read(3)
        if size in (0, 1):
            n = 8 << size
            h.width, h.height = bits.read(n), bits.read(n)
        elif size in FLV_SIZES:
            h.width, h.height = FLV_SIZES[size]
        if not h.width or not h.height:
            raise _corrupt(w, f"a {h.width}x{h.height} picture (size code {size})")
        kind = bits.read(2)
        h.kind = min(kind, P_PICTURE)
        h.droppable = kind > P_PICTURE
        bits.read(1)  # deblocking flag: FFmpeg reads it and filters nothing
        h.quant = bits.read(5)
        if h.quant == 0:
            raise _corrupt(w, "a quantiser of 0")
        return h

    # -------------------------------------------------------------- frames

    def decode(self, packet: bytes) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """One packet (one coded picture) -> its planes: one frame, or none
        for a disposable picture with no reference before it."""
        pic = self.parse(packet)
        return [] if pic is None else [self.reconstruct(pic)]

    def parse(self, packet: bytes) -> _PictureDecoder | None:
        """A packet's header and macroblocks, entropy-decoded (``decode``'s
        first half): the picture, or None where FFmpeg gives no frame."""
        bits = Bits(packet)
        hdr = self.header(bits)
        if hdr.kind == P_PICTURE and self.ref is None:
            if hdr.droppable:
                return None  # h263dec.c: no reference, no disposable picture
            raise _corrupt(self.where, "a P-picture with no picture before it")
        pic = _PictureDecoder(self, bits, hdr)
        pic.parse()
        if self.log is not None:
            self.log.append((hdr, pic.slices))
        return pic

    def reconstruct(self, pic: _PictureDecoder) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """A parsed picture dequantised, through the IDCT and motion
        compensated (``decode``'s second half): its Y, Cb and Cr planes,
        cropped; kept as the reference unless disposable."""
        hdr = pic.hdr
        ref = self.ref if hdr.kind == P_PICTURE else None
        out = reconstruct(ref, pic.mbw, pic.mbh, pic.kinds, pic.mv_list, pic.intra_blocks,
                          pic.inter_blocks, 0, self.where, DC_SCALES)
        if not hdr.droppable:
            self.ref = out
        h, w = hdr.height, hdr.width
        ch, cw = (h + 1) >> 1, (w + 1) >> 1
        return out.y[:h, :w].copy(), out.cb[:ch, :cw].copy(), out.cr[:ch, :cw].copy()


# -------------------------------------------------- one picture's macroblocks

class _PictureDecoder:
    def __init__(self, dec: H263Decoder, bits: Bits, hdr: Header):
        self.dec, self.bits, self.hdr = dec, bits, hdr
        self.where = dec.where
        self.mbw, self.mbh = (hdr.width + 15) >> 4, (hdr.height + 15) >> 4
        self.slices: list[tuple[int, int]] = []  # (first MB row, QP) of each slice

    def parse(self) -> None:
        """Every slice's macroblocks (``decode_slice`` and ``ff_h263_resync``):
        modes, vectors and coefficients."""
        mbw, mbh = self.mbw, self.mbh
        self.kinds = [SKIP] * (mbw * mbh)
        self.mv_list = [(0, 0)] * (mbw * mbh)
        self.intra_blocks, self.inter_blocks = [], []  # as mpeg4.reconstruct takes them
        # each MB's vector, with a row above and a column each side of zeros
        self.mvs = [(0, 0)] * ((mbw + 2) * (mbh + 1))
        row, quant = 0, self.hdr.quant
        while True:
            self.slices.append((row, quant))
            row, quant = self._slice(row, quant)
            if row >= mbh:
                break
            row, quant = self._gob_header(row)

    def _gob_header(self, row: int) -> tuple[int, int]:
        """``h263_decode_gob_header`` where the slice ended (FFmpeg searches
        on for one only to conceal what it skips): the next slice's first
        row and QP."""
        bits, w = self.bits, self.where
        if self.dec.flv or bits.peek(16):
            raise _corrupt(w, f"the picture's data ends at macroblock row {row} of {self.mbh}")
        bits.skip(16)
        left = min(bits.size - bits.pos, 32)
        while left > 13 and not bits.read(1):  # GSTUFF's zeros, then GBSC's 1
            left -= 1
        if left <= 13:
            raise _corrupt(w, f"no GOB header after macroblock row {row - 1}")
        gn = bits.read(5)
        bits.read(2)  # GFID
        quant = bits.read(5)
        first = gn * gob_rows(self.hdr.height)
        if first != row or quant == 0:
            raise _corrupt(w, f"a GOB header of GN {gn} and GQUANT {quant} after macroblock "
                           f"row {row - 1}")
        return first, quant

    def _slice(self, first: int, quant: int) -> tuple[int, int]:
        """The macroblocks from row ``first`` up to the slice's end (the
        next 16 bits 0 after a macroblock) or the picture's: returns the row
        after it and the QP in force."""
        bits = self.bits
        mbw, mbh = self.mbw, self.mbh
        where = self.where
        p_picture = self.hdr.kind == P_PICTURE
        mvs, width = self.mvs, mbw + 2
        for mby in range(first, mbh):
            for mbx in range(mbw):
                mb = mby * mbw + mbx
                if bits.pos >= bits.size:
                    raise _corrupt(where, f"the picture ends at macroblock {mb}")
                if p_picture:
                    while True:
                        if bits.read(1):  # COD: skipped
                            sym = None
                            break
                        sym = read_vlc(bits, _INTER_MCBPC, 9, where, "MCBPC")
                        if sym != 20:
                            break
                    if sym is not None and sym & 16:
                        raise _refuse(where, "an inter4v macroblock")
                    intra = sym is not None and bool(sym & 4)
                    dquant = sym is not None and sym & 8
                else:
                    while True:
                        sym = read_vlc(bits, _INTRA_MCBPC, 9, where, "MCBPC")
                        if sym != 8:
                            break
                    intra, dquant = True, sym & 4
                k = (mby + 1) * width + mbx + 1
                if sym is None:
                    mvs[k] = (0, 0)
                elif intra:
                    cbp = read_vlc(bits, _CBPY, 6, where, "CBPY") << 2 | sym & 3
                    if dquant:
                        quant = min(max(quant + DQUANT[bits.read(2)], 1), 31)
                    self.kinds[mb] = INTRA
                    mvs[k] = (0, 0)
                    for n in range(6):
                        self.intra_blocks.append((mb, n, self._intra_block(cbp >> (5 - n) & 1),
                                                  quant))
                else:
                    cbp = (read_vlc(bits, _CBPY, 6, where, "CBPY") ^ 15) << 2 | sym & 3
                    if dquant:
                        quant = min(max(quant + DQUANT[bits.read(2)], 1), 31)
                    # ff_h263_pred_motion: the left vector alone in a slice's
                    # first row (0 for its first MB), else the median of left,
                    # above and above right (0 past the picture's edges)
                    if mby == first:
                        px, py = mvs[k - 1]
                    else:
                        a, b, c = mvs[k - 1], mvs[k - width], mvs[k - width + 1]
                        px = sorted((a[0], b[0], c[0]))[1]
                        py = sorted((a[1], b[1], c[1]))[1]
                    mv = (read_motion(bits, px, 1, where), read_motion(bits, py, 1, where))
                    mvs[k] = self.mv_list[mb] = mv
                    self.kinds[mb] = INTER
                    qmul, qadd = quant << 1, (quant - 1) | 1
                    for n in range(6):
                        if cbp >> (5 - n) & 1:
                            self.inter_blocks.append((mb, n, self._coefficients(0, qmul, qadd)))
                # the per-MB end of slice check: the next 16 bits 0
                left = bits.size - bits.pos
                v = bits.peek(16) if left >= 16 else 0 if left <= 0 else bits.peek(left)
                if v == 0:
                    if (mb + 1) % mbw:
                        raise _corrupt(where, f"a slice ends inside macroblock row {mby}")
                    return mby + 1, quant
        return mbh, quant

    def _intra_block(self, coded: int) -> list:
        """One intra block's levels in raster order (the DC's 8-bit FLC, then
        the TCOEFs when ``coded``), before dequantisation."""
        dc = self.bits.read(8)
        blk = [0] * 64
        blk[0] = 128 if dc == 255 else dc
        if coded:
            for pos, lv in self._coefficients(1, 1, 0):
                blk[pos] = lv
        return blk

    def _coefficients(self, first: int, qmul: int, qadd: int) -> list:
        """TCOEF codes from scan index ``first`` up to the last one
        (``h263_decode_block``): a list of (raster position, level x qmul +-
        qadd, or the level itself when qmul is 1 and qadd 0)."""
        table = _INTER_TC[0]
        bits = self.bits
        words = bits.words
        flv = self.dec.flv and self.hdr.flv_version == 1
        out = []
        i = first - 1
        while True:
            p = bits.pos
            e = table[((words[p >> 3] << (p & 7)) & 0xFFFFFFFF) >> 20]
            if e is None:
                raise _corrupt(self.where, f"an invalid TCOEF code at bit {p}")
            if e == "esc":
                bits.pos = p + 7
                if flv:  # a flag, then LAST, RUN and a 7- or 11-bit level
                    long = bits.read(1)
                    last, run = bits.read(1), bits.read(6)
                    level = bits.read(11 if long else 7)
                    if level >> (10 if long else 6):
                        level -= 1 << (11 if long else 7)
                else:  # LAST, RUN, an 8-bit level; -128: 5 bits, then 6 signed
                    last, run, level = bits.read(1), bits.read(6), bits.read(8)
                    if level == 128:
                        lo, hi = bits.read(5), bits.read(6)
                        level = lo | (hi - 64 if hi >> 5 else hi) << 5
                    elif level > 128:
                        level -= 256
                if level:
                    level = level * qmul + qadd if level > 0 else level * qmul - qadd
                    if not -0x8000 <= level <= 0x7FFF:
                        raise _refuse(self.where, "dequantised coefficients outside 16 bits")
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
            out.append((ZIGZAG[i], level))
            if last:
                return out
