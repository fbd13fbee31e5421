"""The macroblock layer of MPEG-1 and MPEG-2 video, in plain Python over the
bit reader: what FFmpeg's ``mpeg_decode_slice``, ``mpeg_decode_mb`` and
the block readers of ``mpeg12dec.c`` / ``mpeg12.c`` read, and the
coefficients dequantised as they dequantise them.

``PictureSyntax(headers, picture, mbw, mbh, mpeg2, where).slice(bits, code)``
reads one slice; the picture's macroblocks are then in ``kind`` (0 not
coded by any slice, 1 predicted, 2 intra), ``direction`` (1 forward, 2
backward, 3 both), ``vectors`` (forward x, y, backward x, y in half
pixels), and its blocks' coefficients, dequantised, in ``intra`` and
``inter`` (``Blocks``: each block's macroblock and number 0-5, and its
nonzero levels' flat positions, block x 64 + raster position, and values):

- macroblock address increments with their escapes (and MPEG-1's
  stuffing). A skipped macroblock of a P-picture is predicted forward at
  vector 0 and resets the vector predictors; of a B-picture it takes the
  previous macroblock's directions and the predictors as its vectors (after
  an intra macroblock FFmpeg fails). A slice's first increment only places
  its first macroblock;
- ``macroblock_type`` (tables B-2 to B-4), ``quantiser_scale_code`` (times
  2, or MPEG-2's non-linear scale under ``q_scale_type`` 1),
  ``frame_motion_type`` and ``dct_type`` where ``frame_pred_frame_dct`` is
  0: frame motion and frame DCT are read, field motion, dual prime and
  field DCT refused at the macroblock that uses them;
- motion vectors: ``motion_code``, the residual of ``f_code - 1`` bits and
  the wrap to ``5 + f_code - 1`` bits; predictors reset at slice starts,
  intra macroblocks (unless they carry concealment vectors, which set the
  forward predictors) and P-pictures' zero-vector macroblocks; MPEG-1's
  ``full_pel`` doubles the vector used, not the predictor;
- ``coded_block_pattern`` (FFmpeg fails on a pattern of 0);
- blocks: the intra DC as a difference (``dct_dc_size`` and its bits) from
  the predictor, which is reset to ``128 << intra_dc_precision`` at slice
  starts and by every non-intra or skipped macroblock; AC coefficients by
  table B-14 (or B-15 for MPEG-2 intra blocks under ``intra_vlc_format``)
  in the zigzag or alternate scan, with MPEG-1's 8/16-bit escapes or
  MPEG-2's 12-bit one; a non-intra block's first coefficient '1s';
  dequantised inline: ``(level * qscale * W) >> 4`` intra and
  ``((2 level + 1) * qscale * W) >> 5`` non-intra, made odd in MPEG-1,
  and in MPEG-2 the mismatch control's parity fixed on coefficient 63 when
  the blocks are laid out (``Blocks.dense``; FFmpeg does not saturate, and
  keeps each level in 16 bits).

Corrupt data (an invalid code, a block past 64 coefficients, a slice past
its row's end or the picture's, bits left over) raises a ValueError naming
ROADMAP.md queue 1, item 4: FFmpeg would conceal it.
"""

from __future__ import annotations

from .mpeg12 import B_TYPE, I_TYPE, P_TYPE, corrupt, refuse, slice_header
from .mpeg12tables import (ADDR_END, ADDR_ESCAPE, ADDR_STUFFING, ALTERNATE, BTYPE_FLAGS, CBP,
                           DC_CHROMA_BITS, DC_CHROMA_CODE, DC_LUMA_BITS, DC_LUMA_CODE, DCT_B14,
                           DCT_B15, DCT_EOB, DCT_ESCAPE, DCT_LEVEL, DCT_RUN, ITYPE_FLAGS,
                           MB_ADDR_INCR, MB_BACKWARD, MB_FORWARD, MB_INTRA, MB_ITYPE,
                           MB_PATTERN, MB_PTYPE, MB_BTYPE, MB_QUANT, MB_ZERO_MV, MOTION,
                           NON_LINEAR_QSCALE, PTYPE_FLAGS, ZIGZAG)

FRAME_MOTION = 2  # frame_motion_type: 1 field, 2 frame, 3 dual prime
MOTION_NAMES = {0: "reserved", 1: "field", 3: "dual-prime"}
ESCAPE, EOB = -1, -2


def vlc(codes, bits: int) -> list:
    """A lookup of ``bits`` bits: (symbol, length) for every prefix of a
    code, None where no code starts."""
    table = [None] * (1 << bits)
    for sym, (code, n) in enumerate(codes):
        code, n = int(code), int(n)
        lo = code << (bits - n)
        for k in range(lo, lo + (1 << (bits - n))):
            table[k] = (sym, n)
    return table


def _dct_table(codes) -> list:
    """16-bit lookup: (run + 1, level, length) of each run/level code,
    (0, ESCAPE, 6) for the escape and (0, EOB, length) for the end of block."""
    out = []
    for sym, e in enumerate(vlc(codes, 16)):
        if e is None:
            out.append(None)
        elif e[0] == DCT_ESCAPE:
            out.append((0, ESCAPE, e[1]))
        elif e[0] == DCT_EOB:
            out.append((0, EOB, e[1]))
        else:
            out.append((int(DCT_RUN[e[0]]) + 1, int(DCT_LEVEL[e[0]]), e[1]))
    return out


_TABLES: dict = {}


def tables() -> dict:
    """The lookups, built at first use."""
    if not _TABLES:
        _TABLES.update(
            addr=vlc(MB_ADDR_INCR, 11), itype=vlc(MB_ITYPE, 2), ptype=vlc(MB_PTYPE, 6),
            btype=vlc(MB_BTYPE, 6), cbp=vlc(CBP, 9), motion=vlc(MOTION, 10),
            dc=(vlc(zip(DC_LUMA_CODE, DC_LUMA_BITS), 9),
                vlc(zip(DC_CHROMA_CODE, DC_CHROMA_BITS), 10)),
            b14=_dct_table(DCT_B14), b15=_dct_table(DCT_B15),
            zigzag=[int(v) for v in ZIGZAG], alternate=[int(v) for v in ALTERNATE],
            nonlinear=[int(v) for v in NON_LINEAR_QSCALE])
    return _TABLES


class Blocks:
    """A picture's intra or non-intra blocks: ``ids`` (macroblock, block)
    of each, and the flat positions and values of their levels."""

    def __init__(self):
        self.ids: list[tuple[int, int]] = []
        self.pos: list[int] = []
        self.val: list[int] = []

    def dense(self, mismatch: bool):
        """``[N, 64]`` int64 levels as FFmpeg's int16_t blocks hold them,
        MPEG-2's mismatch control applied (coefficient 63's low bit flipped
        where the levels' sum is even)."""
        import numpy as np

        coef = np.zeros(64 * len(self.ids), np.int64)
        coef[np.array(self.pos, np.int64)] = self.val
        coef = coef.reshape(-1, 64)
        if mismatch:
            coef[:, 63] ^= (1 + coef.sum(axis=1)) & 1
        return ((coef + 0x8000) & 0xFFFF) - 0x8000


class PictureSyntax:
    """One picture's slices, read (see the module's notes)."""

    def __init__(self, headers, pic, mbw: int, mbh: int, mpeg2: bool, where: str):
        self.t = tables()
        self.h, self.pic = headers, pic
        self.mbw, self.mbh, self.mpeg2 = mbw, mbh, mpeg2
        self.where = where
        n = mbw * mbh
        self.kind = [0] * n
        self.flags = [0] * n
        self.direction = [0] * n
        self.vectors = [(0, 0, 0, 0)] * n
        self.intra = Blocks()
        self.inter = Blocks()
        self.used: set = set()  # what the picture used, for the tests: "alternate_scan", ...
        # when a list: (slice, bit after its macroblock_type, flags) of each coded
        # macroblock, where a stream re-writer inserts macroblock modes
        self.marks: list | None = None
        self.slices = 0
        self.scan = self.t["alternate"] if pic.alternate_scan else self.t["zigzag"]
        self.dc_reset = 128 << pic.intra_dc_precision
        if pic.kind == I_TYPE:
            self.types, self.type_flags, self.type_bits = self.t["itype"], ITYPE_FLAGS, 2
        elif pic.kind == P_TYPE:
            self.types, self.type_flags, self.type_bits = self.t["ptype"], PTYPE_FLAGS, 6
        else:
            self.types, self.type_flags, self.type_bits = self.t["btype"], BTYPE_FLAGS, 6

    # ----------------------------------------------------------- helpers

    def _vlc(self, bits, table, n: int, what: str) -> int:
        e = table[bits.peek(n)]
        if e is None:
            raise corrupt(self.where, f"an invalid {what} code at bit {bits.pos}")
        bits.pos += e[1]
        return e[0]

    def _qscale(self, code: int) -> int:
        if code == 0:
            raise corrupt(self.where, "quantiser_scale_code 0")
        if self.pic.q_scale_type:
            self.used.add("q_scale_type")
            return self.t["nonlinear"][code]
        return code << 1

    def _increment(self, bits) -> int | None:
        """A macroblock address increment less 1 (escapes summed), or None
        at the end of the slice."""
        total = 0
        table = self.t["addr"]
        while True:
            code = self._vlc(bits, table, 11, "macroblock_address_increment")
            if code == ADDR_ESCAPE:
                total += 33
            elif code == ADDR_END:
                if total or bits.peek(15):
                    raise corrupt(self.where, "a slice ending inside an address increment")
                return None
            elif code != ADDR_STUFFING:
                return total + code

    def _motion(self, bits, fcode: int, pred: int) -> int:
        code = self._vlc(bits, self.t["motion"], 10, "motion_code")
        if code == 0:
            return pred
        sign = bits.read(1)
        shift = fcode - 1
        val = code
        if shift:
            val = (((val - 1) << shift) | bits.read(shift)) + 1
        if sign:
            val = -val
        val += pred
        n = 5 + shift
        val &= (1 << n) - 1
        return val - (1 << n) if val >> (n - 1) else val

    def _dc(self, bits, comp: int) -> int:
        size = self._vlc(bits, self.t["dc"][comp > 0], 9 if comp == 0 else 10, "dct_dc_size")
        if size == 0:
            return 0
        v = bits.read(size)
        return v if v >> (size - 1) else v - (1 << size) + 1

    # ------------------------------------------------------------ slices

    def slice(self, bits, code: int) -> None:
        """Read the slice whose start code ``code`` the reader is after."""
        pic, mbw, mbh = self.pic, self.mbw, self.mbh
        self.slices += 1
        mb_y, qcode = slice_header(bits, code, mbh, self.mpeg2)
        if mb_y >= mbh:
            raise corrupt(self.where, f"a slice below the picture (row {mb_y} of {mbh})")
        qscale = self._qscale(qcode)
        first = self._increment(bits)
        if first is None or first >= mbw:
            raise corrupt(self.where, "a slice's first macroblock outside its row")
        mb_x = first
        last_dc = [self.dc_reset] * 3
        last_mv = [0, 0, 0, 0]  # forward x, y, backward x, y
        mv_dir, mv = 0, (0, 0, 0, 0)
        skip_run = 0
        kind, flags_of, direction, vectors = self.kind, self.flags, self.direction, self.vectors
        full_pel, f_code = pic.full_pel, pic.f_code
        b_pic = pic.kind == B_TYPE
        while True:
            if bits.pos > bits.size:
                raise corrupt(self.where, "a slice runs past the end of its data")
            mb = mb_y * mbw + mb_x
            if kind[mb]:
                raise corrupt(self.where, f"macroblock {mb} coded twice")
            skipped = skip_run > 0
            if skipped:
                skip_run -= 1
                prev = flags_of[mb - 1] if mb else 0
                if b_pic:
                    if prev & MB_INTRA:
                        raise corrupt(self.where, "a B-picture's skipped macroblock after an "
                                      "intra one")
                    flags_of[mb] = prev
                else:
                    flags_of[mb] = MB_FORWARD
                kind[mb], direction[mb], vectors[mb] = 1, mv_dir, mv
            else:
                fl = self.type_flags[self._vlc(bits, self.types, self.type_bits,
                                               "macroblock_type")]
                flags_of[mb] = fl
                if self.marks is not None:
                    self.marks.append((self.slices, bits.pos, fl))
                if fl & MB_INTRA:
                    if not pic.frame_pred_frame_dct and bits.read(1):
                        raise refuse(self.where, "field DCT (dct_type 1)")
                    if fl & MB_QUANT:
                        qscale = self._qscale(bits.read(5))
                    if pic.concealment_motion_vectors:
                        self.used.add("concealment_motion_vectors")
                        last_mv[0] = self._motion(bits, f_code[0][0], last_mv[0])
                        last_mv[1] = self._motion(bits, f_code[0][1], last_mv[1])
                        if not bits.read(1):
                            raise corrupt(self.where, "a marker bit missing after concealment "
                                          "motion vectors")
                    else:
                        last_mv = [0, 0, 0, 0]
                    kind[mb] = 2
                    self._intra(bits, mb, qscale, last_dc)
                else:
                    if fl & MB_ZERO_MV:
                        if not pic.frame_pred_frame_dct and bits.read(1):
                            raise refuse(self.where, "field DCT (dct_type 1)")
                        if fl & MB_QUANT:
                            qscale = self._qscale(bits.read(5))
                        last_mv = [0, 0, 0, 0]
                        mv_dir, mv = 1, (0, 0, 0, 0)
                    else:
                        if not pic.frame_pred_frame_dct:
                            motion_type = bits.read(2)
                            if motion_type != FRAME_MOTION:
                                raise refuse(self.where, f"{MOTION_NAMES[motion_type]} motion "
                                             f"(frame_motion_type {motion_type})")
                            self.used.add("frame_motion_type")
                            if fl & MB_PATTERN and bits.read(1):
                                raise refuse(self.where, "field DCT (dct_type 1)")
                        if fl & MB_QUANT:
                            qscale = self._qscale(bits.read(5))
                        mv_dir = (1 if fl & MB_FORWARD else 0) | (2 if fl & MB_BACKWARD else 0)
                        out = list(mv)
                        for i in (0, 1):
                            if mv_dir >> i & 1:
                                x = last_mv[2 * i] = self._motion(bits, f_code[i][0],
                                                                  last_mv[2 * i])
                                y = last_mv[2 * i + 1] = self._motion(bits, f_code[i][1],
                                                                      last_mv[2 * i + 1])
                                if full_pel[i]:
                                    self.used.add("full_pel")
                                    x, y = 2 * x, 2 * y
                                out[2 * i], out[2 * i + 1] = x, y
                        mv = tuple(out)
                    last_dc[0] = last_dc[1] = last_dc[2] = self.dc_reset
                    kind[mb], direction[mb], vectors[mb] = 1, mv_dir, mv
                    if fl & MB_PATTERN:
                        cbp = self._vlc(bits, self.t["cbp"], 9, "coded_block_pattern")
                        if cbp == 0:
                            raise corrupt(self.where, "a coded_block_pattern of 0")
                        self.used.add(f"cbp{cbp}")
                        for n in range(6):
                            if cbp >> (5 - n) & 1:
                                self._inter(bits, mb, n, qscale)
            # the next macroblock
            mb_x += 1
            if mb_x >= mbw:
                mb_x = 0
                mb_y += 1
                if mb_y >= mbh:
                    if skip_run:
                        raise corrupt(self.where, "skipped macroblocks past the picture's end")
                    left = bits.size - bits.pos
                    if left < 0 or (left and bits.peek(min(left, 23))):
                        raise corrupt(self.where, f"{left} bits left after the last macroblock")
                    return
            if not skipped:  # an increment follows every coded macroblock
                inc = self._increment(bits)
                if inc is None:
                    return
                if inc:
                    if pic.kind == I_TYPE:
                        raise corrupt(self.where, "a skipped macroblock in an I-picture")
                    skip_run = inc
                    last_dc = [self.dc_reset] * 3
                    if b_pic:
                        mv = tuple(last_mv)
                    else:
                        mv_dir, mv = 1, (0, 0, 0, 0)
                        last_mv = [0, 0, 0, 0]
                    self.used.add("skipped")

    # ------------------------------------------------------------ blocks

    def _intra(self, bits, mb: int, qscale: int, last_dc: list) -> None:
        """The six intra blocks of a macroblock, dequantised."""
        h, pic = self.h, self.pic
        mpeg2 = self.mpeg2
        if mpeg2 and pic.intra_vlc_format:
            self.used.add("intra_vlc_format")
            table = self.t["b15"]
        else:
            table = self.t["b14"]
        scan = self.scan
        shift = 3 - pic.intra_dc_precision
        words = bits.words
        where = self.where
        blocks = self.intra
        out_pos, out_val = blocks.pos, blocks.val
        for n in range(6):
            comp = 0 if n < 4 else n - 3
            qm = (h.intra if n < 4 else h.chroma_intra) if mpeg2 else h.intra
            dc = last_dc[comp] + self._dc(bits, comp)
            last_dc[comp] = dc
            base = 64 * len(blocks.ids)
            blocks.ids.append((mb, n))
            out_pos.append(base)
            out_val.append(dc << shift if mpeg2 else dc * qm[0])
            i = 0
            while True:
                p = bits.pos
                e = table[((words[p >> 3] << (p & 7)) & 0xFFFFFFFF) >> 16]
                if e is None:
                    raise corrupt(where, f"an invalid DCT coefficient code at bit {p}")
                run, level, length = e
                bits.pos = p + length
                if level == EOB:
                    break
                if level > 0:
                    i += run
                    if i > 63:
                        raise corrupt(where, "a block of more than 64 coefficients")
                    j = scan[i]
                    level = (level * qscale * qm[j]) >> 4
                    if not mpeg2:
                        level = (level - 1) | 1
                    if bits.read(1):
                        level = -level
                else:
                    i += bits.read(6) + 1
                    if i > 63:
                        raise corrupt(where, "a block of more than 64 coefficients")
                    j = scan[i]
                    level = self._escape_level(bits, mpeg2)
                    neg = level < 0
                    level = (abs(level) * qscale * qm[j]) >> 4
                    if not mpeg2:
                        level = (level - 1) | 1
                    if neg:
                        level = -level
                out_pos.append(base + j)
                out_val.append(level)

    def _escape_level(self, bits, mpeg2: bool) -> int:
        if mpeg2:
            v = bits.read(12)
            return v - 4096 if v >= 2048 else v
        v = bits.read(8)
        if v == 128:
            return bits.read(8) - 256
        if v == 0:
            return bits.read(8)
        return v - 256 if v > 128 else v

    def _inter(self, bits, mb: int, n: int, qscale: int) -> None:
        """One coded non-intra block, dequantised."""
        h = self.h
        mpeg2 = self.mpeg2
        qm = (h.inter if n < 4 else h.chroma_inter) if mpeg2 else h.inter
        table = self.t["b14"]
        scan = self.scan
        words = bits.words
        where = self.where
        blocks = self.inter
        base = 64 * len(blocks.ids)
        blocks.ids.append((mb, n))
        i = -1
        p = bits.pos
        if (words[p >> 3] << (p & 7)) & 0x80000000:  # '1s': run 0, level 1
            level = (3 * qscale * qm[0]) >> 5
            if not mpeg2:
                level = (level - 1) | 1
            if (words[p >> 3] << (p & 7)) & 0x40000000:
                level = -level
            blocks.pos.append(base)
            blocks.val.append(level)
            i = 0
            bits.pos = p + 2
        else:
            i = self._inter_coefficient(bits, table, scan, qm, qscale, mpeg2, blocks, base, i)
        while True:
            p = bits.pos
            if ((words[p >> 3] << (p & 7)) & 0xC0000000) == 0x80000000:  # '10': end of block
                bits.pos = p + 2
                return
            i = self._inter_coefficient(bits, table, scan, qm, qscale, mpeg2, blocks, base, i)

    def _inter_coefficient(self, bits, table, scan, qm, qscale, mpeg2, blocks, base, i) -> int:
        p = bits.pos
        words = bits.words
        e = table[((words[p >> 3] << (p & 7)) & 0xFFFFFFFF) >> 16]
        if e is None or e[1] == EOB:
            raise corrupt(self.where, f"an invalid DCT coefficient code at bit {p}")
        run, level, length = e
        bits.pos = p + length
        if level > 0:
            i += run
            if i > 63:
                raise corrupt(self.where, "a block of more than 64 coefficients")
            j = scan[i]
            level = ((2 * level + 1) * qscale * qm[j]) >> 5
            if not mpeg2:
                level = (level - 1) | 1
            if bits.read(1):
                level = -level
        else:
            i += bits.read(6) + 1
            if i > 63:
                raise corrupt(self.where, "a block of more than 64 coefficients")
            j = scan[i]
            level = self._escape_level(bits, mpeg2)
            neg = level < 0
            level = ((2 * abs(level) + 1) * qscale * qm[j]) >> 5
            if not mpeg2:
                level = (level - 1) | 1
            if neg:
                level = -level
        blocks.pos.append(base + j)
        blocks.val.append(level)
        return i
