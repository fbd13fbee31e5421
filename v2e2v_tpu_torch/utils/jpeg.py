"""JPEG frames with numpy and plain Python: gray still images as libjpeg
decodes them, and colour MJPEG video frames as FFmpeg decodes them.

``decode_jpeg_gray`` returns what ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``
returns for a JPEG file, bit for bit: libjpeg's ``JCS_GRAYSCALE`` output, which
is the decoded Y plane (``jdcolor.c::grayscale_convert``), then the EXIF
orientation as OpenCV applies it. Neither cv2 nor PIL is installed beside the
port on the card's machine, so the port carries its own decoder. It follows
libjpeg-turbo's sources:

- markers as ``jdmarker.c`` reads them: SOI, APPn (APP0 ``JFIF``, APP1
  ``Exif``, APP14 ``Adobe``), COM, DQT (8- and 16-bit), DHT, DRI, SOF0/SOF1
  (Huffman sequential) and SOF2 (Huffman progressive) at 8 bits, SOS, RST0-7
  and EOI;
- one component, or three as YCbCr (JFIF, Adobe transform 1, or neither
  marker as ``jdapimin.c::default_decompress_parms`` guesses); the Y
  component must have the largest sampling factors, so its plane needs no
  upsampling; chroma blocks are Huffman-decoded and dropped, and a scan of a
  chroma component alone is skipped;
- baseline entropy decoding as ``jdhuff.c`` does it, through 16-bit
  lookahead tables; progressive decoding as ``jdphuff.c`` does it;
- dequantisation and ``jidctint.c::jpeg_idct_islow`` in integers over every
  block at once, the samples through ``jdmaster.c::prepare_range_limit_table``.

What it does not read raises a ValueError that names what is missing:
arithmetic coding, lossless and hierarchical frames, 12-bit samples, four
components (CMYK/YCCK), RGB (Adobe transform 0), a Y component below the
largest sampling factors, a DNL marker, a progressive file that libjpeg
would smooth (``jdcoefct.c::smoothing_ok``), and truncated or corrupt
entropy-coded data (which libjpeg pads with zeros, with a warning). It also
refuses coefficients and IDCT values outside the range where libjpeg-turbo's
C IDCT and its SIMD one (16-bit lanes, saturating packs) agree, which no
encoder's output reaches.

``decode_mjpeg_frame`` (below, for ``utils/video.py``) shares the markers and
the entropy decoding, baseline and progressive, keeps every component's
blocks, and takes FFmpeg's DC offset and IDCT instead of libjpeg's; FFmpeg
does not smooth a progressive frame's blocks, so neither does it.
"""

from __future__ import annotations

import array
import functools
import re

import numpy as np

from .imgcodecs import ROADMAP, apply_orientation, exif_orientation

# zigzag index -> natural (row-major) index, jutils.c::jpeg_natural_order
NATURAL = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
           41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15,
           23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)

# jidctint.c at CONST_BITS = 13: FIX(x) = round(x * 2^13)
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172

_ZIGZAG = np.argsort(NATURAL)  # natural index -> zigzag index

RANGE_MASK = 1023  # MAXJSAMPLE * 4 + 3


def _range_limit_table() -> np.ndarray:
    """``jdmaster.c::prepare_range_limit_table`` as the IDCT indexes it:
    ``table[x & RANGE_MASK]`` for an output ``x`` before the +128 shift."""
    x = np.arange(RANGE_MASK + 1)
    out = np.zeros(RANGE_MASK + 1, np.uint8)
    out[x < 128] = 128 + x[x < 128]
    out[(x >= 128) & (x < 512)] = 255
    out[x >= 896] = x[x >= 896] - 896
    return out


_RANGE_LIMIT = _range_limit_table()

_SOF_REFUSED = {
    0xC3: "lossless (SOF3) coding",
    0xC5: "hierarchical (SOF5) coding", 0xC6: "hierarchical (SOF6) coding",
    0xC7: "hierarchical (SOF7) coding",
    0xC9: "arithmetic coding (SOF9)", 0xCA: "arithmetic coding (SOF10)",
    0xCB: "arithmetic coding (SOF11)",
    0xCD: "hierarchical arithmetic coding (SOF13)",
    0xCE: "hierarchical arithmetic coding (SOF14)",
    0xCF: "hierarchical arithmetic coding (SOF15)",
    0xCC: "arithmetic coding (a DAC marker)",
    0xDE: "hierarchical coding (a DHP marker)", 0xDF: "hierarchical coding (an EXP marker)",
    0xDC: "a DNL marker (the height given after the first scan)",
}

_MARKER_RE = re.compile(rb"\xff+[^\x00\xff]")
_STUFFED_RE = re.compile(rb"\xff+\x00")


def _refuse(path: str, what: str) -> ValueError:
    return ValueError(f"{path}: {what} is not supported by the port's JPEG decoder ({ROADMAP})")


def _corrupt(path: str, what: str) -> ValueError:
    return ValueError(f"{path}: corrupt or truncated JPEG: {what}; libjpeg would pad or "
                      f"resynchronise it with a warning, the port's decoder refuses it "
                      f"({ROADMAP})")


FAST = 1 << 9  # a lookahead entry that holds the extra bits' value too
# jdhuff.c's HUFF_EXTEND of every s-bit value, for s = 0..15
_EXTENDED = [np.where(np.arange(1 << s) < (1 << s) >> 1, np.arange(1 << s) - (1 << s) + 1,
                      np.arange(1 << s)) for s in range(16)]


@functools.lru_cache(maxsize=16)
def _lookahead(spec: bytes, is_dc: bool) -> array.array:
    """The 16-bit lookahead table of a DHT table (``spec``: its 16 counts,
    then its symbols): at every 16-bit word that starts with a code, bits 0-4
    hold the bits to consume, bits 5-8 the run ``r`` (AC), and either
    ``FAST`` with the extended value from bit 10 (the code and its ``s``
    extra bits fit in the 16), or ``s`` from bit 10 (read the extra bits
    apart; for AC ``s == 0`` is EOB or ZRL). 0 where no code starts. The
    codes are ``jdhuff.c::jpeg_make_d_derived_tbl``'s."""
    counts, symbols = spec[:16], spec[16:]
    blocks = []
    code, k = 0, 0
    for n in range(1, 17):
        for _ in range(counts[n - 1]):
            sym = symbols[k]
            if is_dc and sym > 15:
                raise ValueError(f"a DC Huffman symbol {sym} above 15")
            r, s = (0, sym) if is_dc else (sym >> 4, sym & 15)
            if n + s <= 16 and (s or is_dc):  # every value of the extra bits
                blocks.append(np.repeat((_EXTENDED[s] << 10) | (FAST | (r << 5) | (n + s)),
                                        1 << (16 - n - s)))
            else:
                blocks.append(np.full(1 << (16 - n), (s << 10) | (r << 5) | n, np.int64))
            code += 1
            k += 1
        if code >= 1 << n:  # no code may be all ones
            raise ValueError("a Huffman table with too many codes")
        code <<= 1
    table = np.zeros(1 << 16, np.int64)  # the codes in order fill it from the start
    if blocks:
        filled = np.concatenate(blocks)
        table[:len(filled)] = filled
    return array.array("q", table.tobytes())


def _lookahead_words(seg: bytes) -> array.array:
    """The 16 bits at every bit offset ``p`` of ``seg`` (zeros past its end),
    at index ``p``: one subscript per Huffman lookup, and ``n <= 16`` bits
    are ``look[p] >> (16 - n)``."""
    n = len(seg)
    a = np.zeros(n + 3, np.uint32)
    a[:n] = np.frombuffer(seg, np.uint8)
    w24 = (a[:n + 1] << 16) | (a[1:n + 2] << 8) | a[2:n + 3]
    words = np.empty((n + 1, 8), np.uint16)
    for k in range(8):
        words[:, k] = (w24 >> (8 - k)) & 0xFFFF
    return array.array("H", words.tobytes())


class _Component:
    """One SOF component. ``base`` is the zz offset of its first block and
    ``gw`` its block grid's width (MCU-padded); ``base`` is None for a
    component whose blocks are written to the scratch block and forgotten."""

    __slots__ = ("cid", "index", "h", "v", "tq", "qtable", "base", "gw", "gh")

    def __init__(self, cid, index, h, v, tq):
        self.cid, self.index, self.h, self.v, self.tq = cid, index, h, v, tq
        self.qtable = None
        self.base = self.gw = self.gh = None


class _Scan:
    """What one SOS names: its components with their table ids, and its
    spectral selection and successive approximation."""

    def __init__(self, comps, ss, se, ah, al):
        self.comps, self.ss, self.se, self.ah, self.al = comps, ss, se, ah, al


def _wrap16(v: int) -> int:
    """``(JCOEF)v``: a coefficient is 16 bits."""
    return v if -0x8000 <= v <= 0x7FFF else ((v + 0x8000) & 0xFFFF) - 0x8000


STRIDE = 80  # per block: 64 coefficients in zigzag order, then room for a run past the end


class _Decoder:
    """One file's decode. The coefficients live in ``zz``, a flat array of
    ``STRIDE`` slots per block in zigzag order: the Y component's blocks, then
    (with ``colour``) each chroma component's, then one more block where the
    blocks of components that are not kept are written and forgotten; a
    corrupt run past a block's end lands in its last 16 slots, which must
    stay 0. ``tables`` gives the DC, AC and quantization tables in force
    before the first marker (a video decoder's, which persist from frame to
    frame)."""

    def __init__(self, data: bytes, path: str, colour: bool = False,
                 tables: tuple[dict, dict, dict] | None = None):
        self.data, self.path, self.colour = data, path, colour
        dc, ac, q = tables if tables is not None else ({}, {}, {})
        self.dc_tables: dict[int, array.array] = dict(dc)
        self.ac_tables: dict[int, array.array] = dict(ac)
        self.qtables: dict[int, np.ndarray] = dict(q)
        self.restart = 0
        self.comps: list[_Component] = []
        self.progressive = None
        self.jfif = False
        self.adobe = None
        self.exif: list[bytes] = []  # the APP1 Exif segments before the first scan
        self.scans = 0
        self.y_scans = 0

    # ----------------------------------------------------------- markers

    def segment(self, pos: int) -> tuple[bytes, int]:
        data = self.data
        if pos + 2 > len(data):
            raise _corrupt(self.path, "a marker segment past the end of the file")
        length = (data[pos] << 8) | data[pos + 1]
        if length < 2 or pos + length > len(data):
            raise _corrupt(self.path, "a marker segment's length runs past the end of the file")
        return data[pos + 2:pos + length], pos + length

    def decode(self) -> np.ndarray:
        self.read()
        return self.output()

    def read(self) -> None:
        """Every marker to EOI: the tables, the frame header and the scans'
        coefficients."""
        data, path = self.data, self.path
        if data[:2] != b"\xff\xd8":
            raise ValueError(f"{path}: not a JPEG file")
        pos = 2
        self.end = len(data)  # where EOI ends: a second field may follow it
        while True:
            # libjpeg skips bytes before a marker with a warning, and reads
            # the end of the file as EOI
            m = _MARKER_RE.search(data, pos)
            if m is None:
                break
            marker, pos = data[m.end() - 1], m.end()
            if marker == 0xD9:
                self.end = pos
                break
            if marker in _SOF_REFUSED:
                raise _refuse(path, _SOF_REFUSED[marker])
            if 0xD0 <= marker <= 0xD7 or marker == 0x01:  # parameterless, ignored
                continue
            if marker == 0xD8:
                raise _corrupt(path, "a second SOI marker")
            if not (marker in (0xC0, 0xC1, 0xC2, 0xC4, 0xDA, 0xDB, 0xDD, 0xFE)
                    or 0xE0 <= marker <= 0xEF):
                raise _refuse(path, f"the marker 0xFF{marker:02X}")
            body, pos = self.segment(pos)
            if marker == 0xDA:
                pos = self.scan(self.sos(body), pos)
            elif marker in (0xC0, 0xC1, 0xC2):
                self.sof(body, marker == 0xC2)
            elif marker == 0xC4:
                self.dht(body)
            elif marker == 0xDB:
                self.dqt(body)
            elif marker == 0xDD:
                if len(body) != 2:
                    raise _corrupt(path, "a DRI segment of the wrong length")
                self.restart = (body[0] << 8) | body[1]
            elif marker == 0xE0 and body[:5] == b"JFIF\x00" and len(body) >= 14:
                self.jfif = True
            elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
                self.adobe = body[11]
            elif marker == 0xE1 and body[:6] == b"Exif\x00\x00" and not self.scans:
                self.exif.append(body[6:])
        if self.progressive is None:
            raise _corrupt(path, "no frame header (SOF)")
        if self.y_scans == 0:
            raise _corrupt(path, "no scan of the Y component")

    def sof(self, body: bytes, progressive: bool) -> None:
        path = self.path
        if self.progressive is not None:
            raise _corrupt(path, "a second frame header (SOF)")
        if len(body) < 6:
            raise _corrupt(path, "a short SOF segment")
        precision, height, width, n = (body[0], (body[1] << 8) | body[2],
                                       (body[3] << 8) | body[4], body[5])
        if precision != 8:
            raise _refuse(path, f"{precision}-bit samples")
        if height == 0:
            raise _refuse(path, "a DNL marker (a frame of height 0)")
        if width == 0:
            raise _corrupt(path, "a frame of width 0")
        if n == 4:
            raise _refuse(path, "four components (CMYK/YCCK)")
        if n not in (1, 3):
            raise _refuse(path, f"{n} components")
        if len(body) != 6 + 3 * n:
            raise _corrupt(path, "an SOF segment of the wrong length")
        for i in range(n):
            cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
            h, v = hv >> 4, hv & 15
            if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
                raise _corrupt(path, "a bad sampling factor or quantization table id")
            self.comps.append(_Component(cid, i, h, v, tq))
        if len({c.cid for c in self.comps}) != n:
            raise _corrupt(path, "two components with one id")
        self.height, self.width, self.progressive = height, width, progressive
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        y = self.comps[0]
        if (y.h, y.v) != (self.hmax, self.vmax):
            raise _refuse(path, f"a Y component sampled below the largest factors ({y.h}x{y.v} "
                          f"against {self.hmax}x{self.vmax}), which libjpeg upsamples")
        self.mcus_x = -(-width // (8 * self.hmax))
        self.mcus_y = -(-height // (8 * self.vmax))
        self.bx, self.by = self.mcus_x * y.h, self.mcus_y * y.v  # Y blocks, MCU-padded
        blocks = 0
        for c in (self.comps if self.colour else self.comps[:1]):
            c.base, c.gw, c.gh = blocks * STRIDE, self.mcus_x * c.h, self.mcus_y * c.v
            blocks += c.gw * c.gh
        self.zz = array.array("q", bytes(8 * (blocks + 1) * STRIDE))
        self.scratch = blocks * STRIDE
        # progressive: the Y coefficients' missing bits (-1: never sent)
        self.coef_bits = [-1] * 64

    def dht(self, body: bytes) -> None:
        pos = 0
        while pos < len(body):
            if pos + 17 > len(body):
                raise _corrupt(self.path, "a short DHT segment")
            tc, th = body[pos] >> 4, body[pos] & 15
            n = sum(body[pos + 1:pos + 17])
            if tc > 1 or th > 3 or n > 256 or pos + 17 + n > len(body):
                raise _corrupt(self.path, "a bad DHT segment")
            try:
                table = _lookahead(bytes(body[pos + 1:pos + 17 + n]), tc == 0)
            except ValueError as e:
                raise _corrupt(self.path, str(e)) from None
            (self.ac_tables if tc else self.dc_tables)[th] = table
            pos += 17 + n

    def dqt(self, body: bytes) -> None:
        pos = 0
        while pos < len(body):
            pq, tq = body[pos] >> 4, body[pos] & 15
            size = 64 * (pq + 1)
            if pq > 1 or tq > 3 or pos + 1 + size > len(body):
                raise _corrupt(self.path, "a bad DQT segment")
            zz = np.frombuffer(body[pos + 1:pos + 1 + size], np.uint8 if pq == 0 else ">u2")
            table = np.zeros(64, np.int64)
            table[list(NATURAL)] = zz
            self.qtables[tq] = table
            pos += 1 + size

    def sos(self, body: bytes) -> _Scan:
        path = self.path
        if self.progressive is None:
            raise _corrupt(path, "a scan before the frame header")
        if not body or not 1 <= body[0] <= 4 or len(body) != 4 + 2 * body[0]:
            raise _corrupt(path, "a bad SOS segment")
        n = body[0]
        comps = []
        by_id = {c.cid: c for c in self.comps}
        for i in range(n):
            cid, t = body[1 + 2 * i:3 + 2 * i]
            if cid not in by_id or any(c is by_id[cid] for c, _, _ in comps):
                raise _corrupt(path, f"a scan of an unknown or repeated component {cid}")
            comps.append((by_id[cid], t >> 4, t & 15))
        ss, se, a = body[1 + 2 * n], body[2 + 2 * n], body[3 + 2 * n]
        ah, al = a >> 4, a & 15
        if self.progressive:
            bad = se != 0 if ss == 0 else (ss > se or se > 63 or n != 1)
            if bad or (ah != 0 and al != ah - 1) or al > 13:
                raise _corrupt(path, f"a bad progressive scan (Ss={ss} Se={se} Ah={ah} Al={al})")
        else:  # libjpeg warns on other values in a sequential scan and reads it whole
            ss, se, ah, al = 0, 63, 0, 0
        if n > 1 and sum(c.h * c.v for c, _, _ in comps) > 10:
            raise _corrupt(path, "more than 10 blocks in an MCU")
        if not self.scans:
            self.check_colour()  # libjpeg settles the colour space at the first SOS
        self.scans += 1
        for c, _, _ in comps:  # jdinput.c::latch_quant_tables
            if c.qtable is None:
                if c.tq not in self.qtables:
                    raise _corrupt(path, f"no quantization table {c.tq}")
                c.qtable = self.qtables[c.tq].copy()
        return _Scan(comps, ss, se, ah, al)

    def check_colour(self) -> None:
        """``jdapimin.c::default_decompress_parms``: three components are
        YCbCr unless an Adobe marker (and no JFIF one) says RGB, or neither
        marker is there and the components are named 'R', 'G', 'B'."""
        if len(self.comps) != 3 or self.jfif:
            return
        if self.adobe == 0:
            raise _refuse(self.path, "RGB (Adobe transform 0)")
        if self.adobe is None and [c.cid for c in self.comps] == [82, 71, 66]:
            raise _refuse(self.path, "RGB (components named 'R', 'G', 'B')")

    # --------------------------------------------------------------- scans

    def split(self, pos: int) -> tuple[list[bytes], list[int], int]:
        """The scan's entropy-coded data from ``pos`` to the next marker that
        is not RSTn: its restart segments, unstuffed, the RST numbers between
        them, and the position of that marker."""
        data = self.data
        segments, rsts = [], []
        start = pos
        while True:
            m = _MARKER_RE.search(data, pos)
            end = len(data) if m is None else m.start()
            marker = None if m is None else data[m.end() - 1]
            segments.append(_STUFFED_RE.sub(b"\xff", data[start:end]))
            if marker is None or not 0xD0 <= marker <= 0xD7:
                return segments, rsts, end
            rsts.append(marker - 0xD0)
            start = pos = m.end()

    def scan(self, scan: _Scan, pos: int) -> int:
        path = self.path
        has_y = any(c.index == 0 for c, _, _ in scan.comps)
        kept = has_y or any(c.base is not None for c, _, _ in scan.comps)
        segments, rsts, end = self.split(pos)
        if not kept:
            return end  # chroma alone, not kept: nothing of the planes wanted
        if has_y:
            self.y_scans += 1
            if self.y_scans > 1 and not self.progressive:
                raise _corrupt(path, "a second sequential scan of the Y component")
        for _c, td, ta in scan.comps:
            dc = scan.ss == 0 and scan.ah == 0
            if (dc and td not in self.dc_tables) or (
                    (scan.se > 0) and ta not in self.ac_tables):
                raise _corrupt(path, f"no Huffman table {td if dc else ta} for a scan")
        offs = self.block_offsets(scan)
        n_mcus = len(offs)
        interval = self.restart
        n_seg = -(-n_mcus // interval) if interval else 1
        if len(segments) != n_seg or any(r != i % 8 for i, r in enumerate(rsts)):
            raise _corrupt(path, f"{len(rsts)} restart markers where the scan needs "
                           f"{n_seg - 1}, numbered 0-7 in turn")
        if self.progressive:
            if has_y:
                self.check_progression(scan)
            run = self.progressive_segment
        else:
            run = self.baseline_segment
        # one bit reader over the scan's segments end to end; each segment
        # starts at its own byte, and reading past its end is refused
        look = _lookahead_words(b"".join(segments))
        first = start = 0
        for seg in segments:
            count = min(interval, n_mcus - first) if interval else n_mcus
            try:
                used = run(scan, offs, look, 8 * start, first, count) - 8 * start
            except IndexError:  # read far past the scan's end
                used = 8 * len(seg) + 1
            if used > 8 * len(seg):
                raise _corrupt(path, "the entropy-coded data ends inside an MCU")
            first += count
            start += len(seg)
        return end

    def block_offsets(self, scan: _Scan) -> list[list[tuple[int, int]]]:
        """The scan's MCUs in the order they are coded, each as its blocks:
        (the component's place in the scan, the block's zz offset or the
        scratch block's). A scan of one component walks that component's own
        blocks, one to an MCU; an interleaved scan walks the MCUs, each
        holding every component's h x v blocks."""
        if len(scan.comps) == 1:
            c = scan.comps[0][0]
            bw = -(-(-(-self.width * c.h // self.hmax)) // 8)
            bh = -(-(-(-self.height * c.v // self.vmax)) // 8)
            if c.base is None:
                return [[(0, self.scratch)]] * (bw * bh)
            m = np.arange(bw * bh)
            offs = c.base + ((m // bw) * c.gw + m % bw) * STRIDE
            return [[(0, o)] for o in offs.tolist()]
        my, mx = np.divmod(np.arange(self.mcus_x * self.mcus_y), self.mcus_x)
        ks, cols = [], []
        for k, (c, _, _) in enumerate(scan.comps):
            for v in range(c.v):
                for h in range(c.h):
                    ks.append(k)
                    cols.append(np.full(len(mx), self.scratch) if c.base is None else
                                c.base + ((my * c.v + v) * c.gw + mx * c.h + h) * STRIDE)
        return [list(zip(ks, row)) for row in np.stack(cols, 1).tolist()]

    def baseline_segment(self, scan, offs, look, p, first, count) -> int:
        """``jdhuff.c::decode_mcu``: one restart interval of a sequential
        scan from bit ``p``. Returns the bit it ends at."""
        zz, path = self.zz, self.path
        dcs = [self.dc_tables[td] for _, td, _ in scan.comps]
        acs = [self.ac_tables[ta] for _, _, ta in scan.comps]
        pred = [0] * len(scan.comps)
        for blocks in offs[first:first + count]:
            for k, base in blocks:
                e = dcs[k][look[p]]
                if e & FAST:
                    p += e & 31
                    d = e >> 10
                elif e:
                    p += e & 31
                    s = e >> 10
                    d = look[p] >> (16 - s)
                    p += s
                    if d < 1 << (s - 1):
                        d -= (1 << s) - 1
                else:
                    raise _corrupt(path, "a bad Huffman code")
                if d:
                    d += pred[k]
                    if not -0x80000000 <= d <= 0x7FFFFFFF:  # libjpeg adds unsigned
                        d = ((d + 0x80000000) & 0xFFFFFFFF) - 0x80000000
                    pred[k] = d
                zz[base] = pred[k]
                ac = acs[k]
                i, end = base + 1, base + 64
                while i < end:
                    e = ac[look[p]]
                    if e & FAST:
                        p += e & 31
                        i += (e >> 5) & 15
                        zz[i] = e >> 10
                        i += 1
                    elif e:
                        p += e & 31
                        s = e >> 10
                        if s:
                            i += (e >> 5) & 15
                            v = look[p] >> (16 - s)
                            p += s
                            zz[i] = v - (1 << s) + 1 if v < 1 << (s - 1) else v
                            i += 1
                        elif e & 0x1E0 == 0x1E0:  # ZRL
                            i += 16
                        else:  # EOB
                            break
                    else:
                        raise _corrupt(path, "a bad Huffman code")
        return p

    def check_progression(self, scan: _Scan) -> None:
        """``jdphuff.c::start_pass_phuff_decoder``'s check of the scan against
        the bits already sent; libjpeg warns and goes on, this refuses."""
        bits = self.coef_bits
        if scan.ss > 0 and bits[0] < 0:
            raise _corrupt(self.path, "an AC scan before the DC scan")
        for k in range(scan.ss, scan.se + 1):
            if scan.ah != max(bits[k], 0):
                raise _corrupt(self.path, f"a bogus progression at coefficient {k}")
            bits[k] = scan.al

    def progressive_segment(self, scan, offs, look, p, first, count) -> int:
        """``jdphuff.c``'s four scan kinds over one restart interval from bit
        ``p``. Returns the bit it ends at."""
        zz, scratch, path = self.zz, self.scratch, self.path
        ss, se, ah, al = scan.ss, scan.se, scan.ah, scan.al
        if ss == 0 and ah == 0:  # DC first
            tabs = [self.dc_tables[td] for _, td, _ in scan.comps]
            pred = [0] * len(scan.comps)
            for blocks in offs[first:first + count]:
                for k, base in blocks:
                    e = tabs[k][look[p]]
                    if e & FAST:
                        p += e & 31
                        d = e >> 10
                    elif e:
                        p += e & 31
                        s = e >> 10
                        d = look[p] >> (16 - s)
                        p += s
                        if d < 1 << (s - 1):
                            d -= (1 << s) - 1
                    else:
                        raise _corrupt(path, "a bad Huffman code")
                    d += pred[k]
                    if not -0x80000000 <= d <= 0x7FFFFFFF:
                        d = ((d + 0x80000000) & 0xFFFFFFFF) - 0x80000000
                    pred[k] = d
                    d <<= al
                    zz[base] = d if -0x8000 <= d <= 0x7FFF else _wrap16(d)
            return p
        if ss == 0:  # DC refine: a bit a block
            p1 = 1 << al
            for blocks in offs[first:first + count]:
                for _k, base in blocks:
                    if look[p] >> 15 and base != scratch:
                        zz[base] = _wrap16(zz[base] | p1)
                    p += 1
            return p
        ac = self.ac_tables[scan.comps[0][2]]
        eobrun = 0
        if ah == 0:  # AC first
            for blocks in offs[first:first + count]:
                if eobrun:
                    eobrun -= 1
                    continue
                base = blocks[0][1]
                i = ss
                while i <= se:
                    e = ac[look[p]]
                    if not e:
                        raise _corrupt(path, "a bad Huffman code")
                    p += e & 31
                    r = (e >> 5) & 15
                    if e & FAST:
                        v = e >> 10
                    else:
                        s = e >> 10
                        if not s:
                            if r == 15:  # ZRL
                                i += 16
                                continue
                            eobrun = 1 << r  # EOBn
                            if r:
                                eobrun += look[p] >> (16 - r)
                                p += r
                            eobrun -= 1
                            break
                        v = look[p] >> (16 - s)
                        p += s
                        if v < 1 << (s - 1):
                            v -= (1 << s) - 1
                    i += r
                    if i > se:
                        raise _corrupt(path, "a run past the end of the band")
                    v <<= al
                    zz[base + i] = v if -0x8000 <= v <= 0x7FFF else _wrap16(v)
                    i += 1
            return p
        # AC refine
        p1, m1 = 1 << al, -(1 << al)
        for blocks in offs[first:first + count]:
            base = blocks[0][1]
            i = ss
            if eobrun == 0:
                while i <= se:
                    e = ac[look[p]]
                    if not e:
                        raise _corrupt(path, "a bad Huffman code")
                    r = (e >> 5) & 15
                    p += e & 31
                    if e & FAST:  # the code and the new coefficient's sign in one
                        if e >> 10 not in (1, -1):
                            raise _corrupt(path, "a refinement coefficient of size other than 1")
                        s = p1 if e >> 10 > 0 else m1
                    elif e >> 10:
                        if e >> 10 != 1:
                            raise _corrupt(path, "a refinement coefficient of size other than 1")
                        s = p1 if look[p] >> 15 else m1
                        p += 1
                    else:
                        s = 0
                        if r != 15:
                            eobrun = 1 << r
                            if r:
                                eobrun += look[p] >> (16 - r)
                                p += r
                            break
                    # over nonzero coefficients (a correction bit each) and r
                    # zero ones, to the one that becomes nonzero
                    while True:
                        c = zz[base + i]
                        if c:
                            if look[p] >> 15 and not c & p1:
                                zz[base + i] = _wrap16(c + (p1 if c >= 0 else m1))
                            p += 1
                        else:
                            r -= 1
                            if r < 0:
                                break
                        i += 1
                        if i > se:
                            break
                    if s:
                        if i > se:
                            raise _corrupt(path, "a run past the end of the band")
                        zz[base + i] = s
                    i += 1
            if eobrun > 0:
                # the band's nonzero coefficients after the end of band
                while i <= se:
                    c = zz[base + i]
                    if c:
                        if look[p] >> 15 and not c & p1:
                            zz[base + i] = _wrap16(c + (p1 if c >= 0 else m1))
                        p += 1
                    i += 1
                eobrun -= 1
        return p

    # -------------------------------------------------------------- output

    def coefficients(self) -> np.ndarray:
        """Every kept block's coefficients, ``[blocks, 64]`` in natural
        order, as 16-bit JCOEFs, component after component."""
        zz = np.frombuffer(self.zz, np.int64).reshape(-1, STRIDE)
        if zz[:, 64:].any():
            raise _corrupt(self.path, "a run past the end of a block")
        # the zigzag order undone; astype(int16) wraps as a JCOEF store does
        return zz[:-1, _ZIGZAG].astype(np.int16).astype(np.int64)

    def output(self) -> np.ndarray:
        path, y = self.path, self.comps[0]
        if self.progressive and self.coef_bits[0] >= 0 and any(self.coef_bits[1:10]):
            # jdcoefct.c::smoothing_ok: libjpeg smooths the blocks while any of
            # the first 10 coefficients still misses bits
            raise _refuse(path, "a progressive file whose first AC coefficients are not all "
                          "sent in full (libjpeg smooths its blocks)")
        coef = self.coefficients()
        q = y.qtable
        if int(q.max()) > 0x7FFF:
            raise _refuse(path, "a quantization value above 32767")
        pixels = idct_islow(coef * q, path)
        img = (pixels.reshape(self.by, self.bx, 8, 8).transpose(0, 2, 1, 3)
               .reshape(self.by * 8, self.bx * 8))
        img = np.ascontiguousarray(img[:self.height, :self.width])
        # OpenCV takes the first orientation tag of the Exif segments in turn
        for exif in self.exif:
            if exif_orientation(exif) is not None:
                return apply_orientation(img, exif)
        return img


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _idct_1d(d0, d1, d2, d3, d4, d5, d6, d7, shift0: int):
    """One pass of ``jpeg_idct_islow`` on 8 inputs; ``shift0`` is the
    left shift that puts the even part's 0 and 4 terms at CONST_BITS."""
    z1 = (d2 + d6) * FIX_0_541196100
    tmp2 = z1 + d6 * -FIX_1_847759065
    tmp3 = z1 + d2 * FIX_0_765366865
    tmp0 = (d0 + d4) << shift0
    tmp1 = (d0 - d4) << shift0
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d7, d5, d3, d1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0 = t0 * FIX_0_298631336
    t1 = t1 * FIX_2_053119869
    t2 = t2 * FIX_3_072711026
    t3 = t3 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)


def idct_islow(deq: np.ndarray, path: str = "<bytes>") -> np.ndarray:
    """``jidctint.c::jpeg_idct_islow`` on ``[N, 64]`` dequantized
    coefficients (row-major) -> ``[N, 64]`` uint8 samples: a column pass
    descaled by CONST_BITS - PASS1_BITS, a row pass by CONST_BITS +
    PASS1_BITS + 3, then the range-limit table."""
    x = deq.reshape(-1, 8, 8).astype(np.int64)
    cols = _idct_1d(*(x[:, r, :] for r in range(8)), CONST_BITS)  # each [N, 8 columns]
    ws = np.stack([_descale(c, CONST_BITS - PASS1_BITS) for c in cols], axis=1)  # [N, 8, 8]
    if np.abs(ws).max(initial=0) > 0x7FFF:
        raise _refuse(path, "IDCT intermediate values outside 16 bits")
    rows = _idct_1d(*(ws[:, :, c] for c in range(8)), CONST_BITS)  # each [N, 8 rows]
    out = np.stack([_descale(r, CONST_BITS + PASS1_BITS + 3) for r in rows], axis=2)
    if (out < -512).any() or (out > 511).any():
        raise _refuse(path, "IDCT outputs outside [-512, 511], where libjpeg's C and SIMD "
                      "IDCTs differ")
    return _RANGE_LIMIT[out & RANGE_MASK].reshape(-1, 64)


def decode_jpeg_gray(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """A JPEG file's bytes -> ``[H, W]`` uint8 gray, as
    ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` (see the module's notes)."""
    return _Decoder(bytes(data), path).decode()


# ------------------------------------------------------------ video frames
#
# A video's MJPEG frames are decoded as FFmpeg's MJPEG decoder
# (libavcodec/mjpegdec.c) decodes them, which is what cv2.VideoCapture reads
# an AVI through: its Huffman tables start as the standard ones of ITU-T T.81
# Annex K.3 and, with the quantization tables, persist from frame to frame;
# the DC prediction starts at 1024 (4 << bits) in the dequantized domain, so
# the +128 level shift goes through the IDCT; the IDCT is libavcodec's
# simple_idct for 8-bit samples (simple_idct_template.c). Each component's
# plane comes out at its own sampling.

# ITU-T T.81 Annex K.3: (16 code counts, symbols) of the standard tables
STD_DC_LUMA = (bytes((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)), bytes(range(12)))
STD_DC_CHROMA = (bytes((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0)), bytes(range(12)))
STD_AC_LUMA = (bytes((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D)), bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a"
    "25262728292a3435363738393a434445464748494a535455565758595a636465666768696a737475767778"
    "797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
STD_AC_CHROMA = (bytes((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77)), bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f1"
    "1718191a262728292a35363738393a434445464748494a535455565758595a636465666768696a73747576"
    "7778797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4"
    "c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))


def standard_tables() -> tuple[dict, dict, dict]:
    """FFmpeg's MJPEG decoder's tables before any DHT or DQT
    (``mjpegdec.c::init_default_huffman_tables``): DC and AC tables 0 the
    luminance ones of Annex K.3, 1 the chrominance ones; no quantization
    table."""
    return ({0: _lookahead(b"".join(STD_DC_LUMA), True),
             1: _lookahead(b"".join(STD_DC_CHROMA), True)},
            {0: _lookahead(b"".join(STD_AC_LUMA), False),
             1: _lookahead(b"".join(STD_AC_CHROMA), False)}, {})


# simple_idct_template.c at 8 bits: Wi = round(cos(i pi / 16) sqrt(2) 2^14),
# W4 one below its rounded value
W1, W2, W3, W4, W5, W6, W7 = 22725, 21407, 19266, 16383, 12873, 8867, 4520
ROW_SHIFT, COL_SHIFT, DC_SHIFT = 11, 20, 3


def _simple_idct_1d(d, bias: int):
    """The even and odd parts of one simple_idct pass over ``d[0..7]``, the
    rounding ``bias`` added to the even part; its 8 outputs before the
    shift."""
    a0 = W4 * d[0] + bias
    a1, a2, a3 = a0 + W6 * d[2], a0 - W6 * d[2], a0 - W2 * d[2]
    a0 = a0 + W2 * d[2]
    a0, a1 = a0 + W4 * d[4] + W6 * d[6], a1 - W4 * d[4] - W2 * d[6]
    a2, a3 = a2 - W4 * d[4] + W2 * d[6], a3 + W4 * d[4] - W6 * d[6]
    b0 = W1 * d[1] + W3 * d[3] + W5 * d[5] + W7 * d[7]
    b1 = W3 * d[1] - W7 * d[3] - W1 * d[5] - W5 * d[7]
    b2 = W5 * d[1] - W1 * d[3] + W7 * d[5] + W3 * d[7]
    b3 = W7 * d[1] - W5 * d[3] + W3 * d[5] - W1 * d[7]
    return (a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3, a2 - b2, a1 - b1, a0 - b0)


# the pass as a matrix: output j = sum_k _SIMPLE[j, k] * d[k] (+ bias). Its
# sums are integers below 2^53, so float64 products give them exactly.
_SIMPLE = np.array(_simple_idct_1d(np.eye(8, dtype=np.int64), 0), np.float64)


def _simple_pass(x: np.ndarray, bias: int, shift: int, path: str) -> np.ndarray:
    """One pass over the last axis of ``x``: the 8 sums, ``>> shift``. A sum
    that leaves 32 bits, where C's wrapping arithmetic would part from
    these exact sums, is refused (no encoder's output comes near)."""
    sums = x @ _SIMPLE.T + bias
    if np.abs(sums).max(initial=0) >= 2.0 ** 31:
        raise _refuse(path, "IDCT sums outside 32 bits")
    return np.floor(sums / (1 << shift)).astype(np.int64)


def _idct_simple_values(deq: np.ndarray, path: str) -> np.ndarray:
    """The simple IDCT's ``[N, 8, 8]`` outputs before any clipping."""
    x = deq.reshape(-1, 8, 8).astype(np.int64)
    if np.abs(x).max(initial=0) > 0x7FFF:
        raise _refuse(path, "coefficients outside 16 bits")
    rows = _simple_pass(x.astype(np.float64), 1 << (ROW_SHIFT - 1), ROW_SHIFT, path)
    dc_only = ~x[:, :, 1:].any(axis=2)
    rows = np.where(dc_only[:, :, None], x[:, :, :1] << DC_SHIFT, rows)  # [N, row, column]
    if np.abs(rows).max(initial=0) > 0x7FFF:
        raise _refuse(path, "IDCT intermediate values outside 16 bits")
    # the column pass's rounding: W4 * (col[0] + (1 << (COL_SHIFT - 1)) / W4)
    bias = W4 * ((1 << (COL_SHIFT - 1)) // W4)
    cols = _simple_pass(rows.transpose(0, 2, 1).astype(np.float64), bias, COL_SHIFT, path)
    return cols.transpose(0, 2, 1)


def idct_simple(deq: np.ndarray, path: str = "<bytes>") -> np.ndarray:
    """libavcodec's ``ff_simple_idct_put_int16_8bit`` on ``[N, 64]``
    dequantized coefficients (row-major, the level shift already in the DC)
    -> ``[N, 64]`` uint8 samples: ``idctRowCondDC`` over each row (a row with
    no AC term becomes its DC << 3), its outputs stored as 16 bits, then
    ``idctSparseColPut`` over each column, clipped to 0..255."""
    return np.clip(_idct_simple_values(deq, path), 0, 255).astype(np.uint8).reshape(-1, 64)


def idct_simple_add(deq: np.ndarray, pred: np.ndarray, path: str = "<bytes>") -> np.ndarray:
    """``ff_simple_idct_add_int16_8bit``: the same transform of ``[N, 64]``
    coefficients (``idctSparseColAdd``'s column pass) added to ``[N, 64]``
    uint8 samples, clipped to 0..255."""
    out = _idct_simple_values(deq, path).reshape(-1, 64) + pred.reshape(-1, 64)
    return np.clip(out, 0, 255).astype(np.uint8)


class MjpegFrame:
    """One decoded MJPEG frame: ``planes`` (Y, Cb, Cr, or Y alone) as uint8
    arrays at their own sampling, ``factors`` each plane's (h, v) sampling
    factors, and ``tables`` the decoder's tables after the frame, in force
    for the next one."""

    def __init__(self, planes, factors, tables):
        self.planes, self.factors, self.tables = planes, factors, tables


def read_mjpeg_frame(data: bytes, path: str = "<bytes>",
                     tables: tuple[dict, dict, dict] | None = None) -> _Decoder:
    """An MJPEG frame's markers and entropy-coded data: the decoder holding
    its coefficients (``decode_mjpeg_frame``'s first half)."""
    dec = _Decoder(bytes(data), path, colour=True,
                   tables=standard_tables() if tables is None else tables)
    dec.read()
    return dec


def mjpeg_planes(dec: _Decoder) -> MjpegFrame:
    """The decoded coefficients dequantized and through FFmpeg's IDCT, each
    component's plane cropped to its own sampling (``decode_mjpeg_frame``'s
    second half)."""
    coef = dec.coefficients()
    planes, start = [], 0
    for c in dec.comps:
        n = c.gw * c.gh
        deq = coef[start:start + n] * c.qtable
        deq[:, 0] += 4 << 8  # mjpegdec.c: last_dc starts at 4 << bits
        px = idct_simple(deq, dec.path)
        plane = px.reshape(c.gh, c.gw, 8, 8).transpose(0, 2, 1, 3).reshape(c.gh * 8, c.gw * 8)
        h = -(-dec.height * c.v // dec.vmax)
        w = -(-dec.width * c.h // dec.hmax)
        planes.append(np.ascontiguousarray(plane[:h, :w]))
        start += n
    return MjpegFrame(planes, [(c.h, c.v) for c in dec.comps],
                      (dec.dc_tables, dec.ac_tables, dec.qtables))


def decode_mjpeg_frame(data: bytes, path: str = "<bytes>",
                       tables: tuple[dict, dict, dict] | None = None) -> MjpegFrame:
    """An MJPEG frame's bytes -> its planes as FFmpeg's MJPEG decoder gives
    them (see the notes above). ``tables``: the tables the previous frame
    left (default ``standard_tables()``)."""
    return mjpeg_planes(read_mjpeg_frame(data, path, tables))
