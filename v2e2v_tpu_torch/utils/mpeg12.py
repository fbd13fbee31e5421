"""MPEG-1 (ISO/IEC 11172-2) and MPEG-2 (ISO/IEC 13818-2) video headers, in
plain Python, read as FFmpeg's ``mpeg12dec.c`` reads them.

``start_codes(data)`` splits an elementary stream at its start codes;
``StreamHeaders`` keeps what the headers in front of the slices set, every
field kept as it was coded:

- the sequence header (``0xB3``): sizes, aspect, ``frame_rate_code``, bit
  rate, VBV size, constrained flag and the loaded matrices (read in zigzag
  order; FFmpeg takes an intra matrix's first entry as 8 whatever it says).
  A sequence header sets MPEG-1's defaults and the default matrices, so a
  loaded matrix lasts until the next one;
- the sequence extension (``0xB5``, id 1; its presence makes the stream
  MPEG-2): profile and level, ``progressive_sequence``, ``chroma_format``,
  the size, bit rate and VBV extensions, ``low_delay`` and
  ``frame_rate_extension_n``/``_d``;
- the sequence display extension (id 2) with its colour description, and
  the quant matrix extension (id 3), whose luma matrices also set the
  chroma ones, as FFmpeg's ``load_matrix`` does;
- the GOP header (``0xB8``): time code, ``closed_gop``, ``broken_link``;
- the picture header (``0x00``): ``temporal_reference``,
  ``picture_coding_type``, ``vbv_delay`` and MPEG-1's ``full_pel`` and
  ``f_code`` (an ``f_code`` of 0 taken as 1, as FFmpeg takes it);
- the picture coding extension (id 8): every field;
- the slice header: the row from the start code (and
  ``slice_vertical_position_extension`` above 2800 lines),
  ``quantiser_scale_code``, and the extra information FFmpeg passes over.

User data (``0xB2``), copyright and picture display extensions (ids 4 and
7) are skipped, as FFmpeg skips them for decoding. Refused, each with a
ValueError naming ROADMAP.md queue 1, item 4: the scalable extensions (ids 5,
9 and 10), 4:2:2 and 4:4:4, a colour description whose matrix is not
unspecified (2) or BT.601 (5, 6), ``frame_rate_code`` 0 or past 13 (FFmpeg
fails on them), and corrupt or truncated headers.
"""

from __future__ import annotations

from .imgcodecs import ROADMAP
from .mpeg12tables import FRAME_RATE, INTRA_MATRIX, NON_INTRA_MATRIX, ZIGZAG
from .mpeg4 import Bits

PICTURE, SLICE_MIN, SLICE_MAX = 0x00, 0x01, 0xAF
USER_DATA, SEQUENCE, EXTENSION, SEQUENCE_END, GOP = 0xB2, 0xB3, 0xB5, 0xB7, 0xB8
SEQ_EXT, DISPLAY_EXT, QUANT_EXT, PICTURE_EXT = 1, 2, 3, 8
SCALABLE_EXTS = {5: "sequence scalable", 9: "picture spatial scalable",
                 10: "picture temporal scalable"}
I_TYPE, P_TYPE, B_TYPE, D_TYPE = 1, 2, 3, 4
PICTURE_NAMES = {I_TYPE: "I", P_TYPE: "P", B_TYPE: "B", D_TYPE: "D"}
FRAME_PICTURE = 3
# matrix_coefficients that swscale converts as cv2 converts an unspecified
# one (BT.601 coefficients): unspecified, BT.470BG and SMPTE 170M
PLAIN_MATRICES = (2, 5, 6)


def refuse(where: str, what: str) -> ValueError:
    return ValueError(f"{where}: {what}, which the port's MPEG-1/2 decoder does not read "
                      f"({ROADMAP})")


def corrupt(where: str, what: str) -> ValueError:
    return ValueError(f"{where}: corrupt or truncated MPEG-1/2 video: {what} ({ROADMAP})")


def start_codes(data: bytes) -> list[tuple[int, int]]:
    """(code, position of the byte after it) of every ``0x000001xx`` in ``data``."""
    out = []
    k = data.find(b"\x00\x00\x01")
    n = len(data)
    while 0 <= k and k + 3 < n:
        out.append((data[k + 3], k + 4))
        k = data.find(b"\x00\x00\x01", k + 3)
    return out


class Sequence:
    """The sequence header and its extensions, as coded."""

    width = height = aspect = frame_rate_code = bit_rate = vbv_size = constrained = 0
    mpeg2 = False
    profile_level = 0
    progressive_sequence = 1
    chroma_format = 1
    low_delay = 0
    frame_rate_ext = (0, 0)  # frame_rate_extension_n, _d
    display: dict | None = None  # the sequence display extension's fields

    @property
    def fps(self) -> tuple[int, int]:
        """FFmpeg's frame rate: the code's rate, times (n + 1) / (d + 1) in MPEG-2."""
        num, den = (int(v) for v in FRAME_RATE[self.frame_rate_code])
        if self.mpeg2:
            num *= self.frame_rate_ext[0] + 1
            den *= self.frame_rate_ext[1] + 1
        return num, den


class Picture:
    """A picture header and its coding extension, as coded (MPEG-1's fixed
    values where it has no extension)."""

    temporal_reference = kind = vbv_delay = 0
    full_pel = (0, 0)
    f_code = ((1, 1), (1, 1))  # [forward, backward][horizontal, vertical]
    intra_dc_precision = 0
    picture_structure = FRAME_PICTURE
    top_field_first = 0
    frame_pred_frame_dct = 1
    concealment_motion_vectors = 0
    q_scale_type = 0
    intra_vlc_format = 0
    alternate_scan = 0
    repeat_first_field = 0
    chroma_420_type = 0
    progressive_frame = 1
    extension = False  # a picture coding extension was read


class StreamHeaders:
    """What the headers in front of the slices set (see the module's notes)."""

    def __init__(self, where: str):
        self.where = where
        self.seq: Sequence | None = None
        self.pic: Picture | None = None
        self.closed_gop = 0
        self.broken_link = 0
        self.time_code = 0
        self.intra = self.chroma_intra = self.inter = self.chroma_inter = None

    def _matrix(self, bits: Bits, intra: bool) -> list[int]:
        m = [0] * 64
        for i in range(64):
            v = bits.read(8)
            if v == 0:
                raise corrupt(self.where, "a quantiser matrix entry of 0")
            if intra and i == 0:
                v = 8  # FFmpeg ignores a loaded intra DC quantiser
            m[int(ZIGZAG[i])] = v
        return m

    def sequence(self, bits: Bits) -> None:
        s = Sequence()
        s.width, s.height = bits.read(12), bits.read(12)
        s.aspect, s.frame_rate_code = bits.read(4), bits.read(4)
        s.bit_rate = bits.read(18)
        if not bits.read(1):
            raise corrupt(self.where, "a marker bit missing in the sequence header")
        s.vbv_size, s.constrained = bits.read(10), bits.read(1)
        if s.width == 0 or s.height == 0:
            raise corrupt(self.where, f"a {s.width}x{s.height} sequence")
        if s.frame_rate_code == 0 or s.frame_rate_code > 13:
            raise corrupt(self.where, f"frame_rate_code {s.frame_rate_code}")
        self.intra = self._matrix(bits, True) if bits.read(1) else [int(v) for v in INTRA_MATRIX]
        self.inter = (self._matrix(bits, False) if bits.read(1)
                      else [int(v) for v in NON_INTRA_MATRIX])
        self.chroma_intra, self.chroma_inter = list(self.intra), list(self.inter)
        if bits.pos > bits.size:
            raise corrupt(self.where, "a sequence header cut short")
        self.seq = s

    def extension(self, bits: Bits, after: int | None) -> None:
        kind = bits.read(4)
        if kind in SCALABLE_EXTS:
            raise refuse(self.where, f"the {SCALABLE_EXTS[kind]} extension")
        if kind == SEQ_EXT:
            if after != SEQUENCE or self.seq is None:
                raise corrupt(self.where, "a sequence extension not after a sequence header")
            self._sequence_extension(bits)
        elif kind == DISPLAY_EXT:
            self._display_extension(bits)
        elif kind == QUANT_EXT:
            self._quant_extension(bits)
        elif kind == PICTURE_EXT:
            if after != PICTURE or self.pic is None:
                raise corrupt(self.where, "a picture coding extension not after a picture header")
            self._picture_extension(bits)

    def _sequence_extension(self, bits: Bits) -> None:
        s = self.seq
        s.mpeg2 = True
        s.profile_level = bits.read(8)
        s.progressive_sequence = bits.read(1)
        s.chroma_format = bits.read(2) or 1  # FFmpeg takes the invalid 0 as 4:2:0
        s.width |= bits.read(2) << 12
        s.height |= bits.read(2) << 12
        s.bit_rate |= bits.read(12) << 18
        bits.read(1)
        s.vbv_size |= bits.read(8) << 10
        s.low_delay = bits.read(1)
        s.frame_rate_ext = (bits.read(2), bits.read(5))
        if s.chroma_format != 1:
            raise refuse(self.where, f"chroma_format {s.chroma_format} (4:2:2 or 4:4:4)")

    def _display_extension(self, bits: Bits) -> None:
        d = {"video_format": bits.read(3), "colour_description": bits.read(1)}
        if d["colour_description"]:
            d.update(colour_primaries=bits.read(8), transfer_characteristics=bits.read(8),
                     matrix_coefficients=bits.read(8))
            if d["matrix_coefficients"] not in PLAIN_MATRICES:
                raise refuse(self.where, f"matrix_coefficients {d['matrix_coefficients']} in a "
                             "sequence display extension (swscale would convert otherwise)")
        d["display_horizontal_size"] = bits.read(14)
        bits.read(1)
        d["display_vertical_size"] = bits.read(14)
        if self.seq is not None:
            self.seq.display = d

    def _quant_extension(self, bits: Bits) -> None:
        if self.seq is None:
            raise corrupt(self.where, "a quant matrix extension before any sequence header")
        if bits.read(1):
            self.intra = self.chroma_intra = self._matrix(bits, True)
        if bits.read(1):
            self.inter = self.chroma_inter = self._matrix(bits, False)
        if bits.read(1):
            self.chroma_intra = self._matrix(bits, True)
        if bits.read(1):
            self.chroma_inter = self._matrix(bits, False)

    def gop(self, bits: Bits) -> None:
        self.time_code = bits.read(25)
        self.closed_gop, self.broken_link = bits.read(1), bits.read(1)

    def picture(self, bits: Bits) -> Picture:
        p = Picture()
        p.temporal_reference = bits.read(10)
        p.kind = bits.read(3)
        p.vbv_delay = bits.read(16)
        if p.kind not in PICTURE_NAMES:
            raise corrupt(self.where, f"picture_coding_type {p.kind}")
        full_pel, f_code = [0, 0], [[1, 1], [1, 1]]
        if p.kind in (P_TYPE, B_TYPE):
            full_pel[0] = bits.read(1)
            f = bits.read(3) or 1
            f_code[0] = [f, f]
        if p.kind == B_TYPE:
            full_pel[1] = bits.read(1)
            f = bits.read(3) or 1
            f_code[1] = [f, f]
        p.full_pel = tuple(full_pel)
        p.f_code = tuple(map(tuple, f_code))
        self.pic = p
        return p

    def _picture_extension(self, bits: Bits) -> None:
        p = self.pic
        p.full_pel = (0, 0)
        f = [bits.read(4) for _ in range(4)]
        p.f_code = ((f[0] or 1, f[1] or 1), (f[2] or 1, f[3] or 1))
        p.intra_dc_precision = bits.read(2)
        p.picture_structure = bits.read(2)
        p.top_field_first = bits.read(1)
        p.frame_pred_frame_dct = bits.read(1)
        p.concealment_motion_vectors = bits.read(1)
        p.q_scale_type = bits.read(1)
        p.intra_vlc_format = bits.read(1)
        p.alternate_scan = bits.read(1)
        p.repeat_first_field = bits.read(1)
        p.chroma_420_type = bits.read(1)
        p.progressive_frame = bits.read(1)
        p.extension = True
        if p.picture_structure != FRAME_PICTURE:
            raise refuse(self.where, f"a field picture (picture_structure {p.picture_structure})")


def slice_header(bits: Bits, code: int, mb_height: int, mpeg2: bool) -> tuple[int, int]:
    """A slice's (macroblock row, quantiser_scale_code), the reader left at
    its first macroblock address increment."""
    row = code - SLICE_MIN
    if mpeg2 and mb_height > 2800 // 16:
        row += bits.read(3) << 7
    q = bits.read(5)
    while bits.read(1):  # intra_slice_flag / extra_bit_slice, each with 8 bits
        bits.read(8)
    return row, q
