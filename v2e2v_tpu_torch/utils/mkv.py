"""A Matroska / WebM demuxer for VP8, VP9, MJPEG, MPEG-4 Part 2, MPEG-1/2,
H.263, Sorenson H.263, MS-MPEG-4 v2 and v3, WMV1, WMV2, raw and PNG video, in
plain Python.

``MkvFile(path)`` reads what ``cv2.VideoCapture`` (through FFmpeg's
``libavformat/matroskadec.c``) reads of a file's video track:

- the EBML header and its ``DocType`` (``matroska`` or ``webm``), then the
  first ``Segment``: ``Info`` (``TimestampScale``, ``Duration``),
  ``Tracks`` (each ``TrackEntry``'s ``TrackNumber``, ``TrackType``,
  ``CodecID``, ``CodecPrivate``, ``DefaultDuration`` and ``Video``'s
  ``PixelWidth`` and ``PixelHeight``) and every ``Cluster``'s
  ``Timestamp``, ``SimpleBlock`` and ``BlockGroup``/``Block`` in file order;
- elements of unknown size (a ``Segment`` or ``Cluster`` written live: a
  cluster then ends at the next element of the segment's level); ``Void``,
  ``CRC-32``, ``SeekHead``, ``Cues``, ``Tags``, ``Chapters``,
  ``Attachments`` and elements the demuxer does not know are skipped.

``fps`` is what cv2 reports as ``CAP_PROP_FPS``: ``matroskadec.c`` sets
the stream's average frame rate to ``av_reduce(10^9, DefaultDuration,
30000)``. ``frame_count`` is ``CAP_PROP_FRAME_COUNT``: Matroska gives no
frame count, so OpenCV takes ``floor(duration x fps + 0.5)`` where
``duration`` is the segment's ``Duration`` x ``TimestampScale`` in whole
microseconds, truncated as FFmpeg stores it (under 25 microseconds OpenCV
takes the stream's duration, which FFmpeg leaves unset: refused). ``frames()`` yields the video
track's blocks' bytes in file order. ``rotation`` is 0: cv2 turns no
Matroska frame.

``codec`` is ``"vp8"`` (``V_VP8``), ``"vp9"`` (``V_VP9``; its WebM
``CodecPrivate`` of codec features is read and ignored, as FFmpeg ignores
it, and a ``Colour`` ``Range`` may only say limited or be unspecified: the
range is the key frames'), ``"mjpeg"`` (``V_MJPEG``) or ``"mpeg4"``
(``V_MPEG4/ISO/ASP``, ``/SP`` and ``/AP``, whose headers are the track's
``CodecPrivate``, ``config``) or ``"mpeg12"`` (``V_MPEG1``, ``V_MPEG2``,
whose ``CodecPrivate``, where there is one, holds a sequence header that
the decoder reads before the first block, as FFmpeg reads its extradata),
``"raw"`` (``V_UNCOMPRESSED``: the ``Video`` element's ``ColourSpace``
fourcc names the layout, ``raw_format``, one of ``rawvideo.FORMATS``; cv2
writes it for I420, IYUV, YV12, Y800, GREY and RGBA), or ``"png"``,
``"h263"`` or ``"flv"`` (``V_MS/VFW/FOURCC``, whose ``CodecPrivate`` is a
BITMAPINFOHEADER: its ``biCompression`` picks the codec by the AVI table,
``avi.codec_of``; cv2 writes PNG this way, MPNG, PNG1 or ``png ``, H.263 as
H263, Sorenson H.263 as FLV1, and MS-MPEG-4 v2 (MP42, DIV2), WMV1 and
WMV2, whose extradata, ``extradata``, follows the BITMAPINFOHEADER), or
``"msmpeg4v3"`` (``V_MPEG4/MS/V3``, which cv2 writes for MP43, DIV3 and
the other v3 tags). ``bottom_field_first``: the track says
``FlagInterlaced`` 1 and ``FieldOrder`` 6 (bottom field first), which FFmpeg
hands its MJPEG decoder as the fields' order.

Refused, each with a ValueError naming what the file is and ROADMAP.md queue
1, item 4: laced blocks, ``ContentEncodings`` (header stripping,
compression, encryption), several video tracks or none, ``BlockAdditions``,
other codecs (AVC, HEVC, AV1 and Theora by name), a ``StereoMode``
other than mono, ``Colour`` values that would change the conversion,
cropping, a track without ``DefaultDuration`` or a segment without
``Duration`` (cv2's rate and count then come from FFmpeg's guesses from the
timestamps and the bit rate), and corrupt or truncated elements.
"""

from __future__ import annotations

import math
import struct

from .avi import codec_of
from .imgcodecs import ROADMAP, refuse_video
from .rawvideo import FORMATS

EBML, SEGMENT = 0x1A45DFA3, 0x18538067
DOCTYPE = 0x4282
INFO, TIMESTAMP_SCALE, DURATION = 0x1549A966, 0x2AD7B1, 0x4489
TRACKS, TRACK_ENTRY = 0x1654AE6B, 0xAE
TRACK_NUMBER, TRACK_TYPE, CODEC_ID, CODEC_PRIVATE = 0xD7, 0x83, 0x86, 0x63A2
DEFAULT_DURATION, VIDEO, CONTENT_ENCODINGS = 0x23E383, 0xE0, 0x6D80
PIXEL_WIDTH, PIXEL_HEIGHT, STEREO_MODE, COLOUR = 0xB0, 0xBA, 0x53B8, 0x55B0
COLOUR_SPACE = 0x2EB524
FLAG_INTERLACED, FIELD_ORDER = 0x9A, 0x9D
INTERLACED, BOTTOM_FIRST = 1, 6  # FlagInterlaced's "interlaced", FieldOrder's "bff"
CROPS = (0x54AA, 0x54BB, 0x54CC, 0x54DD)  # PixelCropBottom, Top, Left, Right
CLUSTER, SIMPLE_BLOCK = 0x1F43B675, 0xA3
BLOCK_GROUP, BLOCK, BLOCK_ADDITIONS, ENCRYPTED_BLOCK = 0xA0, 0xA1, 0x75A1, 0xAF
# the elements of a segment's level: an unknown-size cluster ends at one
SEGMENT_LEVEL = (0x114D9B74, INFO, TRACKS, CLUSTER, 0x1C53BB6B, 0x1941A469, 0x1043A770,
                 0x1254C367)
VIDEO_TRACK = 1
CODECS = {"V_VP8": "vp8", "V_VP9": "vp9", "V_MJPEG": "mjpeg", "V_MPEG4/ISO/ASP": "mpeg4",
          "V_MPEG4/ISO/SP": "mpeg4", "V_MPEG4/ISO/AP": "mpeg4", "V_MPEG1": "mpeg12",
          "V_MPEG2": "mpeg12", "V_UNCOMPRESSED": "raw", "V_MS/VFW/FOURCC": "vfw",
          "V_MPEG4/MS/V3": "msmpeg4v3"}
# the codecs a V_MS/VFW/FOURCC track's biCompression may name
VFW_CODECS = ("png", "h263", "flv", "msmpeg4v2", "msmpeg4v3", "wmv1", "wmv2")
NAMED = {"V_MPEG4/ISO/AVC": "H.264 (AVC)", "V_MPEGH/ISO/HEVC": "H.265 (HEVC)",
         "V_AV1": "AV1", "V_THEORA": "Theora"}
# Colour's children and the values that leave FFmpeg's frames as they are:
# MatrixCoefficients, ChromaSitingHorz / Vert, Range, TransferCharacteristics,
# Primaries (2 and 0 are "unspecified"); a Range may also state the one the
# codec's decoder gives (full for MJPEG, as FFmpeg's muxer writes it,
# limited for the others)
COLOUR_UNSPECIFIED = {0x55B1: 2, 0x55B7: 0, 0x55B8: 0, 0x55B9: 0, 0x55BA: 2, 0x55BB: 2}
RANGE = 0x55B9
CODEC_RANGE = {"vp8": 1, "vp9": 1, "mjpeg": 2, "mpeg4": 1, "mpeg12": 1, "raw": 1, "png": 2,
               "h263": 1, "flv": 1, "msmpeg4v2": 1, "msmpeg4v3": 1, "wmv1": 1, "wmv2": 1}


_refuse = refuse_video


def _corrupt(path: str, what: str) -> ValueError:
    return ValueError(f"{path}: corrupt or truncated Matroska/WebM: {what} ({ROADMAP})")


def is_mkv(head: bytes) -> bool:
    """Whether the file's first bytes open an EBML header."""
    return head[:4] == b"\x1a\x45\xdf\xa3"


def av_reduce(num: int, den: int, limit: int) -> tuple[int, int]:
    """``libavutil/rational.c::av_reduce`` for positive ``num``, ``den``: the
    closest fraction with both terms at most ``limit``."""
    g = math.gcd(num, den)
    num, den = num // g, den // g
    a0n, a0d, a1n, a1d = 0, 1, 1, 0
    if num <= limit and den <= limit:
        return num, den
    while den:
        x = num // den
        nxt = num - den * x
        a2n, a2d = x * a1n + a0n, x * a1d + a0d
        if a2n > limit or a2d > limit:
            if a1n:
                x = (limit - a0n) // a1n
            if a1d:
                x = min(x, (limit - a0d) // a1d)
            if den * (2 * x * a1d + a0d) > num * a1d:
                a1n, a1d = x * a1n + a0n, x * a1d + a0d
            break
        a0n, a0d, a1n, a1d = a1n, a1d, a2n, a2d
        num, den = den, nxt
    return a1n, a1d


class Track:
    """One ``TrackEntry``'s fields, as the demuxer needs them."""

    def __init__(self):
        self.number = self.kind = None
        self.codec_id = ""
        self.private = b""
        self.default_duration = 0
        self.width = self.height = 0
        self.encoded = False  # ContentEncodings present
        self.stereo = 0
        self.colour: dict[int, int] = {}
        self.crop = False
        self.interlaced = self.field_order = 0
        self.colour_space = b""


class MkvFile:
    """A Matroska / WebM file's video track (see the module's notes)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self.data = f.read()
        if not is_mkv(self.data):
            raise _refuse(path, "not an EBML (Matroska/WebM) file")
        self.rotation = 0
        pos = self._header()
        segment = None
        for eid, start, end in self._elements(pos, len(self.data)):
            if eid == SEGMENT:
                segment = (start, end)
                break
        if segment is None:
            raise _corrupt(path, "no Segment")
        self.scale, self.duration, self.tracks = 1000000, None, []
        self.clusters: list[tuple[int, int]] = []
        for eid, start, end in self._elements(*segment):
            if eid == INFO:
                self._info(start, end)
            elif eid == TRACKS:
                self._tracks(start, end)
            elif eid == CLUSTER:
                self.clusters.append((start, end))
        video = [t for t in self.tracks if t.kind == VIDEO_TRACK]
        if not video:
            raise _refuse(path, f"a {self.doctype} file with no video track")
        if len(video) > 1:
            raise _refuse(path, f"a {self.doctype} file of {len(video)} video tracks")
        self.track = t = video[0]
        self._check_track(t)
        self.codec = CODECS[t.codec_id]
        self.config = t.private
        self.raw_format = FORMATS.get(t.colour_space) if self.codec == "raw" else None
        self.extradata = b""
        if self.codec == "vfw":
            self.codec = codec_of(t.private[16:20])
            self.extradata = t.private[40:]  # matroskadec.c: past the BITMAPINFOHEADER
        self.width, self.height = t.width, t.height
        self.bottom_field_first = t.interlaced == INTERLACED and t.field_order == BOTTOM_FIRST
        num, den = av_reduce(10 ** 9, t.default_duration, 30000)
        self.fps = num / den
        seconds = math.trunc(self.duration * self.scale * 1000 / 1000000) / 1000000
        if seconds < 0.000025:  # OpenCV's eps_zero: it then takes the stream's unset duration
            raise _refuse(path, f"a {self.doctype} segment of Duration {self.duration}: cv2's "
                          "frame count is then negative")
        self.frame_count = math.floor(seconds * self.fps + 0.5)
        self.blocks = self._blocks(t.number)

    # ---------------------------------------------------------- elements

    def _vint(self, pos: int, end: int, what: str, keep_marker: bool):
        """An EBML variable-length integer at ``pos``: (value, next position,
        all value bits set: an unknown size)."""
        if pos >= end:
            raise _corrupt(self.path, f"{what} at {pos} past the end of its parent")
        first = self.data[pos]
        n = 9 - first.bit_length() if first else 9
        if n > 8 or pos + n > end:
            raise _corrupt(self.path, f"a bad {what} at {pos}")
        v = int.from_bytes(self.data[pos:pos + n], "big")
        if not keep_marker:
            v &= (1 << (7 * n)) - 1
            return v, pos + n, v == (1 << (7 * n)) - 1
        return v, pos + n, False

    def _elements(self, pos: int, end: int):
        """(ID, body start, body end) of each element from ``pos`` to ``end``.
        An element of unknown size runs to ``end`` (a segment) or to the next
        element of the segment's level (a cluster)."""
        while pos < end:
            eid, at, _ = self._vint(pos, end, "element ID", True)
            size, at, unknown = self._vint(at, end, "element size", False)
            if unknown:
                if eid not in (SEGMENT, CLUSTER):
                    raise _corrupt(self.path, f"element 0x{eid:X} at {pos} of unknown size")
                stop = end if eid == SEGMENT else self._cluster_end(at, end)
            else:
                stop = at + size
                if stop > end:
                    raise _corrupt(self.path, f"element 0x{eid:X} at {pos} of size {size} runs "
                                   f"past its parent's end at {end}")
            yield eid, at, stop
            pos = stop

    def _cluster_end(self, pos: int, end: int) -> int:
        """Where a cluster of unknown size ends: the next element of the
        segment's level, or the segment's end."""
        while pos < end:
            eid, at, _ = self._vint(pos, end, "element ID", True)
            if eid in SEGMENT_LEVEL:
                return pos
            size, at, unknown = self._vint(at, end, "element size", False)
            if unknown or at + size > end:
                raise _corrupt(self.path, f"element 0x{eid:X} at {pos} in a cluster of unknown "
                               "size")
            pos = at + size
        return end

    def _uint(self, start: int, end: int) -> int:
        if end - start > 8:
            raise _corrupt(self.path, f"an unsigned integer of {end - start} bytes at {start}")
        return int.from_bytes(self.data[start:end], "big")

    def _float(self, start: int, end: int) -> float:
        if end - start == 4:
            return struct.unpack(">f", self.data[start:end])[0]
        if end - start == 8:
            return struct.unpack(">d", self.data[start:end])[0]
        if end == start:
            return 0.0
        raise _corrupt(self.path, f"a float of {end - start} bytes at {start}")

    # ------------------------------------------------------------ header

    def _header(self) -> int:
        for eid, start, end in self._elements(0, len(self.data)):
            if eid != EBML:
                raise _corrupt(self.path, "no EBML header")
            self.doctype = None
            for sub, s, e in self._elements(start, end):
                if sub == DOCTYPE:
                    self.doctype = self.data[s:e].rstrip(b"\0").decode("latin-1")
            if self.doctype not in ("matroska", "webm"):
                raise _refuse(self.path, f"an EBML file of DocType {self.doctype!r}")
            self.doctype = "WebM" if self.doctype == "webm" else "Matroska"
            return end
        raise _corrupt(self.path, "an empty file")

    def _info(self, start: int, end: int) -> None:
        for eid, s, e in self._elements(start, end):
            if eid == TIMESTAMP_SCALE:
                self.scale = self._uint(s, e)
            elif eid == DURATION:
                self.duration = self._float(s, e)

    def _tracks(self, start: int, end: int) -> None:
        for eid, s, e in self._elements(start, end):
            if eid != TRACK_ENTRY:
                continue
            t = Track()
            self.tracks.append(t)
            for sub, a, b in self._elements(s, e):
                if sub == TRACK_NUMBER:
                    t.number = self._uint(a, b)
                elif sub == TRACK_TYPE:
                    t.kind = self._uint(a, b)
                elif sub == CODEC_ID:
                    t.codec_id = self.data[a:b].rstrip(b"\0").decode("latin-1")
                elif sub == CODEC_PRIVATE:
                    t.private = self.data[a:b]
                elif sub == DEFAULT_DURATION:
                    t.default_duration = self._uint(a, b)
                elif sub == CONTENT_ENCODINGS:
                    t.encoded = True
                elif sub == VIDEO:
                    self._video(t, a, b)

    def _video(self, t: Track, start: int, end: int) -> None:
        for eid, s, e in self._elements(start, end):
            if eid == PIXEL_WIDTH:
                t.width = self._uint(s, e)
            elif eid == PIXEL_HEIGHT:
                t.height = self._uint(s, e)
            elif eid == STEREO_MODE:
                t.stereo = self._uint(s, e)
            elif eid == FLAG_INTERLACED:
                t.interlaced = self._uint(s, e)
            elif eid == FIELD_ORDER:
                t.field_order = self._uint(s, e)
            elif eid == COLOUR_SPACE:
                t.colour_space = self.data[s:e]
            elif eid in CROPS:
                t.crop = t.crop or self._uint(s, e) != 0
            elif eid == COLOUR:
                for sub, a, b in self._elements(s, e):
                    if sub in COLOUR_UNSPECIFIED:
                        t.colour[sub] = self._uint(a, b)

    def _check_track(self, t: Track) -> None:
        name = f"a {self.doctype} video track"
        if t.codec_id not in CODECS:
            what = NAMED.get(t.codec_id)
            raise _refuse(self.path, f"{name} of {what} ({t.codec_id})" if what else
                          f"{name} of codec {t.codec_id!r}")
        if t.encoded:
            raise _refuse(self.path, f"{name} with ContentEncodings (header stripping, "
                          "compression or encryption)")
        if t.stereo:
            raise _refuse(self.path, f"{name} of StereoMode {t.stereo}")
        if t.crop:
            raise _refuse(self.path, f"{name} with PixelCrop values")
        codec = CODECS[t.codec_id]
        if t.codec_id == "V_MS/VFW/FOURCC":
            tag = t.private[16:20]
            codec = codec_of(tag) if len(t.private) >= 40 else None
            if codec not in VFW_CODECS:
                raise _refuse(self.path, f"{name} of codec {t.codec_id!r} whose CodecPrivate "
                              f"(BITMAPINFOHEADER) names {tag.decode('latin-1')!r}, not PNG, "
                              "H.263, Sorenson H.263, MS-MPEG-4 v2 or v3, WMV1 or WMV2")
        specified = {k: v for k, v in t.colour.items() if v != COLOUR_UNSPECIFIED[k]
                     and not (k == RANGE and v == CODEC_RANGE[codec])}
        if specified:
            raise _refuse(self.path, f"{name} with Colour values "
                          f"{ {f'0x{k:X}': v for k, v in specified.items()} }")
        if t.codec_id == "V_UNCOMPRESSED" and t.colour_space not in FORMATS:
            raise _refuse(self.path, f"{name} of raw video in the layout "
                          f"{t.colour_space.decode('latin-1')!r} (ColourSpace)")
        if t.number is None:
            raise _corrupt(self.path, "a video track without TrackNumber")
        if not t.default_duration:
            raise _refuse(self.path, f"{name} without DefaultDuration: cv2's frame rate is then "
                          "FFmpeg's guess from the timestamps")
        if not self.duration or self.duration < 0:
            raise _refuse(self.path, f"a {self.doctype} segment without Duration: cv2's frame "
                          "count is then FFmpeg's estimate")

    # ------------------------------------------------------------ blocks

    def _blocks(self, number: int) -> list[tuple[int, int]]:
        """(start, end) of each of the track's frames, in file order."""
        out = []
        for start, end in self.clusters:
            for eid, s, e in self._elements(start, end):
                if eid == SIMPLE_BLOCK:
                    self._block(s, e, number, out)
                elif eid == BLOCK_GROUP:
                    for sub, a, b in self._elements(s, e):
                        if sub == BLOCK:
                            self._block(a, b, number, out, group=(s, e))
                elif eid == ENCRYPTED_BLOCK:
                    raise _refuse(self.path, "an EncryptedBlock")
        return out

    def _block(self, start: int, end: int, number: int, out: list, group=None) -> None:
        track, at, _ = self._vint(start, end, "block track number", False)
        if track != number:
            return
        if at + 3 > end:
            raise _corrupt(self.path, f"a block at {start} cut short")
        flags = self.data[at + 2]
        if flags & 0x06:
            raise _refuse(self.path, f"a laced block at {start} (lacing "
                          f"{('Xiph', 'fixed-size', 'EBML')[((flags >> 1) & 3) - 1]})")
        if group is not None and any(eid == BLOCK_ADDITIONS for eid, _, _ in
                                     self._elements(*group)):
            raise _refuse(self.path, f"a block group at {group[0]} with BlockAdditions")
        out.append((at + 3, end))

    def frames(self):
        """Each of the video track's frames, in file order."""
        for start, end in self.blocks:
            yield self.data[start:end]
