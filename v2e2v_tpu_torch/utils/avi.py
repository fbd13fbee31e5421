"""A RIFF/AVI demuxer for MJPEG, MPEG-4 Part 2, MPEG-1/2, VP8, VP9, H.263,
Sorenson H.263, MS-MPEG-4 v2 and v3, WMV1, WMV2, raw and PNG video, in plain
Python.

``AviFile(path)`` reads what ``cv2.VideoCapture`` (through FFmpeg's
``libavformat/avidec.c``) reads of an AVI's first video stream:

- the ``hdrl`` list: each ``strl``'s ``strh`` and ``strf``
  (BITMAPINFOHEADER) and its OpenDML super index ``indx``;
- the ``movi`` lists of the first RIFF ``AVI `` chunk and of every RIFF
  ``AVIX`` chunk after it (OpenDML files past 1 GB), with their ``LIST rec``
  groups and ``JUNK`` chunks, odd chunk sizes padded to even;
- the frames' places from the OpenDML standard indexes (``ix##``, reached
  through ``indx``) when there are any, else from ``idx1``, else by walking
  the ``movi`` lists.

``fps`` is ``strh.dwRate / strh.dwScale`` and ``frame_count`` is
``strh.dwLength``, which is what cv2 reports as ``CAP_PROP_FPS`` and
``CAP_PROP_FRAME_COUNT`` (it reads neither ``avih.dwTotalFrames`` nor
``dmlh``). ``frames()`` yields each video chunk's bytes in order, and skips
chunks of size 0 (dropped frames) as FFmpeg does: no frame comes out for
them and the next frame is the next one read.

``codec`` is picked by ``biCompression`` as ``libavformat/riff.c``'s table
picks FFmpeg's decoder (``codec_of``), upper-cased as FFmpeg matches it:
``"mjpeg"`` (MJPG, AVI1, JPEG, and CJPG, LJPG, JPGL and mjpa, which cv2's
writer also writes: plain JPEG frames, one a chunk), ``"mpeg4"`` (XVID,
FMP4, DIVX, DX50, MP4V, MP4S, M4S2), ``"mpeg12"`` for MPEG-1/2 video
(``mpg1`` and ``mpg2``, which cv2's ``PIM1`` and ``MPG2`` become in an AVI,
``PIM1`` and ``MPEG``), ``"vp8"`` (VP80), ``"vp9"`` (VP90), ``"png"``
(MPNG, PNG1, ``png ``), ``"h263"`` (H263, U263, X263, M263, T263, L263,
VX1K, lsvm: FFmpeg's ``h263`` decoder; not ZyGo, whose I-pictures FFmpeg
reads 759 bits into as a debug dump, and not I263, Intel's H.263), ``"flv"``
(FLV1 and S263: Sorenson H.263), ``"msmpeg4v2"`` (MP42, DIV2),
``"msmpeg4v3"`` (MP43, DIV3, MPG3, DIV4, DIV5, DIV6, DVX3, AP41, COL1,
COL0), ``"wmv1"`` (WMV1) and ``"wmv2"`` (WMV2, whose extension header is
``strf``'s bytes past the BITMAPINFOHEADER, ``extradata``), as
``riff.c`` names them (MS-MPEG-4 v1's MP41, MPG4 and DIV1 and WMV3 are named
in refusals), and ``"raw"`` for the uncompressed layouts of
``rawvideo.FORMATS`` (I420, IYUV, YV12, Y800, GREY, RGBA; ``raw_format``
names the layout), matched as written, as ``rawdec.c`` matches them. An
MPEG-4 stream's headers, and an MPEG-1/2 stream's sequence header, lead its
first chunk. ``width`` and ``height`` are ``strf``'s. cv2's writer stores
raw frames top-down under their fourcc; ``biCompression`` 0 (BI_RGB,
bottom-up), which cv2 never writes (it writes I420 for it), is refused.

A file that is not RIFF AVI (Matroska, FLV, ...) and a video stream of
another codec raise a ValueError naming ROADMAP.md queue 1, item 4, and
what the file or the stream is.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from .imgcodecs import ROADMAP, refuse_video
from .rawvideo import FORMATS

# biCompression values (upper-cased) that FFmpeg decodes with each decoder
# and the port reads; mpg1 and mpg2 are what cv2's PIM1 and MPG2 become in
# an AVI
CODEC_FOURCCS = {"mjpeg": (b"MJPG", b"AVI1", b"JPEG", b"CJPG", b"LJPG", b"JPGL", b"MJPA"),
                 "mpeg4": (b"XVID", b"FMP4", b"DIVX", b"DX50", b"MP4V", b"MP4S", b"M4S2"),
                 "mpeg12": (b"MPG1", b"MPG2", b"PIM1", b"MPEG"),
                 "vp8": (b"VP80",), "vp9": (b"VP90",), "png": (b"MPNG", b"PNG1", b"PNG "),
                 "h263": (b"H263", b"U263", b"X263", b"M263", b"T263", b"L263", b"VX1K",
                          b"LSVM"),
                 "flv": (b"FLV1", b"S263"),
                 "msmpeg4v2": (b"MP42", b"DIV2"),
                 "msmpeg4v3": (b"MP43", b"DIV3", b"MPG3", b"DIV4", b"DIV5", b"DIV6", b"DVX3",
                               b"AP41", b"COL1", b"COL0"),
                 "wmv1": (b"WMV1",), "wmv2": (b"WMV2",)}
# FFmpeg's names of tags whose codec the port does not read, for refusals
NAMED = {b"MP41": "MS-MPEG-4 v1", b"MPG4": "MS-MPEG-4 v1", b"DIV1": "MS-MPEG-4 v1",
         b"WMV3": "WMV3 (VC-1)", b"WVC1": "VC-1", b"WMVA": "VC-1", b"WMVP": "WMV3 image",
         b"WVP2": "VC-1 image", b"MSS1": "Windows Media Screen", b"MSS2": "Windows Media "
         "Screen 2"}


def named(fourcc: bytes) -> str:
    """A ``biCompression`` as refusals name it: the tag, and the codec
    FFmpeg reads under it where ``NAMED`` knows it."""
    code = f"codec {fourcc.decode('latin-1')!r} (biCompression"
    what = NAMED.get(fourcc.upper())
    return f"{code}: {what})" if what else f"{code})"


def codec_of(fourcc: bytes) -> str | None:
    """The port's codec for a ``biCompression`` (an AVI's, or a Matroska
    ``V_MS/VFW/FOURCC`` track's), or None: raw layouts as written, the
    others upper-cased."""
    if fourcc in FORMATS:
        return "raw"
    for codec, fourccs in CODEC_FOURCCS.items():
        if fourcc.upper() in fourccs:
            return codec
    return None


_CONTAINERS = (  # (offset, signature, name) of files that are not RIFF AVI
    (4, b"ftyp", "an MP4/MOV (ISO base media)"),
    (4, b"moov", "a QuickTime MOV"),
    (4, b"mdat", "a QuickTime MOV"),
    (0, b"\x1a\x45\xdf\xa3", "a Matroska/WebM"),
    (0, b"FLV", "an FLV"),
    (0, b"\x00\x00\x01\xba", "an MPEG program stream"),
    (0, b"\x00\x00\x01\xb3", "an MPEG video elementary stream"),
    (0, b"\x30\x26\xb2\x75", "an ASF/WMV"),
    (0, b"OggS", "an Ogg"),
    (0, b"\xff\xd8\xff", "a JPEG image"),
    (0, b"\x89PNG", "a PNG image"),
)


_refuse = refuse_video


def _corrupt(path: str, what: str) -> ValueError:
    return ValueError(f"{path}: corrupt or truncated AVI: {what} ({ROADMAP})")


def _container(head: bytes) -> str:
    if head[:4] == b"RIFF":
        return f"a RIFF {head[8:12].decode('latin-1')!r} file"
    if len(head) >= 188 * 2 and head[0] == 0x47 and head[188] == 0x47:
        return "an MPEG transport stream"
    for off, sig, name in _CONTAINERS:
        if head[off:off + len(sig)] == sig:
            return f"{name} file"
    return "a file of unknown format"


@dataclass
class VideoStream:
    """The first video stream's headers."""

    number: int  # its place among the streams: its chunks are '##dc'/'##db'
    compression: bytes  # strf.biCompression
    width: int
    height: int
    rate: int
    scale: int
    length: int
    super_index: bytes | None = None  # the strl's 'indx' chunk
    extradata: bytes = b""  # strf past its BITMAPINFOHEADER's 40 bytes (biSize)


class AviFile:
    """An AVI file's first video stream (see the module's notes)."""

    def __init__(self, path: str):
        self.path = path
        self.movi: list[tuple[int, int]] = []  # (position of the 'movi' tag, end) per list
        self.idx1: tuple[int, int] | None = None  # (data position, size)
        self.streams = 0
        self.video: VideoStream | None = None
        with open(path, "rb") as f:
            head = f.read(512)
            if head[:4] != b"RIFF" or head[8:12] != b"AVI ":
                raise _refuse(path, f"{_container(head)}, not RIFF AVI")
            f.seek(0, 2)
            self.size = f.tell()
            self._read_riffs(f)
        if self.video is None:
            raise _refuse(path, "an AVI file with no video stream")
        v = self.video
        self.codec = codec_of(v.compression)
        if self.codec is None:
            raise _refuse(path, f"an AVI video stream of {named(v.compression)}, not MJPEG, "
                          "MPEG-4 Part 2, MPEG-1/2, VP8, VP9, H.263, Sorenson H.263, MS-MPEG-4 v2 "
                          "or v3, WMV1, WMV2, raw or PNG")
        self.raw_format = FORMATS.get(v.compression)
        if self.codec in ("raw", "png") and (v.width <= 0 or v.height <= 0):
            raise _refuse(path, f"a {self.codec} AVI stream of {v.width}x{v.height} "
                          "(a negative height: rows stored top-down)")
        if v.rate <= 0 or v.scale <= 0:
            raise _corrupt(path, f"a video frame rate of {v.rate}/{v.scale}")
        if not self.movi:
            raise _corrupt(path, "no 'movi' list")

    # ------------------------------------------------------------- headers

    @property
    def fps(self) -> float:
        return self.video.rate / self.video.scale

    @property
    def frame_count(self) -> int:
        return self.video.length

    @property
    def extradata(self) -> bytes:
        """The video stream's extradata (WMV2's extension header)."""
        return self.video.extradata

    @property
    def width(self) -> int:
        return self.video.width

    @property
    def height(self) -> int:
        return abs(self.video.height)

    def _chunks(self, f, pos: int, end: int):
        """(fourcc, data position, size, list type or None) of each chunk
        from ``pos`` to ``end``."""
        while pos + 8 <= end:
            f.seek(pos)
            fcc, size = struct.unpack("<4sI", f.read(8))
            if pos + 8 + size > self.size:
                if fcc != b"RIFF":  # a RIFF chunk cut short is read as far as it goes
                    raise _corrupt(self.path, f"the chunk {fcc!r} at {pos} runs past the end")
                size = self.size - pos - 8
            kind = None
            if fcc in (b"LIST", b"RIFF"):
                if size < 4:
                    raise _corrupt(self.path, f"a {fcc!r} chunk of size {size}")
                kind = f.read(4)
            yield fcc, pos + 8, size, kind
            pos += 8 + size + (size & 1)

    def _read_riffs(self, f) -> None:
        for fcc, data, size, kind in self._chunks(f, 0, self.size):
            if fcc != b"RIFF" or kind not in (b"AVI ", b"AVIX"):
                continue  # trailing bytes and other chunks are skipped, as FFmpeg does
            if kind == b"AVI " and self.streams:
                break  # a second file glued on: FFmpeg stops at it too
            for cfcc, cdata, csize, ckind in self._chunks(f, data + 4, data + size):
                if cfcc == b"LIST" and ckind == b"hdrl" and kind == b"AVI ":
                    self._read_hdrl(f, cdata + 4, cdata + csize)
                elif cfcc == b"LIST" and ckind == b"movi":
                    self.movi.append((cdata, cdata + csize))
                elif cfcc == b"idx1" and kind == b"AVI ":
                    self.idx1 = (cdata, csize)

    def _read_hdrl(self, f, pos: int, end: int) -> None:
        for fcc, data, size, kind in self._chunks(f, pos, end):
            if fcc == b"LIST" and kind == b"strl":
                self._read_strl(f, data + 4, data + size)

    def _read_strl(self, f, pos: int, end: int) -> None:
        number = self.streams
        self.streams += 1
        strh = strf = indx = None
        for fcc, data, size, _ in self._chunks(f, pos, end):
            f.seek(data)
            if fcc == b"strh":
                strh = f.read(size)
            elif fcc == b"strf":
                strf = f.read(size)
            elif fcc == b"indx":
                indx = f.read(size)
        if strh is None or strh[:4] != b"vids" or self.video is not None:
            return
        if len(strh) < 36 or strf is None or len(strf) < 20:
            raise _corrupt(self.path, "a short strh or strf chunk")
        scale, rate, _start, length = struct.unpack("<4I", strh[20:36])
        width, height = struct.unpack("<ii", strf[4:12])
        (bi_size,) = struct.unpack("<I", strf[:4])
        self.video = VideoStream(number, strf[16:20], width, height, rate, scale, length, indx,
                                 strf[40:min(bi_size, len(strf))])

    # -------------------------------------------------------------- frames

    def _ids(self) -> tuple[bytes, bytes]:
        n = self.video.number
        return f"{n:02d}dc".encode(), f"{n:02d}db".encode()

    def chunk_places(self) -> list[tuple[int, int]]:
        """(data position, size) of every video chunk, in order: from the
        OpenDML indexes, else ``idx1``, else the ``movi`` lists."""
        with open(self.path, "rb") as f:
            places = self._from_odml(f)
            if places is None:
                places = self._from_idx1(f)
            if places is None:
                places = self._from_movi(f)
        return places

    def _from_odml(self, f):
        indx = self.video.super_index
        if not indx or len(indx) < 24:
            return None
        per, sub, itype, count, cid = struct.unpack("<HBBI4s", indx[:12])
        if itype != 0 or per != 4:  # AVI_INDEX_OF_INDEXES of 4-dword entries
            return None
        places = []
        for k in range(count):
            off, size, _duration = struct.unpack("<QII", indx[24 + 16 * k:40 + 16 * k])
            if off == 0:
                continue
            f.seek(off)
            fcc, csize = struct.unpack("<4sI", f.read(8))
            body = f.read(csize)
            if fcc[:2] != b"ix" or len(body) < 24:
                raise _corrupt(self.path, f"the standard index at {off} is {fcc!r}")
            sper, _sub, stype, n, _cid, base = struct.unpack("<HBBI4sQ", body[:20])
            if stype != 1 or sper != 2:  # AVI_INDEX_OF_CHUNKS of 2-dword entries
                raise _corrupt(self.path, f"the standard index at {off} has type {stype}")
            for e in range(n):
                doff, dsize = struct.unpack("<II", body[24 + 8 * e:32 + 8 * e])
                places.append((base + doff, dsize & 0x7FFFFFFF))  # bit 31: not a key frame
        return places

    def _from_idx1(self, f):
        if self.idx1 is None:
            return None
        pos, size = self.idx1
        f.seek(pos)
        raw = f.read(size - size % 16)
        ids = self._ids()
        entries = [struct.unpack("<4sIII", raw[k:k + 16]) for k in range(0, len(raw), 16)]
        entries = [(off, n) for cid, _flags, off, n in entries if cid in ids]
        if not entries:
            return None
        # offsets count from the first 'movi' tag, or (some writers) from
        # the start of the file: the first entry tells which
        movi = self.movi[0][0]
        first, _ = entries[0]
        base = movi
        for cand in (movi, 0):
            f.seek(cand + first)
            if f.read(4) in ids:
                base = cand
                break
        else:
            raise _corrupt(self.path, "the idx1 offsets point at no video chunk")
        return [(base + off + 8, n) for off, n in entries]

    def _from_movi(self, f):
        ids = self._ids()
        places = []

        def walk(pos, end):
            for fcc, data, size, kind in self._chunks(f, pos, end):
                if fcc == b"LIST" and kind == b"rec ":
                    walk(data + 4, data + size)
                elif fcc in ids:
                    places.append((data, size))
        for start, end in self.movi:
            walk(start + 4, end)
        return places

    def frames(self):
        """Each video chunk's bytes, in order, chunks of size 0 skipped."""
        places = self.chunk_places()
        with open(self.path, "rb") as f:
            for pos, size in places:
                if size == 0:
                    continue
                f.seek(pos)
                data = f.read(size)
                if len(data) != size:
                    raise _corrupt(self.path, f"a video chunk at {pos} runs past the end")
                yield data
