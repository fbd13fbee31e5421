"""Video files: the port's counterpart of ``cv2.VideoCapture`` followed by
``cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)``, which is how the JAX package's
video readers see a video.

``VideoFile(path)`` has ``fps`` and ``frame_count`` as cv2 reports them
(``CAP_PROP_FPS``, ``CAP_PROP_FRAME_COUNT``) and iterates over the frames as
``[H, W]`` uint8 gray, bit for bit what that cv2 pair returns. It picks the
container by the file's first bytes and the codec by its fourcc:

- RIFF AVI (``utils/avi.py``) of MJPEG: ``utils/jpeg.py::decode_mjpeg_frame``
  decodes each frame to its Y, Cb and Cr planes as FFmpeg's MJPEG decoder
  does, its tables carried from frame to frame, and ``utils/yuv.py``
  converts them to BGR as swscale gives them to OpenCV (gray, 4:4:4,
  4:2:2, 4:2:0, 4:1:1 and 4:4:0, baseline or progressive, full range);
- RIFF AVI of MPEG-4 Part 2 (XVID, FMP4, DIVX, DX50, MP4V), and ISO base
  media / QuickTime files (``utils/mp4.py``: MP4, MOV, M4V) of ``mp4v``:
  ``utils/mpeg4.py`` decodes each VOP as FFmpeg's ``mpeg4`` decoder does,
  and ``yuv.yuv420p_to_bgr`` converts its limited-range 4:2:0 planes; an
  MP4's ``tkhd`` quarter turn is applied as cv2 applies it
  (``CAP_PROP_ORIENTATION_AUTO``);
- Matroska and WebM files (``utils/mkv.py``) of ``V_VP8``: ``utils/vp8dec.py``
  decodes each frame as FFmpeg's ``vp8`` decoder does (a frame that is not
  shown gives none) and ``yuv.yuv420p_to_bgr`` converts its planes with
  centred chroma, at limited range (full range after a key frame whose
  ``clamping_type`` is 1, as FFmpeg decodes on one thread); of ``V_VP9``
  (profile 0): ``utils/vp9dec.py`` decodes each frame as FFmpeg's ``vp9``
  decoder does (superframes split, hidden frames giving none,
  ``show_existing_frame`` its slot's frame) and ``yuv.yuv420p_to_bgr``
  converts its planes with centred chroma, at full range where the key
  frame's ``color_range`` bit is 1; of ``V_MJPEG``, as MJPEG in AVI
  (interlaced included, tested against the track's ``PixelHeight``); of
  ``V_MPEG4/ISO/ASP``, as MPEG-4 Part 2 in MP4, the track's
  ``CodecPrivate`` holding the VOL headers. A Matroska frame whose size is
  not the track's ``PixelWidth`` x ``PixelHeight`` is refused: cv2 would
  scale it to the track's size.

Then to gray as ``cvtColor`` does. No EXIF orientation is applied: FFmpeg
does not apply one to MJPEG frames.

Interlaced MJPEG: when the first frame is under 3/4 of the stream's height
(mjpegdec.c's test), each frame is two fields, each coded at half the
height. Probed on this host's cv2 5.0.0: a packet that holds both fields
gives one frame woven from them, whatever polarity the AVI1 APP0 states:
the packet's second field on the even rows and its first on the odd ones
where FFmpeg takes the stream as bottom field first (an AVI whose
``biCompression`` is exactly ``MJPG``, a Matroska track of ``FieldOrder``
6), else the first on the even rows; a packet of one field gives no frame.
The woven planes are then converted at the full height.

Other containers (MPEG program streams, ASF/WMV, FLV, ...) and codecs
(H.264, HEVC, AV1, VP9 of profiles 1-3, ...) and other sampling factors
raise a ValueError naming ROADMAP.md queue 1, item 4.
"""

from __future__ import annotations

import numpy as np

from .avi import AviFile
from .imgcodecs import ROADMAP
from .jpeg import MjpegFrame, decode_mjpeg_frame, mjpeg_planes, read_mjpeg_frame
from .mkv import MkvFile, is_mkv
from .mp4 import Mp4File, is_mp4
from .mpeg4 import Mpeg4Decoder
from .vp8dec import Vp8Decoder
from .vp9dec import Vp9Decoder
from .yuv import MPEG4_H_POS, VP8_H_POS, bgr_to_gray, mjpeg_to_gray, yuv420p_to_bgr

# cv2's turn of a frame by the display matrix, clockwise in degrees, as
# numpy's counter-clockwise quarter turns
_TURNS = {0: 0, 90: 3, 180: 2, 270: 1}


class VideoFile:
    """A video file's gray frames (see the module's notes)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(12)
        self.avi = self.mp4 = self.mkv = None
        self.rotation = 0
        if is_mp4(head):
            self.mp4 = Mp4File(path)
            self.codec, self.rotation = "mpeg4", self.mp4.rotation
            self.container = self.mp4
        elif is_mkv(head):
            self.container = self.mkv = MkvFile(path)
            self.codec = self.mkv.codec
        else:
            self.container = self.avi = AviFile(path)
            self.codec = self.avi.codec
        self.fps, self.frame_count = self.container.fps, self.container.frame_count

    def packets(self):
        """The container's packets: AVI chunks, MP4 samples or Matroska
        blocks."""
        return self.container.frames()

    def decode(self, data: bytes, index: int, tables=None):
        """An MJPEG frame ``index``'s bytes -> (its planes' frame, as decoded);
        a field of an interlaced stream raises (``fields`` reads those)."""
        where = f"{self.path} frame {index}"
        frame = decode_mjpeg_frame(data, where, tables)
        if self.is_field(frame):
            raise ValueError(f"{where}: a {frame.planes[0].shape[0]}-row field of an interlaced "
                             f"{self.container.height}-row stream, read by VideoFile.fields "
                             f"({ROADMAP})")
        return frame

    def is_field(self, frame: MjpegFrame) -> bool:
        """mjpegdec.c's test for a field of an interlaced frame."""
        return frame.planes[0].shape[0] < self.container.height * 3 // 4

    @property
    def bottom_field_first(self) -> bool:
        """``mjpegdec.c``'s ``interlace_polarity``: 1 for a stream FFmpeg
        says is bottom field first (a Matroska ``FieldOrder``), or of an
        unknown order whose codec tag is exactly ``MJPG`` (an AVI's
        ``biCompression``; Matroska's ``V_MJPEG`` has none)."""
        if self.mkv is not None:
            return self.mkv.bottom_field_first
        return self.avi.video.compression == b"MJPG"

    def fields(self, data: bytes, index: int, tables):
        """An interlaced stream's packet -> (the frame woven from its two
        fields, or None for a packet of one field; the tables after it)."""
        where = f"{self.path} frame {index}"
        first = read_mjpeg_frame(data, where, tables)
        one = mjpeg_planes(first)
        start = data.find(b"\xff\xd8", first.end)
        if start < 0:
            return None, one.tables  # one field a packet: FFmpeg gives no frame
        second = read_mjpeg_frame(data[start:], where, one.tables)
        two = mjpeg_planes(second)
        if data.find(b"\xff\xd8", start + second.end) >= 0:
            raise ValueError(f"{where}: more than two interlaced MJPEG fields in a packet "
                             f"({ROADMAP})")
        if two.factors != one.factors or two.planes[0].shape != one.planes[0].shape:
            raise ValueError(f"{where}: interlaced MJPEG fields of different sizes or "
                             f"samplings ({ROADMAP})")
        h = 2 * one.planes[0].shape[0]
        vmax = max(v for _, v in one.factors)
        planes = []
        for (_, v), a, b in zip(one.factors, one.planes, two.planes):
            woven = np.empty((a.shape[0] + b.shape[0], a.shape[1]), np.uint8)
            if self.bottom_field_first:  # the packet's first field on the odd rows
                woven[0::2], woven[1::2] = b, a
            else:
                woven[0::2], woven[1::2] = a, b
            planes.append(woven[:-(-h * v // vmax)])
        return MjpegFrame(planes, one.factors, two.tables), two.tables

    def planes(self):
        """Each MPEG-4, VP8 or VP9 frame's (Y, Cb, Cr) planes, as FFmpeg
        decodes them."""
        if self.codec in ("vp8", "vp9"):
            self.decoder = decoder = (Vp8Decoder if self.codec == "vp8" else Vp9Decoder)(self.path)
            for data in self.packets():
                yield from decoder.decode(data)
            return
        decoder = Mpeg4Decoder(getattr(self.container, "config", b""), self.path)
        for data in self.packets():
            yield from decoder.decode(data)

    def check_size(self, shape, index: int) -> None:
        """A Matroska frame must have its track's size (cv2 would scale it)."""
        if self.mkv is not None and tuple(shape) != (self.mkv.height, self.mkv.width):
            raise ValueError(f"{self.path} frame {index}: a {shape[0]}x{shape[1]} frame in a "
                             f"{self.mkv.height}x{self.mkv.width} track, which cv2 scales "
                             f"({ROADMAP})")

    def bgr(self):
        """Each MPEG-4, VP8 or VP9 frame as cv2 converts it to BGR, unturned."""
        h_pos = VP8_H_POS if self.codec in ("vp8", "vp9") else MPEG4_H_POS
        for i, (y, cb, cr) in enumerate(self.planes()):
            self.check_size(y.shape, i)
            full = self.codec in ("vp8", "vp9") and self.decoder.full_range
            yield yuv420p_to_bgr(y, cb, cr, f"{self.path} frame {i}", h_pos, full)

    def __iter__(self):
        if self.codec in ("mpeg4", "vp8", "vp9"):
            for bgr in self.bgr():
                yield np.ascontiguousarray(np.rot90(bgr_to_gray(bgr), _TURNS[self.rotation]))
            return
        tables, interlaced = None, None
        for i, data in enumerate(self.packets()):
            if interlaced is None:  # the first frame decides, as in mjpegdec.c
                interlaced = self.is_field(decode_mjpeg_frame(data, f"{self.path} frame 0",
                                                              tables))
            if interlaced:
                frame, tables = self.fields(data, i, tables)
                if frame is None:
                    continue
            else:
                frame = self.decode(data, i, tables)
                tables = frame.tables
            self.check_size(frame.planes[0].shape, i)
            yield mjpeg_to_gray(frame.planes, frame.factors, path=f"{self.path} frame {i}")
