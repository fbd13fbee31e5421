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
  scale it to the track's size;
- MPEG-1 and MPEG-2 video (``codec`` ``"mpeg1"`` or ``"mpeg2"``, told by the
  stream's sequence extension) in MPEG program streams (``utils/mpegps.py``:
  ``.mpg``, ``.mpeg``, ``.vob``), transport streams (``utils/mpegts.py``:
  ``.ts``, ``.m2ts``), AVI (``mpg1``, ``mpg2``), MP4/MOV (object types
  0x60-0x65 and 0x6A, ``m2v1``) and Matroska (``V_MPEG1``, ``V_MPEG2``):
  ``utils/mpeg12dec.py`` decodes 4:2:0 frame pictures, progressive and
  interlaced, and pairs of field pictures (I, P and B) as FFmpeg's
  ``mpeg1video`` / ``mpeg2video`` decoders do, and ``yuv.yuv420p_to_bgr``
  converts their limited-range planes with MPEG-1's centred chroma or
  MPEG-2's left-sited chroma (probed on odd sizes). cv2 5.0.0 returns an
  unconverted buffer for a frame FFmpeg flags interlaced (field pictures,
  ``progressive_frame`` 0 in an interlaced sequence; ``mpeg12dec.py``); the
  port converts those as cv2 converts the others. A program or transport
  stream's ``fps`` and ``frame_count`` are FFmpeg's estimates from its time
  stamps and repeated fields (``mpegrate.py``, ``mpegps.py``), as cv2
  reports them; the count may fall short of the frames;
- H.263 (``codec`` ``"h263"``) in AVI (H263, U263, X263, M263, T263, L263,
  VX1K, lsvm), MOV (``h263``, ``s263``, ``H263``) and Matroska
  (``V_MS/VFW/FOURCC`` carrying H263), and Sorenson H.263 (``"flv"``) in FLV
  files (``utils/flv.py``: codec id 2), AVI (FLV1, S263), MOV (``FLV1``)
  and Matroska (FLV1): ``utils/h263.py`` decodes each picture as FFmpeg's
  ``h263`` / ``flv`` decoders do, and ``yuv.yuv420p_to_bgr`` converts its
  limited-range planes with centred chroma (probed on FLV pictures of odd
  sizes; H.263's five sizes are even, which the unscaled converter takes);
- MS-MPEG-4 v2 (``codec`` ``"msmpeg4v2"``: MP42, DIV2), v3
  (``"msmpeg4v3"``: MP43, DIV3, MPG3, DIV4, DIV5, DIV6, DVX3, AP41, COL1,
  COL0), WMV1 and WMV2 in ASF files (``utils/asf.py``: ``.wmv``), AVI,
  Matroska (``V_MPEG4/MS/V3``, ``V_MS/VFW/FOURCC``) and MOV (``3IVD``, MP42,
  DIV2, WMV1, WMV2): ``utils/msmpeg4.py`` and ``utils/wmv2.py`` decode each
  picture as FFmpeg's ``msmpeg4v2``, ``msmpeg4``, ``wmv1`` and ``wmv2``
  decoders do, at the container's size (the streams carry none; WMV2's
  extension header is the extradata), and ``yuv.yuv420p_to_bgr`` converts
  their limited-range planes with centred chroma (probed on 129x95
  rewrites of cv2's 130x96 clips); and MPEG-4 Part 2 (FMP4), Sorenson H.263
  (FLV1) and MJPEG in ASF, by the decoders above. An ASF's ``fps`` and
  ``frame_count`` are cv2's guesses from its millisecond stamps
  (``asf.py``);
- the same decoders under the other tags and containers cv2 writes them
  into: MJPEG in AVI as CJPG, LJPG, JPGL or mjpa, in MOV as ``jpeg`` or
  ``mjpa`` and in MP4 as ``mp4v`` of object type 0x6C; MPEG-4 Part 2 in AVI
  as MP4S or M4S2 and in MOV as ``XVID`` or ``DIVX``; VP8 and VP9 in AVI
  (VP80, VP90) and VP9 in MP4 (``vp09``);
- raw video (``codec`` ``"raw"``): I420, IYUV, YV12, Y800, GREY and RGBA in
  AVI, RGBA in MOV, and ``V_UNCOMPRESSED`` of those layouts in Matroska,
  read as FFmpeg's ``rawvideo`` decoder reads them and converted as swscale
  converts them (``utils/rawvideo.py::raw_to_bgr``); a packet shorter than
  a frame ends the read there, as it ends cv2's;
- PNG video (``codec`` ``"png"``): MPNG in AVI, ``png `` in MOV, ``mp4v``
  of object type 0x6D in MP4, and ``V_MS/VFW/FOURCC`` carrying MPNG in
  Matroska: each frame's samples as FFmpeg's ``png`` decoder gives them,
  to BGR as swscale does (``rawvideo.png_to_bgr``), then to gray by
  ``cvtColor``, not by ``cv2.imread``'s libpng gray. A PNG frame whose size
  is not the stream's is refused.

Then to gray as ``cvtColor`` does, and an MP4/MOV track's quarter turn
applied. No EXIF orientation is applied: FFmpeg applies none to MJPEG or
PNG frames.

Interlaced MJPEG: when the first frame is under 3/4 of the stream's height
(mjpegdec.c's test), each frame is two fields, each coded at half the
height. Probed on this host's cv2 5.0.0: a packet that holds both fields
gives one frame woven from them, whatever polarity the AVI1 APP0 states:
the packet's second field on the even rows and its first on the odd ones
where FFmpeg takes the stream as bottom field first (an AVI whose
``biCompression`` is exactly ``MJPG``, a Matroska track of ``FieldOrder``
6), else the first on the even rows; a packet of one field gives no frame.
The woven planes are then converted at the full height.

Other containers (raw MPEG video elementary streams, ...) and codecs
(H.264, HEVC, AV1, H.263+, MS-MPEG-4 v1, WMV3 / VC-1, VP6 and the other FLV
codecs, VP9 of profiles 1-3, MPEG-2 4:2:2 and 4:4:4, 16-bit PNG,
other raw layouts, ...) and other sampling factors raise a
ValueError naming ROADMAP.md queue 1, item 4; every such refusal of a file
says what the port reads (``imgcodecs.VIDEO_READS``).
"""

from __future__ import annotations

import numpy as np

from .asf import AsfFile, is_asf
from .avi import AviFile
from .flv import FlvFile, is_flv
from .h263 import H263Decoder
from .imgcodecs import ROADMAP, refuse_video
from .jpeg import MjpegFrame, decode_mjpeg_frame, mjpeg_planes, read_mjpeg_frame
from .mkv import MkvFile, is_mkv
from .mp4 import Mp4File, is_mp4
from .mpeg4 import Bits, Mpeg4Decoder
from .mpeg12 import SEQUENCE
from .mpeg12dec import Mpeg12Decoder
from .mpegps import ProgramStream, is_program_stream, video_headers
from .mpegts import TransportStream, is_transport_stream
from .msmpeg4 import MsMpeg4Decoder
from .rawvideo import png_to_bgr, raw_to_bgr
from .vp8dec import Vp8Decoder
from .vp9dec import Vp9Decoder
from .wmv2 import Wmv2Decoder
from .yuv import MPEG4_H_POS, VP8_H_POS, bgr_to_gray, mjpeg_to_gray, yuv420p_to_bgr

# cv2's turn of a frame by the display matrix, clockwise in degrees, as
# numpy's counter-clockwise quarter turns
_TURNS = {0: 0, 90: 3, 180: 2, 270: 1}
MSMPEG4 = ("msmpeg4v2", "msmpeg4v3", "wmv1", "wmv2")
# codecs whose 4:2:0 chroma swscale takes as centred (probed on odd sizes)
CENTRED = ("vp8", "vp9", "mpeg1", "h263", "flv") + MSMPEG4


class VideoFile:
    """A video file's gray frames (see the module's notes)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(192 * 5)
        self.avi = self.mp4 = self.mkv = None
        self.rotation = 0
        self.syntax_log: list | None = None  # a list: each MPEG-1/2 picture's syntax, kept
        if is_mp4(head):
            self.mp4 = Mp4File(path)
            self.codec, self.rotation = self.mp4.codec, self.mp4.rotation
            self.container = self.mp4
        elif is_mkv(head):
            self.container = self.mkv = MkvFile(path)
            self.codec = self.mkv.codec
        elif is_program_stream(head):
            self.container = ProgramStream(path)
            self.codec = "mpeg12"
        elif head[:4] == b"\x00\x00\x01\xb3":
            raise refuse_video(path, "an MPEG video elementary stream (no container: cv2's "
                               "frame count for it is not a count)")
        elif is_transport_stream(head):
            self.container = TransportStream(path)
            self.codec = "mpeg12"
        elif is_flv(head):
            self.container = FlvFile(path)
            self.codec = self.container.codec
        elif is_asf(head):
            self.container = AsfFile(path)
            self.codec = self.container.codec
            if self.codec == "mpeg4":
                self.container.codec_rate = self._vol_rate()
        else:
            self.container = self.avi = AviFile(path)
            self.codec = self.avi.codec
        if self.codec == "mpeg12":
            self.codec = "mpeg2" if self._sequence().seq.mpeg2 else "mpeg1"
        self.fps, self.frame_count = self.container.fps, self.container.frame_count

    def _vol_rate(self) -> tuple[int, int] | None:
        """An MPEG-4 Part 2 stream's frame rate as FFmpeg's decoder states it
        (``vop_time_increment_resolution`` over the fixed increment), from
        the extradata's VOL or the first packet's."""
        dec = Mpeg4Decoder(self.container.extradata, self.path)
        if dec.vol is None:
            dec._headers(Bits(next(iter(self.packets()), b"")))
        v = dec.vol
        return None if v is None else (v.time_resolution, v.fixed_increment or 1)

    def _sequence(self):
        """An MPEG-1/2 stream's first sequence header: the container's
        configuration (a Matroska ``CodecPrivate``) or its first packet."""
        config = getattr(self.container, "config", b"")
        first = next(iter(self.packets()), b"")
        data = config if config.startswith(bytes([0, 0, 1, SEQUENCE])) else first
        try:
            return video_headers(data, self.path)
        except ValueError as e:
            what = "an MPEG-1/2 video track"
            if self.mp4 is not None:
                what = (f"an '{self.mp4.fourcc.decode('latin-1')}' track of object type "
                        f"0x{self.mp4.object_type:02X}")
            raise refuse_video(self.path, f"{what} whose first packet opens with no valid "
                               f"MPEG-1/2 sequence header") from e

    def packets(self):
        """The container's packets: AVI chunks, MP4 samples, Matroska blocks,
        PES payloads or FLV video tags."""
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
        ``biCompression``; Matroska's ``V_MJPEG`` and MP4/MOV entries have
        none: ``mp4.py`` refuses a ``fiel`` box of two fields)."""
        if self.mkv is not None:
            return self.mkv.bottom_field_first
        return self.avi is not None and self.avi.video.compression == b"MJPG"

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
        """Each MPEG-4, MPEG-1/2, VP8, VP9, H.263, Sorenson H.263, MS-MPEG-4
        or WMV frame's (Y, Cb, Cr) planes, as FFmpeg decodes them."""
        if self.codec in ("mpeg1", "mpeg2"):
            self.decoder = decoder = Mpeg12Decoder(self.path)
            decoder.syntax_log = self.syntax_log
            config = getattr(self.container, "config", b"")
            if config:
                yield from decoder.decode(config)
            for data in self.packets():
                yield from decoder.decode(data)
            yield from decoder.flush()
            return
        if self.codec in ("vp8", "vp9", "h263", "flv") + MSMPEG4:
            c = self.container
            if self.codec == "wmv2":
                self.decoder = decoder = Wmv2Decoder(c.width, c.height, c.extradata, self.path)
            elif self.codec in MSMPEG4:
                self.decoder = decoder = MsMpeg4Decoder(self.codec, c.width, c.height,
                                                        getattr(c, "extradata", b""), self.path)
            elif self.codec in ("h263", "flv"):
                self.decoder = decoder = H263Decoder(self.codec, self.path)
            else:
                self.decoder = decoder = (Vp8Decoder if self.codec == "vp8" else
                                          Vp9Decoder)(self.path)
            for data in self.packets():
                yield from decoder.decode(data)
            return
        decoder = Mpeg4Decoder(getattr(self.container, "config", b""), self.path)
        for data in self.packets():
            yield from decoder.decode(data)

    def check_size(self, shape, index: int) -> None:
        """A Matroska frame must have its track's size (cv2 would scale it),
        and a PNG frame its stream's."""
        c = self.container
        if (self.mkv is not None or self.codec == "png") and tuple(shape) != (c.height, c.width):
            raise ValueError(f"{self.path} frame {index}: a {shape[0]}x{shape[1]} frame in a "
                             f"{c.height}x{c.width} track, which cv2 scales ({ROADMAP})")

    def bgr(self):
        """Each MPEG-4, MPEG-1/2, VP8, VP9, H.263, Sorenson H.263, MS-MPEG-4,
        WMV, raw or PNG frame as cv2 converts it to BGR, unturned."""
        if self.codec in ("raw", "png"):
            c = self.container
            for i, data in enumerate(self.packets()):
                if self.codec == "png":
                    bgr = png_to_bgr(data, f"{self.path} frame {i}")
                    self.check_size(bgr.shape[:2], i)
                else:
                    bgr = raw_to_bgr(data, c.raw_format, c.width, c.height,
                                     f"{self.path} frame {i}")
                    if bgr is None:  # a short packet: FFmpeg's decoder fails, cv2's read ends
                        return
                yield bgr
            return
        h_pos = VP8_H_POS if self.codec in CENTRED else MPEG4_H_POS
        for i, (y, cb, cr) in enumerate(self.planes()):
            self.check_size(y.shape, i)
            full = self.codec in ("vp8", "vp9") and self.decoder.full_range
            yield yuv420p_to_bgr(y, cb, cr, f"{self.path} frame {i}", h_pos, full)

    def __iter__(self):
        turns = _TURNS[self.rotation]
        if self.codec != "mjpeg":
            for bgr in self.bgr():
                yield np.ascontiguousarray(np.rot90(bgr_to_gray(bgr), turns))
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
            gray = mjpeg_to_gray(frame.planes, frame.factors, path=f"{self.path} frame {i}")
            yield np.ascontiguousarray(np.rot90(gray, turns))
