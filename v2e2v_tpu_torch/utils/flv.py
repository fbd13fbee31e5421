"""An FLV demuxer for Sorenson H.263 video, in plain Python.

``FlvFile(path)`` reads what ``cv2.VideoCapture`` (through FFmpeg's
``libavformat/flvdec.c``) reads of an FLV file's video: the file header
(``FLV``, version, flags, header size), then the tags after it, each
(type, data size, 32-bit millisecond time stamp, stream id, data) and the
size of the tag before it. Script tags are AMF0 values; the first
``onMetaData`` ECMA array or object gives ``duration`` and ``framerate``.
Video tags of codec id 2 (Sorenson H.263, ``codec`` ``"flv"``) give one
packet each, their first byte (frame type, codec id) dropped; video
info / command frames (frame type 5) are passed over, as are audio tags
and tags of other types.

``fps`` is what cv2 reports as ``CAP_PROP_FPS``: the stream's average frame
rate, which ``flvdec.c`` sets to ``av_d2q(framerate, 1000)`` (30000/1001 fps
written as 29.97 reads 989/33 = 29.9697). ``frame_count``
(``CAP_PROP_FRAME_COUNT``) is OpenCV's ``floor(duration x fps + 0.5)``,
``duration`` the metadata's in whole microseconds (``num_val x
AV_TIME_BASE``, truncated); where the metadata gives none (or 0), FFmpeg's
from the file's last tag: its time stamp, or the one before it where that
is 0. Probed on this host's cv2 5.0.0 at 23, 24, 25, 30000/1001, 7.5, 10,
12.34 and 60 fps and 5-13 frames, and on rewritten metadata.

Refused, each with a ValueError naming ROADMAP.md queue 1, item 4: other
video codecs (Screen video, VP6, AVC, HEVC, ...; enhanced-FLV tags), a file
without video, an FLV without ``onMetaData`` ``framerate`` (cv2's rate is
then FFmpeg's guess from the time stamps), encrypted tags, empty video
tags, and truncated files.
"""

from __future__ import annotations

import math
import struct

from .imgcodecs import refuse_video
from .mkv import av_reduce

VIDEO, SCRIPT = 9, 18  # tag types; audio (8) and others are passed over
SORENSON_H263 = 2
COMMAND_FRAME = 5
# flvdec.c's video codec ids, named in refusals
CODEC_NAMES = {1: "JPEG", 2: "Sorenson H.263", 3: "Screen video", 4: "On2 VP6",
               5: "On2 VP6 with alpha", 6: "Screen video 2", 7: "AVC (H.264)",
               12: "HEVC (H.265)"}
AV_TIME_BASE = 1000000

_refuse = refuse_video


def _corrupt(path: str, what: str) -> ValueError:
    return refuse_video(path, f"corrupt or truncated FLV: {what}")


def is_flv(head: bytes) -> bool:
    """Whether the file's first bytes open an FLV header."""
    return head[:3] == b"FLV"


def av_d2q(d: float, limit: int) -> tuple[int, int]:
    """``libavutil/rational.c::av_d2q`` for a positive ``d``: the fraction
    nearest ``d`` with both terms at most ``limit`` (0/1 under 1/(2 limit),
    as this host's libavutil gives it)."""
    exponent = max(math.frexp(d)[1] - 1, 0)
    den = 1 << (62 - exponent)
    return av_reduce(math.floor(d * den + 0.5), den, limit)


class _Amf:
    """An AMF0 reader over a script tag's data."""

    def __init__(self, data: bytes, path: str):
        self.data, self.pos, self.path = data, 0, path

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise _corrupt(self.path, "an AMF0 value cut short in a script tag")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def string(self) -> str:
        (n,) = struct.unpack(">H", self.take(2))
        return self.take(n).decode("utf-8", "replace")

    def pairs(self) -> dict:
        """An object's or ECMA array's (key, value) pairs up to the end marker."""
        out = {}
        while True:
            key = self.string()
            if not key and self.data[self.pos:self.pos + 1] == b"\x09":
                self.pos += 1
                return out
            out[key] = self.value()  # a key given twice: the last, as FFmpeg sets it

    def value(self):
        kind = self.take(1)[0]
        if kind == 0:
            return struct.unpack(">d", self.take(8))[0]
        if kind == 1:
            return bool(self.take(1)[0])
        if kind == 2:
            return self.string()
        if kind == 3:
            return self.pairs()
        if kind in (5, 6):
            return None
        if kind == 7:
            return self.take(2)
        if kind == 8:
            self.take(4)  # the array's count, which readers pass over
            return self.pairs()
        if kind == 10:
            (n,) = struct.unpack(">I", self.take(4))
            return [self.value() for _ in range(n)]
        if kind == 11:
            return self.take(10)
        if kind == 12:
            (n,) = struct.unpack(">I", self.take(4))
            return self.take(n).decode("utf-8", "replace")
        raise _corrupt(self.path, f"an AMF0 value of type {kind} in a script tag")


class FlvFile:
    """An FLV file's Sorenson H.263 video (see the module's notes)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self.data = data = f.read()
        if not is_flv(data) or len(data) < 13:
            raise _refuse(path, "not an FLV file")
        (offset,) = struct.unpack(">I", data[5:9])
        self.codec = "flv"
        self.packets: list[bytes] = []
        self.metadata: dict | None = None
        self._read_tags(offset + 4)  # past PreviousTagSize0
        if not self.packets:
            raise _refuse(path, "an FLV file with no video")
        meta = self.metadata or {}
        rate = meta.get("framerate")
        if not isinstance(rate, float) or not rate > 0:
            raise _refuse(path, f"an FLV whose onMetaData gives framerate {rate!r}: cv2's frame "
                          "rate is then FFmpeg's guess from the time stamps")
        num, den = av_d2q(rate, 1000)
        if not num:
            raise _refuse(path, f"an FLV whose onMetaData framerate {rate!r} reads as 0/1: "
                          "cv2's frame rate is then FFmpeg's guess from the time stamps")
        self.fps = num / den
        duration = meta.get("duration")
        micros = int(duration * AV_TIME_BASE) if isinstance(duration, float) else 0
        if not micros:
            micros = self._last_stamp() * AV_TIME_BASE // 1000
        if micros < 25:  # under OpenCV's eps_zero it takes the stream's duration
            raise _refuse(path, f"an FLV of duration {micros} us: cv2's frame count is then "
                          "FFmpeg's estimate")
        self.frame_count = math.floor(micros / AV_TIME_BASE * self.fps + 0.5)

    def _read_tags(self, pos: int) -> None:
        data, path = self.data, self.path
        while pos + 11 <= len(data):
            flags = data[pos]
            size = int.from_bytes(data[pos + 1:pos + 4], "big")
            body = data[pos + 11:pos + 11 + size]
            if len(body) < size:
                raise _corrupt(path, f"the tag at {pos} runs past the end of the file")
            kind = flags & 0x1F
            if flags & 0x20:
                raise _refuse(path, f"an encrypted FLV tag at {pos}")
            if kind == SCRIPT and self.metadata is None:
                amf = _Amf(body, path)
                if amf.take(1) == b"\x02" and amf.string() == "onMetaData":
                    meta = amf.value()
                    self.metadata = meta if isinstance(meta, dict) else {}
            elif kind == VIDEO and size:
                self._video(body, pos)
            elif kind == VIDEO:
                raise _refuse(path, f"an empty FLV video tag at {pos}")
            pos += 11 + size + 4

    def _video(self, body: bytes, pos: int) -> None:
        head = body[0]
        if head & 0x80:
            raise _refuse(self.path, f"an enhanced-FLV video tag (FourCC {body[1:5]!r}) at {pos}")
        codec = head & 0x0F
        if codec != SORENSON_H263:
            name = CODEC_NAMES.get(codec, f"codec id {codec}")
            raise _refuse(self.path, f"an FLV video tag of {name} (codec id {codec}), not "
                          "Sorenson H.263 (2)")
        if head >> 4 == COMMAND_FRAME:
            return
        if len(body) < 2:
            raise _refuse(self.path, f"an empty FLV video tag at {pos}")
        self.packets.append(body[1:])

    def _last_stamp(self) -> int:
        """``flv_read_packet``'s duration search: the time stamp of the tag
        the file's last PreviousTagSize points at, or of the one before it
        where that stamp is 0; 0 where none reads."""
        data, end = self.data, len(self.data)
        while end >= 8:
            (size,) = struct.unpack(">I", data[end - 4:end])
            if not 0 < size < end:
                return 0
            tag = end - 4 - size
            if size != int.from_bytes(data[tag + 1:tag + 4], "big") + 11:
                return 0
            stamp = int.from_bytes(data[tag + 4:tag + 7], "big") | data[tag + 7] << 24
            if stamp:
                return stamp
            if end - 8 < size:
                return 0
            end -= size + 4
        return 0

    def frames(self):
        """Each video packet's bytes, in file order."""
        yield from self.packets
