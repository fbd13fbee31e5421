"""An ASF (``.wmv``) demuxer for video, in plain Python.

``AsfFile(path)`` reads what ``cv2.VideoCapture`` (through FFmpeg's default
``asf`` demuxer, ``libavformat/asfdec_f.c``) reads of an ASF file's video:

- the Header Object (GUID ``75B22630-668E-11CF-A6D9-00AA0062CE6C``, whose
  first bytes ``is_asf`` tests) and its objects by GUID: the File
  Properties (file size, play duration, preroll, flags, the fixed packet
  size) and the Stream Properties of the video stream, with its
  ``BITMAPINFOHEADER`` (size, ``biCompression``) and the extradata after
  it; the Header Extension, Codec List and Content Description objects are
  passed over;
- the Data Object's packets, each of the fixed packet size: the error
  correction bytes (``82 00 00``), the length-type and property flags, the
  packet length, sequence and padding length of every length type, the
  send time and duration, then one payload or several (the payload count
  and length type), each with its stream number and key-frame bit, media
  object number, offset into the media object and replicated data (the
  media object's size and presentation time); a media object split across
  payloads and packets is put together by offset, as ``asf_parse_packet``
  does, and becomes one packet when it is whole; the padding is skipped;
- the Simple Index Object after the data is not read.

``codec`` is picked by ``biCompression`` through ``avi.codec_of`` (FFmpeg's
``ff_codec_bmp_tags``), and ``extradata`` is the extradata (WMV2's 4-byte
extension header, MPEG-4 Part 2's VOL headers).

``fps`` is cv2's ``CAP_PROP_FPS``, ``av_guess_frame_rate`` of the stream:
ASF stamps are milliseconds, so where the codec states no frame rate (or
one ``tb_unreliable`` distrusts: under 5 or from 101 frames a second)
FFmpeg's ``avformat_find_stream_info`` guesses it from the stamps it reads
(every packet's up to 40 stamp differences, or 5 s of them), by
``ff_rfps_add_frame`` and ``ff_rfps_calculate``: the ``get_std_framerate``
candidate whose phase error has the least variance, unless all the
differences share a divisor above 2 ms, which then gives 1000 / divisor.
``rate_guess`` reproduces that; 30 fps read back as 30000/1001 and 29.97 as
359/12, as cv2 reports them. MPEG-4 Part 2's VOL states a rate
(``vop_time_increment_resolution`` over the fixed increment or 1), which
``av_guess_frame_rate`` takes where ``tb_unreliable`` trusts it.
``frame_count`` is OpenCV's ``floor(duration x fps + 0.5)``, the duration
the File Properties' play duration less the preroll, in milliseconds.
Probed with cv2 5.0.0 (FFmpeg's libavformat 62.12) over rates and lengths.

Refused, each with a ValueError naming ROADMAP.md queue 1, item 4: a file
that is not ASF, one with no video stream or more than one, an encrypted
file or stream, a video stream with error correction data (which FFmpeg
uses to descramble audio), Extended Stream Properties (whose payload
extensions may carry the stamps FFmpeg reads), compressed payloads, a
header whose file size is not the file's or that marks a broadcast (cv2's
duration is then FFmpeg's estimate), and corrupt or truncated packets.
"""

from __future__ import annotations

import math
import struct
import uuid

from .avi import codec_of, named
from .imgcodecs import refuse_video

HEADER = "75B22630-668E-11CF-A6D9-00AA0062CE6C"
DATA = "75B22636-668E-11CF-A6D9-00AA0062CE6C"
FILE_PROPERTIES = "8CABDCA1-A947-11CF-8EE4-00C00C205365"
STREAM_PROPERTIES = "B7DC0791-A9B7-11CF-8EE6-00C00C205365"
HEADER_EXTENSION = "5FBF03B5-A92E-11CF-8EE3-00C00C205365"
EXTENDED_STREAM_PROPERTIES = "14E6A5CB-C672-4332-8399-A96952065B5A"
CONTENT_ENCRYPTION = ("2211B3FB-BD23-11D2-B4B7-00A0C955FC6E",
                      "298AE614-2622-4C17-B935-DAE07EE9289C")
VIDEO_MEDIA = "BC19EFC0-5B4D-11CF-A8FD-00805F5C442B"
JFIF_MEDIA = "B61BE100-5B4E-11CF-A8FD-00805F5C442B"
NO_ERROR_CORRECTION = "20FB5700-5B55-11CF-A8FD-00805F5C442B"
HEADER_GUID = uuid.UUID(HEADER).bytes_le
FRAME_HEADER_SIZE = 6  # asfdec_f.c: fewer bytes left in a packet are padding
BROADCAST = 1  # File Properties flags: the play duration is not known
MAX_DURATIONS = 40  # find_stream_info's fps_analyze_framecount at 1 ms stamps
MAX_ANALYZE_US = 5_000_000  # its max_analyze_duration
PROBE_SIZE = 5_000_000  # its probesize in bytes
# the codecs read in ASF: those cv2 writes into it
ASF_CODECS = ("msmpeg4v2", "msmpeg4v3", "wmv1", "wmv2", "mpeg4", "flv", "mjpeg")


def _refuse(path: str, what: str) -> ValueError:
    return refuse_video(path, what)


def _corrupt(path: str, what: str) -> ValueError:
    return refuse_video(path, f"corrupt or truncated ASF: {what}")


def is_asf(head: bytes) -> bool:
    """Whether the file's first bytes are the ASF Header Object's GUID."""
    return head[:16] == HEADER_GUID


def _guid(b: bytes) -> str:
    return str(uuid.UUID(bytes_le=bytes(b))).upper()


def std_framerate(i: int) -> int:
    """``get_std_framerate``: candidate ``i``'s rate x 12 x 1001."""
    if i < 30 * 12:
        return (i + 1) * 1001
    i -= 30 * 12
    if i < 30:
        return (i + 31) * 1001 * 12
    i -= 30
    if i < 3:
        return (80, 120, 240)[i] * 1001 * 12
    return (24, 30, 60, 12, 15, 48)[i - 3] * 1000 * 12


STD_RATES = 30 * 12 + 30 + 3 + 6


def rate_guess(stamps: list[int]) -> tuple[int, int] | None:
    """FFmpeg's ``r_frame_rate`` of a stream of 1 ms stamps whose codec
    states no trusted rate (``ff_rfps_add_frame`` over ``stamps``, then
    ``ff_rfps_calculate``): (num, den), or None where it sets none."""
    from .mkv import av_reduce

    n = 0
    total = 0
    gcd = 0
    err = [[[0.0] * STD_RATES, [0.0] * STD_RATES], [[0.0] * STD_RATES, [0.0] * STD_RATES]]
    last = None
    for ts in stamps:
        if last is not None and ts > last:
            dts = ts * (1 / 1000)
            duration = ts - last
            for i in range(STD_RATES):
                if err[0][1][i] < 1e10:
                    sdts = dts * std_framerate(i) / (1001 * 12)
                    for j in (0, 1):
                        ticks = round(sdts + j * 0.5)  # llrint: ties to even
                        e = sdts - ticks + j * 0.5
                        err[j][0][i] += e
                        err[j][1][i] += e * e
            n += 1
            total += duration
            if n % 10 == 0:
                for i in range(STD_RATES):
                    if err[0][1][i] < 1e10:
                        a0 = err[0][0][i] / n
                        e0 = err[0][1][i] / n - a0 * a0
                        a1 = err[1][0][i] / n
                        e1 = err[1][1][i] / n - a1 * a1
                        if e0 > 0.04 and e1 > 0.04:
                            err[0][1][i] = err[1][1][i] = 2e10
            if n > 3:
                gcd = math.gcd(gcd, duration)
        last = ts
    if n > 15 and gcd > 2:
        return av_reduce(1000, gcd, 2**31 - 1)
    if n <= 1:
        return None
    best, num = 0.01, 0
    for i in range(STD_RATES):
        rate = std_framerate(i)
        if rate < 1001 * 12:  # no codec_info_duration: rates under 1 fps are skipped
            continue
        if (1 / 1000) * total / n < (1001 * 12.0 * 0.8) / rate:
            continue
        for j in (0, 1):
            a = err[j][0][i] / n
            e = err[j][1][i] / n - a * a
            if e < best and best > 0.000000001:
                best, num = e, rate
    if num and num / (12 * 1001) < 1.01 * 1000:
        return av_reduce(num, 12 * 1001, 2**31 - 1)
    return None


def trusted(rate: tuple[int, int] | None) -> bool:
    """``tb_unreliable``'s test of a codec's frame rate, inverted: a time
    base of 1/5 s to 1/101 s."""
    if not rate or not rate[0] or not rate[1]:
        return False
    num, den = rate
    return not (num >= 101 * den or num < 5 * den)


class AsfFile:
    """An ASF file's video stream (see the module's notes)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self.data = data = f.read()
        if not is_asf(data):
            raise _refuse(path, "not an ASF file")
        self.video_id: int | None = None
        self.extradata = b""
        self.packet_size = self.min_packet = 0
        self.play_time = self.preroll = self.file_size = self.flags = 0
        self.data_start = self.data_end = None
        self._read_header()
        if self.video_id is None:
            raise _refuse(path, "an ASF file with no video stream")
        if self.data_start is None:
            raise _corrupt(path, "no Data Object")
        self.codec = codec_of(self.compression)
        if self.codec not in ASF_CODECS:
            raise _refuse(path, f"an ASF video stream of {named(self.compression)}, not MS-MPEG-4 "
                          "v2 or v3, WMV1, WMV2, MPEG-4 Part 2, Sorenson H.263 or MJPEG")
        if self.flags & BROADCAST:
            raise _refuse(path, "a broadcast ASF (no play duration): cv2's frame count is then "
                          "FFmpeg's estimate")
        self.packets, self.stamps = self._demux()
        if not self.packets:
            raise _refuse(path, "an ASF file whose video stream holds no whole frame")
        size = len(data)
        if self.file_size > 0 and abs(size - self.file_size) >= min(size, self.file_size) // 20:
            raise _refuse(path, f"an ASF whose header gives a file size of {self.file_size}, "
                          f"not {size}: cv2's duration is then FFmpeg's estimate")
        self.duration_ms = self.play_time // 10000 - self.preroll
        self.codec_rate: tuple[int, int] | None = None  # the decoder's, set by the reader

    # ------------------------------------------------------------- headers

    def _read_header(self) -> None:
        data, path = self.data, self.path
        if len(data) < 30:
            raise _corrupt(path, "a Header Object cut short")
        (size,) = struct.unpack("<Q", data[16:24])
        pos, end = 30, min(size, len(data))
        while pos + 24 <= end:
            guid = _guid(data[pos:pos + 16])
            (osize,) = struct.unpack("<Q", data[pos + 16:pos + 24])
            if osize < 24 or pos + osize > end:
                raise _corrupt(path, f"a header object of size {osize} at {pos}")
            body = data[pos + 24:pos + osize]
            if guid == FILE_PROPERTIES:
                self._file_properties(body)
            elif guid == STREAM_PROPERTIES:
                self._stream_properties(body)
            elif guid in CONTENT_ENCRYPTION:
                raise _refuse(path, "an encrypted ASF file")
            elif guid == HEADER_EXTENSION:
                self._header_extension(body)
            pos += osize
        pos = size
        if pos + 50 <= len(data) and _guid(data[pos:pos + 16]) == DATA:
            (dsize,) = struct.unpack("<Q", data[pos + 16:pos + 24])
            self.data_start = pos + 50
            # asfdec_f.c: data_object_size gsize - 24 from after its GUID and size
            self.data_end = pos + dsize if dsize >= 100 and not self.flags & BROADCAST else None

    def _file_properties(self, b: bytes) -> None:
        if len(b) < 80:
            raise _corrupt(self.path, "a File Properties object cut short")
        self.file_size, = struct.unpack("<q", b[16:24])
        self.play_time, = struct.unpack("<Q", b[40:48])
        self.preroll, _ignore, self.flags, self.min_packet, self.packet_size = struct.unpack(
            "<IIIII", b[56:76])

    def _header_extension(self, b: bytes) -> None:
        pos = 22  # reserved GUID, reserved 16 bits, data size
        while pos + 24 <= len(b):
            guid = _guid(b[pos:pos + 16])
            (osize,) = struct.unpack("<Q", b[pos + 16:pos + 24])
            if guid == EXTENDED_STREAM_PROPERTIES:
                raise _refuse(self.path, "an ASF with Extended Stream Properties (payload "
                              "extensions may carry the stamps FFmpeg reads)")
            if guid in CONTENT_ENCRYPTION:
                raise _refuse(self.path, "an encrypted ASF file")
            if osize < 24:
                break
            pos += osize

    def _stream_properties(self, b: bytes) -> None:
        path = self.path
        if len(b) < 54:
            raise _corrupt(path, "a Stream Properties object cut short")
        kind = _guid(b[:16])
        if kind not in (VIDEO_MEDIA, JFIF_MEDIA):
            return
        if self.video_id is not None:
            raise _refuse(path, "an ASF file with more than one video stream")
        ec = _guid(b[16:32])
        specific, ec_len, flags = struct.unpack("<IIH", b[40:50])
        if flags & 0x8000:
            raise _refuse(path, "an encrypted ASF video stream")
        if ec_len or ec != NO_ERROR_CORRECTION:
            raise _refuse(path, "an ASF video stream with error correction data")
        self.video_id = flags & 0x7F
        t = b[54:54 + specific]
        if kind == JFIF_MEDIA:
            raise _refuse(path, "an ASF JFIF stream")
        if len(t) < 11 + 40:
            raise _corrupt(path, "a video stream's BITMAPINFOHEADER cut short")
        (format_size,) = struct.unpack("<H", t[9:11])
        bih = t[11:]
        (bi_size,) = struct.unpack("<I", bih[:4])
        self.width, height = struct.unpack("<ii", bih[4:12])
        self.height = abs(height)
        self.compression = bytes(bih[16:20])
        if bi_size > 40:
            if format_size < bi_size - 40:
                raise _corrupt(path, f"an extradata of {bi_size - 40} bytes in a format of "
                               f"{format_size}")
            self.extradata = bytes(bih[40:bi_size])

    # -------------------------------------------------------------- packets

    def _demux(self) -> tuple[list[bytes], list[int]]:
        """``asf_read_packet``: the video stream's media objects, whole, in
        order, and each one's stamp (its presentation time less the
        preroll, in ms)."""
        data, path = self.data, self.path
        pos = self.data_start
        end = self.data_end if self.data_end is not None else len(data)
        out, stamps = [], []
        obj, obj_size, obj_stamp, frag_stamp, filled = None, 0, 0, 0, 0
        while pos < end and pos < len(data):
            start = pos
            rsize = 8
            c = data[pos]
            pos += 1
            if c & 0x80:  # error correction data: FFmpeg's writer's 82 00 00
                if c != 0x82 or data[pos] or data[pos + 1]:
                    raise _corrupt(path, f"a packet at {start} whose error correction bytes are "
                                   "not 82 00 00")
                pos += 2
                rsize += 3
                c = data[pos]
                pos += 1
            prop = data[pos]
            pos += 1

            def two_bits(kind, default):
                nonlocal pos, rsize
                n = (0, 1, 2, 4)[kind & 3]
                if not n:
                    return default
                v = int.from_bytes(data[pos:pos + n], "little")
                pos += n
                rsize += n
                return v

            length = two_bits(c >> 5, self.packet_size)
            two_bits(c >> 1, 0)  # sequence
            pad = two_bits(c >> 3, 0)
            if not length or length >= 1 << 29 or pad >= length:
                raise _corrupt(path, f"a packet at {start} of length {length}, padding {pad}")
            pos += 6  # send time, duration
            if c & 1:
                segtype = data[pos]
                pos += 1
                rsize += 1
                segments = segtype & 0x3F
            else:
                segtype, segments = 0x80, 1
            if rsize > length - pad:
                raise _corrupt(path, f"a packet header at {start} longer than its packet")
            left = length - pad - rsize
            if length < self.min_packet:
                pad += self.min_packet - length
            while left >= FRAME_HEADER_SIZE and segments >= 1:
                segments -= 1
                num = data[pos]
                pos += 1
                hsize = 1
                n_offset = (0, 1, 2, 4)[prop >> 2 & 3]
                n_replic = (0, 1, 2, 4)[prop & 3]
                n_seq = (0, 1, 2, 4)[prop >> 4 & 3]
                pos += n_seq
                frag_offset = int.from_bytes(data[pos:pos + n_offset], "little")
                pos += n_offset
                replic = int.from_bytes(data[pos:pos + n_replic], "little")
                pos += n_replic
                hsize += n_seq + n_offset + n_replic
                if hsize + replic > left:
                    raise _corrupt(path, f"replicated data of {replic} bytes in the packet at "
                                   f"{start}")
                if replic >= 8:
                    new_size, stamp = struct.unpack("<II", data[pos:pos + 8])
                    if new_size >= 1 << 24:
                        raise _corrupt(path, f"a media object of {new_size} bytes")
                    if (num & 0x7F) == self.video_id:
                        obj_size = new_size
                        frag_stamp = stamp
                elif replic == 1:
                    raise _refuse(path, "compressed ASF payloads")
                elif replic:
                    raise _corrupt(path, f"replicated data of {replic} bytes")
                pos += replic
                hsize += replic
                if c & 1:
                    n = (0, 1, 2, 4)[segtype >> 6 & 3]
                    frag = int.from_bytes(data[pos:pos + n], "little")
                    pos += n
                    hsize += n
                    if hsize > left:
                        raise _corrupt(path, f"a payload header past the packet at {start}")
                    if frag > left - hsize:
                        if frag > left - hsize + pad:
                            raise _corrupt(path, f"a payload of {frag} bytes past the packet "
                                           f"at {start}")
                        diff = frag - (left - hsize)
                        left += diff
                        pad -= diff
                else:
                    frag = left - hsize
                left -= hsize
                if (num & 0x7F) != self.video_id:
                    pos += frag
                    left -= frag
                    continue
                if not filled and frag_offset:
                    pos += frag  # a piece of an object whose start was not read
                    left -= frag
                    continue
                if obj is None or len(obj) != obj_size or filled + frag > len(obj):
                    if not obj_size:
                        raise _corrupt(path, f"a media object with no size at {start}")
                    obj = bytearray(obj_size)
                    filled = 0
                    obj_stamp = frag_stamp - self.preroll
                left -= frag
                if left < 0:
                    continue
                if frag_offset >= len(obj) or frag > len(obj) - frag_offset:
                    raise _corrupt(path, f"a payload at {frag_offset} of {frag} bytes in a media "
                                   f"object of {len(obj)}")
                if frag_offset != filled:
                    raise _refuse(path, "an ASF media object whose pieces come out of order")
                piece = data[pos:pos + frag]
                if len(piece) != frag:
                    raise _corrupt(path, "the file ends inside a payload")
                obj[frag_offset:frag_offset + frag] = piece
                pos += frag
                filled += frag
                if filled == len(obj):
                    out.append(bytes(obj))
                    stamps.append(obj_stamp)
                    obj, filled = None, 0
            pos += max(left, 0) + pad
        return out, stamps

    # ---------------------------------------------------------------- rates

    def stamps_read(self) -> list[int]:
        """The stamps ``avformat_find_stream_info`` reads before it stops:
        the first packet's difference count reaching 40, 5 s of stamps
        after the 31st packet, or 5 MB of packets."""
        read, size, diffs = [], 0, 0
        for k, (ts, pkt) in enumerate(zip(self.stamps, self.packets)):
            if diffs >= MAX_DURATIONS or size >= PROBE_SIZE:
                break
            size += len(pkt)
            # fps_first_dts is the third packet's; past 30 packets the span
            # from it stands for the analysed duration
            if k > 30 and (ts - self.stamps[2]) * 1000 >= MAX_ANALYZE_US:
                break
            if read and ts > read[-1]:
                diffs += 1
            read.append(ts)
        return read

    @property
    def fps(self) -> float:
        """cv2's ``CAP_PROP_FPS`` (see the module's notes)."""
        if trusted(self.codec_rate):
            num, den = self.codec_rate
            return num / den
        rate = rate_guess(self.stamps_read())
        if rate is None:
            return 1000.0  # r_frame_rate falls back to the time base's 1000/1
        return rate[0] / rate[1]

    @property
    def frame_count(self) -> int:
        return math.floor(self.duration_ms * 1000 / 1_000_000 * self.fps + 0.5)

    @property
    def config(self) -> bytes:
        """The extradata, as the MPEG-4 Part 2 decoder takes its headers."""
        return self.extradata

    def frames(self):
        """Each video media object's bytes, whole, in order."""
        yield from self.packets
