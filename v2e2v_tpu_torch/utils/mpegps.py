"""MPEG program streams (``.mpg``, ``.mpeg``, ``.vob``) of MPEG-1/2 video,
in plain Python: what ``cv2.VideoCapture`` (FFmpeg's ``mpeg`` demuxer,
``libavformat/mpeg.c``, and its ``mpegvideo`` parser) reads of a file's
video stream, and the rate and frame count cv2 reports for it.

``ProgramStream(path)`` walks the file's packs as FFmpeg does:

- pack headers in the MPEG-1 form (``0010``, 12 bytes) and the MPEG-2 form
  (``01``, 14 bytes and its stuffing), system headers, the program stream
  map, padding and private streams (skipped), and the program end code;
- PES packets of video streams ``0xE0``-``0xEF`` with their headers in the
  MPEG-1 form (stuffing, STD buffer, PTS or PTS and DTS) or the MPEG-2 form
  (flags, header length, PTS/DTS); audio and private streams are skipped.

``payloads`` holds each video PES packet's (PTS or None, bytes) in file
order, and ``dts`` each one's DTS (its PTS where it carries no DTS, as
FFmpeg reads it): the elementary stream that ``mpeg12dec.Mpeg12Decoder``
decodes, however the pictures are split across packets (FFmpeg's parser
joins a picture that spans PES packets and cuts one packet per frame
picture or pair of field pictures; the decoder cuts at the start codes).
``video_headers(es)`` reads the stream's first sequence header.

``fps`` is cv2's ``CAP_PROP_FPS``, FFmpeg's ``avg_frame_rate``, and the
duration behind the count is one packet at ``r_frame_rate``: both are
``mpegrate.stream_rates``' emulation of ``avformat_find_stream_info``, the
coded rate (``frame_rate_code``, times MPEG-2's ``frame_rate_extension``)
for a stream without repeated fields; a soft-telecined one
(``repeat_first_field`` on some pictures, as NTSC film DVDs are coded) may
report another, as cv2 does.

``frame_count`` is cv2's ``CAP_PROP_FRAME_COUNT``: FFmpeg gives a program
stream no frame count, so OpenCV takes ``floor(duration x fps + 0.5)``,
and FFmpeg estimates ``duration`` from the PES time stamps
(``estimate_timings_from_pts``): the largest PTS of the video packets read
from the file's tail (the whole file, up to 250 000 bytes from its end:
past the end of any stream that reaches it), plus one packet's duration in
90 kHz ticks rounded down (``compute_frame_duration`` at ``r_frame_rate``),
less the stream's start time (``mpegrate.stream_rates``: the first
packet's PTS, or where the first packets carry none, FFmpeg's stamps for
them counted back from the first that does), rescaled to whole
microseconds (to nearest). A PES packet carries a PTS only for the first
picture that starts in it, so where one packet holds several pictures
(small frames) the count falls short of the frames: cv2's 12-frame
MPEG-1 clip at 48x32 says 8, an 8x8 one 1 (``pts_frame_count``; pinned by
``tests/test_torch_mpeg12_video.py`` on a seeded sweep of sizes, lengths,
rates, content and telecine cadences).

Refused, each with a ValueError naming ROADMAP.md queue 1, item 4: files
that are not program streams, several video streams, video of another
codec (the elementary stream must open with an MPEG-1/2 sequence header),
a video stream with no PTS, or none in the packets cv2 analyses for its
rate (its count would come from the bit rate), and corrupt or truncated
packs.
"""

from __future__ import annotations

from .imgcodecs import ROADMAP, refuse_video
from .mpeg12 import SEQUENCE, StreamHeaders, start_codes
from .mpeg4 import Bits
from .mpegrate import stream_rates

PACK, END = 0xBA, 0xB9
VIDEO_IDS = range(0xE0, 0xF0)
TICKS = 90000  # PES time stamps' clock
TAIL = 250000  # estimate_timings_from_pts's read size


refuse = refuse_video


def corrupt(path: str, what: str) -> ValueError:
    return ValueError(f"{path}: corrupt or truncated MPEG stream: {what} ({ROADMAP})")


def is_program_stream(head: bytes) -> bool:
    return head[:4] == b"\x00\x00\x01\xba"


def read_pts(b: bytes, at: int) -> int:
    """A 33-bit time stamp of five bytes (its marker bits ignored, as FFmpeg
    ignores them)."""
    return (((b[at] >> 1) & 7) << 30 | b[at + 1] << 22 | (b[at + 2] >> 1) << 15
            | b[at + 3] << 7 | b[at + 4] >> 1)


def pes_payload(body: bytes, path: str) -> tuple[int | None, int | None, bytes]:
    """A PES packet's (PTS, DTS, payload) after its length field, its header
    in the MPEG-1 or the MPEG-2 form (``mpegps_read_pes_header``; the DTS is
    the PTS where none is coded)."""
    k = 0
    n = len(body)
    try:
        while body[k] == 0xFF:  # stuffing
            k += 1
        c = body[k]
        pts = dts = None
        if c & 0xC0 == 0x40:  # STD buffer scale and size
            k += 2
            c = body[k]
        if c & 0xE0 == 0x20:  # MPEG-1: PTS, or PTS and DTS
            pts = dts = read_pts(body, k)
            if c & 0x10:
                dts = read_pts(body, k + 5)
            k += 10 if c & 0x10 else 5
        elif c & 0xC0 == 0x80:  # MPEG-2
            flags, hlen = body[k + 1], body[k + 2]
            if k + 3 + hlen > n:
                raise corrupt(path, "a PES header longer than its packet")
            if flags & 0x80:
                pts = dts = read_pts(body, k + 3)
                if flags & 0x40:
                    dts = read_pts(body, k + 8)
            k += 3 + hlen
        elif c == 0x0F:
            k += 1
        else:
            raise corrupt(path, f"a PES header byte 0x{c:02X}")
    except IndexError:
        raise corrupt(path, "a PES header cut short") from None
    return pts, dts, body[k:]


def video_headers(es: bytes, path: str) -> StreamHeaders:
    """The elementary stream's first sequence header (and extension)."""
    codes = start_codes(es)
    if not codes or codes[0][0] != SEQUENCE:
        raise refuse(path, "a video stream that does not open with an MPEG-1/2 sequence "
                     "header")
    h = StreamHeaders(path)
    bits = Bits(es[:codes[2][1] if len(codes) > 2 else len(es)])
    bits.pos = 8 * codes[0][1]
    h.sequence(bits)
    if len(codes) > 1 and codes[1][0] == 0xB5:
        bits.pos = 8 * codes[1][1]
        h.extension(bits, SEQUENCE)
    return h


def rates(payloads, dts, seq, transport: bool, path: str):
    """(fps, ``r_frame_rate``, start time) of a stream's video PES packets
    (``payloads`` (PTS, bytes), ``dts`` their DTS) as cv2 reads them
    (``mpegrate.stream_rates``)."""
    es, pes = bytearray(), []
    for (pts, data), d in zip(payloads, dts):
        if data:
            pes.append((len(es), len(es) + len(data), pts, d))
            es += data
    avg, rate, start = stream_rates(bytes(es), pes, seq.fps, seq.mpeg2, transport)
    if start is None:
        where = ("" if all(pts is None for pts, _ in payloads)
                 else " in the packets cv2 analyses for its rate")
        raise refuse(path, f"a video stream with no PTS{where} (cv2's count would come from the "
                     "bit rate)")
    return avg, rate, start


def pts_frame_count(packets: list[tuple[int, int, int | None]], size: int,
                    fps: tuple[int, int], rate: tuple[int, int], start: int, path: str) -> int:
    """cv2's ``get_total_frames`` for a program or transport stream (see the
    module's notes): ``packets`` holds each video packet's (file position,
    payload bytes, PTS or None) in file order, ``size`` the file's; ``fps``
    is cv2's rate, ``rate`` the packets' (``r_frame_rate``), ``start`` the
    stream's start time (``rates``).

    ``estimate_timings_from_pts`` reads from ``size - (250000 << r)`` (at
    least 0) for r = 0, 1, ... 6 until a pass finds a PTS, each pass
    stopping once the payloads it has read reach ``250000 << max(r - 1,
    0)`` bytes; the largest PTS of that pass ends the duration."""
    stamped = [p for _, _, p in packets if p is not None]
    if not stamped:
        raise refuse(path, "a video stream with no PTS (cv2's count would come from the bit "
                     "rate)")
    last = None
    for retry in range(7):
        offset = max(0, size - (TAIL << retry))
        limit = TAIL << max(retry - 1, 0)
        read = 0
        for pos, nbytes, pts in packets:
            if pos < offset:
                continue
            if read >= limit:
                break
            read += nbytes
            if pts is not None:
                last = pts if last is None else max(last, pts)
        if last is not None or offset == 0:
            break
    if last is None:
        raise refuse(path, "no PTS within FFmpeg's reach of the file's end")
    num, den = fps
    frame = TICKS * rate[1] // rate[0]  # av_rescale_rnd(1, 90000 den, num, AV_ROUND_DOWN)
    ticks = last + frame - start
    if ticks <= 0:
        raise refuse(path, f"PTS that go back from {start} to {last}")
    micros = (ticks * 1000000 + TICKS // 2) // TICKS
    return int(micros / 1e6 * (num / den) + 0.5)


class ProgramStream:
    """An MPEG program stream's video (see the module's notes)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            d = f.read()
        if not is_program_stream(d):
            raise refuse(path, "not an MPEG program stream")
        self.size = len(d)
        self.stream_id = None
        self.payloads: list[tuple[int | None, bytes]] = []
        self.dts: list[int | None] = []
        self.starts: list[int] = []  # each video packet's file position
        pos, n = 0, len(d)
        while pos + 4 <= n:
            if d[pos:pos + 3] != b"\x00\x00\x01":
                nxt = d.find(b"\x00\x00\x01", pos)  # FFmpeg resyncs at the next start code
                if nxt < 0:
                    break
                pos = nxt
                continue
            code = d[pos + 3]
            if code == PACK:
                if pos + 5 > n:
                    break
                if d[pos + 4] >> 6 == 1:  # MPEG-2
                    if pos + 14 > n:
                        raise corrupt(path, f"a pack header at {pos} cut short")
                    pos += 14 + (d[pos + 13] & 7)
                else:
                    pos += 12
                continue
            if code == END:
                pos += 4
                continue
            if code < 0xB9:
                pos += 4  # not a system start code: FFmpeg skips it
                continue
            if pos + 6 > n:
                raise corrupt(path, f"a packet at {pos} cut short")
            size = d[pos + 4] << 8 | d[pos + 5]
            if pos + 6 + size > n:
                raise corrupt(path, f"the packet 0x{code:02X} at {pos} runs past the end")
            if code in VIDEO_IDS:
                if self.stream_id is None:
                    self.stream_id = code
                elif code != self.stream_id:
                    raise refuse(path, "a program stream of several video streams "
                                 f"(0x{self.stream_id:02X} and 0x{code:02X})")
                pts, dts, data = pes_payload(d[pos + 6:pos + 6 + size], path)
                self.payloads.append((pts, data))
                self.dts.append(dts)
                self.starts.append(pos)
            pos += 6 + size
        if self.stream_id is None:
            raise refuse(path, "a program stream with no video stream")
        self.es = b"".join(p for _, p in self.payloads)
        self.headers = video_headers(self.es, path)
        self.seq = self.headers.seq
        pictures = self.es.count(b"\x00\x00\x01\x00")
        if pictures < 3:
            raise refuse(path, f"a stream of {pictures} pictures, whose rate and count cv2 "
                         "takes from too few time stamps")
        avg, rate, start = rates(self.payloads, self.dts, self.seq, False, path)
        self.fps = avg[0] / avg[1]
        self.frame_count = pts_frame_count(
            [(pos, len(data), pts) for pos, (pts, data) in zip(self.starts, self.payloads)],
            self.size, avg, rate, start, path)

    def frames(self):
        """The video elementary stream, one PES payload at a time."""
        for _, data in self.payloads:
            yield data
