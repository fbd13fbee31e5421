"""MPEG transport streams (``.ts``, and ``.m2ts``/``.mts`` of 192-byte
packets) of MPEG-1/2 video, in plain Python: what ``cv2.VideoCapture``
(FFmpeg's ``mpegts`` demuxer, ``libavformat/mpegts.c``) reads of a file's
video, and the rate and frame count cv2 reports for it.

``TransportStream(path)`` reads the file's 188-byte packets (192-byte ones
with their 4-byte ``TP_extra_header`` in front of the sync byte, as
Blu-ray's M2TS writes them):

- the program association table (PID 0) and the one program's map (its
  PMT), whose first elementary stream of ``stream_type`` 0x01 (MPEG-1
  video) or 0x02 (MPEG-2 video) is the video;
- that PID's packets: the adaptation field skipped, a PES started at each
  ``payload_unit_start_indicator`` and its header read as in a program
  stream (``mpegps.pes_payload``).

``payloads`` holds each PES packet's (PTS or None, payload), the
elementary stream ``mpeg12dec.Mpeg12Decoder`` decodes; ``fps`` and
``frame_count`` are cv2's, by the rules of ``mpegps.py`` (FFmpeg's
``estimate_timings_from_pts`` serves both demuxers), each PES placed at
its first packet.

Refused, each with a ValueError naming ROADMAP.md queue 1, item 4: several
programs, several video streams, other video codecs (H.264, HEVC, ...), a
discontinuity (``discontinuity_indicator``, or a continuity counter that
skips), scrambled packets, and corrupt or truncated packets and tables.
"""

from __future__ import annotations

from .mpegps import corrupt, packet_rate, pes_payload, pts_frame_count, refuse, video_headers

SYNC = 0x47
MPEG_VIDEO = {0x01: "MPEG-1", 0x02: "MPEG-2"}
NAMED = {0x10: "MPEG-4 Part 2", 0x1B: "H.264 (AVC)", 0x24: "H.265 (HEVC)", 0x42: "AVS",
         0xD1: "Dirac", 0xEA: "VC-1"}
VIDEO_TYPES = set(MPEG_VIDEO) | set(NAMED)


def packet_size(d: bytes) -> int | None:
    """188 or 192 where the file's first packets keep their sync bytes."""
    for size, lead in ((188, 0), (192, 4)):
        if len(d) >= lead + size and all(d[lead + k * size] == SYNC
                                         for k in range(min(4, (len(d) - lead) // size))):
            return size
    return None


def is_transport_stream(head: bytes) -> bool:
    return packet_size(head) is not None


class TransportStream:
    """An MPEG transport stream's video (see the module's notes)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            d = f.read()
        self.size = len(d)
        size = packet_size(d[:192 * 5])
        if size is None:
            raise refuse(path, "not an MPEG transport stream")
        lead = size - 188
        sections: dict[int, bytes] = {}
        pmt_pid = video_pid = None
        self.payloads: list[tuple[int | None, bytes]] = []
        self.starts: list[int] = []
        pes, pes_pos, counter = None, 0, None
        for pos in range(0, len(d) - size + 1, size):
            p = d[pos + lead:pos + size]
            if p[0] != SYNC:
                raise corrupt(path, f"a transport packet at {pos} without its sync byte")
            start = p[1] & 0x40
            pid = (p[1] & 0x1F) << 8 | p[2]
            if p[3] & 0xC0:
                raise refuse(path, f"scrambled packets on PID {pid}")
            control = (p[3] >> 4) & 3
            k = 4
            if control & 2:  # an adaptation field
                alen = p[4]
                if alen and p[5] & 0x80 and pid == video_pid:
                    raise refuse(path, "a discontinuity in the video stream")
                k = 5 + alen
            if not control & 1 or k > 188:
                continue
            body = p[k:]
            if pid == video_pid:
                cc = p[3] & 15
                if counter is not None and cc != (counter + 1) & 15:
                    raise refuse(path, f"a continuity counter that skips from {counter} to "
                                 f"{cc} (lost video packets)")
                counter = cc
                if start:
                    if pes is not None:
                        self._pes(pes, pes_pos)
                    pes, pes_pos = bytearray(body), pos
                elif pes is not None:
                    pes += body
                continue
            if pid == 0 or (pmt_pid is not None and pid == pmt_pid):
                if start:
                    body = body[1 + body[0]:]  # pointer_field
                    sections[pid] = bytes(body)
                elif pid in sections:
                    sections[pid] += body
                sec = sections.get(pid, b"")
                if len(sec) < 3 or len(sec) < 3 + ((sec[1] & 0x0F) << 8 | sec[2]):
                    continue
                sec = sec[:3 + ((sec[1] & 0x0F) << 8 | sec[2])]
                if pid == 0 and pmt_pid is None:
                    pmt_pid = self._pat(sec)
                elif pid == pmt_pid and video_pid is None:
                    video_pid = self._pmt(sec)
        if pes is not None:
            self._pes(pes, pes_pos)
        if video_pid is None:
            raise refuse(path, "a transport stream with no MPEG-1/2 video in its program map")
        if not self.payloads:
            raise corrupt(path, "no video packets")
        self.es = b"".join(data for _, data in self.payloads)
        self.headers = video_headers(self.es, path)
        self.seq = self.headers.seq
        if not self.seq.mpeg2:
            raise refuse(path, "MPEG-1 video in a transport stream, whose rate and count cv2 "
                         "reports at twice the coded rate")
        num, den = self.seq.fps
        self.fps = num / den
        pictures = self.es.count(b"\x00\x00\x01\x00")
        if pictures < 3:
            raise refuse(path, f"a stream of {pictures} pictures, whose rate and count cv2 "
                         "takes from too few time stamps")
        self.frame_count = pts_frame_count(
            [(pos, len(data), pts) for pos, (pts, data) in zip(self.starts, self.payloads)],
            self.size, self.seq.fps, packet_rate(self.seq.fps, self.seq.mpeg2, pictures), path)

    def _pes(self, pes: bytearray, pos: int) -> None:
        if len(pes) < 6 or pes[:3] != b"\x00\x00\x01":
            raise corrupt(self.path, f"a video PES at {pos} without its start code")
        pts, data = pes_payload(bytes(pes[6:]), self.path)
        length = pes[4] << 8 | pes[5]
        if length:  # a bounded packet: its stated length, the rest is stuffing
            data = data[:max(0, length - (len(pes) - 6 - len(data)))]
        self.payloads.append((pts, data))
        self.starts.append(pos)

    def _pat(self, sec: bytes) -> int:
        if sec[0] != 0:
            raise corrupt(self.path, f"a program association table of table_id {sec[0]}")
        programs = [(sec[k] << 8 | sec[k + 1], (sec[k + 2] & 0x1F) << 8 | sec[k + 3])
                    for k in range(8, len(sec) - 4, 4)]
        programs = [(num, pid) for num, pid in programs if num != 0]  # 0: the network PID
        if len(programs) != 1:
            raise refuse(self.path, f"a transport stream of {len(programs)} programs")
        return programs[0][1]

    def _pmt(self, sec: bytes) -> int:
        if sec[0] != 2:
            raise corrupt(self.path, f"a program map of table_id {sec[0]}")
        info = (sec[10] & 0x0F) << 8 | sec[11]
        k = 12 + info
        videos = []
        while k + 5 <= len(sec) - 4:
            kind, pid = sec[k], (sec[k + 1] & 0x1F) << 8 | sec[k + 2]
            k += 5 + ((sec[k + 3] & 0x0F) << 8 | sec[k + 4])
            if kind in VIDEO_TYPES:
                videos.append((kind, pid))
        if not videos:
            raise refuse(self.path, "a program with no video stream")
        if len(videos) > 1:
            raise refuse(self.path, f"a program of {len(videos)} video streams")
        kind, pid = videos[0]
        if kind not in MPEG_VIDEO:
            what = NAMED.get(kind, f"stream_type 0x{kind:02X}")
            raise refuse(self.path, f"a program of {what} video")
        return pid

    def frames(self):
        """The video elementary stream, one PES payload at a time."""
        for _, data in self.payloads:
            yield data
