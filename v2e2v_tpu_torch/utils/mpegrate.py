"""The rate cv2 reports for MPEG-1/2 video in program and transport streams,
and the packet rate behind its frame count, in plain Python: what
``avformat_find_stream_info`` (FFmpeg's ``libavformat/demux.c``) leaves in
``avg_frame_rate`` (``CAP_PROP_FPS``) and ``r_frame_rate`` when it reads a
stream through the ``mpegvideo`` parser.

``stream_rates(es, pes, fps, mpeg2, transport)`` takes the elementary
stream, each video PES packet's (offset in ``es``, end, PTS, DTS), the
coded rate and whether the stream is a transport stream's, and emulates:

- the parser (``mpeg1_find_frame_end``, ``av_parser_parse2``), run only as
  far as the loop below reads (a stream's open costs the analysis, not the
  file's length): one packet
  per frame picture or per pair of field pictures, cut where a start code
  other than a slice follows the slices (or after a sequence end code);
  each packet stamped with the PTS and DTS of the PES packet in which its
  picture start code lies, taken once (``ff_fetch_timestamp``, a ring of
  four PES descriptors, one descriptor per PES packet); its picture type
  and ``repeat_pict`` from its last picture coding extension: 1, 2 where
  ``repeat_first_field`` is set in an interlaced sequence on a progressive
  frame (soft telecine), 3 or 5 in a progressive sequence;
- ``compute_pkt_fields``: each packet's duration, ``(1 + repeat_pict)``
  fields of ``1 / (2 x fps)`` in 90 kHz ticks rounded down; the DTS of an
  I- or P-picture from the last one's PTS or the running DTS plus the last
  I/P duration, of a B-picture from the running DTS stepped by its exact
  duration (``av_add_stable``); ``has_b_frames`` from MPEG-2's sequence
  extension, or for MPEG-1 from the second packet on (its decoder sets it);
  the packets before the stream's first time stamp stamped relative to
  ``RELATIVE_TS_BASE`` (``update_initial_timestamps``), and once that
  stamp arrives, ``first_dts`` the stamp less the durations before it and
  ``start_time`` the first PTS among those packets, shifted, else the
  stamped packet's;
- the loop of ``avformat_find_stream_info``: over every packet to the end
  of a program stream (its demuxer has no header), stopped past 7 s of
  packet durations or 5,000,000 bytes of video packets (FFmpeg counts
  every stream's: audio beside the video would stop it sooner); a
  transport stream's once 20 DTS
  steps are in (``fps_analyze_framecount``: its demuxer reads a header).
  From the third packet on, each packet's duration and ``repeat_pict + 1``
  fields: in a program stream ``repeat_pict`` is the parser's when the
  packet is handed on, the last packet the parse of its PES packet cut
  (the whole PES packet is parsed at once), in a transport stream the
  packet's own; the packet the parser gives at the end of the file counts
  2 fields (the parser is closed by then);
- ``avg_frame_rate``: fields / (2 x duration), reduced under 60001 and
  taken to the nearest standard rate within 1 % (1/12 steps to 30, then
  31-60, 80, 120, 240, and 24, 30, 60, 12, 15, 48 x 1000/1001); in a
  transport stream the coded rate competes for that rate at no error
  (``FF_INFMT_FLAG_PREFER_CODEC_FRAMERATE``), so the average keeps it unless
  the average is itself a standard rate earlier in the list;
- ``r_frame_rate`` (``ff_rfps_add_frame``, ``ff_rfps_calculate``) where
  the codec's time base is unreliable (MPEG-2, MPEG-1 at 50.5 fps and up):
  90000 over the DTS steps' GCD past 15 steps, else the standard rate on
  whose grid the DTS lie best; else twice the coded rate.

So a soft-telecined stream (``repeat_first_field`` set on some pictures,
as NTSC film DVDs are coded) may report a rate other than its coded one,
as cv2 does: cv2's 10 fps 128x96 program stream patched 3:2 says 11.58 or
8, a transport stream of it 10 or 9.67. Pinned against cv2 on telecine
cadences patched into cv2's clips in every container, on interlaced
streams of field pictures, on a DVD-like stream and on streams whose first
PES packets carry no stamps (``tests/test_torch_mpeg2i.py``), and while
probing against the bundled
libavformat's own fields (every packet's PTS, DTS and duration,
``avg_frame_rate``, ``r_frame_rate``, ``start_time``) on 244 cv2-written
and rewritten streams.
"""

from __future__ import annotations

import bisect
import itertools
import math
from collections.abc import Iterator

TICKS = 90000
PTS_NB = 4  # AV_PARSER_PTS_NB
ANALYZE_US = 7_000_000  # max_stream_analyze_duration of the mpeg and mpegts demuxers
PROBESIZE = 5_000_000
FPS_FRAMES = 20  # fps_analyze_framecount: the DTS steps that end a transport stream's analysis
SLICES = range(0x01, 0xB0)
# RELATIVE_TS_BASE: the stamps FFmpeg gives packets before the stream's first
# time stamp count from here, shifted once that stamp arrives
RELATIVE = 2 ** 63 - 1 - (1 << 48)


def std_rate(j: int) -> int:
    """``get_std_framerate(j)``: a standard rate in units of 1/12012 fps."""
    if j < 30 * 12:
        return (j + 1) * 1001
    j -= 30 * 12
    if j < 30:
        return (j + 31) * 1001 * 12
    j -= 30
    if j < 3:
        return (80, 120, 240)[j] * 1001 * 12
    return (24, 30, 60, 12, 15, 48)[j - 3] * 1000 * 12


N_STD = 30 * 12 + 30 + 3 + 6  # MAX_STD_TIMEBASES


def av_reduce(num: int, den: int, limit: int) -> tuple[int, int]:
    """libavutil's ``av_reduce``: num / den in lowest terms, or its best
    continued-fraction approximation with both parts at most ``limit``."""
    a0n, a0d, a1n, a1d = 0, 1, 1, 0
    g = math.gcd(num, den)
    if g:
        num, den = num // g, den // g
    if num <= limit and den <= limit:
        return num, den
    while den:
        x = num // den
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
        num, den = den, num - den * x
    return a1n, a1d


def _rescale_near(a: int, b: int, c: int) -> int:
    return (a * b + c // 2) // c  # av_rescale_rnd(a, b, c, AV_ROUND_NEAR_INF), a >= 0


def add_stable(ts: int, num: int, den: int) -> int:
    """``av_add_stable(1/90000, ts, num/den s, 1)``: ``ts`` stepped by an
    increment that need not be a whole number of ticks."""
    m = num * TICKS
    if m % den == 0:
        return ts + m // den
    if m < den:
        return ts
    old = _rescale_near(ts, den, m)
    old_ts = _rescale_near(old, m, den)
    return _rescale_near(old + 1, m, den) + ts - old_ts


class Packet:
    """One packet of the parser: its bytes in the stream, stamps, picture
    type, ``repeat_pict``, the PES packet whose parse cut it (None at the end
    of the file) and that PES packet's stamps where this is the first packet
    that parse cut."""

    __slots__ = ("start", "end", "pts", "dts", "kind", "repeat", "pes", "next_pts", "next_dts",
                 "has_b")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


class _Parser:
    """``mpegvideo``'s parser over the PES payloads, one ``av_parser_parse2``
    call at a time (see the module's notes)."""

    def __init__(self, es: bytes, pes):
        self.es, self.pes = es, pes
        self.codes: list[int] = []  # the start codes' offsets, found as far as the parse has read
        self.scan = 0  # where the search for the next start code resumes
        self.ring: list = [None] * PTS_NB  # (offset, end, pts, dts)
        self.ring_at = 0
        self.started = 0  # frame_start_found
        # offsets are taken from the first packet's file position p > 0: the
        # parser's frame_offset starts at 0 = -p, next_frame_offset at p = 0
        self.frame_offset, self.next_frame_offset = -1, 0
        self.pts = self.dts = None
        self.fetch = True
        self.progressive_sequence = 0
        self.repeat, self.kind, self.has_b = 0, 0, 0

    def _fetch(self, at: int, remove: bool, fuzzy: bool) -> None:
        if not fuzzy:
            self.pts = self.dts = None
        for i, e in enumerate(self.ring):
            if e is None:
                continue
            off, end, pts, dts = e
            if at >= off and (self.frame_offset < off
                              or (not self.frame_offset and not self.next_frame_offset)):
                if not fuzzy or dts is not None:
                    self.pts, self.dts = pts, dts
                if remove:
                    self.ring[i] = (math.inf, end, pts, dts)
                if at < end:
                    break

    def _find_codes(self, end: int) -> None:
        """Extends ``codes`` with the start codes whose code byte lies before
        ``end``."""
        es, codes, k = self.es, self.codes, self.scan
        while True:
            k = es.find(b"\x00\x00\x01", k)
            if k < 0 or k + 3 >= end:
                break
            codes.append(k)
            k += 3
        self.scan = len(es) if k < 0 else k

    def _headers(self, a: int, b: int) -> None:
        """``mpegvideo_extract_headers`` over one packet's bytes."""
        es, codes = self.es, self.codes
        for i in range(bisect.bisect_left(codes, a), len(codes)):
            q = codes[i]
            if q + 3 >= b:
                break
            code = es[q + 3]
            if code == 0x00 and q + 5 < b:
                self.kind = (es[q + 5] >> 3) & 7
                self.repeat = 1
            elif code == 0xB5 and q + 4 < b:
                ext = es[q + 4] >> 4
                if ext == 1 and q + 9 < b:
                    self.progressive_sequence = es[q + 5] & 8
                    self.has_b = int(not es[q + 9] >> 7)  # !low_delay
                elif ext == 8 and q + 8 < b:
                    tff, rff, progressive = es[q + 7] & 0x80, es[q + 7] & 2, es[q + 8] & 0x80
                    self.repeat = 1
                    if rff and self.progressive_sequence:
                        self.repeat = 5 if tff else 3
                    elif rff and progressive:
                        self.repeat = 2

    def _packet(self, start: int, end: int, pes, next_pts=None, next_dts=None) -> Packet:
        self._headers(start, end)
        self.frame_offset, self.next_frame_offset = self.next_frame_offset, end
        self.fetch = True
        return Packet(start=start, end=end, pts=self.pts, dts=self.dts, kind=self.kind,
                      repeat=self.repeat, pes=pes, next_pts=next_pts, next_dts=next_dts,
                      has_b=self.has_b)

    def packets(self) -> Iterator[Packet]:
        """Each packet as the parse of the PES packets cuts it: the parse
        reads no further than the packets taken."""
        es, codes = self.es, self.codes
        ci, start = 0, 0
        for p, (off, end, pts, dts) in enumerate(self.pes):
            self._find_codes(end)
            cur, first = off, True
            self.ring_at = (self.ring_at + 1) % PTS_NB
            self.ring[self.ring_at] = (off, end, pts, dts)
            while cur < end:
                next_pts, next_dts = (pts, dts) if first else (None, None)
                first = False
                if self.fetch:
                    self.fetch = False
                    self._fetch(cur, False, False)
                found = None
                while ci < len(codes) and codes[ci] + 3 < end:
                    q = codes[ci]
                    code = es[q + 3]
                    ci += 1
                    if self.started == 0 and code in SLICES:
                        self.started = 4
                        continue
                    if code == 0xB7:  # a sequence end code closes the packet
                        self.started, found = 0, q + 4
                        break
                    if self.started == 2 and code == 0xB3:
                        self.started = 0
                    if self.started < 4 and code == 0xB5:
                        if q + 6 < len(es) and es[q + 4] & 0xF0 == 0x80:  # picture coding ext
                            # a frame picture, or the first or second of two fields
                            self.started = 0 if es[q + 6] & 3 == 3 else (self.started + 2) & 3
                    if self.started == 4 and code not in SLICES:
                        self.started, found = 0, q
                        ci -= 1  # the next call scans from this start code again
                        break
                    if self.started == 0 and code == 0x00:
                        self._fetch(q, True, q > cur)
                if found is None:
                    break  # no packet ends in this PES packet: its bytes are kept
                yield self._packet(start, found, p, next_pts, next_dts)
                start = cur = max(cur, found)
        if start < len(es):  # the end of the file flushes the parser
            self._find_codes(len(es))
            if self.fetch:
                self.fetch = False
                self._fetch(len(es), False, False)
            yield self._packet(start, len(es), None)


def _with_state(packets: Iterator[Packet]) -> Iterator[tuple[Packet, int]]:
    """Each packet with the parser's ``repeat_pict`` once the parse of its PES
    packet is done (that of the last packet the parse cut): one PES packet's
    packets ahead of the caller."""
    for pes, group in itertools.groupby(packets, key=lambda pk: pk.pes):
        group = list(group)
        for pk in group:
            yield pk, group[-1].repeat


def is_relative(ts: int | None) -> bool:
    return ts is not None and ts > RELATIVE - (1 << 48)


def stream_rates(es: bytes, pes, fps: tuple[int, int], mpeg2: bool, transport: bool):
    """(``avg_frame_rate``, ``r_frame_rate``, start) of the stream (see the
    module's notes); each rate a (num, den) pair, the start the stream's
    ``start_time``, else its ``first_dts``, else None (no packet the
    analysis read carries a time stamp)."""
    num, den = fps
    last_ip_pts = first_dts = start = last_order = last_dts = None
    cur_dts = RELATIVE
    early: list[int | None] = []  # the PTS of the packets before the first stamp

    def update_initial(dts, pts):  # update_initial_timestamps
        nonlocal first_dts, cur_dts, start
        if first_dts is not None or dts is None or is_relative(dts):
            return
        first_dts, cur_dts = dts - (cur_dts - RELATIVE), dts
        shift = first_dts - RELATIVE
        for p in early:  # the packets buffered so far, their relative stamps shifted
            if start is None and p is not None:
                start = p + shift if is_relative(p) else p
        if start is None:
            start = pts + shift if is_relative(pts) else pts

    last_ip_dur = has_b = ordered = misordered = 0
    err = [[[0.0] * N_STD for _ in range(2)] for _ in range(2)]  # duration_error
    count = total = gcd = duration = fields = read = 0
    for k, (pk, parsed) in enumerate(_with_state(_Parser(es, pes).packets())):
        if transport and count >= FPS_FRAMES:  # mpegts has a header: its info is found
            break
        pts, dts = pk.pts, pk.dts
        # has_b_frames: an MPEG-2 sequence extension's !low_delay, read by the
        # parser; MPEG-1's set by the decoder, once it has the first packet
        has_b = has_b or pk.has_b or (k > 0 and not mpeg2)
        if dts is not None:  # the DTS order check
            if dts == pts and last_order is not None:
                ordered, misordered = ordered + (last_order <= dts), misordered + (last_order > dts)
                if ordered + misordered > 250:
                    ordered, misordered = ordered >> 1, misordered >> 1
            last_order = dts
            if ordered < 8 * misordered and dts == pts:
                dts = None
        has_b = has_b or pk.kind == 3
        delayed = bool(has_b and pk.kind != 3)
        if has_b and dts == pts and dts is not None and delayed:
            dts = None
        dur = TICKS * den * (1 + pk.repeat) // (2 * num)
        if dts is not None and pts is not None and pts > dts:
            delayed = True
        if delayed:
            if dts is None:
                dts = last_ip_pts
            update_initial(dts, pts)
            if dts is None:
                dts = cur_dts
            last_ip_dur = last_ip_dur or dur
            cur_dts = dts + last_ip_dur
            if (dts is not None and pts is None and pk.next_dts is not None
                    and pk.next_pts is not None and abs(cur_dts - pk.next_dts) <= 1
                    and pk.next_dts != pk.next_pts):
                pts = pk.next_dts
            last_ip_dur, last_ip_pts = dur, pts
        else:
            if pts is None:
                pts = dts
            update_initial(pts, pts)
            if pts is None:
                pts = cur_dts
            dts = pts
            cur_dts = add_stable(pts, den * (1 + pk.repeat), 2 * num)
        if first_dts is None:
            early.append(pts)
        if dts is not None and dts > cur_dts:
            cur_dts = dts
        if k > 1:
            if (duration * 1000000 + TICKS // 2) // TICKS >= ANALYZE_US:
                break
            duration += dur
            if pk.pes is None:  # the parser is closed by the end of the file
                fields += 2
            else:
                fields += (pk.repeat if transport else parsed) + 1
        if dts is not None and last_dts is not None and dts > last_dts:  # ff_rfps_add_frame
            sec = (dts - RELATIVE if is_relative(dts) else dts) * (1 / TICKS)
            for i in range(N_STD):
                if err[0][1][i] < 1e10:
                    sdts = sec * std_rate(i) / (1001 * 12)
                    for j in (0, 1):
                        e = sdts - round(sdts + j * 0.5) + j * 0.5
                        err[j][0][i] += e
                        err[j][1][i] += e * e
            count += 1
            total += dts - last_dts
            if count % 10 == 0:
                for i in range(N_STD):
                    if err[0][1][i] < 1e10:
                        a0, a1 = err[0][0][i] / count, err[1][0][i] / count
                        if (err[0][1][i] / count - a0 * a0 > 0.04
                                and err[1][1][i] / count - a1 * a1 > 0.04):
                            err[0][1][i] = err[1][1][i] = 2e10
            if count > 3:
                gcd = math.gcd(gcd, dts - last_dts)
        if dts is not None:
            last_dts = dts
        read += pk.end - pk.start
        if read >= PROBESIZE:
            break
    # tb_unreliable: the codec's time base 1 / (2 fps)
    unreliable = mpeg2 or 2 * num >= 101 * den or 2 * num < 5 * den
    rate = None
    if unreliable and count > 15 and gcd > TICKS // 500:
        rate = av_reduce(TICKS, gcd, 2 ** 31 - 1)
    if rate is None and unreliable and count > 1:
        best, best_err = 0, 0.01
        for j in range(N_STD):
            sr = std_rate(j)
            if duration and duration * (1 / TICKS) < (1001 * 12.0) / sr:
                continue
            if not duration and sr < 1001 * 12:
                continue
            if (1 / TICKS) * total / count < (1001 * 12.0 * 0.8) / sr:
                continue
            for e in err:
                a = e[0][j] / count
                v = e[1][j] / count - a * a
                if v < best_err and best_err > 0.000000001:
                    best_err, best = v, sr
        if best and best / (12 * 1001) < 1.01 * TICKS:
            rate = av_reduce(best, 12 * 1001, 2 ** 31 - 1)
    avg = None
    if fields and duration:
        avg = av_reduce(fields * TICKS, duration * 2, 60000)
        best, best_err = 0, 0.01
        for j in range(N_STD):
            e = abs((avg[0] / avg[1]) / (std_rate(j) / (12 * 1001)) - 1)
            if e < best_err:
                best_err, best = e, std_rate(j)
            if transport:  # FF_INFMT_FLAG_PREFER_CODEC_FRAMERATE: the coded rate competes
                e = abs((num / den) / (std_rate(j) / (12 * 1001)) - 1)
                if e < best_err:
                    best_err, best = e, std_rate(j)
        if best:
            avg = av_reduce(best, 12 * 1001, 2 ** 31 - 1)
    if rate is None:
        rate = av_reduce(2 * num, den, 2 ** 31 - 1)
        if rate[0] > TICKS * rate[1]:
            rate = (TICKS, 1)
    return avg, rate, first_dts if start is None else start
