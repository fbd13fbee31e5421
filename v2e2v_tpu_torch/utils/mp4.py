"""An ISO base media (MP4, M4V) and QuickTime (MOV) demuxer for MPEG-4
Part 2, MPEG-1/2, MJPEG, VP9, H.263, Sorenson H.263, MS-MPEG-4 v2 and v3,
WMV1, WMV2, raw RGBA and PNG video, in plain Python.

``Mp4File(path)`` reads what ``cv2.VideoCapture`` (through FFmpeg's
``libavformat/mov.c``) reads of a file's video track:

- the top-level boxes in any order (``moov`` after ``mdat``, as FFmpeg's
  muxer writes it, or before it, as a faststart file has it), 64-bit box
  sizes and a last box that runs to the end of the file;
- the one ``vide`` track: ``tkhd`` (its display matrix), ``mdhd`` (its
  timescale), ``hdlr``, ``edts``/``elst``, and ``stbl``'s ``stsd`` (an
  ``mp4v`` entry whose ``esds`` names MPEG-4 Visual, object type 0x20, and
  holds the VOL headers as its DecoderSpecificInfo, or names MPEG-2 video,
  0x60-0x65, or MPEG-1 video, 0x6A, as cv2 writes them into an MP4; or a
  QuickTime ``m2v1``, ``mp2v``, ``m1v1`` or ``m1v `` entry, cv2 writing
  ``m2v1`` into a MOV; an ``mp4v`` entry of object type 0x6C, MJPEG, or
  0x6D, PNG, which cv2 writes into an MP4 when asked for MJPG or MPNG;
  QuickTime's ``jpeg`` and ``mjpa`` (MJPEG), ``XVID`` and ``DIVX`` (MPEG-4
  Part 2 with no ``esds``: the VOL headers are the ``glbl`` box, or lead
  the first sample), ``png `` and ``RGBA`` (raw, top-down R, G, B, A); ``h263``, ``s263`` and
  ``H263`` (H.263, which cv2 writes into a MOV as ``h263``) and ``FLV1``
  (Sorenson H.263, which ``mov.c`` finds in the AVI table); ``3IVD``
  (MS-MPEG-4 v3, cv2's entry for MP43, DIV3 and the other v3 tags),
  ``MP42`` and ``DIV2`` (v2), ``WMV1`` and ``WMV2`` (from the AVI table
  too; WMV2's extradata is its ``glbl`` box);
  ``vp09`` (VP9) whose ``vpcC`` says what cv2's muxer writes: 8 bits,
  4:2:0, limited range, colour unspecified (the decoder takes range and
  colour space from the key frames)), ``stts``, ``stsc``, ``stsz``, and
  ``stco`` or ``co64``. ``codec`` is ``"mpeg4"``, ``"mpeg12"``,
  ``"mjpeg"``, ``"vp9"``, ``"raw"`` (``raw_format`` ``"rgba"``), ``"png"``,
  ``"h263"``, ``"flv"``, ``"msmpeg4v2"``, ``"msmpeg4v3"``, ``"wmv1"`` or
  ``"wmv2"``; ``width`` and ``height`` are the sample entry's.

``fps`` is the track's timescale times its sample count over the sum of the
``stts`` durations, and ``frame_count`` the sample count: what cv2 reports as
``CAP_PROP_FPS`` and ``CAP_PROP_FRAME_COUNT``. An edit list of one edit at
media time 0 keeps the samples that start before its end, as FFmpeg does
(cv2's own files end it just past the last sample). ``rotation`` is the clockwise
turn, 0, 90, 180 or 270 degrees, that cv2 gives each frame by the
``tkhd`` matrix (``CAP_PROP_ORIENTATION_AUTO``). ``frames()`` yields each
sample's bytes in decoding order.

Other codecs, several video tracks or sample descriptions, other edit
lists (empty edits, shifts, several edits, other rates), matrices other than the four turns, and
corrupt or truncated boxes raise a ValueError naming ROADMAP.md queue 1,
item 4.
"""

from __future__ import annotations

import struct

from .imgcodecs import ROADMAP, refuse_video

CONTAINERS = (b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts")
MPEG4_VISUAL = 0x20  # esds objectTypeIndication of ISO/IEC 14496-2
# the objectTypeIndications of ISO/IEC 13818-2 (its profiles) and 11172-2
MPEG12_VISUAL = {0x60: "MPEG-2 Simple", 0x61: "MPEG-2 Main", 0x62: "MPEG-2 SNR",
                 0x63: "MPEG-2 Spatial", 0x64: "MPEG-2 High", 0x65: "MPEG-2 4:2:2",
                 0x6A: "MPEG-1"}
# QuickTime sample entries of MPEG-1/2 video (cv2 writes m2v1 into a MOV)
MPEG12_ENTRIES = (b"m2v1", b"mp2v", b"m1v1", b"m1v ")
# the esds objectTypeIndications of MJPEG and PNG (mov.c: ff_mp4_obj_type)
OBJECT_CODECS = {0x6C: "mjpeg", 0x6D: "png"}
# sample entries without an esds, by codec (mov.c: ff_codec_movvideo_tags);
# RGBA is raw: FFmpeg's rawvideo decoder reads its layout from the tag
ENTRIES = {b"jpeg": "mjpeg", b"mjpa": "mjpeg", b"XVID": "mpeg4", b"DIVX": "mpeg4",
           b"vp09": "vp9", b"png ": "png", b"RGBA": "raw", b"h263": "h263", b"s263": "h263",
           b"H263": "h263", b"FLV1": "flv", b"3IVD": "msmpeg4v3", b"MP42": "msmpeg4v2",
           b"DIV2": "msmpeg4v2", b"WMV1": "wmv1", b"WMV2": "wmv2"}
# vpcC's fields after version and flags that cv2's muxer writes: bit depth
# 8, 4:2:0 (0 or 1) and limited range, primaries, transfer and matrix 2
VPCC_DEPTH, VPCC_UNSPECIFIED = 8, (2, 2, 2)
# tkhd matrices (a, b, c, d at 16.16) of the turns cv2 applies, and each
# turn clockwise in degrees
TURNS = {(1, 0, 0, 1): 0, (0, 1, -1, 0): 90, (-1, 0, 0, -1): 180, (0, -1, 1, 0): 270}
# the top-level box types that mark an ISO base media / QuickTime file
SIGNATURES = (b"ftyp", b"moov", b"mdat", b"free", b"skip", b"wide", b"pnot")


_refuse = refuse_video


def _corrupt(path: str, what: str) -> ValueError:
    return ValueError(f"{path}: corrupt or truncated MP4/MOV: {what} ({ROADMAP})")


def is_mp4(head: bytes) -> bool:
    """Whether the file's first bytes open an ISO base media box."""
    return len(head) >= 8 and head[4:8] in SIGNATURES


class Track:
    """One track's boxes, as the demuxer needs them."""

    def __init__(self):
        self.handler = None
        self.timescale = 0
        self.matrix = None
        self.boxes: dict[bytes, bytes] = {}
        self.stsd_entries: list[tuple[bytes, tuple[int, int]]] = []  # (type, body span)
        self.edits: list[tuple[int, int, int]] = []  # (duration, media_time, rate)


class Mp4File:
    """An MP4/MOV file's video track (see the module's notes)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self.data = f.read()
        if not is_mp4(self.data[:8]):
            raise _refuse(path, "not an ISO base media / QuickTime file")
        self.movie_timescale = 0
        self.tracks: list[Track] = []
        moov = [body for kind, body in self._boxes(0, len(self.data)) if kind == b"moov"]
        if not moov:
            raise _corrupt(path, "no 'moov' box")
        self._walk(moov[0], None)
        video = [t for t in self.tracks if t.handler == b"vide"]
        if not video:
            raise _refuse(path, "a file with no video track")
        if len(video) > 1:
            raise _refuse(path, f"a file of {len(video)} video tracks")
        self.track = t = video[0]
        self._read_codec(t)
        self._read_samples(t)
        self._read_edits(t)
        self.rotation = self._read_matrix(t)

    # ------------------------------------------------------------- boxes

    def _boxes(self, pos: int, end: int):
        """(type, (body start, body end)) of each box from ``pos`` to ``end``."""
        d = self.data
        while pos + 8 <= end:
            size, kind = struct.unpack(">I4s", d[pos:pos + 8])
            head = 8
            if size == 1:
                if pos + 16 > end:
                    raise _corrupt(self.path, f"a 64-bit box header at {pos} cut short")
                size = struct.unpack(">Q", d[pos + 8:pos + 16])[0]
                head = 16
            elif size == 0:
                size = end - pos
            if size < head or pos + size > end:
                raise _corrupt(self.path, f"the box {kind!r} at {pos} of size {size} runs "
                               f"past its parent's end at {end}")
            yield kind, (pos + head, pos + size)
            pos += size

    def _body(self, span) -> bytes:
        return self.data[span[0]:span[1]]

    def _walk(self, span, track: Track | None) -> None:
        for kind, sub in self._boxes(*span):
            if kind == b"trak":
                track = Track()
                self.tracks.append(track)
                self._walk(sub, track)
            elif kind in CONTAINERS:
                self._walk(sub, track)
            elif kind == b"mvhd":
                body = self._body(sub)
                self.movie_timescale = struct.unpack(">I", body[20:24] if body[0] == 1
                                                     else body[12:16])[0]
            elif track is None:
                continue
            elif kind == b"tkhd":
                body = self._body(sub)
                at = 4 + (32 if body[0] == 1 else 20) + 16  # version/flags, times, reserved...
                if len(body) < at + 36:
                    raise _corrupt(self.path, "a short 'tkhd' box")
                track.matrix = struct.unpack(">9i", body[at:at + 36])
            elif kind == b"mdhd":
                body = self._body(sub)
                track.timescale = struct.unpack(">I", body[20:24] if body[0] == 1
                                                else body[12:16])[0]
            elif kind == b"hdlr" and track.handler is None:  # mdia's (a MOV's minf has one too)
                track.handler = self._body(sub)[8:12]
            elif kind == b"elst":
                body = self._body(sub)
                version, n = body[0], struct.unpack(">I", body[4:8])[0]
                step = 20 if version == 1 else 12
                for k in range(n):
                    e = body[8 + k * step:8 + (k + 1) * step]
                    if len(e) < step:
                        raise _corrupt(self.path, "a short 'elst' box")
                    if version == 1:
                        dur, media, rate = struct.unpack(">Qqi", e)
                    else:
                        dur, media, rate = struct.unpack(">Iii", e)
                    track.edits.append((dur, media, rate))
            elif kind == b"stsd":
                body = self._body(sub)
                n = struct.unpack(">I", body[4:8])[0]
                pos = sub[0] + 8
                for kind2, sub2 in self._boxes(pos, sub[1]):
                    track.stsd_entries.append((kind2, sub2))
                if len(track.stsd_entries) != n:
                    raise _corrupt(self.path, f"'stsd' lists {n} entries and holds "
                                   f"{len(track.stsd_entries)}")
            elif kind in (b"stts", b"stsc", b"stsz", b"stco", b"co64", b"ctts"):
                track.boxes[kind] = self._body(sub)

    # ------------------------------------------------------------- codec

    def _read_codec(self, t: Track) -> None:
        if len(t.stsd_entries) != 1:
            raise _refuse(self.path, f"a video track of {len(t.stsd_entries)} sample "
                          "descriptions")
        kind, span = t.stsd_entries[0]
        self.fourcc = kind
        self.codec, self.object_type, self.config = "mpeg4", MPEG4_VISUAL, b""
        self.raw_format = None
        entry = self._body(span)
        if len(entry) < 78:  # VisualSampleEntry's fields before its boxes
            raise _corrupt(self.path, f"a short {kind!r} sample entry")
        self.width, self.height = struct.unpack(">HH", entry[24:28])
        boxes = {k: self._body(s) for k, s in reversed(list(self._boxes(span[0] + 78, span[1])))}
        if kind in MPEG12_ENTRIES:
            self.codec = "mpeg12"
        elif kind in ENTRIES:
            self.codec = ENTRIES[kind]
            self.config = boxes.get(b"glbl", b"")  # mov.c: extradata, the VOL headers
            self.extradata = self.config
            if self.codec == "raw":
                self.raw_format = "rgba"
            elif self.codec == "vp9":
                self._check_vpcc(boxes.get(b"vpcC"))
            elif self.codec == "mjpeg" and boxes.get(b"fiel", b"\x01")[0] != 1:
                raise _refuse(self.path, f"an interlaced {kind.decode('latin-1')!r} track "
                              "('fiel' box of two fields)")
        elif kind != b"mp4v":
            raise _refuse(self.path, f"a video track of codec {kind.decode('latin-1')!r}")
        elif b"esds" not in boxes:
            raise _refuse(self.path, "an 'mp4v' sample entry with no 'esds' box")
        else:
            self.config = self._esds(boxes[b"esds"][4:])

    def _check_vpcc(self, vpcc: bytes | None) -> None:
        """A ``vp09`` entry's ``vpcC`` (version 1) must say what cv2's muxer
        writes (``VPCC_*``)."""
        if vpcc is None or len(vpcc) < 12 or vpcc[0] != 1:
            raise _refuse(self.path, "a 'vp09' sample entry without a version-1 'vpcC' box")
        depth, sub, full = vpcc[6] >> 4, (vpcc[6] >> 1) & 7, vpcc[6] & 1
        if depth != VPCC_DEPTH or sub > 1 or full or tuple(vpcc[7:10]) != VPCC_UNSPECIFIED:
            raise _refuse(self.path, f"a 'vp09' track whose 'vpcC' says {depth} bits, chroma "
                          f"subsampling {sub}, full range {full}, colour {tuple(vpcc[7:10])}")

    def _esds(self, d: bytes) -> bytes:
        """The ES_Descriptor's DecoderConfigDescriptor: its object type must
        be MPEG-4 Visual; returns its DecoderSpecificInfo."""
        def descriptor(pos):
            tag = d[pos]
            size, pos = 0, pos + 1
            for _ in range(4):
                b = d[pos]
                pos += 1
                size = (size << 7) | (b & 0x7F)
                if not b & 0x80:
                    break
            return tag, pos, pos + size

        try:
            tag, pos, end = descriptor(0)
            if tag != 3:
                raise _corrupt(self.path, f"an 'esds' box opening with descriptor tag {tag}")
            flags = d[pos + 2]
            pos += 3
            if flags & 0x80:
                pos += 2
            if flags & 0x40:
                pos += 1 + d[pos]
            if flags & 0x20:
                pos += 2
            tag, pos, dend = descriptor(pos)
            if tag != 4:
                raise _corrupt(self.path, f"an ES descriptor with no DecoderConfigDescriptor")
            self.object_type = d[pos]
            if d[pos] in MPEG12_VISUAL:
                self.codec = "mpeg12"
            elif d[pos] in OBJECT_CODECS:
                self.codec = OBJECT_CODECS[d[pos]]
            elif d[pos] != MPEG4_VISUAL:
                raise _refuse(self.path, f"an 'mp4v' track of object type 0x{d[pos]:02X}, not "
                              "MPEG-4 Visual (0x20), MPEG-1/2 video (0x60-0x65, 0x6A), MJPEG "
                              "(0x6C) or PNG (0x6D)")
            pos += 13
            if pos >= dend:
                return b""
            tag, pos, send = descriptor(pos)
            return d[pos:send] if tag == 5 else b""
        except IndexError:
            raise _corrupt(self.path, "a truncated 'esds' box") from None

    # ----------------------------------------------------------- samples

    def _table(self, t: Track, kind: bytes, fmt: str):
        body = t.boxes.get(kind)
        if body is None:
            raise _corrupt(self.path, f"no '{kind.decode()}' box")
        n = struct.unpack(">I", body[4:8])[0]
        step = struct.calcsize(">" + fmt)
        if 8 + n * step > len(body):
            raise _corrupt(self.path, f"a short '{kind.decode()}' box")
        return [struct.unpack(">" + fmt, body[8 + k * step:8 + (k + 1) * step]) for k in range(n)]

    def _read_samples(self, t: Track) -> None:
        stsz = t.boxes.get(b"stsz")
        if stsz is None:
            raise _corrupt(self.path, "no 'stsz' box")
        fixed, count = struct.unpack(">II", stsz[4:12])
        if fixed:
            sizes = [fixed] * count
        else:
            if 12 + 4 * count > len(stsz):
                raise _corrupt(self.path, "a short 'stsz' box")
            sizes = list(struct.unpack(f">{count}I", stsz[12:12 + 4 * count]))
        if b"co64" in t.boxes:
            chunks = [c for (c,) in self._table(t, b"co64", "Q")]
        else:
            chunks = [c for (c,) in self._table(t, b"stco", "I")]
        stsc = self._table(t, b"stsc", "III")
        if any(desc != 1 for _, _, desc in stsc):
            raise _refuse(self.path, "samples of a second sample description")
        offsets = []
        for k, (first, per, _) in enumerate(stsc):
            last = stsc[k + 1][0] - 1 if k + 1 < len(stsc) else len(chunks)
            for c in range(first, last + 1):
                if not 1 <= c <= len(chunks):
                    raise _corrupt(self.path, f"'stsc' names chunk {c} of {len(chunks)}")
                pos = chunks[c - 1]
                for _ in range(per):
                    if len(offsets) == len(sizes):
                        break
                    offsets.append(pos)
                    pos += sizes[len(offsets) - 1]
        if len(offsets) != len(sizes):
            raise _corrupt(self.path, f"{len(sizes)} samples in 'stsz' and {len(offsets)} "
                           "placed by 'stsc' and the chunk offsets")
        for pos, size in zip(offsets, sizes):
            if pos + size > len(self.data):
                raise _corrupt(self.path, f"a sample at {pos} of {size} bytes runs past the end")
        self.samples = list(zip(offsets, sizes))
        stts = self._table(t, b"stts", "II")
        self.durations = [d for n, d in stts for _ in range(n)]
        total = sum(n * d for n, d in stts)
        frames = sum(n for n, _ in stts)
        if t.timescale <= 0 or total <= 0:
            raise _corrupt(self.path, f"a timescale of {t.timescale} and a duration of {total}")
        self.fps = t.timescale * frames / total
        self.frame_count = len(sizes)
        self.duration = total

    def _read_edits(self, t: Track) -> None:
        """The edit list FFmpeg's ``mov_fix_index`` applies: one edit at
        media time 0, rate 1, keeps the samples that start before its end
        (its duration rescaled to the track's timescale, rounded to
        nearest), as cv2 reads them; ``frame_count`` stays the sample
        count, as cv2 reports it."""
        self.kept = len(self.samples)
        if not t.edits:
            return
        shifted = self._composition_start(t)
        if len(t.edits) > 1 or t.edits[0][1] not in (0, shifted) or t.edits[0][2] != 0x10000:
            raise _refuse(self.path, f"an edit list {t.edits} other than one edit at media "
                          "time 0 or at the first frame's composition time")
        if self.movie_timescale <= 0:
            raise _corrupt(self.path, f"a movie timescale of {self.movie_timescale}")
        end = (2 * t.edits[0][0] * t.timescale + self.movie_timescale) // (
            2 * self.movie_timescale)
        if t.edits[0][1]:  # B-frames' delay: every frame must lie inside the edit
            if max(self.pts) >= t.edits[0][1] + end:
                raise _refuse(self.path, f"an edit list {t.edits} that ends before the last "
                              "frame")
            return
        start, self.kept = 0, 0
        for d in self.durations:
            if start >= end:
                break
            self.kept += 1
            start += d

    def _composition_start(self, t: Track) -> int | None:
        """Each sample's composition time (``pts``: its decoding time plus its
        ``ctts`` offset); returns the first frame's, or None without ``ctts``."""
        dts, at = [], 0
        for d in self.durations:
            dts.append(at)
            at += d
        self.pts = dts
        if b"ctts" not in t.boxes:
            return None
        version = t.boxes[b"ctts"][0]
        offsets = [off for n, off in self._table(t, b"ctts", "Ii" if version else "II")
                   for _ in range(n)]
        if len(offsets) != len(dts):
            raise _corrupt(self.path, f"'ctts' covers {len(offsets)} of {len(dts)} samples")
        self.pts = [a + b for a, b in zip(dts, offsets)]
        return min(self.pts)

    def _read_matrix(self, t: Track) -> int:
        m = t.matrix or (0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
        a, b, _u, c, d, _v, _x, _y, _w = m
        key = tuple(v // 0x10000 if v % 0x10000 == 0 else None for v in (a, b, c, d))
        if key not in TURNS:
            raise _refuse(self.path, f"a display matrix {m} other than a quarter turn")
        return TURNS[key]

    def frames(self):
        """Each sample's bytes that the edit list keeps, in decoding order."""
        for pos, size in self.samples[:self.kept]:
            yield self.data[pos:pos + size]
