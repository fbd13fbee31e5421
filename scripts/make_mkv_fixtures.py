#!/usr/bin/env python3
"""Write the Matroska / WebM fixtures of the port's video path
(``v2e2v_tpu_torch/utils/mkv.py``, ``vp8dec.py``, ``video.py``) and what the
JAX package's readers return for each.

    JAX_PLATFORMS=cpu python scripts/make_mkv_fixtures.py [--out tests/data/mkv] [--seed 0]

It needs cv2 built with FFmpeg and the JAX package, so it runs where the JAX
package's dependencies are installed, not on the card's machine; the card
checks the port against the hashes this writes. The clips come from seeded
numpy scenes through ``cv2.VideoWriter`` (libvpx's VP8, FFmpeg's Matroska
and WebM muxers), some then patched or remuxed here:

- ``flagship.webm``: 12 frames at 960x720, 240 fps, a pan of 3 rows and -7
  columns a frame with sensor noise; ``flagship.mkv``, the same frames
  written as Matroska;
- ``gop.webm``: 30 frames at 64x96 at 30 fps, so that libvpx's key frames
  open frames 0 and 12 and later ones refresh the golden frame;
- ``noise.webm``: 8 frames at 64x80 with a noise patch from the third on
  (intra macroblocks inside inter frames, ``SPLITMV``);
- ``flat.webm``: 8 flat frames at 64x80 (skipped macroblocks, long zero
  runs);
- ``odd.webm``: 8 frames written at 80x64 whose key frames and track say
  75x49 (swscale's general scaler; the macroblock grid is the same);
- ``portrait.webm``: 7 frames at 160x96;
- ``ntsc.webm`` and ``odd_rate.webm``: 6 frames whose ``DefaultDuration``
  and ``Duration`` are set to 30000/1001 fps and to 23 fps over 0.18 s
  (cv2 then reports 4 frames of 6, and the readers take 5);
- ``no_default_duration.webm``: 6 frames without ``DefaultDuration`` (cv2's
  rate is then FFmpeg's guess from the timestamps: the port refuses it);
- ``live.webm``: ``gop.webm``'s first 14 frames remuxed here with a
  ``Segment`` and ``Cluster`` of unknown size, ``Void`` elements and
  ``BlockGroup`` blocks, as a live writer lays them out;
- ``mjpeg.mkv`` (cv2's ``MJPG``), ``mjpeg_interlaced.mkv`` (two 40-row
  fields a block, ``V_MJPEG`` in a 80-row track, muxed here) and
  ``mpeg4.mkv`` (cv2's ``mp4v``: ``V_MPEG4/ISO/ASP``);

and ``manifest.json``: each clip's codec, fps and frame count as cv2 reports
them, the frames read, and the sha256 of each frame of the JAX
``VideoReader`` (``ds = (0.25, 0.25)``) and of the JAX ``VideoSequence``
(full size), and ``reader_frames.npz``: the JAX ``VideoReader``'s frames of
each distinct scene (the flagship's once).

The tests use this module's writers too: ``BoolEncoder`` (RFC 6386 section
7.3), ``vp8_stream`` (crafted VP8 frames: a header written field by field,
macroblocks and tokens drawn at random through the port's own parser, so
every context and probability is the decoder's), ``write_webm`` (a minimal
Matroska/WebM muxer) and the EBML patchers.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import shutil
import struct
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))
from v2e2v_tpu_torch.utils import vp8, vp8dec  # noqa: E402

FLAGSHIP = (720, 960, 12, 240.0)  # height, width, frames, fps

# ------------------------------------------------------ boolean encoder


class BoolEncoder:
    """RFC 6386 section 7.3's boolean encoder."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.bit_count = 255, 0, 24

    def _add_one(self) -> None:
        i = len(self.out) - 1
        while i >= 0 and self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, prob: int, bit: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._add_one()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def flush(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._add_one()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


class Recorder(vp8._Bool):
    """Stands in for the port's boolean decoder while a frame is written:
    each bit the parser asks for is the next of ``script`` while it lasts,
    else drawn (``uniform``: even odds; else at the asked probability), and
    is encoded at the probability asked."""

    def __init__(self, rng: np.random.Generator, script=(), uniform: bool = False):
        self.enc, self.rng, self.uniform = BoolEncoder(), rng, uniform
        self.script = list(script)[::-1]

    def bit(self, prob: int) -> int:
        if self.script:
            b = self.script.pop()
        elif self.uniform:
            b = int(self.rng.random() < 0.5)
        else:
            b = int(self.rng.random() * 256 >= prob)
        self.enc.put(prob, b)
        return b

    def check(self) -> None:
        pass


def _literal(n: int, v: int) -> list:
    return [(v >> (n - 1 - i)) & 1 for i in range(n)]


def _signed(n: int, v: int) -> list:
    return _literal(n, abs(v)) + [int(v < 0)]


def _optional(n: int, v) -> list:
    return [0] if v is None else [1] + _signed(n, v)


def header_bits(f: dict, key: bool, rng: np.random.Generator) -> list:
    """A frame header's bits in the order the decoder reads them, from the
    fields ``f`` (see ``vp8_stream``); the probability updates are drawn
    with ``rng`` at the rates ``f`` gives."""
    bits = [0, f.get("clamping", 0)] if key else []
    seg = f.get("segmentation")
    bits += [int(seg is not None)]
    if seg is not None:
        bits += [int(seg.get("probs") is not None), int(seg.get("quant") is not None)]
        if seg.get("quant") is not None:
            bits += [seg.get("absolute", 0)]
            bits += [b for v in seg["quant"] for b in _optional(7, v)]
            bits += [b for v in seg["filter"] for b in _optional(6, v)]
        if seg.get("probs") is not None:
            bits += [b for p in seg["probs"] for b in ([0] if p is None else [1] + _literal(8, p))]
    bits += [f.get("simple", 0)] + _literal(6, f.get("level", 0))
    bits += _literal(3, f.get("sharpness", 0))
    deltas = f.get("deltas")  # None: off; {"ref": [...], "mode": [...]} or {} (no update)
    bits += [int(deltas is not None)]
    if deltas is not None:
        bits += [int(bool(deltas))]
        if deltas:
            for v in list(deltas["ref"]) + list(deltas["mode"]):
                bits += [0] if v is None else [1] + _signed(6, v)
    bits += _literal(2, f.get("parts_log2", 0))
    bits += _literal(7, f.get("q", 20)) + [b for v in f.get("q_deltas", [None] * 5)
                                             for b in _optional(4, v)]
    if not key:
        g, a = f.get("refresh_golden", 0), f.get("refresh_altref", 0)
        bits += [g, a]
        bits += [] if g else _literal(2, f.get("copy_golden", 0))
        bits += [] if a else _literal(2, f.get("copy_altref", 0))
        bits += [f.get("sign_golden", 0), f.get("sign_altref", 0)]
    bits += [f.get("refresh_probs", 1)]
    if not key:
        bits += [f.get("refresh_last", 1)]
    rate = f.get("coeff_updates", 0.0)
    for _ in range(4 * 8 * 3 * 11):
        if rng.random() < rate:
            bits += [1] + _literal(8, int(rng.integers(1, 256)))
        else:
            bits += [0]
    skip = f.get("skip_prob", 128)
    bits += [0] if skip is None else [1] + _literal(8, skip)
    if not key:
        bits += _literal(8, f.get("prob_intra", 128)) + _literal(8, f.get("prob_last", 128))
        bits += _literal(8, f.get("prob_gf", 128))
        for name, n in (("ymode_probs", 4), ("uvmode_probs", 3)):
            probs = f.get(name)
            bits += [0] if probs is None else [1] + [b for p in probs for b in _literal(8, p)]
        rate = f.get("mv_updates", 0.0)
        for _ in range(2 * 19):
            if rng.random() < rate:
                bits += [1] + _literal(7, int(rng.integers(0, 128)))
            else:
                bits += [0]
    return bits


def vp8_stream(frames: list, width: int, height: int, seed: int) -> list[bytes]:
    """Crafted VP8 frames: each ``frames`` entry is a dict of header fields
    (``key``, ``version``, ``show``, ``clamping``, ``segmentation``, ``level``,
    ``simple``, ``sharpness``, ``deltas``, ``parts_log2``, ``q``, ``q_deltas``,
    the reference flags, ``refresh_probs``, ``refresh_last``, update rates,
    ``skip_prob``, the inter probabilities, ``uniform``), the rest drawn at
    random with ``seed``: the port's parser runs over each frame with
    ``Recorder``s in place of its boolean decoders, so the macroblocks and
    tokens it draws are read back in the same contexts."""
    rng = np.random.default_rng(seed)
    state = vp8dec.Vp8Decoder("<crafted>")
    out = []
    for f in frames:
        key = bool(f.get("key"))
        if key:
            state.size = (height, width)
            state._reset()
        script = header_bits(f, key, rng)
        first = Recorder(rng, script, uniform=f.get("uniform", True))
        hdr = state._header(first, key)
        assert not first.script, "the header script and the parser disagree"
        parts = [Recorder(rng, uniform=False) for _ in range(hdr["num_parts"])]
        hdr["parts"] = parts
        state.macroblocks(first, hdr, key)
        state.end_frame(hdr, ("planes",))
        body = first.enc.flush()
        tokens = [p.enc.flush() for p in parts]
        tag = int(not key) | (f.get("version", 0) << 1) | (f.get("show", 1) << 4) | (len(body) << 5)
        data = tag.to_bytes(3, "little")
        if key:
            data += b"\x9d\x01\x2a" + struct.pack("<HH", width | (f.get("hscale", 0) << 14),
                                                  height | (f.get("vscale", 0) << 14))
        data += body + b"".join(len(t).to_bytes(3, "little") for t in tokens[:-1])
        out.append(data + b"".join(tokens))
    return out


# ------------------------------------------------------ EBML and WebM


def _vint_size(n: int, unknown: bool = False) -> bytes:
    if unknown:
        return b"\x01\xff\xff\xff\xff\xff\xff\xff"
    length = 1
    while n >= (1 << (7 * length)) - 1:
        length += 1
    return ((1 << (7 * length)) | n).to_bytes(length, "big")


def element(eid: int, body: bytes, unknown: bool = False) -> bytes:
    return eid.to_bytes((eid.bit_length() + 7) // 8, "big") + _vint_size(len(body), unknown) + body


def uint(eid: int, v: int) -> bytes:
    return element(eid, v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big"))


def write_webm(path: Path, frames: list[bytes], width: int, height: int,
               default_duration: int | None = 33333333, duration: float | None = None,
               doctype: str = "webm", codec_id: str = "V_VP8",
               per_cluster: int = 8, live: bool = False, track_extra: bytes = b"",
               video_extra: bytes = b"", tracks_extra: bytes = b"", lacing: bool = False,
               block_extra: bytes = b"", tracks_first: bytes = b"") -> None:
    """A minimal Matroska/WebM file of one video track (number 1): ``live``
    writes the segment and clusters with unknown sizes, ``Void`` elements
    and ``BlockGroup``s; the ``*_extra`` bytes go into the track entry, its
    ``Video``, ``Tracks`` after it and each block group (which
    ``block_extra`` asks for), ``tracks_first`` into ``Tracks`` before it;
    ``lacing`` sets the first block's Xiph lacing bits."""
    step = default_duration or 33333333
    if duration is None:
        duration = len(frames) * step / 1e6
    header = element(0x1A45DFA3, uint(0x4286, 1) + uint(0x42F7, 1) + uint(0x42F2, 4)
                     + uint(0x42F3, 8) + element(0x4282, doctype.encode()) + uint(0x4287, 4)
                     + uint(0x4285, 2))
    info = element(0x1549A966, uint(0x2AD7B1, 1000000) + element(0x4489, struct.pack(">d",
                                                                                     duration))
                   + element(0x4D80, b"make_mkv_fixtures") + element(0x5741, b"make_mkv_fixtures"))
    video = element(0xE0, uint(0xB0, width) + uint(0xBA, height) + video_extra)
    entry = (uint(0xD7, 1) + uint(0x73C5, 1) + uint(0x83, 1) + element(0x86, codec_id.encode())
             + (uint(0x23E383, default_duration) if default_duration else b"") + video
             + track_extra)
    tracks = element(0x1654AE6B, tracks_first + element(0xAE, entry) + tracks_extra)
    clusters = b""
    for c in range(0, len(frames), per_cluster):
        start = round(c * step / 1e6)
        body = uint(0xE7, start)
        for k, data in enumerate(frames[c:c + per_cluster]):
            rel = round((c + k) * step / 1e6) - start
            flags = 0x80 if not data[0] & 1 else 0
            if lacing and c + k == 0:
                flags |= 0x02
            block = b"\x81" + struct.pack(">hB", rel, flags) + data
            if live or block_extra:
                body += element(0xA0, element(0xA1, b"\x81" + struct.pack(">hB", rel, flags & 0x7F)
                                              + data) + block_extra)
            else:
                body += element(0xA3, block)
            if live:
                body += element(0xEC, bytes(3))
        clusters += element(0x1F43B675, body, unknown=live)
    segment = (element(0xEC, bytes(8)) if live else b"") + info + tracks + clusters
    path.write_bytes(header + element(0x18538067, segment, unknown=live))


MASTERS = {0x18538067, 0x1654AE6B, 0xAE, 0xE0, 0x1F43B675, 0xA0, 0x1549A966, 0x55B0}


def _vint(d: bytes, p: int, keep: bool):
    n = 9 - d[p].bit_length()
    v = int.from_bytes(d[p:p + n], "big")
    return (v if keep else v & ((1 << (7 * n)) - 1)), p + n


def walk(d: bytes, pos: int = 0, end: int | None = None, path=()):
    """(path of IDs, start, body start, end) of every element, depth first
    through the masters the demuxer reads (known sizes only)."""
    end = len(d) if end is None else end
    while pos < end:
        eid, a = _vint(d, pos, True)
        size, b = _vint(d, a, False)
        stop = min(b + size, end)
        yield path + (eid,), pos, b, stop
        if eid in MASTERS:
            yield from walk(d, b, stop, path + (eid,))
        pos = stop


def set_uint(d: bytes, eid: int, value: int) -> bytes:
    """The first element ``eid``'s unsigned value, in its own length."""
    for path, _, b, stop in walk(d):
        if path[-1] == eid:
            return d[:b] + value.to_bytes(stop - b, "big") + d[stop:]
    raise KeyError(hex(eid))


def set_float(d: bytes, eid: int, value: float) -> bytes:
    for path, _, b, stop in walk(d):
        if path[-1] == eid:
            return d[:b] + struct.pack(">d" if stop - b == 8 else ">f", value) + d[stop:]
    raise KeyError(hex(eid))


def to_void(d: bytes, eid: int) -> bytes:
    """The first element ``eid`` overwritten by a ``Void`` of its length."""
    for path, pos, _, stop in walk(d):
        if path[-1] == eid:
            n = stop - pos
            return d[:pos] + b"\xec" + bytes((0x80 | (n - 2),)) + bytes(n - 2) + d[stop:]
    raise KeyError(hex(eid))


def vp8_frames(d: bytes) -> list[tuple[int, int]]:
    """(start, end) of each SimpleBlock's frame."""
    return [(b + 4, stop) for path, _, b, stop in walk(d) if path[-1] == 0xA3]


def patch_vp8_size(d: bytes, width: int, height: int) -> bytes:
    """Every key frame's size and the track's ``PixelWidth``/``PixelHeight``."""
    out = bytearray(d)
    for start, _ in vp8_frames(d):
        if not out[start] & 1:
            out[start + 6:start + 10] = struct.pack("<HH", width, height)
    return set_uint(set_uint(bytes(out), 0xB0, width), 0xBA, height)


# ----------------------------------------------------------------- clips

def write_clips(out: Path, rng: np.random.Generator) -> dict[str, str]:
    """Every clip; the value names the scene whose reader frames it shares."""
    import cv2
    from make_mpeg4_fixtures import avi1, pan, write
    from make_video_fixtures import imencode, scene

    h, w, n, fps = FLAGSHIP
    frames = pan(rng, h, w, n, (3, -7)).astype(np.int16)
    frames = np.clip(frames + rng.normal(0, 1.2, frames.shape), 0, 255).astype(np.uint8)
    clips = {}
    for name in ("flagship.webm", "flagship.mkv"):
        write(out / name, frames, fps, "VP80")
        clips[name] = "flagship"
    write(out / "gop.webm", pan(rng, 64, 96, 30, (1, 2)), 30.0, "VP80")
    mix = pan(rng, 64, 80, 8, (2, 3))
    mix[2:, 16:48, 24:64] = rng.integers(0, 256, (6, 32, 40, 3), dtype=np.uint8)
    write(out / "noise.webm", mix, 30.0, "VP80")
    write(out / "flat.webm", np.full((8, 64, 80, 3), (40, 120, 200), np.uint8), 30.0, "VP80")
    write(out / "odd.webm", pan(rng, 64, 80, 8, (1, -2)), 60.0, "VP80")
    (out / "odd.webm").write_bytes(patch_vp8_size((out / "odd.webm").read_bytes(), 75, 49))
    write(out / "portrait.webm", pan(rng, 160, 96, 7, (2, 1)), 240.0, "VP80")
    for name, dd, dur in (("ntsc", 33366667, 200.2), ("odd_rate", 43478261, 180.0),
                          ("no_default_duration", None, None)):
        write(out / f"{name}.webm", pan(rng, 64, 80, 6, (1, -1)), 30.0, "VP80")
        d = (out / f"{name}.webm").read_bytes()
        d = to_void(d, 0x23E383) if dd is None else set_uint(d, 0x23E383, dd)
        if dur is not None:
            d = set_float(d, 0x4489, dur)
        (out / f"{name}.webm").write_bytes(d)
    gop = (out / "gop.webm").read_bytes()
    write_webm(out / "live.webm", [gop[s:e] for s, e in vp8_frames(gop)][:14], 96, 64,
               default_duration=33333333, live=True, per_cluster=5)
    write(out / "mjpeg.mkv", scene(rng, 64, 80, 5), 25.0, "MJPG")
    fields = scene(rng, 40, 96, 8)
    packets = [avi1(imencode(f), 0) for f in fields]
    write_webm(out / "mjpeg_interlaced.mkv", [packets[k] + packets[k + 1] for k in range(0, 8, 2)],
               96, 80, default_duration=40000000, doctype="matroska", codec_id="V_MJPEG")
    write(out / "mpeg4.mkv", pan(rng, 64, 80, 6, (1, 2)), 25.0, "mp4v")
    for name in ("gop.webm", "noise.webm", "flat.webm", "odd.webm", "portrait.webm", "ntsc.webm",
                 "odd_rate.webm", "no_default_duration.webm", "live.webm", "mjpeg.mkv",
                 "mjpeg_interlaced.mkv", "mpeg4.mkv"):
        clips[name] = name.rsplit(".", 1)[0]
    return clips


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


CODECS = {"VP80": "vp8", "MJPG": "mjpeg", "FMP4": "mpeg4", "MP4V": "mpeg4"}
REFUSED = ("no_default_duration.webm",)  # cv2's rate is FFmpeg's guess from the timestamps


def main() -> None:
    import cv2

    from v2e2v_tpu.data.manifests import VideoSequence
    from v2e2v_tpu.data.video_readers import VideoReader

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=ROOT / "tests" / "data" / "mkv")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.out.exists():
        shutil.rmtree(args.out)
    args.out.mkdir(parents=True)
    clips = write_clips(args.out, np.random.default_rng(args.seed))
    manifest, arrays = {}, {}
    for name, key in clips.items():
        path = str(args.out / name)
        cap = cv2.VideoCapture(path)
        fourcc = int(cap.get(cv2.CAP_PROP_FOURCC)).to_bytes(4, "little").decode().upper()
        entry = {"fps": cap.get(cv2.CAP_PROP_FPS), "frame_count": cap.get(cv2.CAP_PROP_FRAME_COUNT),
                 "frames": key, "codec": CODECS.get(fourcc, fourcc),
                 "ported": name not in REFUSED}
        cap.release()
        reader = VideoReader(FLAGSHIP[:2], ds=(0.25, 0.25))
        reader.initialize(path)
        pairs = list(VideoSequence(path))
        full = [p[0] for p in pairs[:1]] + [p[1] for p in pairs]
        entry.update(frames_read=reader.num_frames, shape=list(full[0].shape),
                     reader_shape=list(reader.frames[0].shape),
                     timestamps=[float(t) for t in reader.timestamps],
                     reader_sha256=[sha(f) for f in reader.frames],
                     sequence_sha256=[sha(f) for f in full])
        stack = np.stack(reader.frames)
        if key in arrays:
            assert np.array_equal(arrays[key], stack), f"{name} differs from {key}"
        arrays[key] = stack
        manifest[name] = entry
    np.savez_compressed(args.out / "reader_frames.npz", **arrays)
    (args.out / "manifest.json").write_text(json.dumps(
        {"writer": "scripts/make_mkv_fixtures.py", "seed": args.seed, "cv2": cv2.__version__,
         "clips": manifest}, indent=1) + "\n")
    total = sum(p.stat().st_size for p in args.out.rglob("*") if p.is_file())
    print(f"{len(clips)} clips, reader_frames.npz and manifest.json under {args.out}: "
          f"{total} bytes")


if __name__ == "__main__":
    main()
