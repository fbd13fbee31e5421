#!/usr/bin/env python3
"""Write the MPEG-4 Part 2 fixtures of the port's video path
(``v2e2v_tpu_torch/utils/mp4.py``, ``mpeg4.py``, ``yuv.yuv420p_to_bgr``,
``avi.py``'s MPEG-4 fourccs, ``video.py``) and what the JAX package's readers
return for each.

    JAX_PLATFORMS=cpu python scripts/make_mpeg4_fixtures.py [--out tests/data/mpeg4] [--seed 0]

It needs cv2 built with FFmpeg and the JAX package, so it runs where the JAX
package's dependencies are installed, not on the card's machine; the card
checks the port against the hashes this writes. Every clip is written by
``cv2.VideoWriter`` (FFmpeg's ``mpeg4`` encoder: simple profile, I- and
P-VOPs, a GOP of 12) from seeded numpy scenes, some then patched here:

- ``flagship.mp4``: 12 frames at 960x720, 240 fps, a pan of 3 rows and -7
  columns a frame, whose motion vectors reach past the frame's edge; the
  same frames as ``flagship.mov``, ``flagship.m4v``, and ``XVID`` and
  ``FMP4`` AVIs (``flagship_xvid.avi``, ``flagship_fmp4.avi``);
- ``gop.mp4``: 25 frames at 64x96, so that I-VOPs open frames 12 and 24;
- ``portrait.mp4``: 7 frames at 96x160 (portrait);
- ``ntsc.mp4``: 5 frames at 96x128 whose ``mdhd`` timescale and ``stts``
  durations are set to 30000 and 1001 (cv2 itself writes 29.97 fps);
- ``odd.mp4``: 8 frames written at 80x64 whose VOL and sample entry say
  75x49 (cv2 writes even sizes only; the macroblock grid is the same);
- ``noise.mp4``: 6 frames at 64x80 with a noise patch from the third on:
  escape codes of all three kinds and intra MBs inside P-VOPs;
- ``flat.mp4``: 6 flat frames at 64x80: skipped MBs and long runs;
- ``interlaced_p0.avi``, ``interlaced_p1.avi``: interlaced MJPEG, 4 packets
  of two 40-row fields (80x96 frames), whose AVI1 APP0 states polarity 0
  and 1 (cv2 weaves both alike: ``utils/video.py``);
- ``tiny_420.avi`` (7x12), ``tiny_411.avi`` (8x24), ``tiny_440.avi`` (5x8):
  MJPEG frames so small that swscale cuts its bicubic chroma filter to the
  plane (``utils/yuv.py``), two each;

and ``manifest.json``: each clip's codec, fps and frame count as cv2 reports them,
the frames read, and the sha256 of each frame of the JAX ``VideoReader``
(``ds = (0.25, 0.25)``) and of the JAX ``VideoSequence`` (full size), and
``reader_frames.npz``: the JAX ``VideoReader``'s frames of each distinct
scene (the flagship's once). The helpers that patch a written MP4
(``patch_vol_size``, ``set_timing``, ``set_matrix``, ``faststart``,
``to_co64``) are what the tests use too.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import shutil
import struct
import sys
from pathlib import Path

import cv2
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
from make_video_fixtures import imencode, scene, segments, write_avi  # noqa: E402

FLAGSHIP = (720, 960, 12, 240.0)  # height, width, frames, fps
TINY = {"tiny_420": (7, 12), "tiny_411": (8, 24), "tiny_440": (5, 8)}  # (height, width)
CONTAINERS = {"flagship.mp4": "mp4v", "flagship.mov": "mp4v", "flagship.m4v": "mp4v",
              "flagship_xvid.avi": "XVID", "flagship_fmp4.avi": "FMP4"}


def pan(rng: np.random.Generator, h: int, w: int, frames: int, step) -> np.ndarray:
    """``[frames, h, w, 3]``: a window moving ``step`` (rows, columns) a
    frame over a larger ``scene``."""
    dy, dx = step
    big = scene(rng, h + abs(dy) * frames + 8, w + abs(dx) * frames + 8, 1)[0]
    out = []
    for t in range(frames):
        y = 4 + (dy * t if dy >= 0 else -dy * (frames - t))
        x = 4 + (dx * t if dx >= 0 else -dx * (frames - t))
        out.append(big[y:y + h, x:x + w])
    return np.stack(out)


def write(path: Path, frames: np.ndarray, fps: float, fourcc: str = "mp4v") -> None:
    h, w = frames.shape[1:3]
    vw = cv2.VideoWriter(str(path), cv2.CAP_FFMPEG, cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    if not vw.isOpened():
        raise RuntimeError(f"cv2.VideoWriter cannot write {fourcc} through FFmpeg here")
    for f in frames:
        vw.write(f)
    vw.release()


# ------------------------------------------------------ patching an MP4

def boxes(data: bytes, pos: int = 0, end: int | None = None, path=()):
    """(path of box types, start, header size, size) of every box, depth
    first, through the containers the demuxer walks and ``stsd``'s entries."""
    end = len(data) if end is None else end
    while pos + 8 <= end:
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        head = 8
        if size == 1:
            size, head = struct.unpack(">Q", data[pos + 8:pos + 16])[0], 16
        elif size == 0:
            size = end - pos
        here = path + (kind,)
        yield here, pos, head, size
        if kind in (b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts"):
            yield from boxes(data, pos + head, pos + size, here)
        elif kind == b"stsd":
            yield from boxes(data, pos + head + 8, pos + size, here)
        elif kind == b"mp4v":
            yield from boxes(data, pos + head + 78, pos + size, here)
        pos += size


def find(data: bytes, kind: bytes) -> tuple[int, int, int]:
    """(start, header size, size) of the first box of ``kind``."""
    for path, pos, head, size in boxes(data):
        if path[-1] == kind:
            return pos, head, size
    raise KeyError(kind)


def patch_vol_size(data: bytes, width: int, height: int) -> bytes:
    """Set the VOL's width and height (and the sample entry's) of a file
    cv2 wrote: its VOL has ``vol_control_parameters`` without VBV and no
    ``fixed_vop_rate``, so the width lies 48 bits after the start code."""
    out = bytearray(data)
    k = out.find(b"\x00\x00\x01\x20") + 4
    bits = int.from_bytes(out[k:k + 12], "big")
    n = 96
    first = (bits >> (n - 48)) & ((1 << 48) - 1)  # up to the width
    assert first & 0b111 == 0b101, "an unexpected VOL layout"  # marker, fixed_vop_rate 0, marker
    rest = bits & ((1 << (n - 48 - 28)) - 1)
    field = (width << 15) | (1 << 14) | (height << 1) | 1  # width, marker, height, marker
    out[k:k + 12] = ((first << (n - 48)) | (field << (n - 48 - 28)) | rest).to_bytes(12, "big")
    pos, head, _ = find(bytes(out), b"mp4v")
    out[pos + head + 24:pos + head + 28] = struct.pack(">HH", width, height)
    return bytes(out)


def set_timing(data: bytes, timescale: int, delta: int) -> bytes:
    """The video track's ``mdhd`` timescale and every ``stts`` duration."""
    out = bytearray(data)
    pos, head, _ = find(data, b"mdhd")
    body = pos + head
    assert out[body] == 0
    n = sum(c for c, _ in _stts(data))
    out[body + 12:body + 20] = struct.pack(">II", timescale, n * delta)
    pos, head, _ = find(data, b"stts")
    out[pos + head + 4:pos + head + 16] = struct.pack(">III", 1, n, delta)
    return bytes(out)


def _stts(data: bytes):
    pos, head, _ = find(data, b"stts")
    n = struct.unpack(">I", data[pos + head + 4:pos + head + 8])[0]
    return [struct.unpack(">II", data[pos + head + 8 + 8 * k:pos + head + 16 + 8 * k])
            for k in range(n)]


def set_matrix(data: bytes, a: int, b: int, c: int, d: int) -> bytes:
    """The video track's ``tkhd`` matrix (a, b, c, d in whole units)."""
    out = bytearray(data)
    pos, head, _ = find(data, b"tkhd")
    at = pos + head + 40
    out[at:at + 36] = struct.pack(">9i", a << 16, b << 16, 0, c << 16, d << 16, 0, 0, 0,
                                  0x40000000)
    return bytes(out)


def faststart(data: bytes) -> bytes:
    """``moov`` moved before ``mdat`` (as ``-movflags faststart`` lays a
    file out), its chunk offsets moved on by ``moov``'s size."""
    top = [(p[-1], pos, size) for p, pos, _, size in boxes(data) if len(p) == 1]
    moov = next((pos, size) for k, pos, size in top if k == b"moov")
    moov_bytes = bytearray(data[moov[0]:moov[0] + moov[1]])
    pos, head, _ = find(bytes(moov_bytes), b"stco")
    n = struct.unpack(">I", moov_bytes[pos + head + 4:pos + head + 8])[0]
    for k in range(n):
        at = pos + head + 8 + 4 * k
        off = struct.unpack(">I", moov_bytes[at:at + 4])[0]
        moov_bytes[at:at + 4] = struct.pack(">I", off + moov[1])
    rest = b"".join(data[p:p + s] for k, p, s in top if k not in (b"ftyp", b"moov"))
    ftyp = b"".join(data[p:p + s] for k, p, s in top if k == b"ftyp")
    return ftyp + bytes(moov_bytes) + rest


def to_co64(data: bytes) -> bytes:
    """``stco`` rewritten as ``co64`` (64-bit chunk offsets), the boxes
    that hold it grown and the offsets moved on to match."""
    pos, head, size = find(data, b"stco")
    n = struct.unpack(">I", data[pos + head + 4:pos + head + 8])[0]
    grow = 4 * n
    offs = struct.unpack(f">{n}I", data[pos + head + 8:pos + head + 8 + 4 * n])
    moov = find(data, b"moov")
    shift = grow if moov[0] < min(offs) else 0  # samples after moov move too
    co64 = struct.pack(">I4s", size + grow, b"co64") + data[pos + 8:pos + 16] + struct.pack(
        f">{n}Q", *(o + shift for o in offs))
    out = bytearray(data[:pos] + co64 + data[pos + size:])
    for path, p, h, s in boxes(data):
        if path[-1] in (b"moov", b"trak", b"mdia", b"minf", b"stbl") and p < pos < p + s:
            out[p:p + 4] = struct.pack(">I", s + grow)
    return bytes(out)


def avi1(jpeg: bytes, polarity: int) -> bytes:
    """``jpeg`` with its JFIF APP0 replaced by an AVI1 APP0 stating
    ``polarity`` (AVI1, polarity, a zero byte, two field sizes)."""
    out, last = bytearray(), 0
    for marker, start, end in segments(jpeg):
        if marker == 0xE0 and jpeg[start + 4:start + 9] == b"JFIF\x00":
            body = b"AVI1" + bytes((polarity,)) + bytes(9)
            out += jpeg[last:start] + b"\xff\xe0" + struct.pack(">H", len(body) + 2) + body
            last = end
    return bytes(out + jpeg[last:])


def interlaced(path: Path, fields: np.ndarray, polarity: int) -> None:
    """An MJPEG AVI whose packets each hold two fields (consecutive frames
    of ``fields``), the stream's height twice a field's."""
    enc = [avi1(imencode(f), polarity) for f in fields]
    h, w = fields.shape[1:3]
    write_avi(path, [enc[k] + enc[k + 1] for k in range(0, len(enc) - 1, 2)], w, 2 * h, 60)


# ----------------------------------------------------------------- clips

def write_clips(out: Path, rng: np.random.Generator) -> dict[str, str]:
    """Every clip; the value names the scene whose reader frames it shares."""
    h, w, n, fps = FLAGSHIP
    frames = pan(rng, h, w, n, (3, -7))
    clips = {}
    for name, fourcc in CONTAINERS.items():
        write(out / name, frames, fps, fourcc)
        clips[name] = "flagship"
    write(out / "gop.mp4", pan(rng, 64, 96, 25, (1, 2)), 30.0)
    write(out / "portrait.mp4", pan(rng, 160, 96, 7, (2, 1)), 240.0)
    write(out / "ntsc.mp4", pan(rng, 96, 128, 5, (1, -1)), 29.97)
    path = out / "ntsc.mp4"
    path.write_bytes(set_timing(path.read_bytes(), 30000, 1001))
    write(out / "odd.mp4", pan(rng, 64, 80, 8, (1, -2)), 60.0)
    path = out / "odd.mp4"
    path.write_bytes(patch_vol_size(path.read_bytes(), 75, 49))
    mix = pan(rng, 64, 80, 6, (2, 3))
    mix[2:, 16:48, 24:64] = rng.integers(0, 256, (4, 32, 40, 3), dtype=np.uint8)
    write(out / "noise.mp4", mix, 30.0)
    write(out / "flat.mp4", np.full((6, 64, 80, 3), (40, 120, 200), np.uint8), 30.0)
    for p in (0, 1):
        interlaced(out / f"interlaced_p{p}.avi", scene(rng, 40, 96, 8), p)
    for name, (h, w) in TINY.items():
        factor = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{name[5:]}")
        write_avi(out / f"{name}.avi", [imencode(f, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor])
                                        for f in scene(rng, h, w, 2)], w, h, 30)
    for name in ("gop.mp4", "portrait.mp4", "ntsc.mp4", "odd.mp4", "noise.mp4", "flat.mp4",
                 "interlaced_p0.avi", "interlaced_p1.avi", *(f"{t}.avi" for t in TINY)):
        clips[name] = name.rsplit(".", 1)[0]
    return clips


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main() -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from v2e2v_tpu.data.manifests import VideoSequence
    from v2e2v_tpu.data.video_readers import VideoReader

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=Path(__file__).resolve().parents[1]
                    / "tests" / "data" / "mpeg4")
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
        entry = {"fps": cap.get(cv2.CAP_PROP_FPS), "frame_count": cap.get(cv2.CAP_PROP_FRAME_COUNT),
                 "frames": key,
                 "codec": "mjpeg" if name.startswith(("interlaced", "tiny")) else "mpeg4"}
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
        {"writer": "scripts/make_mpeg4_fixtures.py", "seed": args.seed, "cv2": cv2.__version__,
         "clips": manifest}, indent=1) + "\n")
    total = sum(p.stat().st_size for p in args.out.rglob("*") if p.is_file())
    print(f"{len(clips)} clips, reader_frames.npz and manifest.json under {args.out}: "
          f"{total} bytes")


if __name__ == "__main__":
    main()
