#!/usr/bin/env python3
"""Write the video fixtures of the port's video path (``v2e2v_tpu_torch/utils/
avi.py``, ``jpeg.py::decode_mjpeg_frame``, ``yuv.py``, ``video.py``) and what
the JAX package's readers return for each.

    python scripts/make_video_fixtures.py [--out tests/data/video] [--seed 0]

It needs cv2 built with FFmpeg (``cv2.VideoWriter``, ``cv2.imencode`` and the
JAX package's ``VideoReader`` and ``VideoSequence``, which read through
``cv2.VideoCapture``), so it runs where the JAX package's dependencies are
installed, not on the card's machine; the card checks its decoder against the
frames and hashes this writes. From seeded numpy colour scenes it writes these
MJPEG AVIs:

- ``flagship.avi``: 12 frames at 960x720, 240 fps, by ``cv2.VideoWriter``
  (FFmpeg's AVI muxer and MJPEG encoder: yuvj420p, optimal Huffman tables);
  the reader shrinks it to the flagship's 180x240;
- ``portrait.avi``: 7 frames at 96x160 (portrait), ``cv2.VideoWriter``;
- ``ntsc.avi``: 5 frames at 30000/1001 fps, ``cv2.imencode`` frames in an
  ``idx1``-indexed AVI written here;
- ``no_dht.avi``: 5 frames whose DHT segments are cut out and whose JFIF APP0
  is an ``AVI1`` one: the decoder takes the standard tables of T.81 Annex K.3;
- ``odd_width.avi``: 4 frames at 75x64 in ``LIST rec`` groups with ``JUNK``
  chunks, no index;
- ``restart.avi``: 5 frames with a restart interval of 3 MCUs, the third
  chunk empty (a dropped frame, which FFmpeg skips);
- ``opendml.avi``: 9 frames over a RIFF ``AVI `` and two RIFF ``AVIX``
  chunks, indexed by an ``indx`` super index and one ``ix00`` per ``movi``
  list, with ``odml``/``dmlh``, as OpenDML files past 1 GB are;
- ``odd_height.avi``: 3 frames at 64x49 (4:2:0 through swscale's general
  scaler, not its unscaled converter);
- ``yuv411.avi``, ``yuv422.avi``, ``yuv440.avi``, ``yuv444.avi``: 4 frames
  each at 80x64, ``cv2.imencode`` at each ``IMWRITE_JPEG_SAMPLING_FACTOR``;
- ``gray.avi``: 4 one-component frames at 80x64 (FFmpeg's ``gray``);
- ``progressive.avi``: 4 progressive 4:2:0 frames at 80x64;
- ``progressive_422.avi``: 3 progressive 4:2:2 frames at 77x49 (odd sizes:
  the general scaler);
- ``hd_yuv411.avi``, ``hd_yuv422.avi``, ``hd_yuv440.avi``, ``hd_yuv444.avi``,
  ``hd_gray.avi``, ``hd_progressive.avi``: 2 frames each at 960x720 (a
  webcam's MJPEG size; 4:2:2 is what webcams send most), quality 60, which
  the card times per sampling;

and ``manifest.json``: each clip's fps and frame count as cv2 reports them,
the frames read, and the sha256 of each frame of the JAX ``VideoReader``
(``ds = (0.25, 0.25)``) and of the JAX ``VideoSequence`` (full size), and
``reader_frames.npz``: the JAX ``VideoReader``'s frames of every clip that the
port reads.
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

FLAGSHIP = (720, 960, 12, 240.0)  # height, width, frames, fps
SAMPLINGS = {"yuv411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
             "yuv422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "yuv440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
             "yuv444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}


def scene(rng: np.random.Generator, h: int, w: int, frames: int) -> np.ndarray:
    """``[frames, h, w, 3]`` uint8 BGR: smooth colour gradients, a drifting
    sinusoid and three soft-edged discs that move a few pixels a frame."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64) / max(h, w)
    grad = [rng.uniform(60, 190) + rng.uniform(-50, 50) * xx + rng.uniform(-50, 50) * yy
            for _ in range(3)]
    k = rng.uniform(6, 14, 2)
    discs = [(rng.uniform(0.2, 0.8) * h / max(h, w), rng.uniform(0.2, 0.8) * w / max(h, w),
              rng.uniform(0.08, 0.2), rng.uniform(-0.01, 0.01, 2), rng.uniform(-90, 90, 3))
             for _ in range(3)]
    out = np.empty((frames, h, w, 3), np.uint8)
    for t in range(frames):
        img = np.stack(grad, -1) + 25 * np.sin(k[0] * xx + k[1] * yy + 0.3 * t)[..., None]
        for cy, cx, r, (vy, vx), colour in discs:
            d = np.sqrt((yy - cy - vy * t) ** 2 + (xx - cx - vx * t) ** 2)
            img += colour * np.clip((r - d) / (0.3 * r), 0, 1)[..., None]
        out[t] = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    return out


# --------------------------------------------------------------- AVI writing

def _chunk(fcc: bytes, body: bytes) -> bytes:
    return fcc + struct.pack("<I", len(body)) + body + (b"\0" if len(body) & 1 else b"")


def _list(kind: bytes, body: bytes) -> bytes:
    return _chunk(b"LIST", kind + body)


def write_avi(path: Path, frames: list[bytes], width: int, height: int, rate: int,
              scale: int = 1, index: str = "idx1", riffs: int = 1, rec: bool = False,
              junk: bool = False, fourcc: bytes = b"MJPG") -> None:
    """One video stream of ``frames`` (each a chunk '00dc'; b'' writes an
    empty chunk) at ``rate / scale`` fps. ``index``: 'idx1', 'odml' (an
    ``indx`` super index, one ``ix00`` standard index per ``movi`` list, and
    ``idx1`` over the first RIFF) or 'none'. ``riffs`` > 1 spreads the frames
    over a RIFF 'AVI ' and RIFF 'AVIX' chunks. ``rec`` wraps each chunk in a
    ``LIST rec``; ``junk`` puts a ``JUNK`` chunk before each."""
    n = len(frames)
    odml = index == "odml"
    groups = np.array_split(np.arange(n), riffs)
    avih = struct.pack("<14I", round(1e6 * scale / rate), 0, 0, 0x10,
                       len(groups[0]), 0, 1, 0, width, height, 0, 0, 0, 0)
    strh = b"vids" + fourcc + struct.pack("<IHHIIIIIIIIhhhh", 0, 0, 0, 0, scale, rate, 0, n, 0,
                                          0xFFFFFFFF, 0, 0, 0, width, height)
    strf = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 24, fourcc, width * height * 3,
                       0, 0, 0, 0)
    indx_size = 24 + 16 * riffs

    def header(indx: bytes) -> bytes:
        strl = _chunk(b"strh", strh) + _chunk(b"strf", strf)
        if odml:
            strl += _chunk(b"indx", indx)
        hdrl = _chunk(b"avih", avih) + _list(b"strl", strl)
        if odml:
            hdrl += _list(b"odml", _chunk(b"dmlh", struct.pack("<I", n) + bytes(244)))
        return _list(b"hdrl", hdrl)

    # the layout: lay each RIFF out once with a placeholder indx, then again
    # with the ix00 offsets known
    def build(indx: bytes):
        out = bytearray()
        ix_places = []
        for r, group in enumerate(groups):
            body = bytearray(b"AVI " if r == 0 else b"AVIX")
            if r == 0:
                body += header(indx)
            movi_tag = len(out) + 8 + len(body) + 8  # the file position of 'movi'
            movi = bytearray(b"movi")
            idx1, ix = bytearray(), bytearray()
            for i in group:
                if junk:
                    movi += _chunk(b"JUNK", b"\0" * 7)
                data = frames[i]
                chunk = _chunk(b"00dc", data)
                pos = len(movi) + (12 if rec else 0)  # of the chunk, from 'movi'
                movi += _list(b"rec ", chunk) if rec else chunk
                idx1 += b"00dc" + struct.pack("<III", 0x10, pos, len(data))
                ix += struct.pack("<II", pos + 8, len(data))  # from the 'movi' tag
            if odml:
                ix_places.append((movi_tag + len(movi), 32 + len(ix), len(group)))
                movi += _chunk(b"ix00", struct.pack("<HBBI4sQI", 2, 0, 1, len(group), b"00dc",
                                                    movi_tag, 0) + ix)
            body += _chunk(b"LIST", bytes(movi))
            if r == 0 and index in ("idx1", "odml"):
                body += _chunk(b"idx1", bytes(idx1))
            out += _chunk(b"RIFF", bytes(body))
        return bytes(out), ix_places

    indx = bytes(indx_size)
    data, ix_places = build(indx)
    if odml:
        indx = struct.pack("<HBBI4sIII", 4, 0, 0, riffs, b"00dc", 0, 0, 0) + b"".join(
            struct.pack("<QII", off, size, count) for off, size, count in ix_places)
        data, _ = build(indx)
    path.write_bytes(data)


# ------------------------------------------------------------------ frames

def imencode(img: np.ndarray, params=()) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, list(params))
    if not ok:
        raise RuntimeError(f"cv2.imencode failed with {params}")
    return buf.tobytes()


def segments(jpeg: bytes):
    """(marker, start, end) of each marker segment before the first SOS."""
    pos = 2
    while pos < len(jpeg):
        marker = jpeg[pos + 1]
        end = pos + 2 + struct.unpack(">H", jpeg[pos + 2:pos + 4])[0]
        yield marker, pos, end
        if marker == 0xDA:
            return
        pos = end


def without_dht(jpeg: bytes) -> bytes:
    """The frame with its DHT segments cut out and its JFIF APP0 turned into
    an ``AVI1`` one (the convention of MJPEG cameras that leave the standard
    tables out)."""
    out, last = bytearray(jpeg[:2]), 2
    for marker, start, end in segments(jpeg):
        if marker == 0xDA:
            break
        if marker == 0xC4:
            last = end
            continue
        body = jpeg[start:end]
        if marker == 0xE0 and body[4:9] == b"JFIF\x00":
            avi1 = b"AVI1" + bytes(10)
            body = b"\xff\xe0" + struct.pack(">H", len(avi1) + 2) + avi1
        out += body
        last = end
    return bytes(out + jpeg[last:])


def video_writer(path: Path, frames: np.ndarray, fps: float) -> None:
    h, w = frames.shape[1:3]
    vw = cv2.VideoWriter(str(path), cv2.CAP_FFMPEG, cv2.VideoWriter_fourcc(*"MJPG"), fps, (w, h))
    if not vw.isOpened():
        raise RuntimeError("cv2.VideoWriter cannot write MJPG through FFmpeg here")
    for f in frames:
        vw.write(f)
    vw.release()


def write_clips(out: Path, rng: np.random.Generator) -> dict[str, bool]:
    """Every clip; the value says whether the port reads it."""
    h, w, n, fps = FLAGSHIP
    video_writer(out / "flagship.avi", scene(rng, h, w, n), fps)
    video_writer(out / "portrait.avi", scene(rng, 160, 96, 7), 240.0)
    write_avi(out / "ntsc.avi", [imencode(f, [cv2.IMWRITE_JPEG_QUALITY, 85])
                                 for f in scene(rng, 96, 128, 5)], 128, 96, 30000, 1001)
    write_avi(out / "no_dht.avi", [without_dht(imencode(f)) for f in scene(rng, 80, 112, 5)],
              112, 80, 25)
    write_avi(out / "odd_width.avi", [imencode(f) for f in scene(rng, 64, 75, 4)], 75, 64, 60,
              index="none", rec=True, junk=True)
    restart = [imencode(f, [cv2.IMWRITE_JPEG_RST_INTERVAL, 3]) for f in scene(rng, 64, 96, 5)]
    restart[2] = b""
    write_avi(out / "restart.avi", restart, 96, 64, 120)
    write_avi(out / "opendml.avi", [imencode(f) for f in scene(rng, 48, 64, 9)], 64, 48, 500,
              index="odml", riffs=3)
    write_avi(out / "odd_height.avi", [imencode(f) for f in scene(rng, 49, 64, 3)],
              64, 49, 30)
    for name, factor in SAMPLINGS.items():
        write_avi(out / f"{name}.avi", [imencode(f, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor])
                                        for f in scene(rng, 64, 80, 4)], 80, 64, 30)
    write_avi(out / "gray.avi", [imencode(cv2.cvtColor(f, cv2.COLOR_BGR2GRAY))
                                 for f in scene(rng, 64, 80, 4)], 80, 64, 30)
    write_avi(out / "progressive.avi", [imencode(f, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
                                        for f in scene(rng, 64, 80, 4)], 80, 64, 30)
    write_avi(out / "progressive_422.avi", [
        imencode(f, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                     cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]) for f in scene(rng, 49, 77, 3)],
        77, 49, 30)
    hd = {**{name: [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor]
               for name, factor in SAMPLINGS.items()},
          "gray": [], "progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]}
    for name, params in hd.items():
        imgs = scene(rng, 720, 960, 2)
        if name == "gray":
            imgs = [cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) for f in imgs]
        write_avi(out / f"hd_{name}.avi", [imencode(f, [cv2.IMWRITE_JPEG_QUALITY, 60, *params])
                                           for f in imgs], 960, 720, 30)
    return {p.name: not p.name.startswith("refused") for p in sorted(out.glob("*.avi"))}


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main() -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from v2e2v_tpu.data.manifests import VideoSequence
    from v2e2v_tpu.data.video_readers import VideoReader

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=Path(__file__).resolve().parents[1]
                    / "tests" / "data" / "video")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.out.exists():
        shutil.rmtree(args.out)
    args.out.mkdir(parents=True)
    clips = write_clips(args.out, np.random.default_rng(args.seed))
    manifest, arrays = {}, {}
    for name, read in clips.items():
        path = str(args.out / name)
        cap = cv2.VideoCapture(path)
        entry = {"fps": cap.get(cv2.CAP_PROP_FPS), "frame_count": cap.get(cv2.CAP_PROP_FRAME_COUNT),
                 "ported": read}
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
        if read:
            arrays[name.removesuffix(".avi")] = np.stack(reader.frames)
        manifest[name] = entry
    np.savez_compressed(args.out / "reader_frames.npz", **arrays)
    (args.out / "manifest.json").write_text(json.dumps(
        {"writer": "scripts/make_video_fixtures.py", "seed": args.seed, "cv2": cv2.__version__,
         "clips": manifest}, indent=1) + "\n")
    total = sum(p.stat().st_size for p in args.out.rglob("*") if p.is_file())
    print(f"{len(clips)} AVI files, reader_frames.npz and manifest.json under {args.out}: "
          f"{total} bytes")


if __name__ == "__main__":
    main()
