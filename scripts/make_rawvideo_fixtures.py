#!/usr/bin/env python3
"""Write the fixtures of the port's raw and PNG video path and of the other
tags and containers of its decoders (``v2e2v_tpu_torch/utils/rawvideo.py``,
the tag tables of ``avi.py``, ``mp4.py`` and ``mkv.py``, ``video.py``) and
what the JAX package's readers return for each.

    JAX_PLATFORMS=cpu python scripts/make_rawvideo_fixtures.py [--out tests/data] [--seed 0]

It needs cv2 built with FFmpeg and the JAX package, so it runs where the JAX
package's dependencies are installed, not on the card's machine; the card
checks the port against the records this writes. It writes two folders.

``rawvideo/``: clips of the decoders the port has under the other tags and
containers cv2 writes them into (``cv2.VideoWriter``, 6 frames of a scene at
96x64, 10 fps): ``cjpg.avi``, ``ljpg.avi``, ``jpgl.avi``, ``mjpa.avi``
(MJPEG), ``mp4s.avi``, ``m4s2.avi`` (MPEG-4 Part 2), ``vp80.avi``,
``vp90.avi``, ``jpeg.mov`` and ``mjpa.mov`` (MJPEG), ``xvid.mov`` and
``divx.mov`` (MPEG-4 with a ``glbl`` box), ``mjpg.mp4`` (MJPEG as ``mp4v``
of object type 0x6C) and ``vp09.mp4``; raw clips cv2 writes (3 frames):
``i420.avi``, ``iyuv.avi``, ``yv12.avi``, ``y800.avi``, ``grey.avi``,
``rgba.avi``, ``rgba.mov``, ``i420.mkv``, ``yv12.mkv``, ``y800.mkv`` and
``rgba.mkv`` at 96x64, and ``y800_w130.avi`` and ``y800_w130.mkv`` at 130x48
(cv2 stores 4:2:0-sized packets under Y800, which FFmpeg reads at a row
stride rounded up to 4); and raw AVIs written here byte by byte
(``write_avi``), 2-3 frames of noise each: ``i420_odd.avi`` (37x23),
``yv12_odd.avi`` (21x9), ``i420_5x7.avi``, ``rgba_odd.avi`` (13x7),
``y800_w60.avi`` to ``y800_w63.avi`` (each residue of the width mod 4, at
17 rows, with 4:2:0-sized packets), ``grey_exact_w62.avi`` (packets of
exactly W x H bytes, read at the width), ``i420_short.avi`` (the fourth
of four packets one byte short: cv2 reads three frames), ``i420_long.avi``
(packets 100 bytes long) and ``i420_dropped.avi`` (an empty chunk, which
the demuxer skips).

``pngvideo/``: ``flagship.avi``, 12 frames of PNG video (MPNG) at 960x720,
10 fps, a pan of 3 rows and -7 columns a frame over a scene posterized to
steps of 16 (so the 12 frames stay under 0.5 MB: FFmpeg's PNG encoder
filters every row with Paeth); ``mpng.avi``, ``png.mov``, ``png.mp4``
(``mp4v`` of object type 0x6D), ``mpng.mkv`` and ``png1.mkv``
(``V_MS/VFW/FOURCC``), 5 frames at 96x64 by ``cv2.VideoWriter``; and
``types.avi``, written here: one frame of each PNG colour type and depth
up to 8 bits (gray at 1, 2, 4 and 8 bits, RGB, palette at 4 and 8 bits,
gray + alpha, RGBA) at 11x6.

Each folder's ``manifest.json`` holds cv2's version and, for each clip, its
codec, fps and frame count as cv2 reports them, the sha256 of each cv2 BGR
frame (one decoding thread) and of its ``cvtColor`` gray, of each JAX ``VideoReader`` frame (``ds =
(0.25, 0.25)``) and of each JAX ``VideoSequence`` frame; ``reader_frames.npz``
the JAX ``VideoReader``'s frames of each clip.

``write_avi`` and ``png_bytes`` need no cv2: ``chip_smoke.py`` writes its
960x720 raw clips at run time with ``write_avi``, and the tests craft files
with both.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import shutil
import struct
import sys
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
FLAGSHIP = (720, 960, 12, 10.0)  # height, width, frames, fps
POSTERIZE = 16
SIZE = (64, 96)  # the small clips' height, width
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


# ------------------------------------------------------------- writers

def _chunk(fcc: bytes, body: bytes) -> bytes:
    return fcc + struct.pack("<I", len(body)) + body + (b"\0" if len(body) & 1 else b"")


def write_avi(path: Path, chunks: list[bytes], width: int, height: int, fps: int,
              fourcc: bytes, bits: int = 12, extradata: bytes = b"") -> None:
    """An AVI of one video stream: ``chunks`` as '00dc' chunks (b'' an empty
    one), ``biCompression`` ``fourcc``, ``biBitCount`` ``bits``, ``fps``
    frames a second, ``extradata`` after the BITMAPINFOHEADER, and an
    ``idx1`` index."""
    n = len(chunks)
    avih = struct.pack("<14I", 1000000 // fps, 0, 0, 0x10, n, 0, 1, 0, width, height, 0, 0, 0, 0)
    strh = b"vids" + fourcc + struct.pack("<IHHIIIIIIIIhhhh", 0, 0, 0, 0, 1, fps, 0, n, 0,
                                          0xFFFFFFFF, 0, 0, 0, width, height)
    strf = struct.pack("<IiiHH4sIiiII", 40 + len(extradata), width, height, 1, bits, fourcc,
                       width * height * bits // 8, 0, 0, 0, 0) + extradata
    hdrl = _chunk(b"avih", avih) + _chunk(b"LIST", b"strl" + _chunk(b"strh", strh)
                                          + _chunk(b"strf", strf))
    movi, idx1 = bytearray(b"movi"), bytearray()
    for data in chunks:
        idx1 += b"00dc" + struct.pack("<III", 0x10, len(movi), len(data))
        movi += _chunk(b"00dc", data)
    body = (b"AVI " + _chunk(b"LIST", b"hdrl" + hdrl) + _chunk(b"LIST", bytes(movi))
            + _chunk(b"idx1", bytes(idx1)))
    path.write_bytes(_chunk(b"RIFF", body))


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def png_bytes(samples: np.ndarray, color: int, depth: int = 8,
              palette: np.ndarray | None = None) -> bytes:
    """``[H, W, channels]`` samples (each below ``2 ** depth``) -> a PNG of
    colour type ``color`` at ``depth`` bits (sub-byte samples packed, most
    significant first), filter None on every row."""
    h, w = samples.shape[:2]
    if depth < 8:
        per = 8 // depth
        s = np.zeros((h, -(-w // per) * per), np.uint8)
        s[:, :w] = samples.reshape(h, w)
        s = s.reshape(h, -1, per)
        rows = np.zeros(s.shape[:2], np.uint8)
        for k in range(per):
            rows |= s[:, :, k] << (8 - depth * (k + 1))
    else:
        rows = samples.astype(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()
    out = PNG_SIGNATURE + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
    if palette is not None:
        out += _png_chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return out + _png_chunk(b"IDAT", zlib.compress(raw)) + _png_chunk(b"IEND", b"")


def yuv420_packet(rng: np.random.Generator, width: int, height: int) -> bytes:
    """A 4:2:0 packet of noise: Y, then two chroma planes of
    ``ceil(W / 2) x ceil(H / 2)``."""
    n = width * height + 2 * ((width + 1) // 2) * ((height + 1) // 2)
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def png_types(rng: np.random.Generator, h: int = 6, w: int = 11) -> list[bytes]:
    """One PNG of each colour type and depth up to 8 bits."""
    palette = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    frames = [png_bytes(rng.integers(0, 1 << d, (h, w, 1), dtype=np.uint8), 0, d)
              for d in (1, 2, 4, 8)]
    frames += [png_bytes(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), 2),
               png_bytes(rng.integers(0, 16, (h, w, 1), dtype=np.uint8), 3, 4, palette),
               png_bytes(rng.integers(0, 16, (h, w, 1), dtype=np.uint8), 3, 8, palette),
               png_bytes(rng.integers(0, 256, (h, w, 2), dtype=np.uint8), 4),
               png_bytes(rng.integers(0, 256, (h, w, 4), dtype=np.uint8), 6)]
    return frames


# --------------------------------------------------------------- clips

def writer(path: Path, frames: np.ndarray, fps: float, fourcc: str) -> None:
    """``frames`` through ``cv2.VideoWriter`` with ``fourcc``."""
    import cv2

    h, w = frames.shape[1:3]
    vw = cv2.VideoWriter(str(path), cv2.CAP_FFMPEG, cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    if not vw.isOpened():
        raise RuntimeError(f"cv2.VideoWriter cannot write {fourcc} into {path.suffix} here")
    for f in frames:
        vw.write(f)
    vw.release()


def raw_clips(out: Path, rng: np.random.Generator) -> dict[str, str]:
    """Every clip of ``rawvideo/``; the value is its codec."""
    sys.path.insert(0, str(ROOT / "scripts"))
    from make_mpeg4_fixtures import pan

    h, w = SIZE
    clips = {}
    tags = {"cjpg.avi": ("CJPG", "mjpeg"), "ljpg.avi": ("LJPG", "mjpeg"),
            "jpgl.avi": ("JPGL", "mjpeg"), "mjpa.avi": ("mjpa", "mjpeg"),
            "mp4s.avi": ("MP4S", "mpeg4"), "m4s2.avi": ("M4S2", "mpeg4"),
            "vp80.avi": ("VP80", "vp8"), "vp90.avi": ("VP90", "vp9"),
            "jpeg.mov": ("jpeg", "mjpeg"), "mjpa.mov": ("mjpa", "mjpeg"),
            "xvid.mov": ("XVID", "mpeg4"), "divx.mov": ("DIVX", "mpeg4"),
            "mjpg.mp4": ("MJPG", "mjpeg"), "vp09.mp4": ("vp09", "vp9")}
    for name, (fourcc, codec) in tags.items():
        writer(out / name, pan(rng, h, w, 6, (1, -2)), 10.0, fourcc)
        clips[name] = codec
    for name in ("i420.avi", "iyuv.avi", "yv12.avi", "y800.avi", "grey.avi", "rgba.avi",
                 "rgba.mov", "i420.mkv", "yv12.mkv", "y800.mkv", "rgba.mkv"):
        writer(out / name, pan(rng, h, w, 3, (1, 2)), 10.0, name[:4].upper())
        clips[name] = "raw"
    for ext in (".avi", ".mkv"):
        writer(out / f"y800_w130{ext}", pan(rng, 48, 130, 3, (1, 1)), 10.0, "Y800")
        clips[f"y800_w130{ext}"] = "raw"
    crafted = {
        "i420_odd.avi": (b"I420", 37, 23, [yuv420_packet(rng, 37, 23) for _ in range(3)]),
        "yv12_odd.avi": (b"YV12", 21, 9, [yuv420_packet(rng, 21, 9) for _ in range(3)]),
        "i420_5x7.avi": (b"I420", 5, 7, [yuv420_packet(rng, 5, 7) for _ in range(3)]),
        "rgba_odd.avi": (b"RGBA", 13, 7, [rng.integers(0, 256, 13 * 7 * 4, dtype=np.uint8)
                                          .tobytes() for _ in range(3)]),
        "grey_exact_w62.avi": (b"GREY", 62, 17, [rng.integers(0, 256, 62 * 17, dtype=np.uint8)
                                                 .tobytes() for _ in range(2)]),
        "i420_long.avi": (b"I420", 24, 10, [yuv420_packet(rng, 24, 10) + bytes(100)
                                            for _ in range(2)]),
        "i420_dropped.avi": (b"I420", 24, 10, [yuv420_packet(rng, 24, 10), b"",
                                               yuv420_packet(rng, 24, 10),
                                               yuv420_packet(rng, 24, 10)]),
    }
    short = [yuv420_packet(rng, 24, 10) for _ in range(4)]
    short[3] = short[3][:-1]
    crafted["i420_short.avi"] = (b"I420", 24, 10, short)
    for width in (60, 61, 62, 63):
        crafted[f"y800_w{width}.avi"] = (b"Y800", width, 17, [yuv420_packet(rng, width, 17)
                                                              for _ in range(2)])
    for name, (fourcc, cw, ch, chunks) in crafted.items():
        bits = 32 if fourcc == b"RGBA" else 8 if fourcc in (b"Y800", b"GREY") else 12
        write_avi(out / name, chunks, cw, ch, 30, fourcc, bits)
        clips[name] = "raw"
    return clips


def png_clips(out: Path, rng: np.random.Generator) -> dict[str, str]:
    """Every clip of ``pngvideo/``; the value is its codec."""
    sys.path.insert(0, str(ROOT / "scripts"))
    from make_mpeg4_fixtures import pan

    fh, fw, n, fps = FLAGSHIP
    frames = pan(rng, fh, fw, n, (3, -7))
    writer(out / "flagship.avi", frames // POSTERIZE * POSTERIZE + POSTERIZE // 2, fps, "MPNG")
    h, w = SIZE
    for name, fourcc in (("mpng.avi", "MPNG"), ("png.mov", "png "), ("png.mp4", "MPNG"),
                         ("mpng.mkv", "MPNG"), ("png1.mkv", "PNG1")):
        writer(out / name, pan(rng, h, w, 5, (1, -1)), 10.0, fourcc)
    write_avi(out / "types.avi", png_types(rng), 11, 6, 30, b"MPNG", 24)
    return {p.name: "png" for p in sorted(out.iterdir())}


# ------------------------------------------------------------- records

def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def cv2_frames(path: Path) -> tuple[list, float, float]:
    """cv2's BGR frames (one decoding thread), fps and frame count."""
    import cv2

    cap = cv2.VideoCapture(str(path), cv2.CAP_FFMPEG, [cv2.CAP_PROP_N_THREADS, 1])
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    fps, count = cap.get(cv2.CAP_PROP_FPS), cap.get(cv2.CAP_PROP_FRAME_COUNT)
    cap.release()
    return out, fps, count


def records(folder: Path, clips: dict[str, str], seed: int,
            writer: str = "scripts/make_rawvideo_fixtures.py") -> None:
    """``manifest.json`` and ``reader_frames.npz`` of ``folder``'s clips,
    written by the script ``writer``."""
    import cv2

    from v2e2v_tpu.data.manifests import VideoSequence
    from v2e2v_tpu.data.video_readers import VideoReader

    manifest, arrays = {}, {}
    for name, codec in clips.items():
        path = folder / name
        frames, fps, count = cv2_frames(path)
        entry = {"fps": fps, "frame_count": count, "codec": codec,
                 "cv2_sha256": [sha(f) for f in frames],
                 "gray_sha256": [sha(cv2.cvtColor(f, cv2.COLOR_BGR2GRAY)) for f in frames]}
        reader = VideoReader(FLAGSHIP[:2], ds=(0.25, 0.25))
        reader.initialize(str(path))
        pairs = list(VideoSequence(str(path)))
        full = [p[0] for p in pairs[:1]] + [p[1] for p in pairs]
        entry.update(frames_read=reader.num_frames, shape=list(full[0].shape),
                     reader_shape=list(reader.frames[0].shape),
                     timestamps=[float(t) for t in reader.timestamps],
                     reader_sha256=[sha(f) for f in reader.frames],
                     sequence_sha256=[sha(f) for f in full])
        key = entry["frames"] = name.replace(".", "_")
        arrays[key] = np.stack(reader.frames)
        manifest[name] = entry
    np.savez_compressed(folder / "reader_frames.npz", **arrays)
    (folder / "manifest.json").write_text(json.dumps(
        {"writer": writer, "seed": seed, "cv2": cv2.__version__,
         "clips": manifest}, indent=1) + "\n")
    total = sum(p.stat().st_size for p in folder.rglob("*") if p.is_file())
    print(f"{len(clips)} clips, reader_frames.npz and manifest.json under {folder}: "
          f"{total} bytes")


def main() -> None:
    sys.path.insert(0, str(ROOT))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=ROOT / "tests" / "data")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    for name, make in (("rawvideo", raw_clips), ("pngvideo", png_clips)):
        folder = args.out / name
        if folder.exists():
            shutil.rmtree(folder)
        folder.mkdir(parents=True)
        records(folder, make(folder, rng), args.seed)


if __name__ == "__main__":
    main()
