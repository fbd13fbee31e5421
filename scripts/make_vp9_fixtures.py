#!/usr/bin/env python3
"""Write the VP9 fixtures of the port's video path (``v2e2v_tpu_torch/utils/vp9*.py``,
``mkv.py``, ``video.py``) and what the JAX package's readers return for each.

    JAX_PLATFORMS=cpu python scripts/make_vp9_fixtures.py [--out tests/data/vp9] [--seed 0]

It needs cv2 built with FFmpeg and libvpx, and the JAX package, so it runs
where the JAX package's dependencies are installed, not on the card's
machine; the card checks the port against the hashes this writes. The clips
come from seeded numpy scenes (``make_mkv_fixtures.py``'s and
``make_mpeg4_fixtures.py``'s) through ``cv2.VideoWriter`` with the ``VP90``
fourcc (libvpx's VP9, FFmpeg's WebM and Matroska muxers):

- ``flagship.webm`` and ``flagship.mkv``: 12 frames at 960x720, 10 fps, a
  pan of 3 rows and -7 columns a frame with sensor noise (two tile columns;
  the golden frame refreshed at frame 6); the card's run builds its PNG
  twin from the reader's frames, as for the VP8 flagship;
- ``gop.webm``: 16 frames at 64x96 at 30 fps (a second key frame at 12);
- ``noise.webm``: 8 frames at 96x128 of noisy squares over a pan (every
  block size to 32x32, transform size and type, intra and inter mode);
- ``flat.webm``: 6 flat frames at 64x80;
- ``odd.webm``: 6 frames at 75x49 (swscale's general route, partial
  superblocks); ``portrait.webm``: 7 frames at 160x96;
- ``ntsc.webm``: 6 frames whose ``DefaultDuration`` and ``Duration`` say
  30000/1001 fps; ``wide.webm``: 4 frames at 1280x64 (four tile columns);

and ``manifest.json`` (cv2's version, each clip's fps, frame count, the sha256
of each cv2 frame, of each JAX ``VideoReader`` frame (``ds = (0.25, 0.25)``)
and of each JAX ``VideoSequence`` frame) and ``reader_frames.npz`` (the JAX
``VideoReader``'s frames of each clip but the flagship's twin).

The tests use this module's header tools: ``parse_header`` and
``write_header`` read and write a frame's uncompressed header field by
field (the compressed header and tiles kept as they are), ``rewrite``
applies changes to chosen frames of a clip, and ``superframe`` packs frames
into one packet with a superframe index.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import shutil
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

FLAGSHIP = (720, 960, 12, 10.0)  # height, width, frames, fps


# ------------------------------------------------------- header tools

class Bits:
    def __init__(self, data: bytes = b""):
        self.data, self.pos = data, 0
        self.out: list[int] = []

    def f(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | ((self.data[self.pos >> 3] >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def s(self, n: int) -> int:
        v = self.f(n)
        return -v if self.f(1) else v

    def put(self, n: int, v: int) -> None:
        self.out += [(v >> (n - 1 - i)) & 1 for i in range(n)]

    def sput(self, n: int, v: int) -> None:
        self.put(n, abs(v))
        self.put(1, int(v < 0))

    def bytes(self) -> bytes:
        bits = self.out + [0] * (-len(self.out) % 8)
        return bytes(int("".join(map(str, bits[i:i + 8])), 2) for i in range(0, len(bits), 8))


def _tile_bounds(width: int) -> tuple[int, int]:
    sb_cols = (width + 63) >> 6
    lo = 0
    while (64 << lo) < sb_cols:
        lo += 1
    hi = 0
    while (sb_cols >> hi) >= 4:
        hi += 1
    return lo, max(0, hi - 1)


def parse_header(frame: bytes, size: tuple[int, int] | None = None) -> tuple[dict, bytes]:
    """A frame's uncompressed header as a dict, and the bytes after it.
    ``size`` is the stream's (width, height), for inter frames whose size
    comes from a reference."""
    b = Bits(frame)
    h: dict = {}
    assert b.f(2) == 2
    h["profile"] = b.f(1) | (b.f(1) << 1)
    if h["profile"] == 3:
        h["reserved"] = b.f(1)
    h["show_existing"] = b.f(1)
    if h["show_existing"]:
        h["existing_idx"] = b.f(3)
        return h, frame[(b.pos + 7) >> 3:]
    h["key"] = 1 - b.f(1)
    h["show"] = b.f(1)
    h["error_res"] = b.f(1)
    if h["key"]:
        h["sync"] = b.f(24)
        h["color_space"] = b.f(3)
        h["color_range"] = b.f(1)
        h["width"], h["height"] = b.f(16) + 1, b.f(16) + 1
        h["render"] = (b.f(16), b.f(16)) if b.f(1) else None
    else:
        h["intra_only"] = b.f(1) if not h["show"] else 0
        h["reset_context"] = 0 if h["error_res"] else b.f(2)
        h["refresh"] = b.f(8)
        h["ref_idx"], h["sign_bias"] = [], []
        for _ in range(3):
            h["ref_idx"].append(b.f(3))
            h["sign_bias"].append(b.f(1))
        h["size_from_ref"] = None
        for i in range(3):
            if b.f(1):
                h["size_from_ref"] = i
                break
        if h["size_from_ref"] is None:
            h["width"], h["height"] = b.f(16) + 1, b.f(16) + 1
        else:
            h["width"], h["height"] = size
        h["render"] = (b.f(16), b.f(16)) if b.f(1) else None
        h["allow_hp"] = b.f(1)
        h["filter"] = "switchable" if b.f(1) else b.f(2)
    if not h["error_res"]:
        h["refresh_context"], h["parallel"] = b.f(1), b.f(1)
    h["context_idx"] = b.f(2)
    h["lf_level"], h["sharpness"] = b.f(6), b.f(3)
    h["lf_deltas"] = None
    if b.f(1):
        h["lf_deltas"] = {"update": b.f(1)}
        if h["lf_deltas"]["update"]:
            h["lf_deltas"]["ref"] = [b.s(6) if b.f(1) else None for _ in range(4)]
            h["lf_deltas"]["mode"] = [b.s(6) if b.f(1) else None for _ in range(2)]
    h["base_q"] = b.f(8)
    h["dq"] = [b.s(4) if b.f(1) else None for _ in range(3)]
    h["seg"] = None
    if b.f(1):
        seg = h["seg"] = {"update_map": b.f(1)}
        if seg["update_map"]:
            seg["tree_probs"] = [b.f(8) if b.f(1) else None for _ in range(7)]
            seg["temporal"] = b.f(1)
            if seg["temporal"]:
                seg["pred_probs"] = [b.f(8) if b.f(1) else None for _ in range(3)]
        seg["update_data"] = b.f(1)
        if seg["update_data"]:
            seg["abs"] = b.f(1)
            seg["features"] = []
            for _ in range(8):
                q = b.s(8) if b.f(1) else None
                lf = b.s(6) if b.f(1) else None
                ref = b.f(2) if b.f(1) else None
                seg["features"].append([q, lf, ref, b.f(1)])
    lo, hi = _tile_bounds(h["width"])
    h["tile_cols_log2"] = lo
    while h["tile_cols_log2"] < hi and b.f(1):
        h["tile_cols_log2"] += 1
    h["tile_rows_log2"] = b.f(1)
    if h["tile_rows_log2"]:
        h["tile_rows_log2"] += b.f(1)
    h["compressed_size"] = b.f(16)
    return h, frame[(b.pos + 7) >> 3:]


def write_header(h: dict) -> bytes:
    """``parse_header``'s inverse (the bytes of the uncompressed header)."""
    b = Bits()
    b.put(2, 2)
    b.put(1, h["profile"] & 1)
    b.put(1, h["profile"] >> 1)
    if h["profile"] == 3:
        b.put(1, h.get("reserved", 0))
    b.put(1, h["show_existing"])
    if h["show_existing"]:
        b.put(3, h["existing_idx"])
        return b.bytes()
    b.put(1, 1 - h["key"])
    b.put(1, h["show"])
    b.put(1, h["error_res"])
    if h["key"]:
        b.put(24, h.get("sync", 0x498342))
        b.put(3, h["color_space"])
        b.put(1, h["color_range"])
        b.put(16, h["width"] - 1)
        b.put(16, h["height"] - 1)
    else:
        if not h["show"]:
            b.put(1, h["intra_only"])
        if not h["error_res"]:
            b.put(2, h["reset_context"])
        b.put(8, h["refresh"])
        for i in range(3):
            b.put(3, h["ref_idx"][i])
            b.put(1, h["sign_bias"][i])
        for i in range(3):
            if h["size_from_ref"] == i:
                b.put(1, 1)
                break
            b.put(1, 0)
        else:
            b.put(16, h["width"] - 1)
            b.put(16, h["height"] - 1)
    b.put(1, h["render"] is not None)
    if h["render"] is not None:
        b.put(16, h["render"][0])
        b.put(16, h["render"][1])
    if not h["key"]:
        b.put(1, h["allow_hp"])
        b.put(1, h["filter"] == "switchable")
        if h["filter"] != "switchable":
            b.put(2, h["filter"])
    if not h["error_res"]:
        b.put(1, h["refresh_context"])
        b.put(1, h["parallel"])
    b.put(2, h["context_idx"])
    b.put(6, h["lf_level"])
    b.put(3, h["sharpness"])
    d = h["lf_deltas"]
    b.put(1, d is not None)
    if d is not None:
        b.put(1, d["update"])
        if d["update"]:
            for v in list(d["ref"]) + list(d["mode"]):
                b.put(1, v is not None)
                if v is not None:
                    b.sput(6, v)
    b.put(8, h["base_q"])
    for v in h["dq"]:
        b.put(1, v is not None)
        if v is not None:
            b.sput(4, v)
    seg = h["seg"]
    b.put(1, seg is not None)
    if seg is not None:
        b.put(1, seg["update_map"])
        if seg["update_map"]:
            for p in seg["tree_probs"]:
                b.put(1, p is not None)
                if p is not None:
                    b.put(8, p)
            b.put(1, seg["temporal"])
            if seg["temporal"]:
                for p in seg["pred_probs"]:
                    b.put(1, p is not None)
                    if p is not None:
                        b.put(8, p)
        b.put(1, seg["update_data"])
        if seg["update_data"]:
            b.put(1, seg["abs"])
            for q, lf, ref, skip in seg["features"]:
                for n, v, signed in ((8, q, True), (6, lf, True), (2, ref, False)):
                    b.put(1, v is not None)
                    if v is not None:
                        (b.sput if signed else b.put)(n, v)
                b.put(1, skip)
    lo, hi = _tile_bounds(h["width"])
    for _ in range(h["tile_cols_log2"] - lo):
        b.put(1, 1)
    if h["tile_cols_log2"] < hi:
        b.put(1, 0)
    b.put(1, h["tile_rows_log2"] > 0)
    if h["tile_rows_log2"]:
        b.put(1, h["tile_rows_log2"] > 1)
    b.put(16, h["compressed_size"])
    return b.bytes()


def split_packets(packets: list[bytes]) -> list[bytes]:
    """Each frame of each packet (superframes split)."""
    from v2e2v_tpu_torch.utils.vp9 import superframe_split
    return [p[s:e] for p in packets for s, e in superframe_split(p)]


def rewrite(packets: list[bytes], change, size: tuple[int, int]) -> list[bytes]:
    """Each frame's header passed through ``change(index, header)`` (which
    edits the dict in place, or returns a list of frames to put in its place,
    each a header dict or a (header, rest) pair) and written back."""
    out = []
    for i, frame in enumerate(split_packets(packets)):
        h, rest = parse_header(frame, size)
        got = change(i, h)
        if got is None:
            out.append(write_header(h) + rest)
        else:
            for item in got:
                if isinstance(item, tuple):
                    out.append(write_header(item[0]) + item[1])
                else:
                    out.append(write_header(item) + (rest if not item["show_existing"] else b""))
    return out


def superframe(frames: list[bytes]) -> bytes:
    """Frames packed into one packet with a superframe index (4-byte sizes)."""
    marker = 0xC0 | (3 << 3) | (len(frames) - 1)
    index = bytes([marker]) + b"".join(len(f).to_bytes(4, "little") for f in frames)
    return b"".join(frames) + index + bytes([marker])


def show_existing(idx: int) -> bytes:
    return write_header({"profile": 0, "show_existing": 1, "existing_idx": idx})


# ----------------------------------------------------------------- clips

def noise_frames(rng: np.random.Generator, h: int, w: int, n: int) -> np.ndarray:
    """A pan with noisy squares of 4 to 32 pixels and sensor noise: every
    block size, transform size and type and intra mode in a few frames."""
    from make_mpeg4_fixtures import pan

    fr = pan(rng, h, w, n, (2, 3)).astype(np.int16)
    for k in range(n):
        for _ in range(6):
            y, x = rng.integers(0, h - 8), rng.integers(0, w - 8)
            s = int(rng.choice([4, 8, 16, 32]))
            fr[k, y:y + s, x:x + s] = rng.integers(0, 256, (min(s, h - y), min(s, w - x), 3))
        fr[k] += rng.normal(0, 10, fr[k].shape).astype(np.int16)
    return np.clip(fr, 0, 255).astype(np.uint8)


def patch_size(d: bytes, width: int, height: int) -> bytes:
    """A WebM of cv2's (which writes even sizes only) with its key frames'
    size and the track's ``PixelWidth``/``PixelHeight`` set to an odd size of
    the same 8x8 grid: the headers keep their length, the frames are patched
    in place."""
    from make_mkv_fixtures import set_uint, vp8_frames

    out = bytearray(d)
    for start, end in vp8_frames(d):
        h, rest = parse_header(d[start:end], (width, height))
        if not h.get("key"):
            continue
        h["width"], h["height"] = width, height
        new = write_header(h) + rest
        assert len(new) == end - start
        out[start:end] = new
    return set_uint(set_uint(bytes(out), 0xB0, width), 0xBA, height)


def write_clips(out: Path, rng: np.random.Generator) -> dict[str, str]:
    """Every clip; the value names the frames' key in ``reader_frames.npz``."""
    from make_mkv_fixtures import set_float, set_uint
    from make_mpeg4_fixtures import pan, write

    h, w, n, fps = FLAGSHIP
    frames = pan(rng, h, w, n, (3, -7)).astype(np.int16)
    frames = np.clip(frames + rng.normal(0, 1.2, frames.shape), 0, 255).astype(np.uint8)
    clips = {}
    for name in ("flagship.webm", "flagship.mkv"):
        write(out / name, frames, fps, "VP90")
        clips[name] = "flagship"
    write(out / "gop.webm", pan(rng, 64, 96, 16, (1, 2)), 30.0, "VP90")
    # its own generator: seed 1 is the first whose clip reaches every block
    # size, transform size and type and intra mode (the tests assert it)
    write(out / "noise.webm", noise_frames(np.random.default_rng(1), 96, 128, 8), 10.0, "VP90")
    write(out / "flat.webm", np.full((6, 64, 80, 3), (40, 120, 200), np.uint8), 10.0, "VP90")
    write(out / "odd.webm", pan(rng, 50, 76, 6, (1, -2)), 10.0, "VP90")
    (out / "odd.webm").write_bytes(patch_size((out / "odd.webm").read_bytes(), 75, 49))
    write(out / "portrait.webm", pan(rng, 160, 96, 7, (2, 1)), 10.0, "VP90")
    write(out / "ntsc.webm", pan(rng, 64, 80, 6, (1, -1)), 30.0, "VP90")
    d = (out / "ntsc.webm").read_bytes()
    (out / "ntsc.webm").write_bytes(set_float(set_uint(d, 0x23E383, 33366667), 0x4489, 200.2))
    write(out / "wide.webm", pan(rng, 64, 1280, 4, (1, 3)), 10.0, "VP90")
    for name in ("gop.webm", "noise.webm", "flat.webm", "odd.webm", "portrait.webm",
                 "ntsc.webm", "wide.webm"):
        clips[name] = name.rsplit(".", 1)[0]
    return clips


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def cv2_frames(path: Path, one_thread: bool = True) -> tuple[list, float, float]:
    """cv2's BGR frames (one decoding thread, as the tests read cv2), fps and
    frame count."""
    import cv2

    cap = (cv2.VideoCapture(str(path), cv2.CAP_FFMPEG, [cv2.CAP_PROP_N_THREADS, 1])
           if one_thread else cv2.VideoCapture(str(path)))
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    fps, count = cap.get(cv2.CAP_PROP_FPS), cap.get(cv2.CAP_PROP_FRAME_COUNT)
    cap.release()
    return out, fps, count


def main() -> None:
    import cv2

    from v2e2v_tpu.data.manifests import VideoSequence
    from v2e2v_tpu.data.video_readers import VideoReader

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=ROOT / "tests" / "data" / "vp9")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.out.exists():
        shutil.rmtree(args.out)
    args.out.mkdir(parents=True)
    clips = write_clips(args.out, np.random.default_rng(args.seed))
    manifest, arrays = {}, {}
    for name, key in clips.items():
        path = args.out / name
        frames, fps, count = cv2_frames(path)
        threaded, _, _ = cv2_frames(path, one_thread=False)
        assert [sha(f) for f in threaded] == [sha(f) for f in frames], name
        entry = {"fps": fps, "frame_count": count, "frames": key, "codec": "vp9",
                 "cv2_sha256": [sha(f) for f in frames]}
        reader = VideoReader(FLAGSHIP[:2], ds=(0.25, 0.25))
        reader.initialize(str(path))
        pairs = list(VideoSequence(str(path)))
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
        {"writer": "scripts/make_vp9_fixtures.py", "seed": args.seed, "cv2": cv2.__version__,
         "clips": manifest}, indent=1) + "\n")
    total = sum(p.stat().st_size for p in args.out.rglob("*") if p.is_file())
    print(f"{len(clips)} clips, reader_frames.npz and manifest.json under {args.out}: "
          f"{total} bytes")


if __name__ == "__main__":
    main()
