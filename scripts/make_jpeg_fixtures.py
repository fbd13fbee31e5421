#!/usr/bin/env python3
"""Write the JPEG fixtures of the port's decoder (``v2e2v_tpu_torch/utils/jpeg.py``)
and what ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` returns for each.

    python scripts/make_jpeg_fixtures.py [--out tests/data/jpeg] [--seed 0]

It needs cv2 (``cv2.imencode`` writes every file), so it runs where the JAX
package's dependencies are installed, not on the card's machine; the card
checks its decoder against the hashes this writes. From seeded numpy colour
scenes it writes:

- ``cases/*.jpg``: one file per encoder setting (the five sampling factors, a
  gray JPEG, restart intervals, optimised Huffman tables, quality 100 and 5,
  progressive, an odd size) and three with an Exif orientation (3, 6, 8) in
  an APP1 segment;
- ``sequence/sequence_0000000001/frames/``: 12 colour frames at 180x240 of a
  moving scene, 250 fps, with their ``timestamps.txt``: a frame folder the
  evaluation CLIs read;
- ``manifest.json``: each file's shape and the sha256 of the bytes of
  ``cv2.imread(path, 0)``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import shutil
import struct
from pathlib import Path

import cv2
import numpy as np

SEQUENCE_FRAMES, SEQUENCE_HW, FPS = 12, (180, 240), 250.0


def scene(rng: np.random.Generator, h: int, w: int, frames: int = 1) -> np.ndarray:
    """``[frames, h, w, 3]`` uint8 BGR: colour gradients, a drifting
    sinusoidal texture, three saturated discs that move a few pixels a frame,
    and mild noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    grad = [rng.uniform(40, 200) + rng.uniform(-60, 60) * xx / w + rng.uniform(-60, 60) * yy / h
            for _ in range(3)]
    kx, ky = rng.uniform(0.05, 0.4, 2)
    discs = [(rng.uniform(0, h), rng.uniform(0, w), rng.uniform(3, max(4, h / 4)),
              rng.uniform(-3, 3), rng.uniform(-3, 3), rng.choice([0, 255], 3))
             for _ in range(3)]
    out = np.empty((frames, h, w, 3), np.uint8)
    for t in range(frames):
        img = np.stack(grad, -1) + 30 * np.sin(kx * xx + ky * yy + 0.3 * t)[..., None]
        for cy, cx, r, vy, vx, colour in discs:
            img[(yy - cy - vy * t) ** 2 + (xx - cx - vx * t) ** 2 < r * r] = colour
        img += rng.normal(0, 4, img.shape)
        out[t] = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    return out


def exif_app1(orientation: int, order: str = "<") -> bytes:
    """An APP1 segment ``Exif\\0\\0`` + a TIFF header whose IFD0 holds the
    orientation tag (0x0112, SHORT, one value)."""
    tiff = ((b"II" if order == "<" else b"MM") + struct.pack(order + "HI", 42, 8)
            + struct.pack(order + "H", 1)
            + struct.pack(order + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(order + "I", 0))
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def with_segment(jpeg: bytes, segment: bytes) -> bytes:
    """``segment`` inserted after SOI and the APP0 segment that follows it."""
    pos = 2
    if jpeg[2:4] == b"\xff\xe0":
        pos = 4 + struct.unpack(">H", jpeg[4:6])[0]
    return jpeg[:pos] + segment + jpeg[pos:]


def encode(img: np.ndarray, params: list[int]) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, params)
    if not ok:
        raise RuntimeError(f"cv2.imencode failed with {params}")
    return buf.tobytes()


SF = {n: getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{n}") for n in (411, 420, 422, 440, 444)}
CASES = {  # name: (height, width, colour, cv2.imencode parameters, orientation)
    **{f"sampling_{n}": (48, 64, True, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, f], None)
       for n, f in SF.items()},
    "gray": (48, 64, False, [], None),
    "restart_2": (48, 64, True, [cv2.IMWRITE_JPEG_RST_INTERVAL, 2], None),
    "optimize": (48, 64, True, [cv2.IMWRITE_JPEG_OPTIMIZE, 1], None),
    "quality_100": (48, 64, True, [cv2.IMWRITE_JPEG_QUALITY, 100], None),
    "quality_5": (48, 64, True, [cv2.IMWRITE_JPEG_QUALITY, 5], None),
    "progressive": (48, 64, True, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1], None),
    "odd_181x243": (181, 243, True, [], None),
    **{f"exif_orientation_{o}": (37, 53, True, [], o) for o in (3, 6, 8)},
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=Path(__file__).resolve().parents[1]
                    / "tests" / "data" / "jpeg")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.out.exists():
        shutil.rmtree(args.out)
    (args.out / "cases").mkdir(parents=True)
    rng = np.random.default_rng(args.seed)
    files = {}
    for name, (h, w, colour, params, orientation) in CASES.items():
        img = scene(rng, h, w)[0]
        data = encode(img if colour else cv2.cvtColor(img, cv2.COLOR_BGR2GRAY), params)
        if orientation is not None:
            data = with_segment(data, exif_app1(orientation))
        files[f"cases/{name}.jpg"] = data
    frames = args.out / "sequence" / "sequence_0000000001" / "frames"
    frames.mkdir(parents=True)
    (frames / "timestamps.txt").write_text(
        "".join(f"{i} {i / FPS:.9f}\n" for i in range(SEQUENCE_FRAMES)))
    for i, img in enumerate(scene(rng, *SEQUENCE_HW, SEQUENCE_FRAMES)):
        files[f"sequence/sequence_0000000001/frames/frame_{i:010d}.jpg"] = encode(img, [])
    manifest = {}
    for rel, data in files.items():
        path = args.out / rel
        path.write_bytes(data)
        gray = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
        manifest[rel] = {"shape": list(gray.shape),
                         "sha256": hashlib.sha256(gray.tobytes()).hexdigest()}
    (args.out / "manifest.json").write_text(json.dumps(
        {"writer": "scripts/make_jpeg_fixtures.py", "seed": args.seed,
         "cv2": cv2.__version__, "files": manifest}, indent=1) + "\n")
    total = sum(p.stat().st_size for p in args.out.rglob("*") if p.is_file())
    print(f"{len(files)} JPEG files and manifest.json under {args.out}: {total} bytes")


if __name__ == "__main__":
    main()
