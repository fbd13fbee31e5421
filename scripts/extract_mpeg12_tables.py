#!/usr/bin/env python3
"""Write ``v2e2v_tpu_torch/utils/mpeg12tables.py``: the tables an MPEG-1 /
MPEG-2 video decoder needs, cut out of the FFmpeg library that
``opencv-python`` bundles (``libavcodec``'s ``mpeg12data.c``, ``mpeg12.c``,
``mpeg12dec.c``, ``mathtables.c`` and ``mpegvideodata.c``: what cv2's
``mpeg1video`` and ``mpeg2video`` decoders read).

    python scripts/extract_mpeg12_tables.py [--libs DIR] [--out v2e2v_tpu_torch/utils/mpeg12tables.py]

``DIR`` defaults to the ``opencv_python.libs`` folder beside the installed
``cv2``. Each table is found by its first entries (ISO/IEC 13818-2 Annex B's
and clause 7's, as FFmpeg lays them out) and read to its full length from
the library. A prefix must occur exactly once in the library, or, where
FFmpeg keeps a table of the same start for another codec (H.263's motion
codes, the VC-1 and MPEG-4 copies of the run and level tables), exactly
once within 16 KiB of the macroblock address increment table, which is
unique; else the script stops. The tables:

- ``MB_ADDR_INCR`` (code, length) of increments 1-33, the escape (+33),
  MPEG-1's stuffing and the end marker of eight zeros;
- ``MB_PTYPE`` and ``MB_BTYPE``: (code, length) of P- and B-picture
  macroblock types, in FFmpeg's order; ``PTYPE_FLAGS`` and ``BTYPE_FLAGS``
  name each entry's flags (table B-3 and B-4; ``MB_*`` below). I-picture
  types ('1' intra, '01' intra + quant) and MPEG-1 D-pictures ('1') are
  two codes FFmpeg reads as bits, written here as ``MB_ITYPE``;
- ``CBP``: (code, length) of ``coded_block_pattern`` 0-63 (B-9);
- ``MOTION``: (code, length) of ``motion_code`` 0-16 (B-10, sign apart);
- ``DC_LUMA`` and ``DC_CHROMA``: (code, length) of ``dct_dc_size`` 0-11;
- ``DCT_B14`` and ``DCT_B15``: (code, length) of the 111 run/level
  entries, then the escape, then the end of block (B-14, B-15);
  ``DCT_RUN`` and ``DCT_LEVEL`` their runs and levels;
- ``INTRA_MATRIX`` and ``NON_INTRA_MATRIX``: the default matrices, in
  raster order;
- ``ZIGZAG`` and ``ALTERNATE``: the two scans (scan index -> raster
  position);
- ``NON_LINEAR_QSCALE``: MPEG-2's ``quantiser_scale`` for
  ``q_scale_type`` 1 (table 7-6);
- ``FRAME_RATE``: (numerator, denominator) of ``frame_rate_code`` 0-15
  (codes 9-13 are FFmpeg's Xing and libmpeg3 rates).

The generated module holds plain literals and the sha256 of each table's
bytes; ``tests/test_torch_mpeg12.py`` checks both and each table's
invariants. Nothing is downloaded.
"""

from __future__ import annotations

import argparse
import hashlib
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "v2e2v_tpu_torch" / "utils" / "mpeg12tables.py"
WINDOW = 16384

# name -> (dtype, shape, the first entries, flattened)
PREFIXES = {
    "MB_ADDR_INCR": ("u1", (36, 2), [1, 1, 3, 3, 2, 3, 3, 4, 2, 4, 3, 5, 2, 5]),
    "MB_PTYPE": ("u1", (7, 2), [3, 5, 1, 2, 1, 3, 1, 1, 1, 6, 1, 5, 2, 5]),
    "MB_BTYPE": ("u1", (11, 2), [3, 5, 2, 3, 3, 3, 2, 4, 3, 4, 2, 2, 3, 2]),
    "CBP": ("u1", (64, 2), [1, 9, 11, 5, 9, 5, 13, 6, 13, 4]),
    "MOTION": ("u1", (17, 2), [1, 1, 1, 2, 1, 3, 1, 4, 3, 6, 5, 7, 4, 7, 3, 7, 11, 9]),
    "DC_LUMA_CODE": ("<u2", (12,), [4, 0, 1, 5, 6, 14, 30, 62]),
    "DC_LUMA_BITS": ("u1", (12,), [3, 2, 2, 3, 3, 4, 5, 6, 7, 8]),
    "DC_CHROMA_CODE": ("<u2", (12,), [0, 1, 2, 6, 14, 30, 62, 126]),
    "DC_CHROMA_BITS": ("u1", (12,), [2, 2, 2, 3, 4, 5, 6, 7, 8, 9]),
    "DCT_B14": ("<u2", (113, 2), [3, 2, 4, 4, 5, 5, 6, 7]),
    "DCT_B15": ("<u2", (113, 2), [2, 2, 6, 3, 7, 4, 28, 5]),
    "DCT_RUN": ("u1", (111,), [0] * 40 + [1] * 18),
    "DCT_LEVEL": ("u1", (111,), list(range(1, 41)) + [1, 2, 3]),
    "INTRA_MATRIX": ("<u2", (64,), [8, 16, 19, 22, 26, 27, 29, 34]),
    "NON_INTRA_MATRIX": ("<u2", (64,), [16] * 64),
    "ZIGZAG": ("u1", (64,), [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5]),
    "ALTERNATE": ("u1", (64,), [0, 8, 16, 24, 1, 9, 2, 10, 17, 25, 32, 40, 48, 56, 57, 49]),
    "NON_LINEAR_QSCALE": ("u1", (32,), [0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 18, 20, 22,
                                        24, 28]),
    "FRAME_RATE": ("<i4", (16, 2), [0, 0, 24000, 1001, 24, 1, 25, 1, 30000, 1001, 30, 1]),
}

# macroblock_type flags, as FFmpeg's MB_TYPE_* bits name them
FLAGS = """
MB_INTRA = 1  # macroblock_intra
MB_PATTERN = 2  # macroblock_pattern: a coded_block_pattern follows
MB_BACKWARD = 4  # macroblock_motion_backward
MB_FORWARD = 8  # macroblock_motion_forward
MB_QUANT = 16  # macroblock_quant: a quantiser_scale_code follows
MB_ZERO_MV = 32  # a P-picture's coded macroblock with no motion: forward at vector 0

# (code, length) of an I-picture's two types ('1', '01') and their flags;
# an MPEG-1 D-picture's one type is '1', intra
MB_ITYPE = ((1, 1), (1, 2))
ITYPE_FLAGS = (MB_INTRA, MB_INTRA | MB_QUANT)
# MB_PTYPE's and MB_BTYPE's entries' flags (tables B-3 and B-4)
PTYPE_FLAGS = (MB_INTRA, MB_PATTERN | MB_ZERO_MV | MB_FORWARD, MB_FORWARD,
               MB_FORWARD | MB_PATTERN, MB_QUANT | MB_INTRA,
               MB_QUANT | MB_PATTERN | MB_ZERO_MV | MB_FORWARD,
               MB_QUANT | MB_FORWARD | MB_PATTERN)
BTYPE_FLAGS = (MB_INTRA, MB_BACKWARD, MB_BACKWARD | MB_PATTERN, MB_FORWARD,
               MB_FORWARD | MB_PATTERN, MB_FORWARD | MB_BACKWARD,
               MB_FORWARD | MB_BACKWARD | MB_PATTERN, MB_QUANT | MB_INTRA,
               MB_QUANT | MB_BACKWARD | MB_PATTERN, MB_QUANT | MB_FORWARD | MB_PATTERN,
               MB_QUANT | MB_FORWARD | MB_BACKWARD | MB_PATTERN)
ADDR_ESCAPE, ADDR_STUFFING, ADDR_END = 33, 34, 35  # MB_ADDR_INCR's last three entries
DCT_ESCAPE, DCT_EOB = 111, 112  # DCT_B14's and DCT_B15's last two entries
"""


def _lib(folder: Path) -> Path:
    avc = sorted(folder.glob("libavcodec-*.so*"))
    if len(avc) != 1:
        raise SystemExit(f"{folder}: want one libavcodec-*.so")
    return avc[0]


def _hits(data: bytes, needle: bytes) -> list[int]:
    out, k = [], data.find(needle)
    while k >= 0:
        out.append(k)
        k = data.find(needle, k + 1)
    return out


def extract(data: bytes) -> dict[str, np.ndarray]:
    anchor = None
    tables = {}
    for name, (dtype, shape, prefix) in PREFIXES.items():
        hits = _hits(data, np.array(prefix, dtype).tobytes())
        if len(hits) != 1 and anchor is not None:
            hits = [h for h in hits if abs(h - anchor) < WINDOW]
        if len(hits) != 1:
            raise SystemExit(f"{name}: its first entries occur {len(hits)} times")
        if anchor is None:
            anchor = hits[0]
        size = int(np.prod(shape)) * np.dtype(dtype).itemsize
        a = np.frombuffer(data[hits[0]:hits[0] + size], dtype).reshape(shape)
        tables[name] = a.astype(np.dtype(dtype).newbyteorder("="))
    return tables


def checksum(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def render(tables: dict[str, np.ndarray], lib: Path) -> str:
    lines = ['"""MPEG-1 and MPEG-2 video\'s tables, as FFmpeg\'s ``mpeg1video`` and',
             "``mpeg2video`` decoders hold them (ISO/IEC 13818-2 Annex B and clause 7;",
             "(code, length) pairs MSB first). Generated by",
             f"``scripts/extract_mpeg12_tables.py`` from ``{lib.name}``",
             "(opencv-python's bundled FFmpeg); do not edit. ``CHECKSUMS`` holds the",
             "sha256 (first 16 hex digits) of each table's bytes.", '"""', "",
             "import numpy as np", "", "",
             "def _t(dtype, shape, values):",
             "    a = np.array(values, dtype).reshape(shape)",
             "    a.flags.writeable = False",
             "    return a", ""]
    lines += FLAGS.strip("\n").splitlines() + [""]
    for name, a in tables.items():
        head = f"{name} = _t(np.{a.dtype.name}, {tuple(a.shape)}, ["
        lines.append(head)
        vals = [str(int(v)) for v in a.ravel()]
        row = "   "
        for v in vals:
            if len(row) + len(v) + 2 > 96:
                lines.append(row)
                row = "   "
            row += " " + v + ","
        lines.append(row)
        lines.append("])")
    lines += ["", "CHECKSUMS = {"]
    lines += [f'    "{name}": "{checksum(a)}",' for name, a in tables.items()]
    lines += ["}", ""]
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--libs", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args()
    folder = args.libs
    if folder is None:
        import cv2

        folder = Path(cv2.__file__).resolve().parents[1] / "opencv_python.libs"
    lib = _lib(folder)
    tables = extract(lib.read_bytes())
    args.out.write_text(render(tables, lib))
    print(f"{len(tables)} tables from {lib.name} -> {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
