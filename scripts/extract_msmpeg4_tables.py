#!/usr/bin/env python3
"""Write ``v2e2v_tpu_torch/utils/msmpeg4tables.py``: the tables the MS-MPEG-4
family's decoders need (FFmpeg's ``msmpeg4v2``, ``msmpeg4v3``, ``wmv1`` and
``wmv2``), cut out of the FFmpeg library that ``opencv-python`` bundles
(``libavcodec``'s ``msmpeg4data.c``, ``msmpeg4_vc1_data.c`` and
``wmv2data.c``).

    python scripts/extract_msmpeg4_tables.py [--libs DIR] [--out v2e2v_tpu_torch/utils/msmpeg4tables.py]

``DIR`` defaults to the ``opencv_python.libs`` folder beside the installed
``cv2``. The library is stripped (``nm -D`` names no msmpeg4 or wmv2
symbol), so each table is found by its first entries, as FFmpeg lays them
out, and read to its full length. A prefix must occur exactly once in the
library, or exactly once within 64 KiB of ``RL0_VLC``'s, which is unique;
else the script stops. The run and level arrays of each run/level table
are found beside its code table: FFmpeg keeps ``run[n]``, then
``level[n]``, then the codes, each array padded with zeros after its last
entry (a level is never 0, and a run array ends with the largest run of its
"last" entries), so each array is the ``n`` bytes that end at the last
non-zero byte before the next. The tables:

- ``RL0``, ``RL1``, ``RL3``, ``RL4``: the run/level tables of
  ``ff_rl_table[0, 1, 3, 4]`` (the intra luma tables 0 and 1, the intra
  chroma / inter tables 0 and 1): ``_VLC`` (code, length) of each entry and
  the escape last, ``_RUN`` and ``_LEVEL``, and ``_LAST`` the first entry
  whose "last" bit is 1. ``ff_rl_table[2]`` and ``[5]`` are MPEG-4's intra
  and inter (H.263 TCOEF) tables, which ``utils/mpeg4.py`` holds;
- ``MB_INTRA``: (code, length) of the 64 coded block patterns of an
  I-picture's macroblock (``ff_msmp4_mb_i_table``);
- ``MB_NON_INTRA``: (code, length) of the 128 symbols of a P-picture's
  macroblock (bit 6 set: inter; the low six bits the coded block pattern),
  the four tables WMV2's ``cbp_table_index`` picks from
  (``ff_wmv2_inter_table``; v3 and WMV1 use table 3; the library holds
  tables 2, 1 and 0 in that order, then table 3 apart, as it holds the
  motion vector tables 1 then 0);
- ``DC``: (code, length) of the DC differential sizes 0-118 and the escape
  (119), by ``dc_table_index`` and luma / chroma;
- ``MV0_LENS`` / ``MV0_SYMS`` and ``MV1_*``: the two motion vector tables
  (by ``mv_table_index``; FFmpeg keeps table 1 first) as FFmpeg builds
  their VLCs from lengths (codes assigned in order), each symbol ``x << 8 |
  y``, both offset by 32; 0 is the escape;
- ``V2_MB_TYPE`` and ``V2_INTRA_CBPC``: msmpeg4v2's (code, length) of a
  P macroblock's type and of an I macroblock's ``cbpc``;
- ``INTER_INTRA``: (code, length) of WMV1's ``h263_aic_dir``;
- ``OLD_FF_Y_DC_SCALE``, ``WMV1_Y_DC_SCALE``, ``WMV1_C_DC_SCALE``: the DC
  scales by QP (v3 uses the first with ``WMV1_C_DC_SCALE``);
- ``WMV1_SCAN``: WMV1's and WMV2's four scans (inter, intra, intra
  horizontal, intra vertical), scan index -> raster position;
- ``WMV2_SCAN_A`` and ``WMV2_SCAN_B``: WMV2's 8x4 and 4x8 ABT scans
  (read, not used: the port refuses those block types).

The generated module holds plain literals and the sha256 of each table's
bytes; ``tests/test_torch_msmpeg4.py`` checks both and each table's
invariants. Nothing is downloaded.
"""

from __future__ import annotations

import argparse
import hashlib
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "v2e2v_tpu_torch" / "utils" / "msmpeg4tables.py"
WINDOW = 65536

# name -> (dtype, shape, the first entries, flattened); RL0_VLC first: the anchor
PREFIXES = {
    "RL0_VLC": ("<u2", (133, 2), [1, 2, 6, 3]),
    "RL1_VLC": ("<u2", (186, 2), [1, 2, 5, 3]),
    "RL3_VLC": ("<u2", (149, 2), [4, 3, 20, 5]),
    "RL4_VLC": ("<u2", (169, 2), [0, 3, 3, 4]),
    "MB_INTRA": ("<u2", (64, 2), [1, 1, 23, 6]),
    "DC": ("<u4", (2, 2, 120, 2), [1, 1, 1, 2]),
    "MB_NON_INTRA_210": ("<u4", (3, 128, 2), [212, 8, 8645, 14]),
    "MB_NON_INTRA_3": ("<u4", (128, 2), [64, 7, 5065, 13]),
    "MV1_LENS": ("u1", (1100,), [2, 15, 15, 15]),
    "MV1_SYMS": ("<u2", (1100,), [0x2020, 0x2A27]),
    "MV0_LENS": ("u1", (1100,), [8, 12, 12, 13]),
    "MV0_SYMS": ("<u2", (1100,), [0, 0x1F27, 0x261F]),
    "V2_MB_TYPE": ("u1", (8, 2), [1, 1, 0, 2, 3, 3]),
    "V2_INTRA_CBPC": ("u1", (4, 2), [1, 1, 0, 3]),
    "INTER_INTRA": ("u1", (4, 2), [0, 1, 2, 2, 6, 3]),
    "OLD_FF_Y_DC_SCALE": ("u1", (32,), [0, 8, 8, 8, 8, 10, 12, 14, 16, 17, 18, 19, 20, 21, 22, 23,
                                         24, 25, 26, 27, 28, 29, 30, 31, 32, 33]),
    "WMV1_C_DC_SCALE": ("u1", (32,), [0, 8, 8, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14,
                                       14, 15, 15, 16, 16, 17, 17, 18, 18, 19, 19, 20]),
    "WMV1_Y_DC_SCALE": ("u1", (32,), [0, 8, 8, 8, 8, 8]),
    "WMV1_SCAN": ("u1", (4, 64), [0, 8, 1, 2, 9, 16, 24, 17, 10, 3, 4, 11, 18, 25, 32, 40, 48,
                                   56]),
    "WMV2_SCAN_A": ("u1", (32,), [0, 1, 2, 8, 3, 9, 10, 16]),
    "WMV2_SCAN_B": ("u1", (32,), [0, 8, 1, 16, 9, 24, 17, 2]),
}
# the run/level tables: name -> n (its code table holds n entries and the escape)
RL_TABLES = {"RL0": 132, "RL1": 185, "RL3": 148, "RL4": 168}


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


def _before(data: bytes, end: int, n: int) -> int:
    """The start of the ``n``-byte array that ends at the last non-zero byte
    before ``end``."""
    while data[end - 1] == 0:
        end -= 1
    return end - n


def extract(data: bytes) -> dict[str, np.ndarray]:
    anchor = None
    found, tables = {}, {}
    for name, (dtype, shape, prefix) in PREFIXES.items():
        hits = _hits(data, np.array(prefix, dtype).tobytes())
        if len(hits) != 1 and anchor is not None:
            hits = [h for h in hits if abs(h - anchor) < WINDOW]
        if len(hits) != 1:
            raise SystemExit(f"{name}: its first entries occur {len(hits)} times")
        if anchor is None:
            anchor = hits[0]
        found[name] = hits[0]
        size = int(np.prod(shape)) * np.dtype(dtype).itemsize
        a = np.frombuffer(data[hits[0]:hits[0] + size], dtype).reshape(shape)
        tables[name] = a.astype(np.dtype(dtype).newbyteorder("="))
    out = {}
    for name, n in RL_TABLES.items():
        level = _before(data, found[f"{name}_VLC"], n)
        run = _before(data, level, n)
        out[f"{name}_VLC"] = tables.pop(f"{name}_VLC")
        out[f"{name}_RUN"] = np.frombuffer(data[run:run + n], np.uint8).copy()
        out[f"{name}_LEVEL"] = np.frombuffer(data[level:level + n], np.uint8).copy()
        if out[f"{name}_LEVEL"].min() == 0 or out[f"{name}_RUN"][0] != 0:
            raise SystemExit(f"{name}: no run and level arrays before its codes")
    # the three tables lie in the library in the order 2, 1, 0
    out["MB_NON_INTRA"] = np.concatenate([tables.pop("MB_NON_INTRA_210")[::-1],
                                          tables.pop("MB_NON_INTRA_3")[None]])
    out.update(tables)
    return out


def checksum(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def render(tables: dict[str, np.ndarray], lib: Path) -> str:
    lines = ['"""The MS-MPEG-4 family\'s tables (msmpeg4v2, msmpeg4v3, WMV1, WMV2), as',
             "FFmpeg's decoders hold them ((code, length) pairs MSB first). Generated by",
             f"``scripts/extract_msmpeg4_tables.py`` from ``{lib.name}``",
             "(opencv-python's bundled FFmpeg); do not edit. ``CHECKSUMS`` holds the",
             "sha256 (first 16 hex digits) of each table's bytes.", '"""', "",
             "import numpy as np", "", "",
             "def _t(dtype, shape, values):",
             "    a = np.array(values, dtype).reshape(shape)",
             "    a.flags.writeable = False",
             "    return a", ""]
    for name, n in RL_TABLES.items():
        runs = tables[f"{name}_RUN"]
        last = int(np.flatnonzero(np.diff(runs.astype(int)) < 0)[0]) + 1
        lines.append(f"{name}_LAST = {last}  # the first of {n} entries whose 'last' bit is 1")
    lines.append("")
    for name, a in tables.items():
        lines.append(f"{name} = _t(np.{a.dtype.name}, {tuple(a.shape)}, [")
        row = "   "
        for v in (str(int(v)) for v in a.ravel()):
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
