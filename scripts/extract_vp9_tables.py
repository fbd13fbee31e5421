#!/usr/bin/env python3
"""Write ``v2e2v_tpu_torch/utils/vp9tables.py``: the tables a VP9 decoder needs
(default probabilities, scans, quantiser lookups, filter kernels, trees and
block-size lookups), cut out of the FFmpeg and libvpx libraries that
``opencv-python`` bundles.

    python scripts/extract_vp9_tables.py [--libs DIR] [--out v2e2v_tpu_torch/utils/vp9tables.py]

``DIR`` defaults to the ``opencv_python.libs`` folder beside the installed
``cv2``; it holds ``libavcodec-*.so`` (FFmpeg's ``vp9`` decoder, the one cv2
decodes VP9 with) and ``libvpx-*.so`` (built with its symbol table). Each
table is found by its libvpx symbol (``nm -S`` gives its address and size)
and is then looked for in libavcodec in the layout FFmpeg keeps it in:

- as is: the coefficient probabilities, the Pareto tail, the inter-frame
  y-mode, interpolation-filter, inter-mode and single-reference
  probabilities, the quantiser lookups and the three 8-tap kernel sets;
- with FFmpeg's intra-mode order (V, H, DC, D45, D135, D117, D153, D63,
  D207, TM against libvpx's DC, V, H, D45, D135, D117, D153, D207, D63, TM):
  the key-frame y- and uv-mode and the inter-frame uv-mode probabilities;
- with the block levels reversed (64x64 first): the partition
  probabilities; transposed (FFmpeg keeps coefficients column by column):
  the scans and their neighbours; as ``(col, row)`` bytes by FFmpeg's block
  order: the MV reference positions; as the 14 x 14 table
  ``counter_to_context[mode_2_counter[a] + mode_2_counter[l]]``: the
  mode-context tables.

Every such table must occur in libavcodec exactly once (else the script
stops). The probabilities that libvpx sets in code (skip, transform size,
intra/inter, compound, compound reference and motion vectors) are read from
FFmpeg's ``ProbContext`` of defaults, which starts at the y-mode table found
above and whose other fields are checked against libvpx's; the
``inv_map_table`` of the probability updates is found by its first 20
entries. Trees, bands, token energy classes, extra-bit probabilities and
block-size lookups are libvpx's alone (FFmpeg writes them as code).

The generated module holds plain literals and the sha256 of each table's
bytes; ``tests/test_torch_vp9.py`` checks both and each table's invariants.
Nothing is downloaded.
"""

from __future__ import annotations

import argparse
import hashlib
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "v2e2v_tpu_torch" / "utils" / "vp9tables.py"
# FFmpeg's intra-mode order, each as libvpx's index
FF_FROM_VPX = [1, 2, 0, 3, 4, 5, 6, 8, 7, 9]


def _libs(folder: Path) -> tuple[Path, Path]:
    avc = sorted(folder.glob("libavcodec-*.so*"))
    vpx = sorted(folder.glob("libvpx-*.so*"))
    if len(avc) != 1 or len(vpx) != 1:
        raise SystemExit(f"{folder}: want one libavcodec-*.so and one libvpx-*.so")
    return avc[0], vpx[0]


def _symbols(lib: Path) -> dict[str, list[tuple[int, int]]]:
    """name -> [(file offset, size)] of every data symbol (``nm -S``; the
    read-only sections are mapped at their file offsets)."""
    out = subprocess.run(["nm", "-S", str(lib)], capture_output=True, text=True,
                         check=True).stdout
    syms: dict[str, list[tuple[int, int]]] = {}
    for line in out.splitlines():
        parts = line.split()
        if len(parts) == 4 and parts[2] in "rRdD":
            syms.setdefault(parts[3], []).append((int(parts[0], 16), int(parts[1], 16)))
    return syms


class Libraries:
    def __init__(self, folder: Path):
        self.avc_path, self.vpx_path = _libs(folder)
        self.avc = self.avc_path.read_bytes()
        self.vpx = self.vpx_path.read_bytes()
        self.syms = _symbols(self.vpx_path)

    def vpx_table(self, name: str, dtype, shape) -> np.ndarray:
        """libvpx's table ``name`` (of several with that name, the one of the
        right size that libavcodec holds too)."""
        size = int(np.prod(shape)) * np.dtype(dtype).itemsize
        found = [(a, s) for a, s in self.syms.get(name, []) if s == size]
        if not found:
            raise SystemExit(f"libvpx has no {name} of {size} bytes")
        tables = {self.vpx[a:a + s] for a, s in found}
        if len(tables) > 1:  # VP8's table of the same name and size: keep FFmpeg's
            tables = {b for b in tables if self.avc.count(b) == 1}
        if len(tables) != 1:
            raise SystemExit(f"libvpx's tables {name} differ")
        return np.frombuffer(tables.pop(), dtype).reshape(shape).copy()

    def avc_once(self, data: bytes, what: str) -> int:
        at = self.avc.find(data)
        if at < 0 or self.avc.find(data, at + 1) >= 0:
            raise SystemExit(f"{what}: not found exactly once in {self.avc_path.name}")
        return at


def extract(lib: Libraries) -> dict[str, np.ndarray]:
    u8, i16, i32 = np.uint8, np.int16, np.int32
    t: dict[str, np.ndarray] = {}

    def both(name, table, ff_bytes=None):
        lib.avc_once(table.tobytes() if ff_bytes is None else ff_bytes, name)
        t[name] = table

    coef = np.stack([lib.vpx_table(f"default_coef_probs_{n}x{n}", u8, (2, 2, 6, 6, 3))
                     for n in (4, 8, 16, 32)])
    both("COEF_PROBS", coef)
    both("PARETO8", lib.vpx_table("vp9_pareto8_full", u8, (255, 8)))
    kfy = lib.vpx_table("vp9_kf_y_mode_prob", u8, (10, 10, 9))
    both("KF_Y_MODE_PROBS", kfy, kfy[FF_FROM_VPX][:, FF_FROM_VPX].tobytes())
    kfuv = lib.vpx_table("vp9_kf_uv_mode_prob", u8, (10, 9))
    both("KF_UV_MODE_PROBS", kfuv, kfuv[FF_FROM_VPX].tobytes())
    kfp = lib.vpx_table("vp9_kf_partition_probs", u8, (16, 3))
    both("KF_PARTITION_PROBS", kfp, kfp.reshape(4, 4, 3)[::-1].tobytes())
    ymode = lib.vpx_table("default_if_y_probs", u8, (4, 9))
    start = lib.avc_once(ymode.tobytes(), "Y_MODE_PROBS")
    t["Y_MODE_PROBS"] = ymode
    uv = lib.vpx_table("default_if_uv_probs", u8, (10, 9))
    both("UV_MODE_PROBS", uv, uv[FF_FROM_VPX].tobytes())
    part = lib.vpx_table("default_partition_probs", u8, (16, 3))
    both("PARTITION_PROBS", part, part.reshape(4, 4, 3)[::-1].tobytes())
    both("SWITCHABLE_INTERP_PROBS", lib.vpx_table("default_switchable_interp_prob", u8, (4, 2)))
    both("INTER_MODE_PROBS", lib.vpx_table("default_inter_mode_probs", u8, (7, 3)))
    both("SINGLE_REF_PROBS", lib.vpx_table("default_single_ref_p", u8, (5, 2)))

    # FFmpeg's ProbContext of defaults (vp9data.c ff_vp9_default_probs): its
    # fields in order, checked where libvpx has the table
    fields = [("Y_MODE_PROBS", (4, 9)), ("UV_MODE_PROBS", (10, 9)),
              ("SWITCHABLE_INTERP_PROBS", (4, 2)), ("INTER_MODE_PROBS", (7, 3)),
              ("INTRA_INTER_PROBS", (4,)), ("COMP_INTER_PROBS", (5,)),
              ("SINGLE_REF_PROBS", (5, 2)), ("COMP_REF_PROBS", (5,)), ("TX_PROBS_32", (2, 3)),
              ("TX_PROBS_16", (2, 2)), ("TX_PROBS_8", (2, 1)), ("SKIP_PROBS", (3,)),
              ("MV_JOINT_PROBS", (3,))]
    comp = [("MV_SIGN_PROBS", (1,)), ("MV_CLASS_PROBS", (10,)), ("MV_CLASS0_PROBS", (1,)),
            ("MV_BITS_PROBS", (10,)), ("MV_CLASS0_FP_PROBS", (2, 3)), ("MV_FP_PROBS", (3,)),
            ("MV_CLASS0_HP_PROBS", (1,)), ("MV_HP_PROBS", (1,))]
    at = start
    ff = {}
    for name, shape in fields:
        n = int(np.prod(shape))
        ff[name] = np.frombuffer(lib.avc[at:at + n], u8).reshape(shape).copy()
        at += n
    mv = {name: [] for name, _ in comp}
    for _ in range(2):
        for name, shape in comp:
            n = int(np.prod(shape))
            mv[name].append(np.frombuffer(lib.avc[at:at + n], u8).reshape(shape).copy())
            at += n
    ff_part = np.frombuffer(lib.avc[at:at + 48], u8).reshape(4, 4, 3)[::-1].reshape(16, 3)
    if not np.array_equal(ff_part, part):
        raise SystemExit("FFmpeg's ProbContext is not laid out as expected (partition)")
    if not np.array_equal(ff["UV_MODE_PROBS"], uv[FF_FROM_VPX]):
        raise SystemExit("FFmpeg's ProbContext is not laid out as expected (uv modes)")
    for name in ("SWITCHABLE_INTERP_PROBS", "INTER_MODE_PROBS", "SINGLE_REF_PROBS"):
        if not np.array_equal(ff[name], t[name]):
            raise SystemExit(f"FFmpeg's ProbContext is not laid out as expected ({name})")
    for name in ("INTRA_INTER_PROBS", "COMP_INTER_PROBS", "COMP_REF_PROBS", "TX_PROBS_32",
                 "TX_PROBS_16", "TX_PROBS_8", "SKIP_PROBS", "MV_JOINT_PROBS"):
        t[name] = ff[name]
    for name, _ in comp:
        t[name] = np.stack(mv[name])

    t["DC_QLOOKUP"] = lib.vpx_table("dc_qlookup", i16, (256,))
    t["AC_QLOOKUP"] = lib.vpx_table("ac_qlookup", i16, (256,))
    for name in ("DC_QLOOKUP", "AC_QLOOKUP"):
        lib.avc_once(t[name].tobytes(), name)
    kernels = [lib.vpx_table(n, i16, (16, 8)) for n in
               ("sub_pel_filters_8", "sub_pel_filters_8lp", "sub_pel_filters_8s")]
    kernels.append(lib.vpx_table("bilinear_filters", i16, (16, 8)))
    lib.avc_once(np.stack([kernels[1], kernels[0], kernels[2]]).tobytes(), "SUBPEL_FILTERS")
    t["SUBPEL_FILTERS"] = np.stack(kernels)  # regular, smooth, sharp, bilinear

    for n in (4, 8, 16, 32):
        for kind in ("default", "row", "col") if n < 32 else ("default",):
            scan = lib.vpx_table(f"{kind}_scan_{n}x{n}", i16, (n * n,))
            nb = lib.vpx_table(f"{kind}_scan_{n}x{n}_neighbors", i16, (n * n + 1, 2))
            name = f"{kind.upper()}_SCAN_{n}X{n}"
            lib.avc_once(((scan % n) * n + scan // n).astype(i16).tobytes(), name)
            lib.avc_once(((nb[1:n * n] % n) * n + nb[1:n * n] // n).astype(i16).tobytes(),
                         name + "_NEIGHBORS")
            t[name] = scan
            t[name + "_NEIGHBORS"] = nb[:n * n]
    mvref = lib.vpx_table("mv_ref_blocks", i32, (13, 8, 2)).astype(np.int8)
    both("MV_REF_BLOCKS", mvref, mvref[::-1, :, ::-1].tobytes())
    c2c = lib.vpx_table("counter_to_context", i32, (19,)).astype(u8)
    m2c = lib.vpx_table("mode_2_counter", i32, (14,)).astype(u8)
    lut = c2c[m2c[:, None].astype(int) + m2c[None, :]]
    lib.avc_once(lut.tobytes(), "COUNTER_TO_CONTEXT")
    t["COUNTER_TO_CONTEXT"], t["MODE_2_COUNTER"] = c2c, m2c

    inv = lib.avc[lib.avc_once(bytes(range(7, 255, 13)) + bytes((1, 2, 3, 4, 5, 6, 8)),
                               "INV_MAP_TABLE"):][:255]
    t["INV_MAP_TABLE"] = np.frombuffer(inv, u8).copy()

    t["COEFBAND_4X4"] = lib.vpx_table("vp9_coefband_trans_4x4", u8, (16,))
    t["COEFBAND_8X8PLUS"] = lib.vpx_table("vp9_coefband_trans_8x8plus", u8, (1024,))
    t["ENERGY_CLASS"] = lib.vpx_table("vp9_pt_energy_class", u8, (12,))
    for k, n in zip(range(1, 6), range(1, 6)):
        t[f"CAT{k}_PROBS"] = lib.vpx_table(f"vp9_cat{k}_prob", u8, (n,))
    t["CAT6_PROBS"] = lib.vpx_table("vp9_cat6_prob", u8, (14,))
    for name, sym, n in (("INTRA_MODE_TREE", "vp9_intra_mode_tree", 18),
                         ("INTER_MODE_TREE", "vp9_inter_mode_tree", 6),
                         ("PARTITION_TREE", "vp9_partition_tree", 6),
                         ("SWITCHABLE_INTERP_TREE", "vp9_switchable_interp_tree", 4),
                         ("SEGMENT_TREE", "vp9_segment_tree", 14),
                         ("MV_JOINT_TREE", "vp9_mv_joint_tree", 6),
                         ("MV_CLASS_TREE", "vp9_mv_class_tree", 20),
                         ("MV_CLASS0_TREE", "vp9_mv_class0_tree", 2),
                         ("MV_FP_TREE", "vp9_mv_fp_tree", 6)):
        t[name] = lib.vpx_table(sym, np.int8, (n,))
    for name, sym, shape in (("NUM_4X4_WIDE", "num_4x4_blocks_wide_lookup", (13,)),
                             ("NUM_4X4_HIGH", "num_4x4_blocks_high_lookup", (13,)),
                             ("NUM_8X8_WIDE", "num_8x8_blocks_wide_lookup", (13,)),
                             ("NUM_8X8_HIGH", "num_8x8_blocks_high_lookup", (13,)),
                             ("MAX_TXSIZE", "max_txsize_lookup", (13,)),
                             ("UV_TXSIZE", "uv_txsize_lookup", (13, 4, 2, 2)),
                             ("PARTITION_CONTEXT", "partition_context_lookup", (13, 2)),
                             ("SUBSIZE", "subsize_lookup", (4, 13)),
                             ("SIZE_GROUP", "size_group_lookup", (13,))):
        t[name] = lib.vpx_table(sym, u8, shape)
    t["INTRA_MODE_TO_TX_TYPE"] = lib.vpx_table("intra_mode_to_tx_type_lookup", i32,
                                               (10,)).astype(u8)
    return t


def checksum(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def render(tables: dict[str, np.ndarray], avc: Path, vpx: Path) -> str:
    lines = ['"""VP9\'s tables, as FFmpeg\'s ``vp9`` decoder and libvpx hold them, in',
             "libvpx's layout (intra modes DC, V, H, D45, D135, D117, D153, D207, D63, TM;",
             "block sizes 4x4 ... 64x64; partition contexts 8x8 first; coefficients row",
             "by row). Generated by ``scripts/extract_vp9_tables.py`` from",
             f"``{avc.name}`` and ``{vpx.name}``",
             "(opencv-python's bundled FFmpeg and libvpx); do not edit.",
             "``CHECKSUMS`` holds the sha256 (first 16 hex digits) of each table's bytes.",
             '"""', "", "import numpy as np", "", ""]
    lines += ["def _t(dtype, shape, values):",
              "    a = np.array(values, dtype).reshape(shape)",
              "    a.flags.writeable = False",
              "    return a", "", ""]
    for name, a in tables.items():
        values = ", ".join(str(int(v)) for v in a.ravel())
        head = f"{name} = _t(np.{a.dtype.name}, {tuple(a.shape)}, ["
        body, line = [], "    "
        for tok in values.split(", "):
            if len(line) + len(tok) + 2 > 99:
                body.append(line.rstrip())
                line = "    "
            line += tok + ", "
        body.append(line.rstrip().rstrip(","))
        lines += [head] + body + ["])"]
    lines += ["", "CHECKSUMS = {"]
    lines += [f'    "{name}": "{checksum(a)}",' for name, a in tables.items()]
    lines += ["}", ""]
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--libs", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args()
    if args.libs is None:
        import cv2
        args.libs = Path(cv2.__file__).resolve().parents[1] / "opencv_python.libs"
    lib = Libraries(args.libs)
    tables = extract(lib)
    args.out.write_text(render(tables, lib.avc_path, lib.vpx_path))
    print(f"{len(tables)} tables -> {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
