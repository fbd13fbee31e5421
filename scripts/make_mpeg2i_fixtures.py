#!/usr/bin/env python3
"""Write the interlaced MPEG-2 fixtures of the port's video path
(``v2e2v_tpu_torch/utils/mpeg12*.py``: field pictures, field and 16x8
motion, dual prime, field DCT; ``mpegps.py``, ``mpegts.py`` and
``mpegrate.py`` for their rates and counts) and what the JAX package's
readers return for each.

    JAX_PLATFORMS=cpu python scripts/make_mpeg2i_fixtures.py [--out tests/data/mpeg2i] [--seed 0]

It needs cv2 built with FFmpeg and the JAX package, so it runs where the JAX
package's dependencies are installed, not on the card's machine; the card
checks the port against the records this writes. cv2's writer makes no
interlaced stream (its FFmpeg options leave the bytes of the file as they
are), so this script carries a small MPEG-2 syntax writer (``Coder``): it
starts from the sequence header and extension cv2 writes for the size and
rate, rewritten with ``progressive_sequence`` 0, and codes its own pictures:

- intra macroblocks from a seeded scene (``make_mpeg4_fixtures.pan``):
  a float64 forward DCT of each block, quantised for the macroblock's
  ``quantiser_scale``, its DC against the slice's predictors, the rest
  under table B-14 or B-15 in the zigzag or alternate scan;
- predicted macroblocks of seeded modes: in frame pictures frame, field and
  dual-prime motion, each field's select, and frame or field DCT; in field
  pictures field, 16x8 and dual-prime motion; zero-vector and skipped
  macroblocks; B-pictures' forward, backward and bidirectional
  macroblocks; vectors kept inside the reference (FFmpeg leaves a
  macroblock that reaches past it unpredicted) and coded against the
  decoder's predictors; coded block patterns and small levels at random;
- dual prime only in P-pictures with no B-picture between them and their
  reference, as the standard asks.

Pictures are frame pictures or pairs of field pictures, top or bottom field
first, an I-field followed by a P-field in one frame among them. The
containers: a program stream (``ps``: 2048-byte packs, each a pack header
and one PES packet, the first picture that starts in a pack stamped with
its PTS and DTS, as a DVD's VOB), a transport stream (``ts``: a PES packet
per frame), AVI (one frame, both fields, a chunk) and Matroska (a block a
frame).

- ``flagship.vob``: 12 frames at 720x576 and 25 fps (PAL DVD), field
  pictures top field first, a GOP I-P-B-B-P-B-B-..., the first frame an
  I/P field pair; read as 180x144 by the readers' quarter;
- ``fields_tff.*`` / ``fields_bff.*``: field pictures of every motion type
  at 176x128, in each container;
- ``frames.*``: interlaced frame pictures (frame, field and dual-prime
  motion, field DCT) at 176x128;
- ``mixed.vob``: frame pictures and field pairs in one stream, concealment
  vectors, B-15, the alternate scan and the non-linear quantiser;
- ``telecine.vob`` and ``.ts``: a DVD-like soft-telecined stream at 352x240
  (an NTSC DVD size): 24000/1001 film coded at 30000/1001 as 17 progressive
  frames, 3:2 by ``repeat_first_field`` and ``top_field_first``, the PES
  stamps following the cadence;
- ``telecine_twin.*`` and ``telecine_gops.mpg`` / ``telecine_ntsc.mpg``:
  cv2's own clips of ``tests/data/mpeg12`` with the 3:2 flags patched into
  their headers (``patch_file``), in a program stream, a VOB, a transport
  stream, an M2TS, AVI and Matroska;

and ``manifest.json`` (cv2's version, each clip's fps and frame count as
cv2 reports them, the sha256 of each cv2 frame, of each JAX
``VideoReader`` frame (``ds = (0.25, 0.25)``) and of each JAX
``VideoSequence`` frame, and what each clip holds) and
``reader_frames.npz`` (the JAX ``VideoReader``'s frames of each clip).
Every clip is checked against cv2 here: cv2's frames on one thread equal its
frames on its default threads, and cv2 reads every frame written.

The tests use this module's ``Coder`` (``stream``, ``frame_cadence``) and
container writers (``program_stream``, ``transport_stream``, ``avi``,
``matroska``) to write streams of one feature each.
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

import make_mpeg12_fixtures as mf  # noqa: E402

FLAGSHIP = (576, 720, 12, 25.0)  # height, width, frames, fps
SMALL = (128, 176)
TELECINE = (240, 352)  # an NTSC DVD's 352x240 size
I, P, B = 1, 2, 3
TOP, BOTTOM, FRAME = 1, 2, 3
# macroblock_type flags (mpeg12tables)
INTRA, PATTERN, BACKWARD, FORWARD, QUANT, ZERO = 1, 2, 4, 8, 16, 32


def tables():
    from v2e2v_tpu_torch.utils import mpeg12tables as t

    return t


class Bits:
    """An MSB-first bit writer."""

    def __init__(self):
        self.acc, self.n = 0, 0

    def put(self, n: int, v: int) -> None:
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.n += n

    def code(self, pair) -> None:
        code, n = (int(v) for v in pair)
        self.put(n, code)

    def bytes(self) -> bytes:
        pad = -self.n % 8
        return ((self.acc << pad).to_bytes((self.n + pad) // 8, "big") if self.n else b"")


# ------------------------------------------------------------ the coder

def fdct(block: np.ndarray) -> np.ndarray:
    """The 8x8 forward DCT in float64 whose inverse MPEG-2's IDCT is
    (orthonormal: the DC is 8 x the mean)."""
    k = np.arange(8)
    c = np.sqrt(2 / 8) * np.cos(np.pi * (2 * k[None, :] + 1) * k[:, None] / 16)
    c[0] /= np.sqrt(2)
    return c @ block @ c.T


def yuv420(bgr: np.ndarray):
    """BT.601 limited-range planes of a BGR frame (chroma averaged 2x2)."""
    b, g, r = (bgr[..., k].astype(np.float64) for k in range(3))
    y = 16 + (65.481 * r + 128.553 * g + 24.966 * b) / 255
    cb = 128 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255
    cr = 128 + (112.0 * r - 93.786 * g - 18.214 * b) / 255
    sub = [(c[0::2, 0::2] + c[1::2, 0::2] + c[0::2, 1::2] + c[1::2, 1::2]) / 4 for c in (cb, cr)]
    return y, sub[0], sub[1]


class Picture:
    """One coded picture's choices (see ``Coder.picture``)."""

    def __init__(self, kind, structure=FRAME, tff=1, rff=0, progressive_frame=0,
                 frame_pred_frame_dct=0, concealment=0, intra_vlc=0, alternate=0,
                 q_scale_type=0, dc_precision=0, dmv=False, temporal=0, modes=None,
                 no_reference=False):
        self.kind, self.structure, self.tff, self.rff = kind, structure, tff, rff
        self.progressive_frame, self.fpfd = progressive_frame, frame_pred_frame_dct
        self.concealment, self.intra_vlc, self.alternate = concealment, intra_vlc, alternate
        self.q_scale_type, self.dc_precision, self.dmv = q_scale_type, dc_precision, dmv
        self.temporal = temporal
        self.modes = modes  # None: every mode the picture allows; else a subset of names
        # a P-field paired with the stream's first I-field: no earlier reference
        self.no_reference = no_reference


class Coder:
    """A small MPEG-2 syntax writer of 4:2:0 interlaced streams (see the
    module's notes): ``stream(plan, scene)`` codes the pictures of ``plan``
    (a list of GOPs, each a list of ``Picture`` in coded order) from the
    frames ``scene[temporal]`` and returns the elementary stream."""

    F_CODE = 3  # vectors within -64..63 half pixels

    def __init__(self, width: int, height: int, rng: np.random.Generator,
                 seq_units: tuple[bytes, bytes], residual: float = 0.6):
        self.residual = residual  # the share of predicted macroblocks with coded blocks
        self.mbw = (width + 15) >> 4
        self.mbh = 2 * ((height + 31) >> 5)  # an interlaced sequence's frame rows
        self.rng = rng
        self.t = tables()
        seq = mf.parse_header(seq_units[0])
        ext = mf.parse_header(seq_units[1])
        ext["progressive_sequence"] = 0
        self.seq_header = mf.write_header(seq) + mf.write_header(ext)
        self.b14 = {(int(r), int(lv)): k for k, (r, lv) in
                    enumerate(zip(self.t.DCT_RUN, self.t.DCT_LEVEL))}
        self.scan = [int(v) for v in self.t.ZIGZAG], [int(v) for v in self.t.ALTERNATE]
        self.used: set = set()

    # ------------------------------------------------------------ stream

    def stream(self, plan, scene: np.ndarray) -> bytes:
        """The sequence header, then each GOP (a GOP header and its pictures,
        ``scene`` indexed by display order over the whole stream), then a
        sequence end code."""
        out, base = [], 0
        for g, gop in enumerate(plan):
            out.append(self.seq_header)
            out.append(mf.write_header({"kind": "gop", "time_code": 0x40000 | g,
                                        "closed_gop": 1, "broken_link": 0}))
            for pic in gop:
                out.append(self.picture(pic, yuv420(scene[base + pic.temporal])))
            base += len(gop)
        out.append(b"\x00\x00\x01\xb7")
        return b"".join(out)

    def picture(self, pic: Picture, planes) -> bytes:
        """A frame picture, or the two field pictures of a field pair
        (``pic.structure`` the first field's; ``pic.kind`` a pair of types
        for an I/P pair)."""
        kinds = pic.kind if isinstance(pic.kind, tuple) else (pic.kind, pic.kind)
        # every macroblock row is coded, those past the picture's height too
        planes = [np.pad(a, ((0, rows - a.shape[0]), (0, cols - a.shape[1])), mode="edge")
                  for a, rows, cols in zip(planes, (16 * self.mbh, 8 * self.mbh, 8 * self.mbh),
                                           (16 * self.mbw, 8 * self.mbw, 8 * self.mbw))]
        if pic.structure == FRAME:
            return self._one(pic, kinds[0], FRAME, planes, first=True)
        second = BOTTOM if pic.structure == TOP else TOP
        return (self._one(pic, kinds[0], pic.structure, planes, first=True)
                + self._one(pic, kinds[1], second, planes, first=False))

    def _one(self, pic: Picture, kind: int, structure: int, planes, first: bool) -> bytes:
        f = self.F_CODE if kind != I or pic.concealment else 15
        fb = self.F_CODE if kind == B else 15
        head = mf.write_header({"kind": "picture", "temporal_reference": pic.temporal & 1023,
                                "type": kind, "vbv_delay": 0xFFFF, "full_pel_f": 0,
                                "f_code_f": 7, "full_pel_b": 0, "f_code_b": 7})
        ext = mf.write_header({
            "kind": "picture_extension", "ext": 8, "f00": f, "f01": f, "f10": fb, "f11": fb,
            "intra_dc_precision": pic.dc_precision, "picture_structure": structure,
            "top_field_first": pic.tff if structure == FRAME else 0,
            "frame_pred_frame_dct": pic.fpfd if structure == FRAME else 0,
            "concealment_motion_vectors": pic.concealment, "q_scale_type": pic.q_scale_type,
            "intra_vlc_format": pic.intra_vlc, "alternate_scan": pic.alternate,
            "repeat_first_field": pic.rff if structure == FRAME else 0,
            "chroma_420_type": pic.progressive_frame, "progressive_frame": pic.progressive_frame,
            "composite_display": 0})
        self.pic, self.kind, self.structure, self.first = pic, kind, structure, first
        self.field = structure != FRAME
        self.no_ref = kind == P and not first and pic.no_reference
        self.parity = structure - 1
        rows = self.mbh // 2 if self.field else self.mbh
        y, cb, cr = planes
        if self.field:  # the field's own rows
            y, cb, cr = y[self.parity::2], cb[self.parity::2], cr[self.parity::2]
        self.src = (y, cb, cr)
        slices = [self._slice(r) for r in range(rows)]
        return head + ext + b"".join(slices)

    # ------------------------------------------------------------ slices

    def _qcode(self) -> int:
        return int(self.rng.integers(3, 12))

    def _qscale(self, code: int) -> int:
        return int(self.t.NON_LINEAR_QSCALE[code]) if self.pic.q_scale_type else 2 * code

    def _slice(self, row: int) -> bytes:
        w = Bits()
        q = self._qcode()
        w.put(5, q)
        w.put(1, 0)  # extra_bit_slice
        self.qscale = self._qscale(q)
        self.last_dc = [128 << self.pic.dc_precision] * 3
        self.last_mv = [[[0, 0], [0, 0]], [[0, 0], [0, 0]]]
        self.prev = None  # the previous macroblock's (flags, directions)
        skip = 0
        for col in range(self.mbw):
            last = col == self.mbw - 1
            if col and not last and self._may_skip(row, col):
                skip += 1
                continue
            w.code(self.t.MB_ADDR_INCR[skip])  # increment skip + 1
            if skip:
                self.used.add("skipped")
            skip = 0
            self._macroblock(w, row, col)
        return bytes([0, 0, 1, row + 1]) + w.bytes()

    # ------------------------------------------------------------ skips

    def _may_skip(self, row: int, col: int) -> bool:
        """Skip this macroblock where its implied prediction stays inside the
        reference: a P-picture's at vector 0, a B-picture's by the previous
        macroblock's directions and the predictors."""
        if self.kind == I or self.prev is None or self.no_ref or self.rng.random() > 0.2:
            return False
        flags, dirs = self.prev
        if self.kind == P:
            self.last_mv[0] = [[0, 0], [0, 0]]
            self.last_dc = [128 << self.pic.dc_precision] * 3
            self.prev = (FORWARD, 1)
            return True
        if flags & INTRA:
            return False
        for d in (0, 1):
            if dirs >> d & 1:
                x, y = self.last_mv[d][0]
                sel = self.parity if self.field else -1
                if not self._inside(row, col, x, y, sel, 16):
                    return False
        self.last_dc = [128 << self.pic.dc_precision] * 3
        return True

    # ------------------------------------------------------ geometry

    def _inside(self, row: int, col: int, x: int, y: int, sel: int, h: int, top=None) -> bool:
        """Whether a (16 x ``h``) prediction at the macroblock's place by the
        half-pel vector (x, y) reads inside the reference: frame-based where
        ``sel`` < 0, else within one field's rows."""
        lo, hi = -16 * (1 << (self.F_CODE - 1)), 16 * (1 << (self.F_CODE - 1)) - 1
        if not (lo <= x <= hi and lo <= y <= hi):
            return False
        sx = 16 * col + (x >> 1)
        if sel < 0:
            sy, v_edge = 16 * row + (y >> 1), 16 * self.mbh
        else:
            base = top if top is not None else (16 * row if self.field else 8 * row)
            sy, v_edge = base + (y >> 1), 8 * self.mbh
        return 0 <= sx <= 16 * self.mbw - (x & 1) - 16 and 0 <= sy <= v_edge - (y & 1) - h

    def _vector(self, row, col, sel, h, top=None):
        """A random half-pel vector inside the reference (mostly small)."""
        for _ in range(40):
            span = 6 if self.rng.random() < 0.7 else 40
            x, y = (int(v) for v in self.rng.integers(-span, span + 1, 2))
            if self._inside(row, col, x, y, sel, h, top):
                return x, y
        return None

    # ------------------------------------------------------------ motion

    def _motion(self, w: Bits, value: int, pred: int) -> None:
        """``value`` coded against ``pred`` (motion_code, sign, residual)."""
        r = self.F_CODE - 1
        f = 1 << r
        delta = value - pred
        if delta > 16 * f - 1:
            delta -= 32 * f
        elif delta < -16 * f:
            delta += 32 * f
        if delta == 0:
            w.code(self.t.MOTION[0])
            return
        v = abs(delta) - 1
        w.code(self.t.MOTION[(v >> r) + 1])
        w.put(1, int(delta < 0))
        w.put(r, v & (f - 1))

    def _dmv(self, w: Bits, d: int) -> None:
        if d == 0:
            w.put(1, 0)
        else:
            w.put(2, 2 if d > 0 else 3)

    # ------------------------------------------------------ macroblocks

    def _modes(self, kind: int) -> list[str]:
        pic = self.pic
        if kind == I:
            return ["intra"]
        if self.field:
            motion = ["field", "16x8"] + (["dmv"] if kind == P and pic.dmv else [])
        elif pic.fpfd:
            motion = ["frame"]
        else:
            motion = ["frame", "field"] + (["dmv"] if kind == P and pic.dmv else [])
        out = ["intra"] + motion + (["zero"] if kind == P else [])
        if self.no_ref:  # only the other field of its own frame to predict from
            out = [m for m in out if m not in ("zero", "dmv")]
        return [m for m in out if pic.modes is None or m in pic.modes] or ["intra"]

    def _macroblock(self, w: Bits, row: int, col: int) -> None:
        rng, t = self.rng, self.t
        modes = self._modes(self.kind)
        weights = np.array([0.15 if m == "intra" else 1.0 for m in modes])
        mode = modes[int(rng.choice(len(modes), p=weights / weights.sum()))]
        if self.kind == I:
            mode = "intra"
        quant = rng.random() < 0.15
        if mode == "intra":
            self._intra_mb(w, row, col, quant)
            return
        dirs = 1
        if self.kind == B:
            dirs = int(rng.choice([1, 2, 3]))
        plan = self._plan(mode, dirs, row, col)
        if plan is None:  # no vector fits: an intra macroblock instead
            self._intra_mb(w, row, col, quant)
            return
        cbp = int(rng.integers(1, 64)) if rng.random() < self.residual else 0
        if mode == "zero":
            cbp = cbp or int(rng.integers(1, 64))
        flags = (PATTERN if cbp else 0) | (QUANT if quant and cbp else 0)
        if mode == "zero":
            flags |= ZERO | FORWARD
        else:
            flags |= (FORWARD if dirs & 1 else 0) | (BACKWARD if dirs & 2 else 0)
        table, codes = ((t.PTYPE_FLAGS, t.MB_PTYPE) if self.kind == P else
                        (t.BTYPE_FLAGS, t.MB_BTYPE))
        w.code(codes[table.index(flags)])
        motion_type = {"frame": 2, "16x8": 2, "field": 1, "dmv": 3}.get(mode)
        if mode != "zero" and (self.field or not self.pic.fpfd):
            w.put(2, motion_type)
            self.used.add(f"{'field' if self.field else 'frame'}_{mode}")
        dct = 0
        if not self.field and not self.pic.fpfd and cbp:
            dct = int(rng.random() < 0.5)
            w.put(1, dct)
            if dct:
                self.used.add("field_dct")
        if flags & QUANT:
            q = self._qcode()
            w.put(5, q)
            self.qscale = self._qscale(q)
        if mode == "zero":
            self.last_mv[0] = [[0, 0], [0, 0]]
            self.used.add("zero")
        else:
            for d in (0, 1):
                if dirs >> d & 1:
                    self._write_vectors(w, mode, d, plan[d])
        self.last_dc = [128 << self.pic.dc_precision] * 3
        if cbp:
            w.code(t.CBP[cbp])
            for n in range(6):
                if cbp >> (5 - n) & 1:
                    self._inter_block(w)
        self.prev = (flags, 1 if mode == "zero" else dirs)
        if self.kind == B and dirs == 3:
            self.used.add("bidirectional")

    def _plan(self, mode: str, dirs: int, row: int, col: int):
        """Each direction's vectors for ``mode``, inside the reference, or None."""
        out = [None, None]
        if mode == "zero":
            return out
        for d in (0, 1):
            if not dirs >> d & 1:
                continue
            if mode == "frame":
                v = self._vector(row, col, -1, 16)
                if v is None:
                    return None
                out[d] = v
            elif mode == "field" and not self.field:
                parts = []
                for _ in (0, 1):
                    sel = int(self.rng.integers(2))
                    v = self._vector(row, col, sel, 8)
                    if v is None:
                        return None
                    parts.append((sel, *v))
                out[d] = parts
            elif mode == "field":
                sel = self._select(d)
                v = self._vector(row, col, sel, 16)
                if v is None:
                    return None
                out[d] = [(sel, *v)]
            elif mode == "16x8":
                parts = []
                for i in (0, 1):
                    sel = self._select(d)
                    v = self._vector(row, col, sel, 8, top=16 * row + 8 * i)
                    if v is None:
                        return None
                    parts.append((sel, *v))
                out[d] = parts
            else:
                out[d] = self._dual_prime(row, col)
                if out[d] is None:
                    return None
        return out

    def _select(self, d: int) -> int:
        """A field select: a P-field with no earlier reference predicts from
        the other field of its own frame only."""
        if self.no_ref:
            return 1 - self.parity
        return int(self.rng.integers(2))

    def _dual_prime(self, row: int, col: int):
        """(x, y, dmv x, dmv y) whose derived vectors all stay inside."""
        pic = self.pic
        for _ in range(40):
            x, y = (int(v) for v in self.rng.integers(-6, 7, 2))
            dx, dy = (int(v) for v in self.rng.integers(-1, 2, 2))
            if self.field:
                top = self.structure == TOP
                x2 = ((x + (x > 0)) >> 1) + dx
                y2 = ((y + (y > 0)) >> 1) + dy + (-1 if top else 1)
                if (self._inside(row, col, x, y, self.parity, 16)
                        and self._inside(row, col, x2, y2, 1 - self.parity, 16)):
                    return (x, y, dx, dy)
            else:
                m = 1 if pic.tff else 3
                v2 = (((x * m + (x > 0)) >> 1) + dx, ((y * m + (y > 0)) >> 1) + dy - 1)
                v3 = (((x * (4 - m) + (x > 0)) >> 1) + dx, ((y * (4 - m) + (y > 0)) >> 1) + dy + 1)
                if all(self._inside(row, col, a, b, s, 8)
                       for (a, b), s in (((x, y), 0), ((x, y), 1), (v2, 1), (v3, 0))):
                    return (x, y, dx, dy)
        return None

    def _write_vectors(self, w: Bits, mode: str, d: int, vs) -> None:
        lm = self.last_mv[d]
        if mode == "frame":
            x, y = vs
            self._motion(w, x, lm[0][0])
            self._motion(w, y, lm[0][1])
            lm[0] = [x, y]
            lm[1] = [x, y]
        elif mode == "field" and not self.field:
            for j, (sel, x, y) in enumerate(vs):
                w.put(1, sel)
                self._motion(w, x, lm[j][0])
                self._motion(w, y, lm[j][1] >> 1)
                lm[j] = [x, 2 * y]
        elif mode == "field":
            sel, x, y = vs[0]
            w.put(1, sel)
            self._motion(w, x, lm[0][0])
            self._motion(w, y, lm[0][1])
            lm[0] = [x, y]
            lm[1] = [x, y]
        elif mode == "16x8":
            for j, (sel, x, y) in enumerate(vs):
                w.put(1, sel)
                self._motion(w, x, lm[j][0])
                self._motion(w, y, lm[j][1])
                lm[j] = [x, y]
        else:
            x, y, dx, dy = vs
            shift = 0 if self.field else 1
            self._motion(w, x, lm[0][0])
            self._dmv(w, dx)
            self._motion(w, y, lm[0][1] >> shift)
            self._dmv(w, dy)
            lm[0] = [x, y << shift]
            lm[1] = [x, y << shift]

    # ------------------------------------------------------------ blocks

    def _intra_mb(self, w: Bits, row: int, col: int, quant: bool) -> None:
        t, rng = self.t, self.rng
        codes = t.MB_ITYPE if self.kind == I else (t.MB_PTYPE if self.kind == P else t.MB_BTYPE)
        flags = INTRA | (QUANT if quant else 0)
        table = (t.ITYPE_FLAGS if self.kind == I else
                 t.PTYPE_FLAGS if self.kind == P else t.BTYPE_FLAGS)
        w.code(codes[table.index(flags)])
        dct = 0
        if not self.field and not self.pic.fpfd:
            dct = int(rng.random() < 0.5)
            w.put(1, dct)
            if dct:
                self.used.add("field_dct")
        if quant:
            q = self._qcode()
            w.put(5, q)
            self.qscale = self._qscale(q)
        if self.pic.concealment:  # a vector for concealment, which the decoder only predicts from
            if self.field:
                w.put(1, int(rng.integers(2)))
            x, y = (int(v) for v in rng.integers(-20, 21, 2))
            self._motion(w, x, self.last_mv[0][0][0])
            self._motion(w, y, self.last_mv[0][0][1])
            self.last_mv[0] = [[x, y], [x, y]]
            w.put(1, 1)
            self.used.add("concealment")
        else:
            self.last_mv = [[[0, 0], [0, 0]], [[0, 0], [0, 0]]]
        y, cb, cr = self.src
        luma = y[16 * row:16 * row + 16, 16 * col:16 * col + 16]
        if dct:
            luma = np.concatenate([luma[0::2], luma[1::2]])
        blocks = [luma[:8, :8], luma[:8, 8:], luma[8:, :8], luma[8:, 8:],
                  cb[8 * row:8 * row + 8, 8 * col:8 * col + 8],
                  cr[8 * row:8 * row + 8, 8 * col:8 * col + 8]]
        for n, blk in enumerate(blocks):
            self._intra_block(w, n, blk)
        self.prev = (INTRA, 0)
        self.used.add("intra")

    def _intra_block(self, w: Bits, n: int, blk: np.ndarray) -> None:
        t = self.t
        comp = 0 if n < 4 else n - 3
        coef = fdct(np.asarray(blk, np.float64))
        shift = 3 - self.pic.dc_precision
        dc = int(np.clip(np.rint(coef[0, 0] / (1 << shift)), 0, (256 << self.pic.dc_precision)
                         - 1))
        diff = dc - self.last_dc[comp]
        self.last_dc[comp] = dc
        size = abs(diff).bit_length()
        if comp == 0:
            w.put(int(t.DC_LUMA_BITS[size]), int(t.DC_LUMA_CODE[size]))
        else:
            w.put(int(t.DC_CHROMA_BITS[size]), int(t.DC_CHROMA_CODE[size]))
        if size:
            w.put(size, diff if diff > 0 else diff + (1 << size) - 1)
        matrix = t.INTRA_MATRIX
        scan = self.scan[self.pic.alternate]
        levels = []
        for i in range(1, 64):
            j = scan[i]
            lv = int(np.rint(coef.flat[j] * 16 / (self.qscale * int(matrix[j]))))
            levels.append(max(-255, min(255, lv)))
        table = t.DCT_B15 if self.pic.intra_vlc else t.DCT_B14
        if self.pic.intra_vlc:
            self.used.add("b15")
        self._run_levels(w, levels, table, first=False)

    def _inter_block(self, w: Bits) -> None:
        rng = self.rng
        levels = [0] * 64
        for _ in range(int(rng.integers(1, 5))):
            levels[int(rng.integers(0, 64 if rng.random() < 0.3 else 10))] = \
                int(rng.choice([-3, -2, -1, 1, 2, 3]))
        if not any(levels):
            levels[0] = 1
        self._run_levels(w, levels, self.t.DCT_B14, first=True)

    def _run_levels(self, w: Bits, levels, table, first: bool) -> None:
        """Run/level codes of ``levels`` (scan order) and the end of block; a
        non-intra block's first (0, +-1) as '1s'."""
        run = 0
        for lv in levels:
            if lv == 0:
                run += 1
                continue
            k = self.b14.get((run, abs(lv)))
            if first and run == 0 and abs(lv) == 1:
                w.put(2, 2 | int(lv < 0))
            elif k is None:
                w.code(table[111])
                w.put(6, run)
                w.put(12, lv & 0xFFF)
            else:
                w.code(table[k])
                w.put(1, int(lv < 0))
            run, first = 0, False
        w.code(table[112])


# ------------------------------------------------------------ containers

def frames_of(es: bytes) -> list[bytes]:
    """The stream cut into frames: a frame picture or a field pair each, the
    sequence and GOP headers in front kept with it."""
    out, cur, fields, seen = [], b"", 0, False
    for u in mf.units(es):
        f = mf.parse_header(u)
        if u[3] in (0xB3, 0xB8) and seen and fields == 0:
            out.append(cur)
            cur, seen = b"", False
        if f is not None and f["kind"] == "picture_extension":
            if f["picture_structure"] == 3:
                fields = 0
            else:
                fields = (fields + 1) % 2
        if u[3] == 0x00:
            if seen and fields == 0:
                out.append(cur)
                cur = b""
            seen = True
        cur += u
    if cur:
        out.append(cur)
    return out


def _ts90(t: float) -> int:
    return int(round(t * 90000))


def _stamp(value: int, marker: int) -> bytes:
    return bytes([(marker << 4) | ((value >> 29) & 0x0E) | 1, (value >> 22) & 0xFF,
                  ((value >> 14) & 0xFE) | 1, (value >> 7) & 0xFF, ((value << 1) & 0xFE) | 1])


def pes(data: bytes, pts: int | None, dts: int | None, bounded: bool = True) -> bytes:
    """A video PES packet (stream 0xE0) in the MPEG-2 form."""
    if pts is None:
        head = b"\x80\x00\x00"
    elif dts is None or dts == pts:
        head = b"\x80\x80\x05" + _stamp(pts, 2)
    else:
        head = b"\x80\xc0\x0a" + _stamp(pts, 3) + _stamp(dts, 1)
    size = len(head) + len(data) if bounded else 0
    return b"\x00\x00\x01\xe0" + struct.pack(">H", size) + head + data


def timestamps(frames: list[bytes], fields_of, rate: tuple[int, int], start: float = 0.5):
    """Each frame's (PTS, DTS) in 90 kHz ticks (DTS None where it equals the
    PTS: B-frames): display times by the frames' fields (``fields_of(d)``:
    2, or 3 for a frame that repeats one, by display index d) at the field
    rate in display order (the temporal references); decoding times the
    same sums in coded order, a frame ahead of display."""
    gops = [i for i, d in enumerate(frames) if b"\x00\x00\x01\xb8" in d] + [len(frames)]
    kind, display = [], []
    for g in range(len(gops) - 1):
        for i in range(gops[g], gops[g + 1]):
            f = mf.parse_header(next(u for u in mf.units(frames[i]) if u[3] == 0))
            kind.append(f["type"])
            display.append(gops[g] + f["temporal_reference"])
    field = 90000 * rate[1] / (2 * rate[0])
    shown = {d: sum(fields_of(k) for k in range(d)) for d in range(len(frames))}
    out = []
    for i in range(len(frames)):
        pts = round((start * 90000) + (shown[display[i]] + 3) * field)
        dts = round((start * 90000) + sum(fields_of(display[k]) for k in range(i)) * field)
        out.append((pts, None if kind[i] == B or dts >= pts else dts))
    return out


def program_stream(path: Path, es: bytes, stamps, pack: int = 2048, frames=None) -> None:
    """``es`` in 2048-byte packs, each an MPEG-2 pack header and one PES
    packet; the first frame that starts in a pack gives it its stamps
    (``frames``: ``es`` cut by ``frames_of``, where the caller has it)."""
    frames = frames_of(es) if frames is None else frames
    starts, at = [], 0
    for data in frames:
        starts.append(at)
        at += len(data)
    out, pos, k, scr = bytearray(), 0, 0, 0
    while pos < len(es):
        room = pack - 14 - 6 - 13
        end = min(len(es), pos + room)
        pts = dts = None
        while k < len(starts) and starts[k] < end:
            if starts[k] >= pos and pts is None:
                pts, dts = stamps[k]
            k += 1
        body = pes(es[pos:end], pts, dts)
        w = Bits()  # an MPEG-2 pack header: SCR, its extension, the mux rate, no stuffing
        for n, v in ((2, 1), (3, scr >> 30), (1, 1), (15, scr >> 15), (1, 1), (15, scr),
                     (1, 1), (9, 0), (1, 1), (22, 25200), (2, 3), (5, 31), (3, 0)):
            w.put(n, v)
        head = b"\x00\x00\x01\xba" + w.bytes()
        packet = head + body
        if len(packet) < pack and end == len(es):  # padding to the pack's size
            pad = pack - len(packet)
            if pad >= 6:
                packet += b"\x00\x00\x01\xbe" + struct.pack(">H", pad - 6) + b"\xff" * (pad - 6)
        out += packet
        pos = end
        scr += 300 * 90
    out += b"\x00\x00\x01\xb9"
    path.write_bytes(bytes(out))


def long_program_stream(path: Path, es: bytes, copies: int, rate=(25, 1)) -> None:
    """``es`` (frames at ``rate`` that repeat no field, from a sequence
    header on) written ``copies`` times over as one program stream whose
    stamps run on: a stream of minutes from a clip of a second, to time a
    stream's open."""
    frames = frames_of(es)
    base = timestamps(frames, lambda d: 2, rate)
    period = len(frames) * 90000 * rate[1] / rate[0]
    stamps = [(round(pts + c * period), None if dts is None else round(dts + c * period))
              for c in range(copies) for pts, dts in base]
    program_stream(path, b"".join(frames) * copies, stamps, frames=frames * copies)


def _crc32(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b << 24
        for _ in range(8):
            crc = (crc << 1) ^ 0x04C11DB7 if crc & 0x80000000 else crc << 1
            crc &= 0xFFFFFFFF
    return crc


def _section(table: bytes) -> bytes:
    return table + struct.pack(">I", _crc32(table))


def transport_stream(path: Path, es: bytes, stamps, m2ts: bool = False) -> None:
    """A transport stream of one program: PAT, PMT (MPEG-2 video on PID
    0x100), and a PES packet per frame (unbounded, as FFmpeg's muxer writes
    video) stamped with its PTS and DTS; 192-byte packets with a 4-byte
    time code in front where ``m2ts``."""
    pat = _section(b"\x00\xb0\x0d\x00\x01\xc1\x00\x00" + b"\x00\x01\xf0\x00")
    pmt = _section(b"\x02\xb0\x12\x00\x01\xc1\x00\x00\xe1\x00\xf0\x00"
                   + b"\x02\xe1\x00\xf0\x00")
    counters = {0: 0, 0x1000: 0, 0x100: 0}
    out = bytearray()

    def packet(pid: int, payload: bytes, start: bool) -> bytes:
        cc = counters[pid]
        counters[pid] = (cc + 1) & 15
        head = bytes([0x47, (0x40 if start else 0) | (pid >> 8), pid & 0xFF])
        if len(payload) >= 184:
            return head + bytes([0x10 | cc]) + payload[:184]
        fill = 184 - len(payload)
        if fill == 1:
            adapt = b"\x00"
        else:
            adapt = bytes([fill - 1, 0]) + b"\xff" * (fill - 2)
        return head + bytes([0x30 | cc]) + adapt + payload

    def put(pid: int, data: bytes) -> None:
        first = True
        while data or first:
            chunk = data[:184]
            p = packet(pid, chunk, first)
            out.extend((b"\x00\x00\x00\x00" if m2ts else b"") + p)
            data = data[len(chunk):]
            first = False

    for k, data in enumerate(frames_of(es)):
        if k % 8 == 0:
            put(0, b"\x00" + pat)
            put(0x1000, b"\x00" + pmt)
        pts, dts = stamps[k]
        put(0x100, pes(data, pts, dts, bounded=False))
    path.write_bytes(bytes(out))


def avi(path: Path, es: bytes, width: int, height: int, fps: int) -> None:
    from make_video_fixtures import write_avi

    write_avi(path, frames_of(es), width, height, fps, fourcc=b"mpg2")


def matroska(path: Path, es: bytes, width: int, height: int, fps: float) -> None:
    from make_mkv_fixtures import write_webm

    write_webm(path, frames_of(es), width, height, default_duration=round(1e9 / fps),
               doctype="matroska", codec_id="V_MPEG2")


# ----------------------------------------------------------------- plans

def cv2_sequence(width: int, height: int, fps: float, tmp: Path) -> tuple[bytes, bytes]:
    """The sequence header and extension cv2's writer gives a clip of that
    size and rate."""
    clip = tmp / f"seq_{width}x{height}_{fps}.avi"
    mf.write(clip, np.zeros((3, height, width, 3), np.uint8), fps, "MPG2")
    from v2e2v_tpu_torch.utils.avi import AviFile

    es = next(iter(AviFile(str(clip)).frames()))
    us = mf.units(es)
    return us[0], us[1]


def gop_plan(kinds: str, structure, rng, dmv: bool = True, first: bool = True,
             **kw) -> list[Picture]:
    """A GOP in coded order from its display order (``kinds``, e.g.
    'IBBPBBP'); each picture's structure from ``structure(i)`` (a
    ``Picture.structure``, or 'IP' / 'IPb' for an I/P field pair top or
    bottom field first); ``first`` where the GOP starts the stream (its I/P
    pair's P-field then has no earlier reference)."""
    refs = [i for i, k in enumerate(kinds) if k != "B"]
    out = []
    prev_ref = None
    for r in refs:
        # the B-pictures before this reference in display order come after it
        group = [r] + [i for i in range(prev_ref + 1 if prev_ref is not None else 0, r)
                       if kinds[i] == "B"]
        for i in group:
            s = structure(i)
            kind = {"I": I, "P": P, "B": B}[kinds[i]]
            pair = s in ("IP", "IPb")
            if pair:
                s, kind = (TOP if s == "IP" else BOTTOM), (I, P)
            adjacent = prev_ref is not None and r == prev_ref + 1
            out.append(Picture(kind, s, temporal=i, dmv=dmv and kinds[i] == "P" and adjacent
                               and i == r, no_reference=pair and first, **kw))
        prev_ref = r
    trailing = [i for i in range(prev_ref + 1, len(kinds)) if kinds[i] == "B"]
    for i in trailing:  # B-pictures after the last reference: an open end
        raise ValueError(f"a GOP ending in B-pictures ({kinds})")
    return out


PULLDOWN = ((1, 1), (0, 0), (0, 1), (1, 0))  # 3:2: (top_field_first, repeat_first_field)


def telecine(plan) -> list:
    """``plan``'s frame pictures made soft-telecined film: progressive frames
    (``progressive_frame`` 1, frame prediction and DCT) flagged 3:2 by their
    display index, as an NTSC film DVD codes 24000/1001 fps at 30000/1001."""
    base = 0
    for gop in plan:
        for pic in gop:
            d = base + pic.temporal
            pic.structure, pic.progressive_frame, pic.fpfd = FRAME, 1, 1
            pic.tff, pic.rff = PULLDOWN[d % 4]
        base += len(gop)
    return plan


def fields_of(plan):
    """Each display index's fields: 3 where its picture repeats one."""
    out, base = {}, 0
    for gop in plan:
        for pic in gop:
            out[base + pic.temporal] = 3 if pic.rff else 2
        base += len(gop)
    return out.__getitem__


# ------------------------------------------------------ FFmpeg and cv2

def ffmpeg_planes(path: Path) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Each frame FFmpeg's ``mpeg2video`` decoder gives for the file's video
    packets (one thread), as its Y, Cb, Cr planes: what cv2 converts, where
    it can (``probe_ffmpeg.py``: the libavformat and libavcodec cv2
    bundles, through ctypes)."""
    import probe_ffmpeg

    return probe_ffmpeg.decode(probe_ffmpeg.demux(str(path)), "mpeg2video")


def yuv_sha(planes) -> str:
    return hashlib.sha256(b"".join(np.ascontiguousarray(p).tobytes() for p in planes)).hexdigest()


def cv2_conversion(planes, tmp: Path) -> list[np.ndarray]:
    """cv2's BGR of each frame's planes: an I420 AVI of them read by cv2 (for
    even sizes swscale converts I420 as it converts MPEG-2's 4:2:0)."""
    from make_video_fixtures import write_avi

    h, w = planes[0][0].shape
    path = tmp / "i420_twin.avi"
    write_avi(path, [b"".join(p.tobytes() for p in f) for f in planes], w, h, 25, fourcc=b"I420")
    frames, _, _ = mf.cv2_frames(path)
    return frames


class _Capture:
    """A stand-in for ``cv2.VideoCapture`` of ``frames`` with a clip's fps
    and count: the JAX readers through it read what cv2 would, had it
    converted every frame."""

    def __init__(self, frames, fps, count):
        self.frames, self.fps, self.count, self.open = list(frames), fps, count, True

    def isOpened(self):
        return self.open

    def get(self, prop):
        import cv2

        return {cv2.CAP_PROP_FPS: self.fps, cv2.CAP_PROP_FRAME_COUNT: self.count}[prop]

    def read(self):
        if not self.frames:
            return False, None
        return True, self.frames.pop(0)

    def release(self):
        self.open = False


def jax_records(path: Path, frames, fps: float, count: float) -> dict:
    """What the JAX package's ``VideoReader`` (180x240 quarter) and
    ``VideoSequence`` return over ``frames`` at the clip's fps and count."""
    import cv2

    from v2e2v_tpu.data.manifests import VideoSequence
    from v2e2v_tpu.data.video_readers import VideoReader

    real = cv2.VideoCapture
    cv2.VideoCapture = lambda *a, **k: _Capture(frames, fps, count)
    try:
        reader = VideoReader((720, 960), ds=(0.25, 0.25))
        reader.initialize(str(path))
        pairs = list(VideoSequence(str(path)))
    finally:
        cv2.VideoCapture = real
    full = [p[0] for p in pairs[:1]] + [p[1] for p in pairs]
    return {"frames_read": reader.num_frames, "shape": list(full[0].shape),
            "reader_shape": list(reader.frames[0].shape),
            "timestamps": [float(t) for t in reader.timestamps],
            "reader_sha256": [mf.sha(f) for f in reader.frames],
            "sequence_sha256": [mf.sha(f) for f in full], "reader": np.stack(reader.frames)}


# ----------------------------------------------------------------- clips

def _write(path: Path, es: bytes, plan, size, fps: float, rate) -> None:
    h, w = size
    kind = path.suffix
    if kind in (".vob", ".mpg"):
        program_stream(path, es, timestamps(frames_of(es), fields_of(plan), rate))
    elif kind in (".ts", ".m2ts"):
        transport_stream(path, es, timestamps(frames_of(es), fields_of(plan), rate),
                         m2ts=kind == ".m2ts")
    elif kind == ".avi":
        avi(path, es, w, h, round(fps))
    else:
        matroska(path, es, w, h, fps)


def crafted(out: Path, name: str, size, fps: float, rate, plan_of, seed: int, exts,
            tmp: Path, residual: float = 0.6) -> dict[str, str]:
    """Code ``plan_of(rng)`` from a seeded pan at ``size`` and write it as
    ``name`` + each of ``exts``; returns the clips and what each holds."""
    h, w = size
    rng = np.random.default_rng(seed)
    coder = Coder(w, h, rng, cv2_sequence(w, h, fps, tmp), residual)
    plan = plan_of(rng)
    n = sum(len(g) for g in plan)
    from make_mpeg4_fixtures import pan

    es = coder.stream(plan, pan(np.random.default_rng(seed + 1), h, w, n, (2, 3)))
    for ext in exts:
        _write(out / f"{name}{ext}", es, plan, size, fps, rate)
    return {f"{name}{ext}": sorted(coder.used) for ext in exts}


def patched(out: Path, source: str, name: str) -> None:
    """cv2's clip ``tests/data/mpeg12/<source>`` with 3:2 soft telecine
    patched into its headers: an interlaced sequence, every picture a
    progressive frame, ``repeat_first_field`` and ``top_field_first`` by the
    pulldown cadence of its coded order."""
    def change(f, i):
        if f["kind"] == "sequence_extension":
            f["progressive_sequence"] = 0
        if f["kind"] == "picture_extension":
            f["progressive_frame"] = 1
            f["top_field_first"], f["repeat_first_field"] = PULLDOWN[i % 4]

    data = (ROOT / "tests" / "data" / "mpeg12" / source).read_bytes()
    (out / name).write_bytes(mf.patch_file(data, change))


def write_clips(out: Path, tmp: Path) -> dict[str, list[str]]:
    """Every clip (see the module's notes); the value lists what it holds."""
    clips = {}
    h, w, n, fps = FLAGSHIP
    clips.update(crafted(out, "flagship", (h, w), fps, (25, 1), lambda rng: [gop_plan(
        "IBBPBBPBBPBP", lambda i: "IP" if i == 0 else TOP, rng)], 0, [".vob"], tmp, 0.15))
    clips.update(crafted(out, "fields_tff", SMALL, 25.0, (25, 1), lambda rng: [
        gop_plan("IPPBBP", lambda i: "IP" if i == 0 else TOP, rng),
        gop_plan("IBBPBBP", lambda i: TOP, rng, first=False)], 1,
        [".vob", ".ts", ".m2ts", ".avi", ".mkv"], tmp))
    clips.update(crafted(out, "fields_bff", SMALL, 25.0, (25, 1), lambda rng: [
        gop_plan("IPBBPBBP", lambda i: "IPb" if i == 0 else BOTTOM, rng),
        gop_plan("IPPBBP", lambda i: BOTTOM, rng, first=False)], 2, [".vob", ".avi"], tmp))
    clips.update(crafted(out, "frames", SMALL, 25.0, (25, 1), lambda rng: [
        gop_plan("IPPBBPBBP", lambda i: FRAME, rng)], 3, [".vob", ".avi", ".mkv"], tmp))
    clips.update(crafted(out, "mixed", SMALL, 30000 / 1001, (30000, 1001), lambda rng: [
        gop_plan("IBBPBBPBBP", lambda i: (FRAME, TOP, BOTTOM)[i % 3], rng, concealment=1,
                 intra_vlc=1, alternate=1, q_scale_type=1, dc_precision=1)], 4, [".vob"], tmp))
    clips.update(crafted(out, "telecine", TELECINE, 30000 / 1001, (30000, 1001),
                         lambda rng: telecine([gop_plan("IBBPBBPBBPBBP", lambda i: FRAME, rng),
                                               gop_plan("IBBP", lambda i: FRAME, rng,
                                                        first=False)]),
                         5, [".vob", ".ts"], tmp, 0.15))
    for source, name in (("twin.mpg", "telecine_twin.mpg"), ("twin.vob", "telecine_twin.vob"),
                         ("twin.ts", "telecine_twin.ts"), ("twin.m2ts", "telecine_twin.m2ts"),
                         ("twin.avi", "telecine_twin.avi"), ("twin.mkv", "telecine_twin.mkv"),
                         ("gops.mpg", "telecine_gops.mpg"), ("ntsc.mpg", "telecine_ntsc.mpg")):
        patched(out, source, name)
        clips[name] = ["telecine"]
    return clips


def main() -> None:
    import tempfile

    import cv2

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=ROOT / "tests" / "data" / "mpeg2i")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.seed != 0:
        raise SystemExit("the fixtures are written from seed 0 (each clip's own seed below it)")
    if args.out.exists():
        shutil.rmtree(args.out)
    args.out.mkdir(parents=True)
    manifest, arrays = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        clips = write_clips(args.out, tmp)
        for name, used in clips.items():
            path = args.out / name
            frames, fps, count = mf.cv2_frames(path)
            threaded, _, _ = mf.cv2_frames(path, one_thread=False)
            planes = ffmpeg_planes(path)
            converted = cv2_conversion(planes, tmp)
            if len(frames) != len(planes) or len(threaded) != len(planes):
                raise SystemExit(f"{name}: cv2 reads {len(frames)} frames, FFmpeg decodes "
                                 f"{len(planes)}")
            # cv2 converts a frame FFmpeg flags progressive; one it flags interlaced
            # (field pictures, progressive_frame 0) it returns unconverted
            defined = all(np.array_equal(a, b) for a, b in zip(frames, converted))
            if defined and [mf.sha(f) for f in threaded] != [mf.sha(f) for f in frames]:
                raise SystemExit(f"{name}: cv2's threads give other frames")
            entry = {"fps": fps, "frame_count": count, "holds": used,
                     "cv2_converts": defined, "frames": name.rsplit(".", 1)[0],
                     "yuv_sha256": [yuv_sha(p) for p in planes],
                     "bgr_sha256": [mf.sha(f) for f in converted]}
            rec = jax_records(path, converted, fps, count)
            if defined:  # the JAX readers through cv2 itself read the same
                from v2e2v_tpu.data.video_readers import VideoReader

                reader = VideoReader((720, 960), ds=(0.25, 0.25))
                reader.initialize(str(path))
                assert [mf.sha(f) for f in reader.frames] == rec["reader_sha256"], name
            stack = rec.pop("reader")
            key = entry["frames"]
            if key in arrays and arrays[key].shape != stack.shape:  # fewer frames read: its own
                key = entry["frames"] = name.replace(".", "_")
            if key in arrays and not np.array_equal(arrays[key], stack):
                raise SystemExit(f"{name} differs from the other {key} clips")
            arrays[key] = stack
            entry.update(rec)
            manifest[name] = entry
    np.savez_compressed(args.out / "reader_frames.npz", **arrays)
    (args.out / "manifest.json").write_text(json.dumps(
        {"writer": "scripts/make_mpeg2i_fixtures.py", "seed": args.seed, "cv2": cv2.__version__,
         "clips": manifest}, indent=1) + "\n")
    total = sum(p.stat().st_size for p in args.out.rglob("*") if p.is_file())
    print(f"{len(manifest)} clips, reader_frames.npz and manifest.json under {args.out}: "
          f"{total} bytes")


if __name__ == "__main__":
    main()
