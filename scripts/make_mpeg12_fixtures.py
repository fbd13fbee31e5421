#!/usr/bin/env python3
"""Write the MPEG-1/2 fixtures of the port's video path
(``v2e2v_tpu_torch/utils/mpeg12*.py``, ``mpegps.py``, ``mpegts.py``, the
MPEG-1/2 parts of ``avi.py``, ``mp4.py``, ``mkv.py`` and ``video.py``) and
what the JAX package's readers return for each.

    JAX_PLATFORMS=cpu python scripts/make_mpeg12_fixtures.py [--out tests/data/mpeg12] [--seed 0]

It needs cv2 built with FFmpeg and the JAX package, so it runs where the JAX
package's dependencies are installed, not on the card's machine; the card
checks the port against the records this writes. Every clip is written by
``cv2.VideoWriter`` (FFmpeg's ``mpeg2video`` encoder for ``MPG2``: I-, P-
and B-pictures, a GOP of 12, the first closed and the others open; its
``mpeg1video`` for ``PIM1``: I- and P-pictures) from seeded numpy scenes
(``make_mpeg4_fixtures.pan``):

- ``flagship.mpg``: 12 frames of MPEG-2 at 960x720, 10 fps, a pan of 3 rows
  and -7 columns a frame with sensor noise (the card builds its PNG twin
  from the reader's frames, as for the other flagships);
- ``twin.vob``, ``.ts``, ``.m2ts``, ``.avi``, ``.mkv``, ``.mp4``, ``.mov``
  and ``.mpg``: one 12-frame MPEG-2 clip at 128x96 in every container cv2
  writes it into (MPEG-2 pack headers in the VOB, 192-byte packets in the
  M2TS, ``mpg2`` in the AVI, ``V_MPEG2`` in the MKV, object type 0x61 in the
  MP4, ``m2v1`` in the MOV);
- ``mpeg1.mpg``, ``mpeg1.avi`` and ``mpeg1.mp4``: MPEG-1 at 30 fps;
- ``gops.mpg``: 40 frames at 64x96 (four GOPs, three of them open);
- ``noise.mpg``: 16 noisy frames at 96x128: every coded block pattern,
  intra macroblocks in P-pictures, every direction in B-pictures;
- ``flat.mpg``, ``portrait.mpg`` (96x160), ``ntsc.mpg`` (30000/1001 fps),
  ``small.mpg`` (cv2's 74x48 of a 75x49 frame);
- ``tiny.mpg`` (8x8, 12 frames; cv2 counts 1) and ``short.mpg`` (noisy
  MPEG-1 at 48x32, 12 frames; cv2 counts 10): FFmpeg's estimated counts,
  as are most of the small program streams' (``twin.mpg`` 6, ``flat.mpg``
  1);

and ``manifest.json`` (cv2's version, each clip's codec, fps and frame count
as cv2 reports them, the frames read, the sha256 of each cv2 frame, of each
JAX ``VideoReader`` frame (``ds = (0.25, 0.25)``) and of each JAX
``VideoSequence`` frame) and ``reader_frames.npz`` (the JAX
``VideoReader``'s frames of each distinct scene, and of a clip of it whose
estimated count leaves the reader fewer frames).

The tests use this module's stream tools: ``units`` splits an elementary
stream at its start codes; ``parse_header`` / ``write_header`` read and
write a sequence header, GOP, picture header or extension field by field;
``rewrite`` applies a change to every header of an elementary stream (and
may add a quant matrix or sequence display extension), keeping the slices;
``patch_file`` does the same in place in a container where the lengths
stay; ``reencode_intra`` writes MPEG-2 I-pictures' macroblocks again under
table B-15 and with concealment vectors; ``cut_at_gop`` drops a stream's
first GOP; ``to_avi`` puts a stream into an AVI, one picture a chunk.
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
TWINS = (".vob", ".ts", ".m2ts", ".avi", ".mkv", ".mp4", ".mov", ".mpg")


# --------------------------------------------------------------- bits

class BitReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def u(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3] if self.pos >> 3 < len(self.data) else 0
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v


class BitWriter:
    def __init__(self):
        self.bits: list[int] = []

    def put(self, n: int, v: int) -> None:
        self.bits += [(v >> (n - 1 - k)) & 1 for k in range(n)]

    def bytes(self) -> bytes:
        bits = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(int("".join(map(str, bits[k:k + 8])), 2) for k in range(0, len(bits), 8))


# ------------------------------------------------------ header tools

def units(es: bytes) -> list[bytes]:
    """The elementary stream cut before each start code."""
    at = []
    k = es.find(b"\x00\x00\x01")
    while k >= 0:
        at.append(k)
        k = es.find(b"\x00\x00\x01", k + 3)
    return [es[a:b] for a, b in zip(at, at[1:] + [len(es)])]


def _matrix(r: BitReader) -> list[int]:
    from v2e2v_tpu_torch.utils.mpeg12tables import ZIGZAG

    m = [0] * 64
    for i in range(64):
        m[int(ZIGZAG[i])] = r.u(8)
    return m


def _put_matrix(w: BitWriter, m) -> None:
    from v2e2v_tpu_torch.utils.mpeg12tables import ZIGZAG

    for i in range(64):
        w.put(8, m[int(ZIGZAG[i])])


SEQ_FIELDS = (("width", 12), ("height", 12), ("aspect", 4), ("frame_rate_code", 4),
              ("bit_rate", 18), ("marker", 1), ("vbv_size", 10), ("constrained", 1))
SEQ_EXT_FIELDS = (("ext", 4), ("profile_level", 8), ("progressive_sequence", 1),
                  ("chroma_format", 2), ("width_ext", 2), ("height_ext", 2),
                  ("bit_rate_ext", 12), ("marker", 1), ("vbv_ext", 8), ("low_delay", 1),
                  ("rate_n", 2), ("rate_d", 5))
PIC_EXT_FIELDS = (("ext", 4), ("f00", 4), ("f01", 4), ("f10", 4), ("f11", 4),
                  ("intra_dc_precision", 2), ("picture_structure", 2), ("top_field_first", 1),
                  ("frame_pred_frame_dct", 1), ("concealment_motion_vectors", 1),
                  ("q_scale_type", 1), ("intra_vlc_format", 1), ("alternate_scan", 1),
                  ("repeat_first_field", 1), ("chroma_420_type", 1), ("progressive_frame", 1),
                  ("composite_display", 1))
GOP_FIELDS = (("time_code", 25), ("closed_gop", 1), ("broken_link", 1))


def _fields(r: BitReader, spec) -> dict:
    return {name: r.u(n) for name, n in spec}


def _put_fields(w: BitWriter, spec, f: dict) -> None:
    for name, n in spec:
        w.put(n, f[name])


def parse_header(unit: bytes) -> dict | None:
    """A header unit's fields (``kind``: sequence, sequence_extension,
    picture_extension, gop or picture), or None for slices and the rest."""
    code = unit[3]
    r = BitReader(unit, 32)
    if code == 0xB3:
        f = {"kind": "sequence", **_fields(r, SEQ_FIELDS)}
        f["intra"] = _matrix(r) if r.u(1) else None
        f["inter"] = _matrix(r) if r.u(1) else None
        return f
    if code == 0xB8:
        return {"kind": "gop", **_fields(r, GOP_FIELDS)}
    if code == 0x00:
        f = {"kind": "picture", "temporal_reference": r.u(10), "type": r.u(3),
             "vbv_delay": r.u(16)}
        if f["type"] in (2, 3):
            f["full_pel_f"], f["f_code_f"] = r.u(1), r.u(3)
        if f["type"] == 3:
            f["full_pel_b"], f["f_code_b"] = r.u(1), r.u(3)
        return f
    if code == 0xB5:
        ext = unit[4] >> 4
        if ext == 1:
            return {"kind": "sequence_extension", **_fields(r, SEQ_EXT_FIELDS)}
        if ext == 8:
            return {"kind": "picture_extension", **_fields(r, PIC_EXT_FIELDS)}
    return None


def write_header(f: dict) -> bytes:
    w = BitWriter()
    kind = f["kind"]
    if kind == "sequence":
        _put_fields(w, SEQ_FIELDS, f)
        for m in (f["intra"], f["inter"]):
            w.put(1, m is not None)
            if m is not None:
                _put_matrix(w, m)
        code = 0xB3
    elif kind == "gop":
        _put_fields(w, GOP_FIELDS, f)
        code = 0xB8
    elif kind == "picture":
        w.put(10, f["temporal_reference"])
        w.put(3, f["type"])
        w.put(16, f["vbv_delay"])
        if f["type"] in (2, 3):
            w.put(1, f["full_pel_f"])
            w.put(3, f["f_code_f"])
        if f["type"] == 3:
            w.put(1, f["full_pel_b"])
            w.put(3, f["f_code_b"])
        w.put(1, 0)  # extra_bit_picture
        code = 0x00
    elif kind == "sequence_extension":
        _put_fields(w, SEQ_EXT_FIELDS, f)
        code = 0xB5
    else:
        _put_fields(w, PIC_EXT_FIELDS, f)
        code = 0xB5
    return bytes([0, 0, 1, code]) + w.bytes()


def quant_extension(intra=None, inter=None, chroma_intra=None, chroma_inter=None) -> bytes:
    w = BitWriter()
    w.put(4, 3)
    for m in (intra, inter, chroma_intra, chroma_inter):
        w.put(1, m is not None)
        if m is not None:
            _put_matrix(w, m)
    return b"\x00\x00\x01\xb5" + w.bytes()


def display_extension(matrix_coefficients: int | None, width: int, height: int) -> bytes:
    w = BitWriter()
    w.put(4, 2)
    w.put(3, 5)  # video_format: unspecified
    w.put(1, matrix_coefficients is not None)
    if matrix_coefficients is not None:
        w.put(8, 1)
        w.put(8, 1)
        w.put(8, matrix_coefficients)
    w.put(14, width)
    w.put(1, 1)
    w.put(14, height)
    return b"\x00\x00\x01\xb5" + w.bytes()


def rewrite(es: bytes, change) -> bytes:
    """``es`` with ``change(fields, index)`` applied to each header: it edits
    the fields in place and may return bytes to insert after that header
    (an extension); ``index`` counts headers of the same kind."""
    out = []
    seen: dict[str, int] = {}
    for u in units(es):
        f = parse_header(u)
        if f is None:
            out.append(u)
            continue
        i = seen.get(f["kind"], 0)
        seen[f["kind"]] = i + 1
        extra = change(f, i)
        out.append(write_header(f))
        if extra:
            out.append(extra)
    return b"".join(out)


def patch_file(data: bytes, change) -> bytes:
    """``change`` applied to each header found in a container file's bytes
    (a program stream's, say), in place: every header must keep its length
    (flags flipped, sizes of the same width); a header a PES packet cuts is
    left as it is."""
    out = bytearray(data)
    seen: dict[str, int] = {}
    k = data.find(b"\x00\x00\x01")
    while k >= 0:
        if data[k + 3] in (0x00, 0xB3, 0xB5, 0xB8):
            end = data.find(b"\x00\x00\x01", k + 3)
            unit = data[k:end if end >= 0 else len(data)]
            f = parse_header(unit)
            if f is not None:
                i = seen.get(f["kind"], 0)
                seen[f["kind"]] = i + 1
                change(f, i)
                new = write_header(f)
                if len(new) <= len(unit):  # the trailing bits of the last byte kept
                    head = bytearray(unit[:len(new)])
                    nbits = _header_bits(f)
                    for b in range(nbits):
                        byte, bit = divmod(b, 8)
                        mask = 0x80 >> bit
                        head[byte] = (head[byte] & ~mask) | (new[byte] & mask)
                    out[k:k + len(new)] = head
        k = data.find(b"\x00\x00\x01", k + 3)
    return bytes(out)


def _header_bits(f: dict) -> int:
    """The bits of a header that ``patch_file`` writes back."""
    body = write_header(f)
    kind = f["kind"]
    spec = {"gop": GOP_FIELDS, "sequence_extension": SEQ_EXT_FIELDS,
            "picture_extension": PIC_EXT_FIELDS}.get(kind)
    if spec is not None:
        return 32 + sum(n for _, n in spec)
    if kind == "picture":
        return 32 + 29 + 4 * (f["type"] in (2, 3)) + 4 * (f["type"] == 3)
    return 8 * len(body) - 8  # a sequence header: up to its last whole byte


def pictures(es: bytes) -> list[bytes]:
    """The stream cut into packets of one picture each, the sequence and GOP
    headers in front of a picture kept with it."""
    out, cur, has_picture = [], b"", False
    for u in units(es):
        if u[3] in (0xB3, 0xB8, 0x00) and has_picture:
            out.append(cur)
            cur, has_picture = b"", False
        cur += u
        has_picture = has_picture or u[3] == 0x00
    if cur:
        out.append(cur)
    return out


def cut_at_gop(es: bytes, gop: int = 1) -> bytes:
    """The stream from its ``gop``-th GOP header on, the first sequence header
    (and its extension) kept in front."""
    us = units(es)
    head = [u for u in us[:2] if u[3] == 0xB3 or (u[3] == 0xB5 and u[4] >> 4 == 1)]
    gops = [k for k, u in enumerate(us) if u[3] == 0xB8]
    start = gops[gop]
    if us[start - 1][3] == 0xB5 and start >= 2 and us[start - 2][3] == 0xB3:
        start -= 2
    return b"".join(head + us[start:]) if us[start][3] != 0xB3 else b"".join(us[start:])


def to_avi(path: Path, es: bytes, width: int, height: int, fps: int,
           fourcc: bytes = b"mpg2") -> None:
    from make_video_fixtures import write_avi

    write_avi(path, pictures(es), width, height, fps, fourcc=fourcc)


def program_stream_es(path: Path) -> bytes:
    from v2e2v_tpu_torch.utils.mpegps import ProgramStream

    return ProgramStream(str(path)).es


# -------------------------------------------- re-writing macroblocks

def _vlc_codes(table) -> dict:
    return {(int(c), int(n)): i for i, (c, n) in enumerate(table)}


def _read_vlc(r: BitReader, codes: dict, maxlen: int) -> int:
    code = 0
    for n in range(1, maxlen + 1):
        code = (code << 1) | r.u(1)
        if (code, n) in codes:
            return codes[(code, n)]
    raise ValueError(f"no code at bit {r.pos}")


def _dct_maps():
    from v2e2v_tpu_torch.utils import mpeg12tables as t

    pairs = [(int(r), int(lv)) for r, lv in zip(t.DCT_RUN, t.DCT_LEVEL)]
    return t, pairs


def reencode_intra(es: bytes, b15: bool = True, concealment: bool = False,
                   seed: int = 0) -> bytes:
    """An MPEG-2 stream whose I-pictures' macroblocks are written again:
    their AC coefficients under table B-15 (``intra_vlc_format`` 1) where
    ``b15``, and, where ``concealment``, a random concealment vector in every
    macroblock (``concealment_motion_vectors`` 1); the decoded pictures
    stay the same. P- and B-pictures are kept as they are."""
    t, pairs = _dct_maps()
    rng = np.random.default_rng(seed)
    b14 = _vlc_codes(t.DCT_B14)
    out = []
    intra = False
    ext_seen = False
    for u in units(es):
        f = parse_header(u)
        if f is not None and f["kind"] == "picture":
            intra, ext_seen = f["type"] == 1, False
        if f is not None and f["kind"] == "picture_extension" and intra:
            fcode = (f["f00"], f["f01"])
            f["intra_vlc_format"] = int(b15)
            f["concealment_motion_vectors"] = int(concealment)
            ext = f
            out.append(write_header(f))
            ext_seen = True
            continue
        if intra and ext_seen and 0x01 <= u[3] <= 0xAF:
            out.append(_reencode_slice(u, ext, fcode, t, pairs, b14, b15, concealment, rng))
            continue
        out.append(u)
    return b"".join(out)


def _reencode_slice(u, ext, fcode, t, pairs, b14, b15, concealment, rng) -> bytes:
    r = BitReader(u, 32)
    w = BitWriter()
    q = r.u(5)
    w.put(5, q)
    while r.u(1):
        w.put(1, 1)
        w.put(8, r.u(8))
    w.put(1, 0)
    addr = _vlc_codes(t.MB_ADDR_INCR)
    dc_codes = (_vlc_codes(zip(t.DC_LUMA_CODE, t.DC_LUMA_BITS)),
                _vlc_codes(zip(t.DC_CHROMA_CODE, t.DC_CHROMA_BITS)))
    table = t.DCT_B15 if b15 else t.DCT_B14
    index = {p: i for i, p in enumerate(pairs)}
    first = True
    while True:
        # the address increment: 1 after the first macroblock
        inc = _read_vlc(r, addr, 11)
        if inc == 35:
            break
        code, n = (int(v) for v in t.MB_ADDR_INCR[inc])
        w.put(n, code)
        if not first and inc != 0:
            raise ValueError("a skipped macroblock in an I-picture")
        first = False
        quant = r.u(1) == 0
        if quant:
            r.u(1)
            w.put(2, 1)
            w.put(5, r.u(5))
        else:
            w.put(1, 1)
        if concealment:  # motion codes with their residual bits, then the marker
            for axis in (0, 1):
                mc = int(rng.integers(0, 3))
                code, n = (int(v) for v in t.MOTION[mc])
                w.put(n, code)
                if mc:
                    w.put(1, int(rng.integers(2)))
                    if fcode[axis] > 1:
                        w.put(fcode[axis] - 1, int(rng.integers(1 << (fcode[axis] - 1))))
            w.put(1, 1)
        for blk in range(6):
            size = _read_vlc(r, dc_codes[blk >= 4], 10)
            pair = ((t.DC_LUMA_CODE[size], t.DC_LUMA_BITS[size]) if blk < 4
                    else (t.DC_CHROMA_CODE[size], t.DC_CHROMA_BITS[size]))
            code, n = (int(v) for v in pair)
            w.put(n, code)
            if size:
                w.put(size, r.u(size))
            while True:  # AC coefficients by B-14 (as cv2 writes them), out by ``table``
                sym = _read_vlc(r, b14, 16)
                if sym == 112:
                    code, n = (int(v) for v in table[112])
                    w.put(n, code)
                    break
                if sym == 111:
                    run, level = r.u(6), r.u(12)
                    level = level - 4096 if level >= 2048 else level
                else:
                    run, level = pairs[sym]
                    if r.u(1):
                        level = -level
                k = index.get((run, abs(level)))
                if k is None:
                    code, n = (int(v) for v in table[111])
                    w.put(n, code)
                    w.put(6, run)
                    w.put(12, level & 0xFFF)
                else:
                    code, n = (int(v) for v in table[k])
                    w.put(n, code)
                    w.put(1, int(level < 0))
    return u[:4] + w.bytes()


def frame_modes(es: bytes, motion=(1, 0), dct: int = 0) -> bytes:
    """An MPEG-2 stream whose pictures say ``frame_pred_frame_dct`` 0, each
    coded macroblock given the modes that then follow its type: frame
    motion (``frame_motion_type`` '10') where it has vectors and frame DCT
    (``dct_type`` '0') where it has blocks; ``motion`` and ``dct`` other
    bits there (field motion '01', dual prime '11', motion type '00',
    field DCT 1). The places come from the port's
    own parser (``PictureSyntax.marks``), so a fault there shows as a
    mismatch with cv2; the decoded pictures stay the same."""
    from v2e2v_tpu_torch.utils.mpeg12dec import Mpeg12Decoder
    from v2e2v_tpu_torch.utils.mpeg12tables import (MB_FORWARD, MB_BACKWARD, MB_INTRA,
                                                    MB_PATTERN, MB_ZERO_MV)

    dec = Mpeg12Decoder("<frame_modes>")
    dec.syntax_log = []
    dec.decode(es)
    dec.flush()
    log = iter(dec.syntax_log)
    out, syn, slice_no = [], None, 0
    for u in units(es):
        f = parse_header(u)
        if f is not None and f["kind"] == "picture":
            syn, slice_no = next(log), 0
        elif f is not None and f["kind"] == "picture_extension":
            f["frame_pred_frame_dct"] = 0
            out.append(write_header(f))
            continue
        elif syn is not None and 0x01 <= u[3] <= 0xAF:
            slice_no += 1
            marks = [(pos, fl) for s, pos, fl in syn.marks if s == slice_no]
            bits = [(b >> (7 - k)) & 1 for b in u[4:] for k in range(8)]
            new, at = [], 0
            for pos, fl in marks:
                new += bits[at:pos]
                at = pos
                if fl & MB_INTRA or fl & MB_ZERO_MV:
                    new.append(dct)
                elif fl & (MB_FORWARD | MB_BACKWARD):
                    new += list(motion)
                    if fl & MB_PATTERN:
                        new.append(dct)
            new += bits[at:]
            new += [0] * (-len(new) % 8)
            out.append(u[:4] + bytes(int("".join(map(str, new[k:k + 8])), 2)
                                     for k in range(0, len(new), 8)))
            continue
        out.append(u)
    return b"".join(out)


# ----------------------------------------------------------------- clips

def write(path: Path, frames: np.ndarray, fps: float, fourcc: str = "MPG2") -> None:
    from make_mpeg4_fixtures import write as write_clip

    write_clip(path, frames, fps, fourcc)


def noise_frames(rng: np.random.Generator, h: int, w: int, n: int) -> np.ndarray:
    """A pan with noisy squares over it: intra, forward, backward and
    bidirectional macroblocks, skips and coded patterns of many kinds."""
    from make_mpeg4_fixtures import pan

    fr = pan(rng, h, w, n, (2, 3)).astype(np.int16)
    for k in range(n):
        for _ in range(8):
            y, x = rng.integers(0, h - 8), rng.integers(0, w - 8)
            s = int(rng.choice([4, 8, 16]))
            fr[k, y:y + s, x:x + s] = rng.integers(0, 256, (min(s, h - y), min(s, w - x), 3))
        fr[k] += rng.normal(0, 4, fr[k].shape).astype(np.int16)
    return np.clip(fr, 0, 255).astype(np.uint8)


def write_clips(out: Path, rng: np.random.Generator) -> dict[str, str]:
    """Every clip; the value names the frames' key in ``reader_frames.npz``."""
    from make_mpeg4_fixtures import pan

    h, w, n, fps = FLAGSHIP
    frames = pan(rng, h, w, n, (3, -7)).astype(np.int16)
    frames = np.clip(frames + rng.normal(0, 1.2, frames.shape), 0, 255).astype(np.uint8)
    write(out / "flagship.mpg", frames, fps)
    clips = {"flagship.mpg": "flagship"}
    twin = pan(rng, 96, 128, 12, (1, 2))
    for ext in TWINS:
        write(out / f"twin{ext}", twin, 10.0)
        clips[f"twin{ext}"] = "twin"
    one = pan(rng, 64, 80, 10, (1, -1))
    for ext in (".mpg", ".avi", ".mp4"):
        write(out / f"mpeg1{ext}", one, 30.0, "PIM1")
        clips[f"mpeg1{ext}"] = "mpeg1"
    write(out / "gops.mpg", pan(rng, 64, 96, 40, (1, 2)), 25.0)
    # its own generator: seed 3 is the first whose clip reaches all 63 coded
    # block patterns (the tests assert it)
    write(out / "noise.mpg", noise_frames(np.random.default_rng(3), 96, 128, 16), 10.0)
    write(out / "flat.mpg", np.full((6, 64, 80, 3), (40, 120, 200), np.uint8), 10.0)
    write(out / "portrait.mpg", pan(rng, 160, 96, 7, (2, 1)), 10.0)
    write(out / "ntsc.mpg", pan(rng, 64, 80, 8, (1, -1)), 30000 / 1001)
    write(out / "small.mpg", pan(rng, 49, 75, 6, (1, -2)), 10.0)
    write(out / "tiny.mpg", pan(rng, 8, 8, 12, (0, 1)), 10.0)
    write(out / "short.mpg", noise_frames(np.random.default_rng(0), 32, 48, 12), 30.0, "PIM1")
    for name in ("gops.mpg", "noise.mpg", "flat.mpg", "portrait.mpg", "ntsc.mpg", "small.mpg",
                 "tiny.mpg", "short.mpg"):
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
    ap.add_argument("--out", type=Path, default=ROOT / "tests" / "data" / "mpeg12")
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
        entry = {"fps": fps, "frame_count": count, "frames": key,
                 "codec": "mpeg1" if name.startswith(("mpeg1", "short")) else "mpeg2",
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
        if key in arrays and arrays[key].shape != stack.shape:  # fewer frames read: its own
            key = entry["frames"] = name.replace(".", "_")
        if key in arrays:
            assert np.array_equal(arrays[key], stack), f"{name} differs from {key}"
        arrays[key] = stack
        manifest[name] = entry
    np.savez_compressed(args.out / "reader_frames.npz", **arrays)
    (args.out / "manifest.json").write_text(json.dumps(
        {"writer": "scripts/make_mpeg12_fixtures.py", "seed": args.seed, "cv2": cv2.__version__,
         "clips": manifest}, indent=1) + "\n")
    total = sum(p.stat().st_size for p in args.out.rglob("*") if p.is_file())
    print(f"{len(clips)} clips, reader_frames.npz and manifest.json under {args.out}: "
          f"{total} bytes")


if __name__ == "__main__":
    main()
