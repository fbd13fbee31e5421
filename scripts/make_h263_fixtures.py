#!/usr/bin/env python3
"""Write the fixtures of the port's H.263 and Sorenson H.263 path
(``v2e2v_tpu_torch/utils/h263.py``, ``flv.py``, the H.263 tags of
``avi.py``, ``mp4.py`` and ``mkv.py``) and what the JAX package's readers
return for each.

    JAX_PLATFORMS=cpu python scripts/make_h263_fixtures.py [--out tests/data/h263] [--seed 0]

It needs cv2 built with FFmpeg and the JAX package, so it runs where the JAX
package's dependencies are installed, not on the card's machine; the card
checks the port against the records this writes. The clips:

- by ``cv2.VideoWriter`` (10 fps unless named otherwise): ``flagship.flv``,
  12 frames of Sorenson H.263 at 960x720 panning 3 rows and -7 columns a
  frame; Sorenson H.263 at 96x64 in ``flv1.avi``, ``s263.avi``,
  ``flv1.mov`` and ``flv1.mkv``; H.263 at 128x96 (``sqcif.avi``), 176x144
  (``qcif.avi``) and 352x288 (``cif.avi``) under H263, at 128x96 under
  each other AVI tag cv2 writes (``u263.avi``, ``x263.avi``, ``m263.avi``,
  ``t263.avi``, ``l263.avi``, ``vx1k.avi``, ``lsvm.avi``), in MOV
  (``h263.mov``, and ``s263.mov``, which cv2 writes as an ``h263`` entry)
  and in Matroska (``h263.mkv``); 14 frames, a second I picture at frame
  12, in ``gop.avi`` and ``gop.flv``; noise and flat content
  (``noise.avi``, ``noise.flv``, ``flat.avi``, ``flat.flv``); a portrait
  FLV (``portrait.flv``, 64x96); FLVs at 24, 25, 30000/1001 and 23 fps of
  5, 9, 13 and 7 frames (``r24.flv``, ``r25.flv``, ``r2997.flv``,
  ``r23.flv``);
- rewritten here: ``odd.flv``, cv2's 74x48 pictures (it writes 75x49 so)
  with the size in every picture header set to 75x47 (the same macroblock
  grid), whose odd height sends swscale to its general scaler;
  ``disposable.flv``, a clip of cv2's with pictures 2 and 4 retyped
  disposable (not kept as references);
- crafted here from random macroblocks (``random_picture``: skipped, inter
  and intra MBs, MCBPC stuffing, DQUANT, vectors over the whole range,
  TCOEFs and every escape form), which FFmpeg decodes without concealment:
  ``gobs_cif.avi`` (H.263 CIF, an I picture and two P pictures with GOB
  headers at random rows, levels through the 8-bit and the -128 escapes),
  ``gobs_4cif.avi`` (4CIF, GOBs of two macroblock rows), ``flv_v0.flv``
  (Sorenson version 0: H.263's escape) and ``flv_v1.flv`` (version 1: the
  7- and 11-bit escapes, a disposable P picture, a 16-bit size code).

``manifest.json`` holds cv2's version and, for each clip, its codec, fps and
frame count as cv2 reports them, the sha256 of each cv2 BGR frame (one
decoding thread) and of its ``cvtColor`` gray, of each JAX ``VideoReader``
frame (``ds = (0.25, 0.25)``) and of each JAX ``VideoSequence`` frame;
``reader_frames.npz`` the JAX ``VideoReader``'s frames of each clip.

The writers (``BitWriter``, ``random_picture``, ``h263_header``,
``flv_header``, ``write_flv``, ``retype_flv``, ``resize_flv``) need no cv2:
``chip_smoke.py`` writes its 704x576 H.263 timing clip with them, and the
tests craft their streams with them.
"""

from __future__ import annotations

import argparse
import shutil
import struct
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from v2e2v_tpu_torch.utils import h263, mpeg4  # noqa: E402

FLAGSHIP = (720, 960, 12, 10.0)  # height, width, frames, fps
SIZE = (64, 96)  # the small Sorenson clips' height, width
RATES = {"r24.flv": (24.0, 5), "r25.flv": (25.0, 9), "r2997.flv": (30000 / 1001, 13),
         "r23.flv": (23.0, 7)}
H263_TAGS = ("U263", "X263", "M263", "T263", "L263", "VX1K", "lsvm")
FLV_TAGGED = ("flv1.avi", "s263.avi", "flv1.mov", "flv1.mkv")  # Sorenson H.263 outside FLV


# ------------------------------------------------------------ bitstreams

class BitWriter:
    """MSB-first bits."""

    def __init__(self):
        self.value, self.n = 0, 0

    def put(self, v: int, n: int) -> None:
        self.value = (self.value << n) | (v & ((1 << n) - 1))
        self.n += n

    def align(self) -> None:
        self.put(0, -self.n % 8)

    def bytes(self) -> bytes:
        self.align()
        return self.value.to_bytes(self.n // 8, "big")


def _tcoef_codes() -> dict:
    codes = {}
    for sym in range(len(mpeg4.INTER_VLC) - 1):
        key = (int(sym >= mpeg4.INTER_LAST), mpeg4.INTER_RUN[sym], mpeg4.INTER_LEVEL[sym])
        codes[key] = mpeg4.INTER_VLC[sym]
    return codes


TCOEF = _tcoef_codes()
ESCAPE = mpeg4.INTER_VLC[-1]


def h263_header(w: BitWriter, fmt: int, kind: int, quant: int, tr: int = 0, umv: int = 0,
                sac: int = 0, ap: int = 0, pb: int = 0, cpm: int = 0, pei: int = 0) -> None:
    """An H.263 picture header (PTYPE's source format ``fmt``; 7 writes the
    PLUSPTYPE code and an UFEP of 0, and stops there)."""
    w.put(h263.PSC, 22)
    w.put(tr, 8)
    w.put(1, 1)  # marker
    w.put(0, 1)  # H.263 id
    w.put(0, 3)  # split screen, document camera, freeze picture release
    w.put(fmt, 3)
    if fmt == 7:
        w.put(0, 3)  # UFEP
        return
    for bit in (kind, umv, sac, ap, pb):
        w.put(bit, 1)
    w.put(quant, 5)
    w.put(cpm, 1)
    if pei:
        w.put(1, 1)
        w.put(0x5A, 8)  # PSPARE
    w.put(0, 1)  # PEI


def flv_header(w: BitWriter, version: int, kind: int, width: int, height: int, quant: int,
               tr: int = 0, size_code: int | None = None, pei: int = 0) -> None:
    """A Sorenson H.263 picture header (``kind`` 0 I, 1 P, 2 disposable P);
    the size as FFmpeg's encoder codes it unless ``size_code`` says."""
    w.put(1, 17)
    w.put(version, 5)
    w.put(tr, 8)
    if size_code is None:
        presets = {v: k for k, v in h263.FLV_SIZES.items()}
        size_code = presets.get((width, height), 0 if width <= 255 and height <= 255 else 1)
    w.put(size_code, 3)
    if size_code in (0, 1):
        w.put(width, 8 << size_code)
        w.put(height, 8 << size_code)
    w.put(kind, 2)
    w.put(0, 1)  # deblocking flag
    w.put(quant, 5)
    if pei:
        w.put(1, 1)
        w.put(0x5A, 8)
    w.put(0, 1)  # PEI


def put_tcoef(w: BitWriter, last: int, run: int, level: int, flavour: str, version: int,
              escape: bool = False, long: bool = False) -> None:
    """One TCOEF: its VLC where the table has it (unless ``escape``), else the
    escape of ``flavour`` / ``version``: Sorenson 1's flag and 7- or 11-bit
    level (the 11-bit one for magnitudes of 64 up, or where ``long``), or
    H.263's 8-bit level, -128 followed by 5 and 6 bits for magnitudes of 128
    up."""
    mag = abs(level)
    if not escape and (last, run, mag) in TCOEF:
        w.put(*TCOEF[last, run, mag])
        w.put(int(level < 0), 1)
        return
    w.put(*ESCAPE)
    if flavour == "flv" and version == 1:
        long = long or mag >= 64
        w.put(int(long), 1)
        w.put(last, 1)
        w.put(run, 6)
        w.put(level, 11 if long else 7)
        return
    w.put(last, 1)
    w.put(run, 6)
    if mag < 128:
        w.put(level, 8)
    else:
        w.put(128, 8)
        w.put(level, 5)
        w.put(level >> 5, 6)


def put_block(w: BitWriter, rng: np.random.Generator, first: int, flavour: str, version: int,
              big: int, quant: int) -> None:
    """A random block of TCOEFs from scan index ``first``: sparse, mostly
    small levels, now and then a level past the table, an escape where the
    table has the code, and at a QP of 4 or less one level up to ``big``
    below the first row, so that no IDCT row sum leaves 16 bits."""
    n = int(rng.choice([1, 2, 4, 9]))
    pos = sorted(rng.choice(np.arange(first, 64), min(n, 64 - first), replace=False))
    prev, wide = first - 1, quant <= 4
    for k, p in enumerate(pos):
        r = rng.random()
        mag = int(rng.integers(1, 4)) if r < 0.8 else int(rng.integers(4, 21))
        if wide and r > 0.9 and mpeg4.ZIGZAG[p] >= 8:
            mag, wide = int(rng.integers(40, big + 1)), False
        put_tcoef(w, int(k == len(pos) - 1), int(p - prev - 1),
                  mag if rng.random() < 0.5 else -mag, flavour, version,
                  escape=rng.random() < 0.05, long=rng.random() < 0.5)
        prev = p


def put_mvd(w: BitWriter, d: int) -> None:
    """A vector difference of ``d`` half-pels (f_code 1: -32 to 32)."""
    w.put(*mpeg4.MVD[abs(d)])
    if d:
        w.put(int(d < 0), 1)


def random_picture(rng: np.random.Generator, flavour: str, kind: int, width: int, height: int,
                   quant: int = 6, version: int = 1, gobs=(), tr: int = 0, big: int = 200,
                   skip: float = 0.2, intra: float = 0.2, coded: float = 1.0,
                   size_code: int | None = None) -> bytes:
    """An H.263 (``flavour`` ``"h263"``, ``width`` x ``height`` one of its
    formats) or Sorenson (``"flv"``, ``version`` 0 or 1; ``kind`` 2 a
    disposable P) picture of random macroblocks, each syntax element within
    what FFmpeg decodes without concealment: skipped (P, share ``skip``),
    inter and intra MBs (``intra`` of a P picture's coded ones), MCBPC
    stuffing, DQUANT keeping QP in 1-12, coded and uncoded blocks (each
    coded at ``coded``), intra DCs of 1-254 and now and then 255 (read as
    128), TCOEFs through the escapes (``put_block``; levels up to ``big``),
    vector differences over the whole range. A GOB header (aligned, then
    GBSC, GN, GFID, GQUANT at a new random QP) opens each macroblock row of
    ``gobs`` that starts a GOB (H.263 only)."""
    w = BitWriter()
    if flavour == "flv":
        flv_header(w, version, kind, width, height, quant, tr, size_code)
    else:
        fmt = {v: k for k, v in h263.FORMATS.items()}[(width, height)]
        h263_header(w, fmt, kind, quant, tr)
    mbw, mbh = (width + 15) >> 4, (height + 15) >> 4
    per_gob = h263.gob_rows(height)
    p_picture = kind != 0
    q = quant
    for my in range(mbh):
        if my in gobs and my % per_gob == 0 and my and flavour == "h263":
            q = int(rng.integers(2, 13))
            w.align()
            w.put(1, 17)
            w.put(my // per_gob, 5)
            w.put(int(not p_picture), 2)  # GFID, as FFmpeg's encoder writes it
            w.put(q, 5)
        for _ in range(mbw):
            if p_picture:
                if rng.random() < skip:
                    w.put(1, 1)  # COD: skipped
                    continue
                w.put(0, 1)
                if rng.random() < 0.05:
                    w.put(*mpeg4.INTER_MCBPC[20])  # stuffing, then COD again
                    w.put(0, 1)
                is_intra = rng.random() < intra
            else:
                is_intra = True
                if rng.random() < 0.05:
                    w.put(*mpeg4.INTRA_MCBPC[8])
            steps = [k for k, d in enumerate(mpeg4.DQUANT) if 1 <= q + d <= 12]
            dq = rng.random() < 0.3
            cbp = [int(rng.random() < coded) for _ in range(6)]
            cbpc, cbpy = 2 * cbp[4] + cbp[5], 8 * cbp[0] + 4 * cbp[1] + 2 * cbp[2] + cbp[3]
            if not p_picture:
                w.put(*mpeg4.INTRA_MCBPC[4 * dq + cbpc])
            else:
                w.put(*mpeg4.INTER_MCBPC[(12 if is_intra else 8) * dq + 4 * (is_intra and not dq)
                                         + cbpc])
            w.put(*mpeg4.CBPY[cbpy if is_intra else cbpy ^ 15])
            if dq:
                k = int(rng.choice(steps))
                w.put(k, 2)
                q += mpeg4.DQUANT[k]
            if not is_intra:
                put_mvd(w, int(rng.integers(-32, 33)))
                put_mvd(w, int(rng.integers(-32, 33)))
            for n in range(6):
                if is_intra:
                    w.put(255 if rng.random() < 0.02 else int(rng.integers(1, 255)), 8)
                if cbp[n]:
                    put_block(w, rng, int(is_intra), flavour, version, big, q)
    return w.bytes()


# ------------------------------------------------------------------- FLV

def _amf_number(x: float) -> bytes:
    return b"\x00" + struct.pack(">d", x)


def _amf_key(key: str) -> bytes:
    return struct.pack(">H", len(key)) + key.encode()


def amf_metadata(meta: dict) -> bytes:
    """An ``onMetaData`` script tag's body: an ECMA array of numbers."""
    body = b"\x02" + _amf_key("onMetaData") + b"\x08" + struct.pack(">I", len(meta))
    for key, value in meta.items():
        body += _amf_key(key) + _amf_number(value)
    return body + b"\x00\x00\x09"


def flv_tag(kind: int, stamp: int, body: bytes) -> bytes:
    """One tag and the PreviousTagSize after it."""
    head = struct.pack(">B3sI3s", kind, len(body).to_bytes(3, "big"),
                       ((stamp & 0xFFFFFF) << 8) | (stamp >> 24), b"\0\0\0")
    return head + body + struct.pack(">I", 11 + len(body))


def write_flv(path: Path, packets: list[bytes], fps: float, width: int, height: int,
              kinds=None, meta: dict | None = None, codec: int = 2) -> None:
    """An FLV of Sorenson H.263 ``packets`` (frame types from ``kinds``: 0
    key, 1 inter, 2 disposable; the first key, the rest inter by default),
    one tag each at ``round(1000 i / fps)`` ms, after an ``onMetaData`` of
    ``duration`` (frames / fps), ``width``, ``height``, ``framerate`` and
    ``videocodecid``, or of ``meta``."""
    kinds = kinds or [0] + [1] * (len(packets) - 1)
    if meta is None:
        meta = {"duration": len(packets) / fps, "width": float(width), "height": float(height),
                "videodatarate": 0.0, "framerate": fps, "videocodecid": float(codec)}
    out = b"FLV\x01\x01" + struct.pack(">II", 9, 0) + flv_tag(18, 0, amf_metadata(meta))
    for i, (data, kind) in enumerate(zip(packets, kinds)):
        out += flv_tag(9, round(1000 * i / fps), bytes([(kind + 1) << 4 | codec]) + data)
    path.write_bytes(out)


def _flv_pictures(data: bytes):
    """(start, size) of each video tag's body in an FLV, past its first byte."""
    pos = 13
    while pos + 11 <= len(data):
        size = int.from_bytes(data[pos + 1:pos + 4], "big")
        if data[pos] == 9:
            yield pos + 12, size - 1
        pos += 11 + size + 4


def _set_bits(data: bytearray, at: int, bit: int, n: int, value: int) -> None:
    """``n`` bits at bit ``bit`` of the bytes from ``at`` set to ``value``."""
    span = (bit + n + 7) // 8
    word = int.from_bytes(data[at:at + span], "big")
    shift = 8 * span - bit - n
    word = (word & ~(((1 << n) - 1) << shift)) | (value << shift)
    data[at:at + span] = word.to_bytes(span, "big")


def resize_flv(data: bytes, width: int, height: int) -> bytes:
    """Every Sorenson picture header of an FLV written with an 8-bit size
    (size code 0) given ``width`` x ``height`` instead."""
    out = bytearray(data)
    for at, _ in _flv_pictures(data):
        if (int.from_bytes(data[at + 3:at + 5], "big") >> 7) & 7 != 0:
            raise ValueError("a picture without an 8-bit size")
        _set_bits(out, at, 33, 16, width << 8 | height)
    return bytes(out)


def retype_flv(data: bytes, pictures, kind: int = 2) -> bytes:
    """The Sorenson pictures numbered ``pictures`` of an FLV retyped
    ``kind`` (2: disposable P), their tags' frame type too."""
    out = bytearray(data)
    for i, (at, _) in enumerate(_flv_pictures(data)):
        if i not in pictures:
            continue
        code = (int.from_bytes(data[at + 3:at + 5], "big") >> 7) & 7
        bit = 33 + (16 if code == 0 else 32 if code == 1 else 0)
        _set_bits(out, at, bit, 2, kind)
        out[at - 1] = (kind + 1) << 4 | (out[at - 1] & 0x0F)
    return bytes(out)


# ----------------------------------------------------------------- clips

def crafted(out: Path, rng: np.random.Generator) -> None:
    """The clips of random macroblocks (see the module's notes)."""
    from make_rawvideo_fixtures import write_avi

    pics = [random_picture(rng, "h263", 0, 352, 288, gobs=(3, 4, 9, 15)),
            random_picture(rng, "h263", 1, 352, 288, gobs=(1, 2, 10)),
            random_picture(rng, "h263", 1, 352, 288, gobs=range(18), quant=3)]
    write_avi(out / "gobs_cif.avi", pics, 352, 288, 10, b"H263")
    pics = [random_picture(rng, "h263", 0, 704, 576, gobs=(2, 8, 14, 30), coded=0.1, big=60),
            random_picture(rng, "h263", 1, 704, 576, gobs=(4, 10), skip=0.7, coded=0.2, big=60)]
    write_avi(out / "gobs_4cif.avi", pics, 704, 576, 10, b"H263")
    for version in (0, 1):
        h, w = (40, 300) if version else (48, 64)
        size = 1 if version else None
        kinds = [0, 1, 2, 1] if version else [0, 1, 1]
        pics = [random_picture(rng, "flv", k, w, h, version=version, size_code=size, tr=i,
                               big=300 if version else 200)
                for i, k in enumerate(kinds)]
        write_flv(out / f"flv_v{version}.flv", pics, 10.0, w, h, kinds)


def clips(out: Path, rng: np.random.Generator) -> dict[str, str]:
    """Every clip; the value is its codec."""
    from make_mpeg4_fixtures import pan
    from make_rawvideo_fixtures import writer

    fh, fw, n, fps = FLAGSHIP
    writer(out / "flagship.flv", pan(rng, fh, fw, n, (3, -7)), fps, "FLV1")
    h, w = SIZE
    for name in FLV_TAGGED:
        writer(out / name, pan(rng, h, w, 5, (1, -2)), 10.0, name[:4].upper())
    for name, (ph, pw), frames in (("sqcif.avi", (96, 128), 5), ("qcif.avi", (144, 176), 4),
                                   ("cif.avi", (288, 352), 3)):
        writer(out / name, pan(rng, ph, pw, frames, (1, 2)), 10.0, "H263")
    for tag in H263_TAGS:
        writer(out / f"{tag.lower()}.avi", pan(rng, 96, 128, 3, (2, -1)), 10.0, tag)
    for name, fourcc in (("h263.mov", "h263"), ("s263.mov", "s263"), ("h263.mkv", "H263")):
        writer(out / name, pan(rng, 96, 128, 4, (-1, 1)), 10.0, fourcc)
    writer(out / "gop.avi", pan(rng, 96, 128, 14, (1, 1)), 10.0, "H263")
    writer(out / "gop.flv", pan(rng, h, w, 14, (1, 1)), 10.0, "FLV1")
    writer(out / "noise.avi", rng.integers(0, 256, (3, 96, 128, 3), np.uint8), 10.0, "H263")
    writer(out / "noise.flv", rng.integers(0, 256, (3, h, w, 3), np.uint8), 10.0, "FLV1")
    writer(out / "flat.avi", np.full((3, 96, 128, 3), (40, 90, 200), np.uint8), 10.0, "H263")
    writer(out / "flat.flv", np.full((3, h, w, 3), (200, 30, 90), np.uint8), 10.0, "FLV1")
    writer(out / "portrait.flv", pan(rng, w, h, 4, (2, 1)), 10.0, "FLV1")
    for name, (rate, frames) in RATES.items():
        writer(out / name, pan(rng, 48, 64, frames, (1, -1)), rate, "FLV1")
    writer(out / "odd.flv", pan(rng, 49, 75, 4, (1, -1)), 10.0, "FLV1")
    (out / "odd.flv").write_bytes(resize_flv((out / "odd.flv").read_bytes(), 75, 47))
    writer(out / "disposable.flv", pan(rng, h, w, 6, (2, 2)), 10.0, "FLV1")
    (out / "disposable.flv").write_bytes(retype_flv((out / "disposable.flv").read_bytes(),
                                                    (2, 4)))
    crafted(out, rng)
    return {p.name: "flv" if p.suffix == ".flv" or p.name in FLV_TAGGED else "h263"
            for p in sorted(out.iterdir())}


def main() -> None:
    from make_rawvideo_fixtures import records

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=ROOT / "tests" / "data" / "h263")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.out.exists():
        shutil.rmtree(args.out)
    args.out.mkdir(parents=True)
    records(args.out, clips(args.out, np.random.default_rng(args.seed)), args.seed,
            "scripts/make_h263_fixtures.py")


if __name__ == "__main__":
    main()
