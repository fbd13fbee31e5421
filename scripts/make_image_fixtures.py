#!/usr/bin/env python3
"""Write the still-frame fixtures of the port's decoders
(``v2e2v_tpu_torch/utils/{image_io,bmp,pnm,tiff,webp,vp8}.py``) and what
``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` returns for each.

    python scripts/make_image_fixtures.py [--out tests/data/images] [--seed 0]

It needs cv2 (``cv2.imwrite`` writes the files it can write, and
``cv2.imread`` gives every hash), so it runs where the JAX package's
dependencies are installed, not on the card's machine; the card checks its
decoders against the hashes this writes. From seeded numpy scenes it writes:

- ``cases/``: one small file per decoder setting, written by ``cv2.imwrite``
  where cv2 can write the case and by the writers below otherwise: PNG
  (Adam7, 16-bit samples, a gamma chunk), BMP (every header, 1/4/8-bit
  palettes, RLE4 and RLE8 with escapes, 5-5-5, 5-6-5, 24 and 32 bits,
  top-down rows, V5 bit fields), PNM (P1-P6, comments, maxvals 1-65535), TIFF
  (strips and tiles, planar 1 and 2, none/LZW/Deflate/PackBits, predictor 2,
  1/4/8/16 bits, MinIsBlack/MinIsWhite/RGB/palette, alpha, big-endian, fill
  order 2, orientation, a second page) and WebP (lossless streams that use
  each transform, the colour cache, meta prefix codes and backward
  references; lossy ones at several qualities, with alpha, and re-encoded by
  ``vp8_rewrite`` with the simple loop filter, sharpness, filter deltas,
  token partitions, the skip flag and delta segments; EXIF orientation, ICC
  profile, an animation's first frame);
- ``sequence/sequence_0000000001/frames/``: 12 frames of a seeded moving
  scene at 180x240, 250 fps, with their ``timestamps.txt``: BMP, PGM, TIFF
  (LZW colour, Deflate 16-bit gray), lossy and lossless WebP at even
  indices, and at odd ones the PNGs read now (16-bit gray and colour, Adam7
  colour and 16-bit gray, colour under a gamma, a palette under sRGB),
  which the evaluation CLIs read too (they list ``.jpg`` and ``.png``);
- ``sequence_png/sequence_0000000001/frames/``: the same frames as 8-bit gray
  PNGs of what ``cv2.imread(path, 0)`` returns, its twin;
- ``manifest.json``: each file's shape and the sha256 of the bytes of
  ``cv2.imread(path, 0)``.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import shutil
import struct
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np

REPO = Path(__file__).resolve().parents[1]
SEQUENCE_FRAMES, SEQUENCE_HW, FPS = 12, (180, 240), 250.0


def _sibling(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def scene(rng: np.random.Generator, h: int, w: int, frames: int = 1) -> np.ndarray:
    """``[frames, h, w, 3]`` uint8 BGR, smooth and moving
    (``make_video_fixtures.scene``)."""
    return _sibling("make_video_fixtures").scene(rng, h, w, frames)


def imencode(ext: str, img: np.ndarray, params=()) -> bytes:
    ok, buf = cv2.imencode(ext, img, list(params))
    if not ok:
        raise RuntimeError(f"cv2.imencode({ext}) failed")
    return buf.tobytes()


# ------------------------------------------------------------------- PNG

def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _pack_samples(samples: np.ndarray, depth: int) -> np.ndarray:
    """``[rows, n]`` samples -> rows of bytes (big-endian at 16 bits, most
    significant bits first below 8)."""
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(samples.shape[0], -1)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    rows, n = samples.shape
    pad = np.zeros((rows, -(-n // per) * per), np.int64)
    pad[:, :n] = samples
    shifts = np.arange(8 - depth, -1, -depth)
    return (pad.reshape(rows, -1, per) << shifts).sum(-1).astype(np.uint8)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def png(samples: np.ndarray, depth: int, color: int, interlace: int = 0, extra: bytes = b"",
        palette: np.ndarray | None = None) -> bytes:
    """A PNG of ``[H, W, C]`` samples; rows filtered None and Sub in turn;
    ``extra`` chunks go before PLTE and IDAT."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack_samples(sub.reshape(sub.shape[0], -1).astype(np.int64), depth)
        for i, r in enumerate(rows):
            if i % 2:  # Sub
                r = r.astype(np.int64)
                r[bpp:] = (r[bpp:] - r[:-bpp].copy()) & 255
                r = np.concatenate([r[:bpp], r[bpp:]]).astype(np.uint8)
            raw += bytes([i % 2]) + r.tobytes()
    head = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)
    plte = b"" if palette is None else _png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", head) + extra + plte
            + _png_chunk(b"IDAT", zlib.compress(raw)) + _png_chunk(b"IEND", b""))


# ------------------------------------------------------------------- BMP

BMP_HEADERS = {"core": 12, "info": 40, "v4": 108, "v5": 124}


def bmp_rows(samples: np.ndarray, bits: int) -> bytes:
    """Pixel rows, each padded to 4 bytes, in the order given: ``[H, W]``
    palette indices or 16-bit words, or ``[H, W, C]`` bytes."""
    h = samples.shape[0]
    if bits <= 8:
        rows = _pack_samples(samples.astype(np.int64), bits)
    elif bits == 16:
        rows = samples.astype("<u2").view(np.uint8).reshape(h, -1)
    else:
        rows = samples.astype(np.uint8).reshape(h, -1)
    out = np.zeros((h, (rows.shape[1] + 3) & -4), np.uint8)
    out[:, :rows.shape[1]] = rows
    return out.tobytes()


def bmp(header: str, bits: int, pixels: bytes, width: int, height: int, palette=None,
        compression: int = 0, masks=None, clr_used: int = 0, top_down: bool = False) -> bytes:
    """A BMP file around ``pixels`` (stored rows or RLE codes): ``masks``
    (red, green, blue) go inside a V4/V5 header, after a 40-byte one."""
    size = BMP_HEADERS[header]
    pal = b""
    if header == "core":
        hdr = struct.pack("<IHHHH", 12, width, height, 1, bits)
        if palette is not None:
            pal = np.asarray(palette, np.uint8)[:, :3].tobytes()
    else:
        hdr = struct.pack("<IiiHHIIiiII", size, width, -height if top_down else height, 1, bits,
                          compression, len(pixels), 2835, 2835, clr_used, 0)
        if size > 40:
            m = masks or (0, 0, 0)
            hdr += struct.pack("<IIII", m[0], m[1], m[2], 0) + b"BGRs" + bytes(48)
            if size == 124:
                hdr += struct.pack("<IIII", 4, 0, 0, 0)
        if palette is not None:
            p = np.asarray(palette, np.uint8)[:, :3]
            pal = np.concatenate([p, np.zeros((len(p), 1), np.uint8)], 1).tobytes()
    after = struct.pack("<III", *masks) if masks is not None and header == "info" else b""
    offset = 14 + len(hdr) + len(after) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset) + hdr + after + pal
            + pixels)


def rle_stream(rng: np.random.Generator, w: int, h: int, bits: int) -> bytes:
    """Random valid RLE4/RLE8 codes for a ``w x h`` image: runs, absolute
    runs, end-of-line, delta and end-of-bitmap escapes (RLE8; an RLE4 stream
    ends with the last row's end-of-line, since OpenCV reads past an
    end-of-bitmap there)."""
    out, x, y = bytearray(), 0, 0
    while y < h:
        room, r = w - x, rng.random()
        if room == 0 or r < 0.08:
            if r < 0.03 and y < h - 1:  # OpenCV's RLE4 skips no rows on a delta
                dx = int(rng.integers(0, room + 1))
                dy = int(rng.integers(0, min(3, h - y))) if bits == 8 else 0
                out += bytes([0, 2, dx, dy])
                x, y = x + dx, y + dy
            else:
                out += bytes([0, 0])
                x, y = 0, y + 1
        elif r < 0.55 or room < 3:
            n = min(int(rng.integers(1, room + 1)), 255)
            out += bytes([n, int(rng.integers(0, 256))])
            x += n
        else:
            n = int(rng.integers(3, min(room, 255) + 1))
            body = rng.integers(0, 256, n if bits == 8 else (n + 1) // 2).astype(np.uint8).tobytes()
            out += bytes([0, n]) + body + b"\0" * (len(body) & 1)
            x += n
    return bytes(out + (bytes([0, 1]) if bits == 8 else b""))


# ------------------------------------------------------------------- PNM

def pnm(kind: int, samples: np.ndarray, maxval: int = 255, comments: bool = False) -> bytes:
    """P1-P6 of ``[H, W]`` or ``[H, W, 3]`` samples (already scaled to
    ``maxval``; bits for P1/P4)."""
    h, w = samples.shape[:2]
    note = b"# written by make_image_fixtures\n" if comments else b""
    head = b"P%d\n" % kind + note + b"%d %d\n" % (w, h)
    if kind not in (1, 4):
        head += note + b"%d\n" % maxval
    if kind == 1:
        return head + b"\n".join(b"".join(b"%d" % v for v in row) for row in samples) + b"\n"
    if kind == 4:
        return head + np.packbits(samples.astype(np.uint8), axis=1).tobytes()
    if kind in (2, 3):
        flat = samples.reshape(h, -1)
        return head + b"\n".join(b" ".join(b"%d" % v for v in row) for row in flat) + b"\n"
    return head + samples.astype(">u2" if maxval > 255 else np.uint8).tobytes()


# ------------------------------------------------------------------ TIFF

def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW as ``tif_lzw.c`` writes it: a clear code first, codes most
    significant bit first, the width growing as the next free code passes
    its maximum, a clear code at 4094."""
    out, acc, nacc, width = bytearray(), 0, 0, 9

    def put(code):
        nonlocal acc, nacc
        acc, nacc = (acc << width) | code, nacc + width
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 255)
        acc &= (1 << nacc) - 1

    table, free, w = {bytes([i]): i for i in range(256)}, 258, b""
    put(256)

    def grow():
        nonlocal table, free, width
        free += 1
        if free == 4094:
            put(256)
            table, free, width = {bytes([i]): i for i in range(256)}, 258, 9
        elif free > (1 << width) - 1:
            width += 1

    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc] = free
        grow()
        w = bytes([c])
    if w:
        put(table[w])
        grow()
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 255)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1)]) + data[i:i + 1]
            i = j + 1
            continue
        while j + 1 < n and data[j + 1] != data[j] and j - i < 127:
            j += 1
        if j + 1 < n and j > i and data[j + 1] == data[j]:
            j -= 1
        out += bytes([j - i]) + data[i:j + 1]
        i = j + 1
    return bytes(out)


_REVERSED = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def tiff(samples: np.ndarray, bits: int, photometric: int, *, order: str = "<",
         compression: int = 1, predictor: int = 1, planar: int = 1, rows_per_strip=None,
         tile=None, orientation=None, colormap=None, extra=None, sample_format=None,
         pages: int = 1, fill_order=None) -> bytes:
    """A TIFF of ``[H, W, spp]`` samples; ``pages`` repeats the image in
    further IFDs."""
    h, w, spp = samples.shape
    mask = (1 << bits) - 1

    def encode(raw: bytes) -> bytes:
        if fill_order == 2:
            raw = raw.translate(_REVERSED) if compression == 1 else raw
        out = {1: lambda r: r, 5: lzw_encode, 8: zlib.compress, 32946: zlib.compress,
               32773: packbits_encode}[compression](raw)
        return out.translate(_REVERSED) if fill_order == 2 and compression != 1 else out

    def block_bytes(block: np.ndarray, pp: int) -> bytes:
        if predictor == 2:
            b = block.reshape(block.shape[0], -1, pp)
            d = b.copy()
            d[:, 1:] = b[:, 1:] - b[:, :-1]
            block = d.reshape(block.shape) & mask
        if bits == 16:
            return block.astype(order + "u2").tobytes()
        return _pack_samples(block, bits).tobytes()

    planes = [samples[..., i:i + 1] for i in range(spp)] if planar == 2 else [samples]
    chunks = []
    for pl in planes:
        pp = pl.shape[-1]
        if tile:
            tw, th = tile
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    block = np.zeros((th, tw * pp), np.int64)
                    part = pl[ty:ty + th, tx:tx + tw]
                    block[:part.shape[0], :part.shape[1] * pp] = part.reshape(part.shape[0], -1)
                    chunks.append(encode(block_bytes(block, pp)))
        else:
            rps = rows_per_strip or h
            for y in range(0, h, rps):
                block = pl[y:y + rps].reshape(min(rps, h - y), -1).astype(np.int64)
                chunks.append(encode(block_bytes(block, pp)))
    body = bytearray(b"II*\0" if order == "<" else b"MM\0*") + bytes(4)
    offsets = []
    for c in chunks:
        offsets.append(len(body))
        body += c + b"\0" * (len(c) & 1)
    fields = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]),
              262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    if tile:
        fields.update({322: (3, [tile[0]]), 323: (3, [tile[1]]), 324: (4, offsets),
                       325: (4, [len(c) for c in chunks])})
    else:
        fields.update({273: (4, offsets), 278: (4, [rows_per_strip or h]),
                       279: (4, [len(c) for c in chunks])})
    for tag, value in ((317, predictor if predictor != 1 else None), (274, orientation),
                       (266, fill_order)):
        if value is not None:
            fields[tag] = (3, [value])
    if colormap is not None:
        fields[320] = (3, [int(v) for v in np.asarray(colormap).reshape(-1)])
    if extra is not None:
        fields[338] = (3, list(extra))
    if sample_format is not None:
        fields[339] = (3, [sample_format] * spp)
    ifds = []
    for _ in range(pages):
        outside = {}
        for tag, (kind, vals) in sorted(fields.items()):
            if len(vals) * (2 if kind == 3 else 4) > 4:
                outside[tag] = len(body)
                body += struct.pack(f"{order}{len(vals)}{'H' if kind == 3 else 'I'}", *vals)
                body += b"\0" * (len(body) & 1)
        ifds.append(len(body))
        body += struct.pack(order + "H", len(fields))
        for tag, (kind, vals) in sorted(fields.items()):
            code = "H" if kind == 3 else "I"
            if tag in outside:
                body += struct.pack(order + "HHII", tag, kind, len(vals), outside[tag])
            else:
                body += struct.pack(order + "HHI", tag, kind, len(vals)) + struct.pack(
                    f"{order}{len(vals)}{code}", *vals).ljust(4, b"\0")
        body += bytes(4)
    struct.pack_into(order + "I", body, 4, ifds[0])
    for prev, nxt in zip(ifds, ifds[1:]):
        count = struct.unpack_from(order + "H", body, prev)[0]
        struct.pack_into(order + "I", body, prev + 2 + 12 * count, nxt)
    return bytes(body)


# ------------------------------------------------------------------ WebP

def webp_chunk(kind: bytes, body: bytes) -> bytes:
    return kind + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def riff(chunks: list[bytes]) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def vp8x(flags: int, w: int, h: int) -> bytes:
    return webp_chunk(b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little")
                      + (h - 1).to_bytes(3, "little"))


def image_chunk(webp: bytes) -> tuple[bytes, bytes]:
    """The (kind, payload) of a simple WebP file's image chunk."""
    return webp[12:16], webp[20:20 + struct.unpack_from("<I", webp, 16)[0]]


def exif_tiff(orientation: int, order: str = "<") -> bytes:
    """A TIFF header whose IFD0 holds the orientation tag."""
    return ((b"II" if order == "<" else b"MM") + struct.pack(order + "HI", 42, 8)
            + struct.pack(order + "H", 1)
            + struct.pack(order + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(order + "I", 0))


def anmf(x: int, y: int, w: int, h: int, payload: bytes) -> bytes:
    return webp_chunk(b"ANMF", (x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little")
                      + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")
                      + (100).to_bytes(3, "little") + b"\0" + payload)


class BoolEncoder:
    """RFC 6386 section 7.3's boolean entropy encoder."""

    def __init__(self):
        self.out, self.range, self.bottom, self.count = bytearray(), 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def bit(self, prob: int, value) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if value:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.count -= 1
            if not self.count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.count = 8

    def literal(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bit(128, (value >> i) & 1)

    def signed(self, value: int, n: int) -> None:
        self.literal(abs(value), n)
        self.bit(128, value < 0)

    def optional_signed(self, value: int, n: int) -> None:
        self.bit(128, value != 0)
        if value:
            self.signed(value, n)

    def flush(self) -> bytes:
        c, v = self.count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def _tree_paths(tree) -> dict[int, list]:
    """The (index into the probabilities, bit) steps to each leaf of a
    libwebp-style tree (leaves as -mode)."""
    paths = {}

    def walk(i, path):
        for b in (0, 1):
            nxt = tree[2 * i + b] if i else tree[b]
            step = path + [(i, b)]
            if nxt > 0:
                walk(nxt, step)
            else:
                paths[-nxt] = step
    walk(0, [])
    return paths


def vp8_rewrite(webp: bytes, *, simple=None, level=None, sharpness=None, deltas=None,
                partitions=1, skip=False, segment_quant=None) -> bytes:
    """Re-encode a lossy WebP file's key frame with other header settings:
    the loop filter's type, level, sharpness and (reference, mode) deltas,
    ``partitions`` token partitions, the per-macroblock skip flag, and
    segment quantizers given as deltas from the base. The macroblocks keep
    their modes and quantized coefficients (read back through the port's
    parser), so every setting makes a valid frame that cv2 decodes."""
    from v2e2v_tpu_torch.utils import vp8

    kind, data = image_chunk(webp)
    assert kind == b"VP8 "
    hdr, width, height, mbs = vp8._parse(data, "<rewrite>")
    base_q, quant_deltas = _quant_fields(data)
    enc = BoolEncoder()
    enc.bit(128, 0)
    enc.bit(128, 0)
    seg_q = segment_quant if segment_quant is not None else (
        [q - base_q for q in hdr.seg_quant] if hdr.absolute else hdr.seg_quant)
    enc.bit(128, hdr.segments)
    if hdr.segments:
        enc.bit(128, hdr.update_map)
        enc.bit(128, 1)  # update the segment data, as deltas
        enc.bit(128, 0)
        for q in seg_q:
            enc.optional_signed(q, 7)
        for f in hdr.seg_filter:
            enc.optional_signed(f - hdr.level if hdr.absolute else f, 6)
        if hdr.update_map:
            for p in hdr.seg_probs:
                enc.bit(128, p != 255)
                if p != 255:
                    enc.literal(p, 8)
    enc.bit(128, hdr.simple if simple is None else simple)
    enc.literal(hdr.level if level is None else level, 6)
    enc.literal(hdr.sharpness if sharpness is None else sharpness, 3)
    enc.bit(128, deltas is not None)
    if deltas is not None:
        enc.bit(128, 1)
        for values in ([deltas[0], 0, 0, 0], [deltas[1], 0, 0, 0]):
            for d in values:
                enc.bit(128, d != 0)
                if d:
                    enc.signed(d, 6)
    enc.literal(partitions.bit_length() - 1, 2)
    enc.literal(base_q, 7)
    for d in quant_deltas:
        enc.optional_signed(d, 4)
    enc.bit(128, 0)  # refresh entropy probabilities
    probs = [[[list(vp8.COEFFS_PROBA0[((t * 8 + b) * 3 + c) * 11:][:11]) for c in range(3)]
              for b in range(8)] for t in range(4)]
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    want = hdr.bands[t][vp8.BANDS.index(b)][c][p]
                    up = vp8.COEFFS_UPDATE_PROBA[((t * 8 + b) * 3 + c) * 11 + p]
                    enc.bit(up, want != probs[t][b][c][p])
                    if want != probs[t][b][c][p]:
                        enc.literal(want, 8)
    skip_prob = 200 if skip else None
    enc.bit(128, skip_prob is not None)
    if skip_prob is not None:
        enc.literal(skip_prob, 8)
    b_paths = _tree_paths(vp8.YMODES_INTRA4)
    bands = hdr.bands
    mb_w = len(mbs[0])
    intra_top = [vp8.B_DC] * (4 * mb_w)
    parts = [BoolEncoder() for _ in range(partitions)]
    nz_top, nz_dc_top = [0] * mb_w, [0] * mb_w
    for mb_y, row in enumerate(mbs):
        intra_left = [vp8.B_DC] * 4
        levels_row = [_levels(mb, hdr) for mb in row]
        for mb_x, mb in enumerate(row):
            if hdr.update_map:
                probs_s = hdr.seg_probs
                if mb.segment < 2:
                    enc.bit(probs_s[0], 0)
                    enc.bit(probs_s[1], mb.segment)
                else:
                    enc.bit(probs_s[0], 1)
                    enc.bit(probs_s[2], mb.segment - 2)
            empty = not any(any(b) for b in levels_row[mb_x])
            if skip_prob is not None:
                enc.bit(skip_prob, empty)
            enc.bit(145, not mb.i4x4)
            if not mb.i4x4:
                m = mb.ymodes[0]
                enc.bit(156, m in (vp8.TM_PRED, vp8.H_PRED))
                if m in (vp8.TM_PRED, vp8.H_PRED):
                    enc.bit(128, m == vp8.TM_PRED)
                else:
                    enc.bit(163, m == vp8.V_PRED)
                intra_top[4 * mb_x:4 * mb_x + 4] = [m] * 4
                intra_left = [m] * 4
            else:
                for y in range(4):
                    ymode = intra_left[y]
                    for x in range(4):
                        m = mb.ymodes[4 * y + x]
                        prob = vp8.BMODES_PROBA[(intra_top[4 * mb_x + x] * 10 + ymode) * 9:]
                        for i, b in b_paths[m]:
                            enc.bit(prob[i], b)
                        ymode = intra_top[4 * mb_x + x] = m
                    intra_left[y] = ymode
            m = mb.uvmode
            enc.bit(142, m != vp8.DC_PRED)
            if m != vp8.DC_PRED:
                enc.bit(114, m != vp8.V_PRED)
                if m != vp8.V_PRED:
                    enc.bit(183, m == vp8.TM_PRED)
        part = parts[mb_y % partitions]
        nz_left = nz_dc_left = 0
        for mb_x, mb in enumerate(row):
            lv = levels_row[mb_x]
            if skip_prob is not None and not any(any(b) for b in lv):
                nz_left = nz_top[mb_x] = 0
                if not mb.i4x4:
                    nz_dc_left = nz_dc_top[mb_x] = 0
                continue
            nz_left, nz_dc_left = _put_residuals(part, bands, mb, lv, nz_top, nz_dc_top, mb_x,
                                                 nz_left, nz_dc_left)
    first = enc.flush()
    tokens = [p.flush() for p in parts]
    sizes = b"".join(len(t).to_bytes(3, "little") for t in tokens[:-1])
    tag = (len(first) << 5) | (1 << 4)  # key frame, version 0, shown
    frame = (tag.to_bytes(3, "little") + b"\x9d\x01\x2a" + struct.pack("<HH", width, height)
             + first + sizes + b"".join(tokens))
    return riff([webp_chunk(b"VP8 ", frame)])


def _quant_fields(data: bytes) -> tuple[int, list[int]]:
    """The base quantizer index and its five deltas, read from a key
    frame's first partition as ``vp8._Header`` reads them."""
    from v2e2v_tpu_torch.utils import vp8
    br = vp8._Bool(data[10:10 + (int.from_bytes(data[:3], "little") >> 5)], "<rewrite>")
    br.bit(128)
    br.bit(128)
    if br.bit(128):
        update_map = br.bit(128)
        if br.bit(128):
            br.bit(128)
            for n in (7,) * 4 + (6,) * 4:
                br.optional_signed(n)
        if update_map:
            for _ in range(3):
                if br.bit(128):
                    br.literal(8)
    br.bit(128)
    br.literal(6)
    br.literal(3)
    if br.bit(128) and br.bit(128):
        for _ in range(8):
            if br.bit(128):
                br.signed(6)
    br.literal(2)
    base = br.literal(7)
    return base, [br.optional_signed(4) for _ in range(5)]


def _levels(mb, hdr) -> list[list[int]]:
    """A macroblock's 25 blocks of quantized levels in zigzag order (16
    luma, 4 + 4 chroma, the second-order block), from its dequantised
    coefficients."""
    from v2e2v_tpu_torch.utils import vp8
    q_y1, q_y2, q_uv = hdr.quant[mb.segment]
    out = []
    for k in range(25):
        q = q_y2 if k == 24 else q_uv if k >= 16 else q_y1
        at = 384 if k == 24 else 16 * k
        block = mb.coeffs[at:at + 16]
        out.append([block[vp8.ZIGZAG[n]] // q[n > 0] if block[vp8.ZIGZAG[n]] >= 0
                    else -((-block[vp8.ZIGZAG[n]]) // q[n > 0]) for n in range(16)])
    return out


def _put_coeffs(enc: BoolEncoder, bands: list, ctx: int, levels: list[int], first: int) -> int:
    """The tokens of one block (``vp8._coeffs`` inverted); returns its nz."""
    from v2e2v_tpu_torch.utils import vp8
    last = max((n for n in range(first, 16) if levels[n]), default=-1)
    n, p = first, bands[first][ctx]
    while n < 16:
        if n > last:
            enc.bit(p[0], 0)
            return n
        enc.bit(p[0], 1)
        while levels[n] == 0:
            enc.bit(p[1], 0)
            n += 1
            p = bands[n][0]
        enc.bit(p[1], 1)
        v = abs(levels[n])
        if v == 1:
            enc.bit(p[2], 0)
            nxt = 1
        else:
            enc.bit(p[2], 1)
            nxt = 2
            if v <= 4:
                enc.bit(p[3], 0)
                enc.bit(p[4], v != 2)
                if v != 2:
                    enc.bit(p[5], v == 4)
            elif v <= 10:
                enc.bit(p[3], 1)
                enc.bit(p[6], 0)
                enc.bit(p[7], v > 6)
                if v <= 6:
                    enc.bit(159, v == 6)
                else:
                    enc.bit(165, (v - 7) >> 1)
                    enc.bit(145, (v - 7) & 1)
            else:
                enc.bit(p[3], 1)
                enc.bit(p[6], 1)
                cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
                enc.bit(p[8], cat >> 1)
                enc.bit(p[9 + (cat >> 1)], cat & 1)
                rest, probs = v - 3 - (8 << cat), vp8.CAT3456[cat]
                for i, prob in enumerate(probs):
                    enc.bit(prob, (rest >> (len(probs) - 1 - i)) & 1)
        enc.bit(128, levels[n] < 0)
        n += 1
        if n < 16:
            p = bands[n][nxt]
    return 16


def _put_residuals(enc, bands, mb, levels, nz_top, nz_dc_top, mb_x, nz_left, nz_dc_left):
    """``vp8._residuals`` inverted: returns the left contexts."""
    if not mb.i4x4:
        nz = _put_coeffs(enc, bands[1], nz_dc_top[mb_x] + nz_dc_left, levels[24], 0)
        nz_dc_top[mb_x] = nz_dc_left = int(nz > 0)
        first, ac = 1, bands[0]
    else:
        first, ac = 0, bands[3]
    tnz, lnz = nz_top[mb_x] & 15, nz_left & 15
    for y in range(4):
        left = lnz & 1
        for x in range(4):
            nz = _put_coeffs(enc, ac, left + (tnz & 1), levels[4 * y + x], first)
            left = int(nz > first)
            tnz = (tnz >> 1) | (left << 7)
        tnz >>= 4
        lnz = (lnz >> 1) | (left << 7)
    out_t, out_l = tnz, lnz >> 4
    for ch in (0, 2):
        tnz, lnz = nz_top[mb_x] >> (4 + ch), nz_left >> (4 + ch)
        for y in range(2):
            left = lnz & 1
            for x in range(2):
                nz = _put_coeffs(enc, bands[2], left + (tnz & 1),
                                 levels[16 + 2 * ch + 2 * y + x], 0)
                left = int(nz > 0)
                tnz = (tnz >> 1) | (left << 3)
            tnz >>= 2
            lnz = (lnz >> 1) | (left << 5)
        out_t |= (tnz << 4) << ch
        out_l |= (lnz & 0xF0) << ch
    nz_top[mb_x] = out_t
    return out_l, nz_dc_left


# ----------------------------------------------------------------- cases

def gray_of(img: np.ndarray) -> np.ndarray:
    return cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)


def cases(rng: np.random.Generator) -> dict[str, bytes]:
    """One small file per decoder setting, by name (with its suffix)."""
    h, w = 24, 40
    img = scene(rng, h, w)[0]
    gray = gray_of(img)
    out = {}
    # PNG: what PRs before this one did not read
    wide = rng.integers(0, 65536, (h, w, 4))
    out["png_adam7_gray.png"] = png(gray[..., None], 8, 0, interlace=1)
    out["png_adam7_rgb16.png"] = png(wide[..., :3], 16, 2, interlace=1)
    out["png_adam7_gray2.png"] = png(rng.integers(0, 4, (h, w, 1)), 2, 0, interlace=1)
    out["png_gray16.png"] = imencode(".png", (gray.astype(np.uint16) * 257) ^ 0x5A)
    out["png_rgb16.png"] = imencode(".png", wide[..., :3].astype(np.uint16))
    out["png_rgba16.png"] = png(wide, 16, 6)
    out["png_gray_alpha16.png"] = png(wide[..., :2], 16, 4)
    out["png_gamma_rgb.png"] = png(img[..., ::-1], 8, 2, extra=_png_chunk(
        b"gAMA", struct.pack(">I", 45455)))
    pal = rng.integers(0, 256, (16, 3))
    out["png_srgb_palette.png"] = png(rng.integers(0, 16, (h, w, 1)), 4, 3, palette=pal,
                                      extra=_png_chunk(b"sRGB", b"\0"))
    # BMP
    idx8 = rng.integers(0, 256, (h, w))
    pal256 = rng.integers(0, 256, (256, 3))
    out["bmp_core_8.bmp"] = bmp("core", 8, bmp_rows(idx8[::-1], 8), w, h, pal256)
    for bits in (1, 4):
        idx = rng.integers(0, 1 << bits, (h, w))
        out[f"bmp_info_{bits}.bmp"] = bmp("info", bits, bmp_rows(idx[::-1], bits), w, h,
                                          pal256[:1 << bits])
    out["bmp_gray_palette_8.bmp"] = imencode(".bmp", gray)
    out["bmp_24.bmp"] = imencode(".bmp", img)
    out["bmp_v4_24_top_down.bmp"] = bmp("v4", 24, bmp_rows(img, 24), w, h, top_down=True)
    out["bmp_32.bmp"] = bmp("info", 32, bmp_rows(np.dstack([img, gray])[::-1], 32), w, h)
    out["bmp_v5_32_bitfields.bmp"] = imencode(".bmp", np.dstack([img, gray]))
    words = rng.integers(0, 65536, (h, w))
    out["bmp_16_555.bmp"] = bmp("info", 16, bmp_rows(words[::-1], 16), w, h)
    out["bmp_16_565.bmp"] = bmp("info", 16, bmp_rows(words[::-1], 16), w, h, compression=3,
                                masks=(0xF800, 0x7E0, 0x1F))
    out["bmp_rle8.bmp"] = bmp("info", 8, rle_stream(rng, w, h, 8), w, h, pal256, compression=1)
    out["bmp_rle4.bmp"] = bmp("info", 4, rle_stream(rng, w, h, 4), w, h, pal256[:16],
                              compression=2)
    # PNM
    bits = (gray > 128).astype(np.int64)
    out["pnm_p1.pbm"] = pnm(1, bits, comments=True)
    out["pnm_p4.pbm"] = pnm(4, bits)
    out["pnm_p2_maxval_1000.pgm"] = pnm(2, gray.astype(np.int64) * 1000 // 255, 1000, True)
    out["pnm_p3_maxval_100.ppm"] = pnm(3, img[..., ::-1].astype(np.int64) * 100 // 255, 100)
    out["pnm_p5_maxval_100.pgm"] = pnm(5, gray.astype(np.int64) * 100 // 255, 100)
    out["pnm_p5_16bit.pgm"] = pnm(5, gray.astype(np.int64) * 257 + 13, 65535)
    out["pnm_p6.ppm"] = imencode(".ppm", img)
    # TIFF
    big = scene(rng, 40, 56)[0]
    big_gray = gray_of(big)
    g16 = big_gray.astype(np.int64)[..., None] * 257 + rng.integers(0, 257, (40, 56, 1))
    out["tiff_lzw_rgb.tif"] = imencode(".tif", big)
    out["tiff_none_gray.tif"] = tiff(big_gray[..., None], 8, 1)
    out["tiff_deflate_predictor_gray16.tif"] = tiff(g16, 16, 1, compression=8, predictor=2,
                                                    rows_per_strip=7)
    out["tiff_packbits_palette4.tif"] = tiff(rng.integers(0, 16, (40, 56, 1)), 4, 3,
                                             compression=32773, rows_per_strip=9,
                                             colormap=rng.integers(0, 65536, (3, 16)))
    out["tiff_tiles_gray16_clipped.tif"] = tiff(g16, 16, 1, compression=8, tile=(32, 16))
    out["tiff_tiles_lzw_rgb.tif"] = tiff(big[..., ::-1], 8, 2, compression=5, tile=(16, 16))
    out["tiff_planar2_rgb16_be.tif"] = tiff(rng.integers(0, 65536, (40, 56, 3)), 16, 2,
                                            compression=5, planar=2, order=">", rows_per_strip=8)
    out["tiff_miniswhite_1bit.tif"] = tiff((big_gray > 100)[..., None].astype(np.int64), 1, 0)
    out["tiff_rgba_unassociated.tif"] = tiff(np.dstack([big[..., ::-1], big_gray]), 8, 2,
                                             compression=8, extra=[2])
    out["tiff_orientation_3.tif"] = tiff(big_gray[..., None], 8, 1, orientation=3,
                                         compression=5, rows_per_strip=16)
    out["tiff_two_pages.tif"] = tiff(big_gray[..., None], 8, 1, compression=32946, pages=2)
    out["tiff_fill_order_2.tif"] = tiff(big_gray[..., None], 8, 1, fill_order=2)
    # WebP, lossless: scenes that make libwebp's encoder use each tool
    yy, xx = np.mgrid[0:45, 0:61]
    smooth = np.clip(np.stack([xx * 3 + yy, yy * 2 + 50 + xx,
                               128 + 60 * np.sin(xx / 7.0) * np.cos(yy / 5.0)], -1),
                     0, 255).astype(np.uint8)
    tiles = np.tile(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8), (6, 8, 1))[:45, :61]
    few = rng.integers(0, 256, (16, 3), dtype=np.uint8)[rng.integers(0, 16, (45, 61))]
    lossless = [cv2.IMWRITE_WEBP_QUALITY, 101]
    out["webp_lossless_smooth.webp"] = imencode(".webp", smooth, lossless)
    out["webp_lossless_tiles.webp"] = imencode(".webp", tiles, lossless)
    out["webp_lossless_16_colours.webp"] = imencode(".webp", few, lossless)
    out["webp_lossless_noise.webp"] = imencode(
        ".webp", rng.integers(0, 256, (64, 96, 3), dtype=np.uint8), lossless)
    # WebP, lossy, and re-encoded with other header settings
    noisy = np.clip(big + rng.normal(0, 6, big.shape), 0, 255).astype(np.uint8)
    for q in (5, 50, 95):
        out[f"webp_lossy_q{q}.webp"] = imencode(".webp", noisy, [cv2.IMWRITE_WEBP_QUALITY, q])
    out["webp_lossy_alpha.webp"] = imencode(".webp", np.dstack([noisy, big_gray]),
                                            [cv2.IMWRITE_WEBP_QUALITY, 60])
    src = out["webp_lossy_q50.webp"]
    for name, kw in (("simple_filter", dict(simple=1, sharpness=3)), ("sharpness_5",
                     dict(sharpness=5, level=30)), ("filter_deltas", dict(deltas=(4, -6))),
                     ("partitions_4", dict(partitions=4)), ("skip", dict(skip=True)),
                     ("segment_deltas", dict(segment_quant=[-10, 5, 20, 0]))):
        out[f"webp_lossy_{name}.webp"] = vp8_rewrite(src, **kw)
    # WebP containers
    kind, payload = image_chunk(out["webp_lossless_tiles.webp"])
    out["webp_exif_orientation_6.webp"] = riff([vp8x(8, 61, 45), webp_chunk(kind, payload),
                                                webp_chunk(b"EXIF", exif_tiff(6, ">"))])
    out["webp_icc_xmp.webp"] = riff([vp8x(32 | 4, 61, 45), webp_chunk(b"ICCP", bytes(64)),
                                     webp_chunk(kind, payload), webp_chunk(b"XMP ", b"<x/>")])
    small_kind, small = image_chunk(imencode(".webp", tiles[:20, :30], lossless))
    out["webp_animation.webp"] = riff([vp8x(2, 61, 45), webp_chunk(b"ANIM", bytes(6)),
                                       anmf(6, 4, 30, 20, webp_chunk(small_kind, small)),
                                       anmf(0, 0, 61, 45, webp_chunk(kind, payload))])
    return {f"cases/{k}": v for k, v in out.items()}


def sequence(rng: np.random.Generator) -> list[tuple[str, bytes]]:
    """The 12 frames of the mixed folder, (file name, bytes): the other
    formats at even indices, PNGs of the kinds this reads now at odd ones
    (the evaluation CLIs list ``.jpg`` and ``.png`` frames only)."""
    frames = scene(rng, *SEQUENCE_HW, SEQUENCE_FRAMES)
    out = []
    for i, img in enumerate(frames):
        gray = gray_of(img)
        level = (img.astype(np.int64) * 5 + 127) // 255  # a 6 x 6 x 6 colour cube
        writers = [
            ("bmp", lambda: imencode(".bmp", gray)),
            ("png", lambda: imencode(".png", gray.astype(np.uint16) * 257 + i)),
            ("pgm", lambda: imencode(".pgm", gray)),
            ("png", lambda: png(img[..., ::-1], 8, 2, interlace=1)),
            ("tiff", lambda: imencode(".tiff", img)),
            ("png", lambda: imencode(".png", img.astype(np.uint16) * 257)),
            ("webp", lambda: imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, 80])),
            ("png", lambda: png(img[..., ::-1], 8, 2, extra=_png_chunk(
                b"gAMA", struct.pack(">I", 45455)))),
            ("tiff", lambda: tiff(gray.astype(np.int64)[..., None] * 257, 16, 1, compression=8,
                                  predictor=2, rows_per_strip=16)),
            ("png", lambda: png(gray.astype(np.int64)[..., None] * 257, 16, 0, interlace=1)),
            ("webp", lambda: imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, 101])),
            ("png", lambda: png(level[..., 0:1] * 36 + level[..., 1:2] * 6 + level[..., 2:3], 8,
                                3, extra=_png_chunk(b"sRGB", b"\0"), palette=np.stack(np.meshgrid(
                                    *[np.arange(6) * 51] * 3, indexing="ij"), -1)[..., ::-1]
                                .reshape(216, 3))),
        ]
        name, write = writers[i]
        out.append((f"frame_{i:010d}.{name}", write()))
    return out


def sha(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=REPO / "tests" / "data" / "images")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))  # vp8_rewrite reads frames through the port's parser
    if args.out.exists():
        shutil.rmtree(args.out)
    rng = np.random.default_rng(args.seed)
    files = cases(rng)
    seq = "sequence_0000000001/frames"
    stamps = "".join(f"{i} {i / FPS:.9f}\n" for i in range(SEQUENCE_FRAMES))
    for name, data in sequence(rng):
        files[f"sequence/{seq}/{name}"] = data
    for rel, data in files.items():
        (args.out / rel).parent.mkdir(parents=True, exist_ok=True)
        (args.out / rel).write_bytes(data)
    for folder in ("sequence", "sequence_png"):
        (args.out / folder / seq).mkdir(parents=True, exist_ok=True)
        (args.out / folder / seq / "timestamps.txt").write_text(stamps)
    manifest = {}
    for rel in sorted(files):
        gray = cv2.imread(str(args.out / rel), cv2.IMREAD_GRAYSCALE)
        if gray is None:
            raise RuntimeError(f"cv2 does not read {rel}")
        manifest[rel] = {"shape": list(gray.shape), "sha256": sha(gray)}
        if rel.startswith("sequence/"):
            twin = f"sequence_png/{seq}/{Path(rel).stem}.png"
            (args.out / twin).write_bytes(imencode(".png", gray))
            manifest[twin] = {"shape": list(gray.shape), "sha256": sha(gray)}
    (args.out / "manifest.json").write_text(json.dumps(
        {"writer": "scripts/make_image_fixtures.py", "seed": args.seed, "cv2": cv2.__version__,
         "files": manifest}, indent=1) + "\n")
    total = sum(p.stat().st_size for p in args.out.rglob("*") if p.is_file())
    print(f"{len(manifest)} files and manifest.json under {args.out}: {total} bytes")


if __name__ == "__main__":
    main()
