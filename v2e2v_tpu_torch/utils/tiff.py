"""TIFF frames with numpy and ``zlib``: ``decode_tiff_gray`` returns what
``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` returns for a TIFF file, bit for
bit.

OpenCV reads TIFF through libtiff. For 8-bit output it reads every strip or
tile with ``TIFFReadRGBAStrip`` / ``TIFFReadRGBATile`` (libtiff's
``TIFFRGBAImage``, ``tif_getimage.c``) and turns each RGBA pixel to gray with
imgcodecs' 14-bit ``icvCvt_BGRA2Gray_8u`` (``imgcodecs.imgcodecs_gray``).
This follows both, for the first image (IFD) of the file:

- strips or tiles, planar configuration 1 (contiguous) or 2 (a plane each),
  bits in either fill order;
- compression none, LZW (``tif_lzw.c``'s codes, MSB first), Deflate (8 and
  32946, through ``zlib``) and PackBits; horizontal differencing (predictor
  2) at 8 and 16 bits;
- MinIsBlack and MinIsWhite at 1, 8 and 16 bits, RGB at 8 and 16, palette at
  1, 4 and 8 bits (OpenCV refuses 2 bits, and 4-bit gray); RGB with or
  without a fourth (alpha) sample, gray with one in contiguous strips;
- libtiff's mapping of each to 8-bit RGBA: gray ``x * 255 / (2^bits - 1)``
  (MinIsWhite from the top), 16-bit gray by its high byte, 16-bit colour by
  ``(x + 128) / 257``, a palette's 16-bit entries by their high byte (or as
  they are where every entry is below 256, as ``checkcmap`` guesses), and
  unassociated alpha premultiplied (``(v a + 127) / 255``); and its
  ``put16bitbwtile``, which steps through a 16-bit gray tile that the right
  edge clips by bytes where it means samples (``_skewed``);
- the orientation tag as ``cv2.imread`` applies it, found by probing: 2-4
  mirror and turn the image as ``imgcodecs.oriented`` does; ``cv2.imread``
  fails on 5-8 (``imdecode`` transposes), so those raise.

Other compressions (JPEG, old JPEG, CCITT, ZSTD, ...), old-style LZW,
floating-point or signed samples, predictor 3, other photometric
interpretations (YCbCr, CMYK, CIELab, ...), other bit depths, alpha beside
palettes or in gray tiles and planes, orientations 5-8, tiles under 2 or 3
(libtiff mirrors each tile), uncompressed tiles (libtiff 4.7
refuses their byte counts for OpenCV), BigTIFF and truncated or corrupt data
raise a ValueError naming ROADMAP.md queue 1, item 4. OpenCV reads some of
them; OpenCV 5.0.0 crashes on some JPEG-in-TIFF files.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .imgcodecs import ROADMAP, imgcodecs_gray, oriented

MINISWHITE, MINISBLACK, RGB, PALETTE = 0, 1, 2, 3
# field type -> (struct code, size)
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("I", 4), 6: ("b", 1),
          7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("i", 4), 11: ("f", 4), 12: ("d", 8),
          13: ("I", 4)}
_PAIRS = (5, 10)  # RATIONAL, SRATIONAL: two numbers per value
_REVERSED = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))
COMPRESSIONS = (1, 5, 8, 32946, 32773)  # none, LZW, Deflate (twice), PackBits


def _refused(path: str, what: str) -> ValueError:
    return ValueError(f"{path}: TIFF {what} is not supported by the port's TIFF reader "
                      f"({ROADMAP})")


def _ifd0(data: bytes, path: str) -> tuple[str, dict[int, tuple]]:
    """The byte order and the first IFD's fields, tag -> values."""
    order = {b"II": "<", b"MM": ">"}.get(data[:2])
    if order is None or len(data) < 8:
        raise _refused(path, "header")
    magic, offset = struct.unpack(order + "HI", data[2:8])
    if magic != 42:
        raise _refused(path, f"version {magic} (BigTIFF)" if magic == 43 else f"magic {magic}")
    if offset + 2 > len(data):
        raise _refused(path, "truncated file (IFD)")
    (count,) = struct.unpack_from(order + "H", data, offset)
    if offset + 2 + 12 * count > len(data):
        raise _refused(path, "truncated file (IFD)")
    fields = {}
    for i in range(count):
        tag, kind, n, value = struct.unpack_from(order + "HHI4s", data, offset + 2 + 12 * i)
        if kind not in _TYPES:
            continue
        code, size = _TYPES[kind]
        n_items = n * (2 if kind in _PAIRS else 1)
        nbytes = n_items * size
        if nbytes <= 4:
            raw = value[:nbytes]
        else:
            (at,) = struct.unpack(order + "I", value)
            raw = data[at:at + nbytes]
            if len(raw) != nbytes:
                raise _refused(path, f"truncated file (tag {tag})")
        fields[tag] = struct.unpack(f"{order}{n_items}{code}", raw)
    return order, fields


def _lzw(src: bytes, size: int, path: str) -> bytes:
    """``tif_lzw.c::LZWDecode``: codes of 9-12 bits, most significant bit
    first, the width growing one code early; 256 clears, 257 ends."""
    if len(src) >= 2 and src[0] == 0 and src[1] & 1:
        raise _refused(path, "old-style (LSB-first) LZW")
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    width, pos, nbits = 9, 0, len(src) * 8
    padded = src + b"\0\0\0"
    old = None
    while len(out) < size and pos + width <= nbits:  # libtiff tolerates a missing end code
        at = pos >> 3
        code = (int.from_bytes(padded[at:at + 3], "big") >> (24 - (pos & 7) - width)) & (
            (1 << width) - 1)
        pos += width
        if code == 257:
            break
        if code == 256:
            del table[258:]
            width, old = 9, None
            continue
        if old is None:
            if code > 255:
                raise _refused(path, "corrupt LZW data")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(old + entry[:1])
        elif code == len(table):
            entry = old + old[:1]
            table.append(entry)
        else:
            raise _refused(path, "corrupt LZW data")
        out += entry
        old = entry
        if len(table) >= (1 << width) - 1 and width < 12:
            width += 1
    if len(out) < size:
        raise _refused(path, "truncated LZW data")
    return bytes(out[:size])


def _packbits(src: bytes, size: int, path: str) -> bytes:
    out = bytearray()
    pos = 0
    while len(out) < size and pos < len(src):
        n = src[pos]
        pos += 1
        if n < 128:
            out += src[pos:pos + n + 1]
            pos += n + 1
        elif n > 128:
            out += src[pos:pos + 1] * (257 - n)
            pos += 1
    if len(out) < size:
        raise _refused(path, "truncated PackBits data")
    return bytes(out[:size])


def _decompress(src: bytes, compression: int, size: int, path: str) -> bytes:
    if compression == 1:
        out = src[:size]
    elif compression == 5:
        out = _lzw(src, size, path)
    elif compression in (8, 32946):
        try:
            out = zlib.decompressobj().decompress(src, size)
        except zlib.error as e:
            raise _refused(path, f"corrupt Deflate data ({e})") from None
    else:
        out = _packbits(src, size, path)
    if len(out) < size:
        raise _refused(path, "truncated image data")
    return out


def _undo_predictor(block: np.ndarray, samples: int) -> np.ndarray:
    """Horizontal differencing undone along each row of ``[rows, cols *
    samples]`` (uint8 or uint16), per sample."""
    rows = block.reshape(block.shape[0], -1, samples)
    return np.cumsum(rows, axis=1, dtype=block.dtype).reshape(block.shape)


def _skewed(block: np.ndarray, visible: int) -> np.ndarray:
    """A 16-bit gray tile that the image's right edge clips, as
    ``tif_getimage.c::put16bitbwtile`` reads it: it steps to the next row by
    ``tw - visible`` bytes where it should step by as many samples, so row
    ``r`` starts ``r * (2 visible + tw - visible)`` bytes into the tile's
    native (little-endian) buffer, and each sample it takes is the 16 bits
    at its byte, of which only the high byte counts."""
    rows, tw = block.shape
    buf = np.concatenate([block.astype("<u2").view(np.uint8).reshape(-1), np.zeros(1, np.uint8)])
    starts = np.arange(rows) * (2 * visible + tw - visible)
    high = buf[starts[:, None] + 2 * np.arange(visible)[None, :] + 1]
    out = np.zeros_like(block)
    out[:, :visible] = high.astype(np.uint16) << 8
    return out


def _samples(data: bytes, order: str, f: dict, width: int, height: int, bits: int, spp: int,
             path: str) -> np.ndarray:
    """Every sample of the image, ``[H, W, spp]`` (uint8 or uint16;
    sub-byte samples one a byte)."""
    compression = f.get(259, (1,))[0]
    predictor = f.get(317, (1,))[0]
    planar = f.get(284, (1,))[0]
    planes, per_pixel = (spp, 1) if planar == 2 and spp > 1 else (1, spp)
    if 322 in f:
        tw, th = f[322][0], f[323][0]
        offsets, counts = f.get(324), f.get(325)
    else:
        tw, th = width, min(f.get(278, (height,))[0], height) or height
        offsets, counts = f.get(273), f.get(279)
    if offsets is None or counts is None:
        raise _refused(path, "file without strip or tile offsets")
    across, down = -(-width // tw), -(-height // th)
    if len(offsets) < across * down * planes or len(counts) < len(offsets):
        raise _refused(path, "file with too few strips or tiles")
    dtype = np.dtype(order + "u2") if bits == 16 else np.dtype(np.uint8)
    stride = -(-tw * per_pixel * bits // 8)
    out = np.zeros((planes, down * th, across * tw, per_pixel), np.uint16 if bits == 16 else
                   np.uint8)
    k = 0
    for p in range(planes):
        for ty in range(down):
            for tx in range(across):
                rows = th if 322 in f else min(th, height - ty * th)
                raw = data[offsets[k]:offsets[k] + counts[k]]
                if f.get(266, (1,))[0] == 2:  # FillOrder 2: each byte's bits reversed
                    raw = raw.translate(_REVERSED)
                block = np.frombuffer(_decompress(raw, compression, rows * stride, path),
                                      np.uint8).reshape(rows, stride)
                k += 1
                if bits == 16:
                    block = block.view(dtype).astype(np.uint16)
                elif bits < 8:
                    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
                    block = ((block[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(rows, -1)
                if predictor == 2:
                    block = _undo_predictor(block[:, :tw * per_pixel], per_pixel)
                if bits == 16 and spp == 1 and 322 in f and (tx + 1) * tw > width:
                    block = _skewed(block, width - tx * tw)
                block = block[:, :tw * per_pixel]
                out[p, ty * th:ty * th + rows, tx * tw:(tx + 1) * tw] = block.reshape(
                    rows, tw, per_pixel)
    out = out[:, :height, :width]
    return np.concatenate(list(out), axis=-1) if planes > 1 else out[0]


def _to_rgb(samples: np.ndarray, f: dict, photometric: int, bits: int, extra: tuple,
            path: str):
    """``TIFFRGBAImage``'s 8-bit R, G, B planes."""
    if photometric in (MINISBLACK, MINISWHITE):
        v = samples[..., 0].astype(np.int64)
        if bits == 16:
            v, top = v >> 8, 255
        else:
            top = (1 << bits) - 1
        v = ((top - v) if photometric == MINISWHITE else v) * 255 // top
        return v, v, v
    if photometric == PALETTE:
        cmap = f.get(320)
        n = 1 << bits
        if cmap is None or len(cmap) < 3 * n:
            raise _refused(path, "palette image without a full ColorMap")
        cmap = np.array(cmap[:3 * n], np.int64).reshape(3, n)
        if cmap.max() >= 256:  # tif_getimage.c::checkcmap: else an 8-bit map, taken as it is
            cmap = cmap >> 8
        index = samples[..., 0].astype(np.int64)
        return cmap[0][index], cmap[1][index], cmap[2][index]
    rgb = samples[..., :3].astype(np.int64)
    if bits == 16:
        rgb = (rgb + 128) // 257  # tif_getimage.c::BuildMapBitdepth16To8
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    if extra and extra[0] == 2:  # unassociated alpha: premultiplied (BuildMapUaToAa)
        a = samples[..., 3].astype(np.int64)
        if bits == 16:
            a = (a + 128) // 257
        r, g, b = ((c * a + 127) // 255 for c in (r, g, b))
    return r, g, b


def decode_tiff_gray(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """A TIFF file's bytes -> ``[H, W]`` uint8 gray (see the module's notes)."""
    order, f = _ifd0(data, path)
    if 256 not in f or 257 not in f:
        raise _refused(path, "file without its image size")
    width, height = f[256][0], f[257][0]
    spp = f.get(277, (1,))[0]
    bits_all = set(f.get(258, (1,))[:spp])
    bits = bits_all.pop() if len(bits_all) == 1 else None
    compression = f.get(259, (1,))[0]
    photometric = f.get(262, (None,))[0]
    extra = f.get(338, ())
    if width == 0 or height == 0:
        raise _refused(path, f"image of {width}x{height}")
    if compression not in COMPRESSIONS:
        raise _refused(path, f"compression {compression}")
    if set(f.get(339, (1,))) != {1}:
        raise _refused(path, f"sample format {f[339]} (not unsigned integers)")
    if f.get(317, (1,))[0] not in (1, 2) or (f.get(317, (1,))[0] == 2 and bits not in (8, 16)):
        raise _refused(path, f"predictor {f.get(317)} at {bits} bits")
    if f.get(266, (1,))[0] not in (1, 2):
        raise _refused(path, f"FillOrder {f[266]}")
    if f.get(284, (1,))[0] not in (1, 2):
        raise _refused(path, f"planar configuration {f[284]}")
    # what OpenCV's header check and TIFFRGBAImage both take, with one extra
    # sample (alpha, tagged or not) at most; libtiff skews the pixels of gray
    # with alpha in tiles and in separate planes, and of palettes with alpha
    tiled = 322 in f
    colour = {MINISBLACK: 1, MINISWHITE: 1, PALETTE: 1, RGB: 3}.get(photometric)
    depths = {MINISBLACK: (1, 8, 16), MINISWHITE: (1, 8, 16), PALETTE: (1, 4, 8), RGB: (8, 16)}
    alpha = spp - (colour or 0)
    if (colour is None or bits not in depths[photometric] or alpha not in (0, 1)
            or len(extra) > alpha or (alpha and photometric != RGB and (
                photometric == PALETTE or tiled or f.get(284, (1,))[0] == 2))):
        raise _refused(path, f"photometric interpretation {photometric} with {spp} samples of "
                             f"{sorted(set(f.get(258, (1,))))} bits")
    if tiled and compression == 1:  # libtiff 4.7: "Invalid tile byte count"
        raise _refused(path, "uncompressed tiles (which OpenCV refuses too)")
    orientation = f.get(274, (1,))[0]
    if orientation in (5, 6, 7, 8):  # imread's check of its buffer fails on the turned image
        raise _refused(path, f"orientation {orientation} (which cv2.imread refuses too)")
    if tiled and orientation in (2, 3):
        raise _refused(path, f"tiles with orientation {orientation} (libtiff mirrors each tile)")
    samples = _samples(data, order, f, width, height, bits, spp, path)
    r, g, b = _to_rgb(samples, f, photometric, bits, extra, path)
    gray = imgcodecs_gray(b, g, r)
    return oriented(gray, orientation)
