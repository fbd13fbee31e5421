"""Frames in and out: PNG with ``zlib``, ``struct`` and numpy, JPEG through
``utils/jpeg.py``.

The JAX package reads frames with ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``
and writes them with PIL; neither is installed beside the port on the card's
machine. ``read_gray`` returns what that ``cv2.imread`` call returns for the
PNGs and JPEGs it covers, the EXIF orientation applied as OpenCV applies it;
``write_gray`` writes 8-bit gray, what the CLI writes.

PNG read: 8-bit gray, gray + alpha, RGB, RGBA, and palette or gray at 1, 2, 4
or 8 bits, not interlaced, with any of the five row filters. Alpha and
``tRNS`` are dropped. Gray at 1, 2 or 4 bits is scaled to 8 bits (x255, x85,
x17). Colour goes to gray as libpng's ``png_set_rgb_to_gray(0.299, 0.587)``
does it for OpenCV: ``(9797 R + 19234 G + 3737 B) >> 15``, truncated, and
``R`` itself where ``R == G == B``. The first ``eXIf`` chunk with a TIFF header
(libpng keeps that one) gives the orientation. 16-bit samples and interlaced
PNGs raise a ValueError that names what is missing; so do BMP, PNM, WebP and
TIFF files, which OpenCV also reads. ``write_rgb`` writes the 8-bit RGB
previews and panels of the V2E2V CLI, what PIL writes for an ``[H, W, 3]``
uint8 array. ``resize_linear_u8`` is ``cv2.resize`` at its default
``INTER_LINEAR`` on 8-bit gray, what the JAX package's video reader shrinks
frames with.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .jpeg import ROADMAP, decode_jpeg_gray

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
TIFF_HEADERS = (b"II*\x00", b"MM\x00*")
# samples per pixel of each colour type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_GRAY_SCALE = {1: 255, 2: 85, 4: 17, 8: 1}


def _chunks(data: bytes, path: str):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: CRC mismatch in PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG without IEND")


def _paeth_row(line: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 0xFF


def _average_row(line: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        line[i] = (line[i] + ((a + prior[i]) >> 1)) & 0xFF


def _unfilter(raw: bytes, height: int, stride: int, bpp: int, path: str) -> np.ndarray:
    """Undo the per-row filters; returns ``[height, stride]`` uint8."""
    if len(raw) < height * (stride + 1):
        raise ValueError(f"{path}: PNG image data is short")
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:  # None
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum per byte lane
            lanes = np.zeros(-(-stride // bpp) * bpp, np.int64)
            lanes[:stride] = line
            cur = (np.cumsum(lanes.reshape(-1, bpp), axis=0) & 0xFF).reshape(-1)[:stride]
            cur = cur.astype(np.uint8)
        elif kind == 2:  # Up
            cur = line + prior  # uint8 arithmetic wraps mod 256
        elif kind in (3, 4):  # Average, Paeth: sequential along the row
            buf = bytearray(line.tobytes())
            (_average_row if kind == 3 else _paeth_row)(buf, prior.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"{path}: unknown PNG row filter {kind}")
        out[y] = cur
        prior = out[y]
    return out


def _unpack(rows: np.ndarray, width: int, depth: int) -> np.ndarray:
    """Sub-byte samples (1, 2 or 4 bits, most significant first) -> one byte each."""
    if depth == 8:
        return rows[:, :width]
    per_byte = 8 // depth
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    samples = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return samples.reshape(rows.shape[0], rows.shape[1] * per_byte)[:, :width]


def _to_gray(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    gray = (9797 * r + 19234 * g + 3737 * b) >> 15
    return np.where((r == g) & (r == b), r, gray).astype(np.uint8)


def exif_orientation(exif: bytes) -> int | None:
    """The value of the orientation tag (0x0112) in IFD0 of ``exif``, a TIFF
    header in either byte order (``II`` or ``MM``) and its IFDs, read as
    OpenCV's Exif reader reads it: the first 16 bits of the entry's value,
    whatever its type. None where the header or IFD0 does not parse or has
    no such tag."""
    order = {b"II": "<", b"MM": ">"}.get(exif[:2])
    if order is None or len(exif) < 8:
        return None
    magic, ifd = struct.unpack(order + "HI", exif[2:8])
    if magic != 42 or ifd + 2 > len(exif):
        return None
    (count,) = struct.unpack(order + "H", exif[ifd:ifd + 2])
    for i in range(count):
        entry = exif[ifd + 2 + 12 * i:ifd + 12 + 12 * i]
        if len(entry) < 10:
            return None
        tag, value = struct.unpack(order + "H6xH", entry)
        if tag == 0x0112:
            return value
    return None


def apply_orientation(img: np.ndarray, exif: bytes) -> np.ndarray:
    """``img`` turned by the orientation tag of ``exif`` (see
    ``exif_orientation``) as OpenCV's ``imread`` turns it: 2 flips
    left-right, 3 rotates 180, 4 flips up-down, 5 transposes, 6 rotates 90
    clockwise, 7 transverses, 8 rotates 90 counter-clockwise. No tag, or any
    other value, leaves ``img`` as it is."""
    orientation = exif_orientation(exif)
    if orientation in (5, 6, 7, 8):
        img = img.T
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def _other_format(data: bytes) -> str | None:
    """The name of an image format OpenCV reads and the port does not."""
    if data[:2] == b"BM":
        return "BMP"
    if len(data) >= 2 and data[0] == 0x50 and 0x31 <= data[1] <= 0x36:  # P1-P6
        return "PNM"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    if data[:4] in TIFF_HEADERS:
        return "TIFF"
    return None


def decode_gray(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """A PNG or JPEG file's bytes -> ``[H, W]`` uint8 gray, as
    ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` (see the module's notes)."""
    if data[:3] == JPEG_SIGNATURE:
        return decode_jpeg_gray(data, path)
    other = _other_format(data)
    if other is not None:
        raise ValueError(f"{path}: {other} frames are not supported by the port's reader "
                         f"({ROADMAP}); convert the frames to PNG or JPEG")
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, palette, idat, exif = None, None, [], None
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"eXIf" and exif is None and body[:4] in TIFF_HEADERS:
            exif = body
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, color, _comp, _filt, interlace = header
    if color not in _CHANNELS:
        raise ValueError(f"{path}: unknown PNG colour type {color}")
    if depth == 16:
        raise ValueError(f"{path}: 16-bit PNG samples are not supported by the port's reader")
    if depth not in (1, 2, 4, 8) or (depth != 8 and color not in (0, 3)):
        raise ValueError(f"{path}: bit depth {depth} is invalid for PNG colour type {color}")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNGs are not supported by the port's "
                         "reader")
    channels = _CHANNELS[color]
    stride = -(-width * channels * depth // 8)
    raw = zlib.decompress(b"".join(idat))
    rows = _unfilter(raw, height, stride, max(1, channels * depth // 8), path)
    samples = _unpack(rows, width * channels, depth).reshape(height, width, channels)
    if color == 0:
        gray = samples[..., 0] * np.uint8(_GRAY_SCALE[depth])
    elif color == 4:
        gray = np.ascontiguousarray(samples[..., 0])
    elif color == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        index = samples[..., 0]
        if int(index.max(initial=0)) >= len(palette):
            raise ValueError(f"{path}: palette index out of range")
        gray = _to_gray(palette[index])
    else:
        gray = _to_gray(samples[..., :3])
    return gray if exif is None else apply_orientation(gray, exif)


def read_gray(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` for the PNGs and JPEGs this
    module reads."""
    with open(path, "rb") as f:
        return decode_gray(f.read(), path)


RESIZE_COEF_BITS = 11  # imgproc/resize.cpp: INTER_RESIZE_COEF_BITS


def _linear_taps(src: int, dst: int, clamp: bool):
    """``resize.cpp``'s linear taps of each output index: the two source
    indices (clipped into the image) and their weights at 11 bits. The
    position ``(d + 0.5) * src / dst - 0.5`` is a float; horizontally a tap
    that falls outside the image is moved onto its edge with weight 0
    (``clamp``), vertically the weights stay and both rows are clipped."""
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    s0 = np.floor(f).astype(np.int64)
    f = (f - s0).astype(np.float32)
    if clamp:
        out = (s0 < 0) | (s0 >= src - 1)
        f[out] = 0
        s0 = np.clip(s0, 0, src - 1)
    one = np.float32(1 << RESIZE_COEF_BITS)
    w0 = np.rint((np.float32(1) - f) * one).astype(np.int64)
    w1 = np.rint(f * one).astype(np.int64)
    return np.clip(s0, 0, src - 1), np.clip(s0 + 1, 0, src - 1), w0, w1


def resize_linear_u8(img: np.ndarray, dsize: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, dsize)`` (``dsize = (width, height)``,
    ``INTER_LINEAR``) on ``[H, W]`` uint8, bit for bit: a horizontal pass of
    11-bit weights into ints, then the vertical pass as OpenCV's SIMD
    ``VResizeLinearVec_32s8u`` rounds it, ``((S0 >> 4) * b0 >> 16) +
    ((S1 >> 4) * b1 >> 16)``, then ``+ 2 >> 2``, saturated. An exact
    2x downscale, which cv2 hands to ``INTER_AREA``, gives the same 2 x 2
    means. Held against cv2 on random sizes up and down."""
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"resize_linear_u8 takes an [H, W] uint8 image, got {img.dtype} "
                         f"{img.shape}")
    w, h = (int(v) for v in dsize)
    if w <= 0 or h <= 0:
        raise ValueError(f"resize_linear_u8: an empty output size {dsize}")
    x0, x1, a0, a1 = _linear_taps(img.shape[1], w, True)
    y0, y1, b0, b1 = _linear_taps(img.shape[0], h, False)
    s = img.astype(np.int64)
    rows = (s[:, x0] * a0 + s[:, x1] * a1) >> 4
    out = ((rows[y0] * b0[:, None]) >> 16) + ((rows[y1] * b1[:, None]) >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _encode(img: np.ndarray, color: int) -> bytes:
    """``[H, W]`` (gray) or ``[H, W, 3]`` (RGB) uint8 -> PNG bytes, 8 bits per
    sample, filter None on every row, zlib level 6."""
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + img[0].size), np.uint8)
    rows[:, 1:] = img.reshape(h, -1)
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def encode_gray(img: np.ndarray) -> bytes:
    """``[H, W]`` uint8 -> the bytes of an 8-bit gray PNG (filter None)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"write_gray takes a 2-D uint8 image, got {img.dtype} {img.shape}")
    return _encode(img, 0)


def encode_rgb(img: np.ndarray) -> bytes:
    """``[H, W, 3]`` uint8 -> the bytes of an 8-bit RGB PNG (colour type 2,
    filter None); channel 0 is stored as red, as PIL stores such an array."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_rgb takes an [H, W, 3] uint8 image, got {img.dtype} {img.shape}")
    return _encode(img, 2)


def _write(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def write_gray(path: str, img: np.ndarray) -> None:
    """Write ``[H, W]`` uint8 as an 8-bit gray PNG."""
    _write(path, encode_gray(img))


def write_rgb(path: str, img: np.ndarray) -> None:
    """Write ``[H, W, 3]`` uint8 as an 8-bit RGB PNG."""
    _write(path, encode_rgb(img))
