"""PNG frames in and out with ``zlib``, ``struct`` and numpy.

The JAX package reads frames with ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``
and writes them with PIL; neither is installed beside the port on the card's
machine. ``read_gray`` returns what that ``cv2.imread`` call returns for the
PNGs it covers; ``write_gray`` writes 8-bit gray, what the CLI writes.

Read: 8-bit gray, gray + alpha, RGB, RGBA, and palette or gray at 1, 2, 4 or
8 bits, not interlaced, with any of the five row filters. Alpha and ``tRNS``
are dropped. Gray at 1, 2 or 4 bits is scaled to 8 bits (x255, x85, x17).
Colour goes to gray as libpng's ``png_set_rgb_to_gray(0.299, 0.587)`` does it
for OpenCV: ``(9797 R + 19234 G + 3737 B) >> 15``, truncated, and ``R`` itself
where ``R == G == B``. 16-bit samples, interlaced PNGs and JPEG frames raise a
ValueError that names what is missing. ``write_rgb`` writes the 8-bit RGB
previews and panels of the V2E2V CLI, what PIL writes for an ``[H, W, 3]``
uint8 array.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
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


def decode_gray(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """A PNG file's bytes -> ``[H, W]`` uint8 gray (see the module's notes)."""
    if data[:3] == JPEG_SIGNATURE:
        raise ValueError(f"{path}: JPEG frames are not supported by the port's reader yet "
                         "(ROADMAP.md queue 1, item 4); convert the frames to PNG")
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
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
        return samples[..., 0] * np.uint8(_GRAY_SCALE[depth])
    if color == 4:
        return np.ascontiguousarray(samples[..., 0])
    if color == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        index = samples[..., 0]
        if int(index.max(initial=0)) >= len(palette):
            raise ValueError(f"{path}: palette index out of range")
        return _to_gray(palette[index])
    return _to_gray(samples[..., :3])


def read_gray(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` for the PNGs this module reads."""
    with open(path, "rb") as f:
        return decode_gray(f.read(), path)


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
