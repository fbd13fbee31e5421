"""BMP frames with numpy: ``decode_bmp_gray`` returns what
``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` returns for a BMP file, bit for bit.

OpenCV reads BMP with its own decoder (``imgcodecs/src/grfmt_bmp.cpp``), and
this follows it:

- headers: ``BITMAPINFOHEADER`` and every longer one (V2-V5; OpenCV reads the
  first 40 bytes and skips the rest), and the OS/2 ``BITMAPCOREHEADER``
  (16-bit sizes, palette entries of 3 bytes). A negative height stores the
  rows top-down, a positive one bottom-up;
- 1, 4 and 8 bits through a palette of ``biClrUsed`` entries (all ``1 <<
  bits`` where 0; entries past the palette are black), RLE4 and RLE8 as
  OpenCV walks them (an escape fills what it skips with palette entry 0, a
  run of RLE8 that ends a row moves to the next one and a following
  end-of-line is then ignored; in RLE4 an end of bitmap or a delta fills to
  the end of the row or by dx only, so an end of bitmap before the last row
  is read past, and the file is refused when its data ends), 16 bits as
  5-5-5 (``BI_RGB``) or through
  ``BI_BITFIELDS`` masks that are 5-5-5 or 5-6-5, 24 bits, and 32 bits (the
  fourth byte ignored);
- colour to gray through imgcodecs' 14-bit ``icvCvt_BGR2Gray_8u``
  (``imgcodecs.imgcodecs_gray``), palette entries once each
  (``CvtPaletteToGray``); 16-bit pixels widen each field by shifting it to
  the top of a byte, as ``icvCvt_BGR5552Gray_8u`` does.
- 32 bits with ``BI_BITFIELDS`` and a header of 56 bytes or more (V3-V5,
  which carry the masks; what ``cv2.imwrite`` writes for BGRA) take OpenCV
  5's other route, found by probing: each channel is its masked field times
  ``255 / max`` in float32, truncated, and gray is ``0.299 R + 0.587 G +
  0.114 B`` in float32, summed in that order and truncated; every one of the
  2^24 triples gives cv2's gray. A zero or non-contiguous mask raises.

OpenCV reads the ``BI_BITFIELDS`` masks of a 16-bit file from the bytes after
the header: in a V4 or V5 header they are inside it, so OpenCV reads whatever
follows and refuses the file unless those bytes happen to be 5-5-5 or 5-6-5
masks; so does this. Other compressions (JPEG, PNG, ``BI_ALPHABITFIELDS``),
other masks, truncated pixel data and RLE codes that run past a row, all of
which OpenCV refuses, raise a ValueError naming ROADMAP.md queue 1, item 4.
"""

from __future__ import annotations

import struct

import numpy as np

from .imgcodecs import ROADMAP, imgcodecs_gray

BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3
MASKS_555 = (0x7C00, 0x3E0, 0x1F)  # red, green, blue
MASKS_565 = (0xF800, 0x7E0, 0x1F)


def _refused(path: str, what: str) -> ValueError:
    return ValueError(f"{path}: {what}: not a BMP that OpenCV reads, nor the port ({ROADMAP})")


def _header(data: bytes, path: str):
    """(offset, width, signed height, bits, compression, gray palette,
    masks) as ``BmpDecoder::readHeader`` reads them; bits is 15 for 5-5-5,
    palette None above 8 bits, masks (red, green, blue) for the float
    route, else None."""
    if len(data) < 18:
        raise _refused(path, "truncated header")
    offset, size = struct.unpack_from("<Ii", data, 10)
    pos = 14 + size
    if size >= 36:
        if len(data) < 50:
            raise _refused(path, "truncated header")
        width, height, _planes, bits, compression = struct.unpack_from("<iiHHI", data, 18)
        clr_used = struct.unpack_from("<i", data, 46)[0]
        ok = width > 0 and height != 0 and (
            (bits in (1, 4, 8, 24, 32) and compression == BI_RGB)
            or (bits in (16, 32) and compression in (BI_RGB, BI_BITFIELDS))
            or (bits == 4 and compression == BI_RLE4) or (bits == 8 and compression == BI_RLE8))
        if not ok:
            raise _refused(path, f"{bits} bits with compression {compression}")
        palette = None
        if bits <= 8:
            if not 0 <= clr_used <= 256:
                raise _refused(path, f"biClrUsed {clr_used}")
            n = clr_used or 1 << bits
            entries = np.zeros((256, 4), np.uint8)
            raw = np.frombuffer(data[pos:pos + 4 * n], np.uint8)
            if raw.size != 4 * n:
                raise _refused(path, "truncated palette")
            entries[:n] = raw.reshape(n, 4)
            palette = imgcodecs_gray(entries[:, 0], entries[:, 1], entries[:, 2])
        elif bits == 16 and compression == BI_BITFIELDS:
            masks = struct.unpack_from("<III", data, pos) if len(data) >= pos + 12 else None
            if masks == MASKS_555:
                bits = 15
            elif masks != MASKS_565:
                raise _refused(path, f"16-bit masks {masks} (only 5-5-5 and 5-6-5 are read)")
        elif bits == 16:
            bits = 15
        elif bits == 32 and compression == BI_BITFIELDS and size >= 56:
            masks = struct.unpack_from("<III", data, 54)
            for m in masks:
                if m == 0 or (m >> _shift(m)) & ((m >> _shift(m)) + 1):
                    raise _refused(path, f"32-bit masks {[hex(m) for m in masks]}: a zero or "
                                         "non-contiguous mask")
            return offset, width, height, bits, compression, None, masks
        return offset, width, height, bits, compression, palette, None
    if size == 12:  # OS/2 BITMAPCOREHEADER: unsigned 16-bit sizes, BGR palette entries
        if len(data) < 26:
            raise _refused(path, "truncated header")
        width, height, _planes, bits = struct.unpack_from("<HHHH", data, 18)
        if not (width > 0 and height != 0 and bits in (1, 4, 8, 24, 32)):
            raise _refused(path, f"OS/2 header with {bits} bits")
        palette = None
        if bits <= 8:
            n = 1 << bits
            raw = np.frombuffer(data[pos:pos + 3 * n], np.uint8)
            if raw.size != 3 * n:
                raise _refused(path, "truncated palette")
            entries = np.zeros((256, 3), np.uint8)
            entries[:n] = raw.reshape(n, 3)
            palette = imgcodecs_gray(entries[:, 0], entries[:, 1], entries[:, 2])
        return offset, width, height, bits, BI_RGB, palette, None
    raise _refused(path, f"header size {size}")


def _shift(mask: int) -> int:
    return (mask & -mask).bit_length() - 1


def _masked(rows: np.ndarray, width: int, masks) -> np.ndarray:
    """The float route of 32-bit ``BI_BITFIELDS`` files with a V3-V5 header."""
    v = rows[:, :4 * width].view("<u4").astype(np.int64)
    f32 = np.float32
    r, g, b = (np.floor(((v & m) >> _shift(m)).astype(f32) * (f32(255) / f32(m >> _shift(m))))
               for m in masks)
    return np.floor(r * f32(0.299) + g * f32(0.587) + b * f32(0.114)).astype(np.uint8)


def _rows(data: bytes, offset: int, width: int, height: int, bits: int, path: str) -> np.ndarray:
    """The uncompressed rows in file order, ``[height, pitch]`` uint8."""
    pitch = ((width * (16 if bits == 15 else bits) + 7) // 8 + 3) & -4
    raw = np.frombuffer(data[offset:offset + pitch * height], np.uint8)
    if offset < 0 or raw.size != pitch * height:
        raise _refused(path, "truncated pixel data")
    return raw.reshape(height, pitch)


def _uncompressed(rows: np.ndarray, width: int, bits: int, palette) -> np.ndarray:
    if bits <= 8:
        per = 8 // bits
        shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
        index = ((rows[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(rows.shape[0], -1)
        return palette[index[:, :width]]
    if bits in (15, 16):
        v = rows[:, :2 * width].view("<u2").astype(np.int64)
        b = (v << 3) & 0xF8
        if bits == 15:
            g, r = (v >> 2) & 0xF8, (v >> 7) & 0xF8
        else:
            g, r = (v >> 3) & 0xFC, (v >> 8) & 0xF8
        return imgcodecs_gray(b, g, r)
    n = bits // 8
    px = rows[:, :n * width].reshape(rows.shape[0], width, n)
    return imgcodecs_gray(px[..., 0], px[..., 1], px[..., 2])


class _Rle:
    """``BmpDecoder::readData``'s RLE walk over rows in file order: ``d`` is
    the next pixel, ``line_end`` the end of its row, ``y`` the rows done."""

    def __init__(self, width: int, height: int, fill: int):
        self.out = np.zeros(width * height, np.uint8)
        self.width, self.height, self.fill = width, height, fill
        self.d, self.line_end, self.y = 0, width, 0

    def fill_run(self, count: int, value: int) -> None:
        """``FillUniGray``: ``count`` pixels of ``value``, moving to the next
        row whenever a row fills (at least once, even for 0)."""
        while True:
            end = min(self.d + count, self.line_end)
            count -= end - self.d
            self.out[self.d:end] = value
            self.d = end
            if self.d >= self.line_end:
                self.line_end += self.width
                self.d = self.line_end - self.width
                self.y += 1
                if self.y >= self.height:
                    return
            if count <= 0:
                return


def _rle(data: bytes, offset: int, width: int, height: int, bits: int, palette: np.ndarray,
         path: str) -> np.ndarray:
    s = _Rle(width, height, int(palette[0]))
    pos, n = offset, len(data)
    line_end_flag = 0
    while True:
        if pos + 2 > n:
            raise _refused(path, "RLE data ends before its end-of-bitmap code")
        length, code = data[pos], data[pos + 1]
        pos += 2
        if length:  # a run of one index (RLE8) or of two alternating ones (RLE4)
            if s.d + length > s.line_end:
                raise _refused(path, "an RLE run past the end of its row")
            if bits == 8:
                y0 = s.y
                s.fill_run(length, int(palette[code]))
                line_end_flag = s.y - y0
                if s.y >= height:
                    break
            else:
                pair = palette[[code >> 4, code & 15]]
                s.out[s.d:s.d + length] = np.resize(pair, length)
                s.d += length
        elif code > 2:  # absolute: ``code`` indices, padded to 16 bits
            if s.d + code > s.line_end:
                raise _refused(path, "an RLE run past the end of its row")
            size = (code + 1) & ~1 if bits == 8 else (((code + 1) >> 1) + 1) & ~1
            raw = np.frombuffer(data[pos:pos + size], np.uint8)
            if raw.size != size:
                raise _refused(path, "truncated RLE data")
            pos += size
            index = raw if bits == 8 else np.stack([raw >> 4, raw & 15], 1).reshape(-1)
            s.out[s.d:s.d + code] = palette[index[:code]]
            s.d += code
            line_end_flag = 0
        else:  # 0 end of row, 1 end of bitmap, 2 delta: skipped pixels take entry 0
            x_shift, y_shift = s.line_end - s.d, height - s.y
            if bits == 8 and not (code or not line_end_flag or x_shift < width):
                line_end_flag = 0  # the run before already moved to this row
                continue
            if code == 2:
                if pos + 2 > n:
                    raise _refused(path, "truncated RLE data")
                x_shift, y_shift = data[pos], data[pos + 1]
                pos += 2
            # RLE8 fills through the rows an end of bitmap or a delta skips;
            # OpenCV's RLE4 fills ``x_shift`` only (the row's rest, or dx), and
            # reads on past an end of bitmap that leaves rows unfilled
            count = x_shift + (y_shift * width if code and bits == 8 else 0)
            if s.y >= height:
                break
            s.fill_run(count, s.fill)
            line_end_flag = 0
            if s.y >= height:
                break
    return s.out.reshape(height, width)


def decode_bmp_gray(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """A BMP file's bytes -> ``[H, W]`` uint8 gray (see the module's notes)."""
    offset, width, height, bits, compression, palette, masks = _header(data, path)
    rows = abs(height)
    if compression in (BI_RLE4, BI_RLE8):
        gray = _rle(data, offset, width, rows, bits, palette, path)
    elif masks is not None:
        gray = _masked(_rows(data, offset, width, rows, bits, path), width, masks)
    else:
        gray = _uncompressed(_rows(data, offset, width, rows, bits, path), width, bits, palette)
    return np.ascontiguousarray(gray[::-1] if height > 0 else gray)
