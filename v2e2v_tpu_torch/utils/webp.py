"""WebP frames with numpy and plain Python: ``decode_webp_gray`` returns what
``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` returns for a WebP file, bit for
bit.

OpenCV decodes a WebP file with libwebp to BGR (``WebPDecodeBGRInto``, or BGRA
where the file has alpha; alpha does not reach gray) and then takes
``cvtColor(COLOR_BGR2GRAY)``, OpenCV 5's 15-bit one (``utils/yuv.bgr_to_gray``).
This reads:

- the RIFF container: a simple file (one ``VP8 `` or ``VP8L`` chunk) or an
  extended one (``VP8X``) with ``ICCP``, ``ALPH``, ``EXIF`` and ``XMP ``
  chunks; where ``VP8X`` flags EXIF, the first ``EXIF`` chunk's orientation
  is applied as OpenCV applies it (``imgcodecs.oriented``; a chunk that starts
  ``Exif\\0\\0`` has none it reads); an animation gives its first frame on a
  transparent (black) canvas, as ``cv2.imread`` does;
- lossless images (``VP8L``, RFC 9649), decoded here: prefix codes (simple and
  normal), meta prefix codes (the entropy image), LZ77 backward references
  with the distance map, the colour cache, and the four transforms
  (predictor, cross-colour, subtract-green, colour-indexing with pixel
  bundling);
- lossy images (``VP8 ``), through ``utils/vp8.py``.

What it does not read raises a ValueError naming ROADMAP.md queue 1, item 4:
files below 32 bytes and images that differ from their ``VP8X`` canvas
(which OpenCV refuses too), and corrupt or truncated data.
"""

from __future__ import annotations

import struct

import numpy as np

from .imgcodecs import ROADMAP, exif_orientation, oriented
from .vp8 import decode_vp8_bgr
from .yuv import bgr_to_gray

# the order in which the code-length code's lengths are stored
CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
# distance codes 1-120 -> (dy << 4) | (8 - dx), the 2-D neighbourhood of RFC 9649 4.2.2
CODE_TO_PLANE = bytes((
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37,
    0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b,
    0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56,
    0x5a, 0x23, 0x2d, 0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e, 0x78, 0x01, 0x77,
    0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e,
    0x30, 0x73, 0x7d, 0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70))
NUM_LENGTH_CODES, NUM_DISTANCE_CODES = 24, 40
PREDICTOR, CROSS_COLOR, SUBTRACT_GREEN, COLOR_INDEXING = range(4)
MAX_CODE_BITS = 15


def _refused(path: str, what: str) -> ValueError:
    return ValueError(f"{path}: WebP {what} is not supported by the port's WebP reader "
                      f"({ROADMAP})")


class _Bits:
    """The VP8L bit stream: least significant bit first."""

    def __init__(self, data: bytes, path: str):
        self.data, self.path = data + bytes(8), path
        self.pos, self.end = 0, 8 * len(data)

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        at = self.pos >> 3
        v = (int.from_bytes(self.data[at:at + 4], "little") >> (self.pos & 7)) & ((1 << n) - 1)
        self.pos += n
        if self.pos > self.end:
            raise _refused(self.path, "truncated lossless data")
        return v


class _Code:
    """A canonical prefix code as a lookup table over the next ``bits``
    bits (its longest code's length): entry = (symbol << 4) | length."""

    def __init__(self, lengths: list[int], path: str):
        used = sorted((n, s) for s, n in enumerate(lengths) if n)
        if not used:
            raise _refused(path, "empty prefix code")
        self.single = used[0][1] if len(used) == 1 else None  # one symbol: no bits read
        if self.single is not None:
            return
        self.bits = used[-1][0]
        if self.bits > MAX_CODE_BITS:
            raise _refused(path, "prefix code longer than 15 bits")
        size = 1 << self.bits
        table = [0] * size
        code, prev, total = 0, used[0][0], 0
        for n, s in used:
            code <<= n - prev
            prev = n
            rev = int(f"{code:0{n}b}"[::-1], 2)
            table[rev::1 << n] = [(s << 4) | n] * (size >> n)
            code += 1
            total += size >> n
        if total != size:  # libwebp refuses codes that are not complete
            raise _refused(path, "incomplete prefix code")
        self.table, self.mask = table, size - 1

    def read(self, bits: _Bits) -> int:
        if self.single is not None:
            return self.single
        at = bits.pos >> 3
        window = int.from_bytes(bits.data[at:at + 3], "little") >> (bits.pos & 7)
        entry = self.table[window & self.mask]
        bits.pos += entry & 15
        if bits.pos > bits.end:
            raise _refused(bits.path, "truncated lossless data")
        return entry >> 4


def _code_lengths(bits: _Bits, size: int) -> list[int]:
    """``ReadHuffmanCode``: a simple code (one or two symbols) or code
    lengths coded with the code-length code."""
    lengths = [0] * size
    if bits.read(1):
        n = bits.read(1) + 1
        first = bits.read(1 + 7 * bits.read(1))
        if first >= size:
            raise _refused(bits.path, "prefix code symbol out of range")
        lengths[first] = 1
        if n == 2:
            second = bits.read(8)
            if second >= size:
                raise _refused(bits.path, "prefix code symbol out of range")
            lengths[second] = 1
        return lengths
    clen = [0] * 19
    for i in range(4 + bits.read(4)):
        clen[CODE_LENGTH_ORDER[i]] = bits.read(3)
    code = _Code(clen, bits.path)
    limit = size
    if bits.read(1):
        limit = 2 + bits.read(2 + 2 * bits.read(3))
        if limit > size:
            raise _refused(bits.path, "corrupt code lengths")
    symbol, prev = 0, 8
    while symbol < size:
        if limit == 0:
            break
        limit -= 1
        n = code.read(bits)
        if n < 16:
            lengths[symbol] = n
            symbol += 1
            if n:
                prev = n
            continue
        extra, offset = ((2, 3), (3, 3), (7, 11))[n - 16]
        repeat = bits.read(extra) + offset
        if symbol + repeat > size:
            raise _refused(bits.path, "corrupt code lengths")
        value = prev if n == 16 else 0
        lengths[symbol:symbol + repeat] = [value] * repeat
        symbol += repeat
    return lengths


def _prefix_value(code: int, bits: _Bits) -> int:
    """A length or distance from its prefix symbol and extra bits."""
    if code < 4:
        return code + 1
    extra = (code - 2) >> 1
    return ((2 + (code & 1)) << extra) + bits.read(extra) + 1


def _group(bits: _Bits, cache_size: int) -> tuple:
    sizes = (256 + NUM_LENGTH_CODES + cache_size, 256, 256, 256, NUM_DISTANCE_CODES)
    return tuple(_Code(_code_lengths(bits, n), bits.path) for n in sizes)


def _image(bits: _Bits, width: int, height: int, top_level: bool) -> list:
    """``DecodeImageStream`` after the transforms: ``width * height`` ARGB
    pixels (ints) of the entropy-coded image."""
    cache_bits = bits.read(4) if bits.read(1) else 0
    if cache_bits and not 1 <= cache_bits <= 11:
        raise _refused(bits.path, f"colour cache of {cache_bits} bits")
    cache = [0] * (1 << cache_bits) if cache_bits else None
    cache_shift = 32 - cache_bits
    meta_bits, meta, meta_w = 0, None, 1
    if top_level and bits.read(1):
        meta_bits = bits.read(3) + 2
        meta_w = -(-width // (1 << meta_bits))
        entropy = _image(bits, meta_w, -(-height // (1 << meta_bits)), False)
        meta = [(p >> 8) & 0xFFFF for p in entropy]
    groups = [_group(bits, len(cache) if cache else 0)
              for _ in range(max(meta) + 1 if meta else 1)]
    total = width * height
    out = []
    x = y = 0
    green, red, blue, alpha, dist = groups[0]
    mask = (1 << meta_bits) - 1 if meta else -1
    read = _Code.read
    while len(out) < total:
        if meta and (x & mask) == 0:
            green, red, blue, alpha, dist = groups[meta[(y >> meta_bits) * meta_w
                                                        + (x >> meta_bits)]]
        g = read(green, bits)
        if g < 256:
            r = read(red, bits)
            b = read(blue, bits)
            argb = (read(alpha, bits) << 24) | (r << 16) | (g << 8) | b
            out.append(argb)
            if cache:
                cache[((0x1E35A7BD * argb) & 0xFFFFFFFF) >> cache_shift] = argb
            x += 1
        elif g < 256 + NUM_LENGTH_CODES:
            length = _prefix_value(g - 256, bits)
            code = _prefix_value(read(dist, bits), bits)
            if code > 120:
                d = code - 120
            else:
                plane = CODE_TO_PLANE[code - 1]
                d = max(1, (plane >> 4) * width + 8 - (plane & 15))
            if d > len(out) or len(out) + length > total:
                raise _refused(bits.path, "corrupt backward reference")
            start = len(out) - d
            for i in range(length):
                argb = out[start + i]
                out.append(argb)
                if cache:
                    cache[((0x1E35A7BD * argb) & 0xFFFFFFFF) >> cache_shift] = argb
            x += length
            while x >= width:
                x -= width
                y += 1
            if meta and x & mask:  # libwebp re-reads the group after a copy
                green, red, blue, alpha, dist = groups[meta[(y >> meta_bits) * meta_w
                                                            + (x >> meta_bits)]]
        else:
            if not cache or g - 280 >= len(cache):
                raise _refused(bits.path, "corrupt colour cache index")
            out.append(cache[g - 280])
            x += 1
        while x >= width:
            x -= width
            y += 1
    return out


def _channels(argb: np.ndarray) -> np.ndarray:
    """uint32 ARGB -> ``[..., 4]`` int64 (A, R, G, B)."""
    a = argb.astype(np.int64)
    return np.stack([(a >> 24) & 255, (a >> 16) & 255, (a >> 8) & 255, a & 255], -1)


def _pack(c: np.ndarray) -> np.ndarray:
    c = c & 255
    return (c[..., 0] << 24) | (c[..., 1] << 16) | (c[..., 2] << 8) | c[..., 3]


def _avg(a, b):
    return (a + b) >> 1


_LEFT_MODES = (1, 5, 6, 7, 10, 11, 12, 13)  # the predictors that read the pixel to the left


def _predict_block(mode: int, top: np.ndarray, tl: np.ndarray, tr: np.ndarray) -> np.ndarray:
    """RFC 9649 4.1's predictors that do not read the left pixel, on ``[n,
    4]`` (A, R, G, B) int64 channels; 14 and 15 predict black, as libwebp's
    table does."""
    if mode == 2:
        return top
    if mode == 3:
        return tr
    if mode == 4:
        return tl
    if mode == 8:
        return _avg(tl, top)
    if mode == 9:
        return _avg(top, tr)
    return np.broadcast_to(np.array([255, 0, 0, 0], np.int64), top.shape)  # 0, 14, 15


def _predict_pixel(mode: int, left: list, top: list, tl: list, tr: list) -> list:
    """The predictors that read the left pixel, on one pixel's channels."""
    if mode == 1:
        return left
    if mode == 5:
        return [(((a + b) >> 1) + c) >> 1 for a, b, c in zip(left, tr, top)]
    if mode == 6:
        return [(a + b) >> 1 for a, b in zip(left, tl)]
    if mode == 7:
        return [(a + b) >> 1 for a, b in zip(left, top)]
    if mode == 10:
        return [(((a + b) >> 1) + ((c + d) >> 1)) >> 1 for a, b, c, d in zip(left, tl, top, tr)]
    if mode == 11:  # Select: left where it is nearer the gradient's estimate
        p_left = sum(abs(a - b) for a, b in zip(top, tl))
        p_top = sum(abs(a - b) for a, b in zip(left, tl))
        return left if p_left < p_top else top
    if mode == 12:
        return [min(255, max(0, a + b - c)) for a, b, c in zip(left, top, tl)]
    out = []  # 13: ClampAddSubtractHalf(Average2(L, T), TL), C division toward zero
    for a, b, c in zip(left, top, tl):
        m = (a + b) >> 1
        d = m - c
        out.append(min(255, max(0, m + (d // 2 if d >= 0 else -((-d) // 2)))))
    return out


def _undo_predictor(pix: np.ndarray, width: int, height: int, bits: int,
                    modes: np.ndarray) -> np.ndarray:
    """The predictor transform inverted, row by row: blocks whose predictor
    reads the left pixel run one pixel at a time, the others at once."""
    c = _channels(pix).reshape(height, width, 4)
    c[0, 0] = (c[0, 0] + [255, 0, 0, 0]) & 255
    c[0] = np.cumsum(c[0], axis=0) & 255  # the first row predicts from the left
    block_w = 1 << bits
    for y in range(1, height):
        row, above = c[y], c[y - 1]
        row[0] = (row[0] + above[0]) & 255  # the first column from the top
        # TR of the last column is the first pixel of the current row
        tr_row = np.concatenate([above[1:], row[:1]])
        for bx, mode in enumerate(modes[y >> bits].tolist()):
            x0, x1 = max(1, bx * block_w), min(width, (bx + 1) * block_w)
            if mode not in _LEFT_MODES:
                pred = _predict_block(mode, above[x0:x1], above[x0 - 1:x1 - 1], tr_row[x0:x1])
                row[x0:x1] = (row[x0:x1] + pred) & 255
                continue
            res, top = row[x0:x1].tolist(), above[x0:x1].tolist()
            tl, tr = above[x0 - 1:x1 - 1].tolist(), tr_row[x0:x1].tolist()
            left, done = row[x0 - 1].tolist(), []
            for i in range(x1 - x0):
                pred = _predict_pixel(mode, left, top[i], tl[i], tr[i])
                left = [(r + q) & 255 for r, q in zip(res[i], pred)]
                done.append(left)
            row[x0:x1] = done
    return _pack(c).reshape(-1)


def _undo_cross_color(pix: np.ndarray, width: int, height: int, bits: int,
                      elements: np.ndarray) -> np.ndarray:
    c = _channels(pix).reshape(height, width, 4)
    e = _channels(elements).reshape(-(-height >> bits), -(-width >> bits), 4)
    e = e[np.arange(height)[:, None] >> bits, np.arange(width)[None, :] >> bits]
    signed = (e ^ 128) - 128  # int8 multipliers: green_to_red in B, green_to_blue in G,
    g2r, g2b, r2b = signed[..., 3], signed[..., 2], signed[..., 1]  # red_to_blue in R
    green = (c[..., 2] ^ 128) - 128
    red = (c[..., 1] + ((g2r * green) >> 5)) & 255
    blue = c[..., 3] + ((g2b * green) >> 5) + ((r2b * ((red ^ 128) - 128)) >> 5)
    c[..., 1], c[..., 3] = red, blue & 255
    return _pack(c).reshape(-1)


def _undo_subtract_green(pix: np.ndarray) -> np.ndarray:
    c = _channels(pix)
    c[..., 1] += c[..., 2]
    c[..., 3] += c[..., 2]
    return _pack(c)


def _undo_color_indexing(pix: np.ndarray, width: int, height: int, packed_w: int,
                         bits: int, table: np.ndarray) -> np.ndarray:
    index = ((pix.astype(np.int64) >> 8) & 255).reshape(height, packed_w)
    if bits:
        per = 1 << bits
        step = 8 >> bits
        x = np.arange(width)
        index = (index[:, x >> bits] >> (step * (x & (per - 1)))) & ((1 << step) - 1)
    full = np.zeros(256, np.int64)
    full[:len(table)] = table
    return full[index[:, :width]].reshape(-1)


def decode_vp8l(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """A ``VP8L`` chunk's payload -> ``[H, W, 4]`` uint8 BGRA."""
    if len(data) < 5 or data[0] != 0x2F:
        raise _refused(path, "lossless stream without its signature")
    bits = _Bits(data, path)
    bits.read(8)
    width, height = bits.read(14) + 1, bits.read(14) + 1
    bits.read(1)  # alpha_is_used: a hint only
    if bits.read(3) != 0:
        raise _refused(path, "lossless stream of an unknown version")
    transforms, xsize = [], width
    while bits.read(1):
        kind = bits.read(2)
        if any(t[0] == kind for t in transforms):
            raise _refused(path, "transform given twice")
        if kind in (PREDICTOR, CROSS_COLOR):
            tb = bits.read(3) + 2
            sub = _image(bits, -(-xsize >> tb), -(-height >> tb), False)
            transforms.append((kind, xsize, tb, np.array(sub, np.int64)))
        elif kind == SUBTRACT_GREEN:
            transforms.append((kind, xsize, 0, None))
        else:
            size = bits.read(8) + 1
            table = _channels(np.array(_image(bits, size, 1, False), np.int64))
            table = _pack(np.cumsum(table, axis=0))  # each entry is coded as a delta
            wb = 3 if size <= 2 else 2 if size <= 4 else 1 if size <= 16 else 0
            packed = -(-xsize >> wb)
            transforms.append((kind, xsize, wb, (table, packed)))
            xsize = packed
    pix = np.array(_image(bits, xsize, height, True), np.int64)
    for kind, w, tb, extra in reversed(transforms):
        if kind == PREDICTOR:
            pix = _undo_predictor(pix, w, height, tb,
                                  ((extra.reshape(-(-height >> tb), -(-w >> tb)) >> 8) & 15))
        elif kind == CROSS_COLOR:
            pix = _undo_cross_color(pix, w, height, tb, extra)
        elif kind == SUBTRACT_GREEN:
            pix = _undo_subtract_green(pix)
        else:
            table, packed = extra
            pix = _undo_color_indexing(pix, w, height, packed, tb, table)
    c = _channels(pix).reshape(height, width, 4)
    return c[..., ::-1].astype(np.uint8)  # A R G B -> B G R A


def _chunks(data: bytes, pos: int, end: int, path: str) -> list:
    """The (kind, payload) of each RIFF chunk of ``data[pos:end]``."""
    out = []
    while pos + 8 <= end:
        kind, size = data[pos:pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        body = data[pos + 8:pos + 8 + size]
        if len(body) != size:
            raise _refused(path, f"truncated chunk {kind!r}")
        out.append((kind, body))
        pos += 8 + size + (size & 1)
    return out


def decode_webp_bgr(data: bytes, path: str = "<bytes>"):
    """A WebP file's bytes -> (``[H, W, 3]`` uint8 BGR as libwebp gives it to
    OpenCV, the EXIF payload whose orientation OpenCV applies, or None)."""
    if len(data) < 32:  # OpenCV's WEBP_HEADER_SIZE
        raise _refused(path, f"file of {len(data)} bytes (OpenCV refuses one below 32)")
    if data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise _refused(path, "container")
    chunks = _chunks(data, 12, min(len(data), 8 + struct.unpack_from("<I", data, 4)[0]), path)
    exif = canvas = frame_at = None
    if chunks and chunks[0][0] == b"VP8X":
        head = chunks[0][1]
        if len(head) < 10:
            raise _refused(path, "truncated VP8X chunk")
        canvas = (int.from_bytes(head[7:10], "little") + 1, int.from_bytes(head[4:7], "little") + 1)
        if head[0] & 8:  # the EXIF flag: OpenCV takes the first chunk
            exif = next((b for k, b in chunks if k == b"EXIF"), None)
        if head[0] & 2:  # an animation: its first frame
            frame = next((b for k, b in chunks if k == b"ANMF"), None)
            if frame is None or len(frame) < 16:
                raise _refused(path, "animation without frames")
            frame_at = (int.from_bytes(frame[3:6], "little") * 2,
                        int.from_bytes(frame[0:3], "little") * 2)
            chunks = _chunks(frame, 16, len(frame), path)
    image = next(((k, b) for k, b in chunks if k in (b"VP8 ", b"VP8L")), None)
    if image is None:
        raise _refused(path, "file without an image chunk")
    if image[0] == b"VP8L":
        bgr = decode_vp8l(image[1], path)[..., :3]
    else:
        bgr = decode_vp8_bgr(image[1], path)
    h, w = bgr.shape[:2]
    if frame_at is not None:  # libwebp's animation decoder: a transparent canvas
        (y0, x0) = frame_at
        if y0 + h > canvas[0] or x0 + w > canvas[1]:
            raise _refused(path, f"first frame of {w}x{h} at {x0},{y0} outside its canvas")
        out = np.zeros(canvas + (3,), np.uint8)
        out[y0:y0 + h, x0:x0 + w] = bgr
        return out, exif
    if canvas is not None and (h, w) != canvas:
        raise _refused(path, f"{w}x{h} image on a {canvas[1]}x{canvas[0]} canvas (OpenCV "
                             "refuses it too)")
    return bgr, exif


def decode_webp_gray(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """A WebP file's bytes -> ``[H, W]`` uint8 gray (see the module's notes)."""
    bgr, exif = decode_webp_bgr(data, path)
    gray = bgr_to_gray(bgr)
    return gray if exif is None else oriented(gray, exif_orientation(exif))
