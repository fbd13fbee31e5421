"""PBM, PGM and PPM frames with numpy: ``decode_pnm_gray`` returns what
``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` returns for a P1-P6 file, bit for
bit.

OpenCV reads them with its own decoder (``imgcodecs/src/grfmt_pxm.cpp``), and
this follows it, as probed:

- the header's numbers as ``ReadNumber`` reads them: whitespace and ``#``
  comments (to the end of the line) before each, and the one byte after the
  last number's digits ends the header;
- P1 and P4 (bitmaps): 1 is black (0), 0 is white (255); P1's digits need no
  separators;
- P2 and P3 (ASCII): each value above ``maxval`` is clipped to it; at
  ``maxval`` <= 255 each value ``v`` becomes ``v * 255 // maxval``; above,
  the 16-bit value's high byte, ``v >> 8``, whatever ``maxval`` is;
- P5 and P6 (binary): one byte a sample at ``maxval`` <= 255, taken as it is
  (not scaled), else two (big-endian), and their high byte;
- P3 and P6 to gray through imgcodecs' 14-bit ``icvCvt_BGR2Gray_8u``
  (``imgcodecs.imgcodecs_gray``) on the 8-bit samples.

P7 (PAM, which the JAX package's manifests do not list), a ``maxval`` of 0
or above 65535, and truncated data raise a ValueError naming ROADMAP.md
queue 1, item 4.
"""

from __future__ import annotations

import re

import numpy as np

from .imgcodecs import ROADMAP, imgcodecs_gray

_SPACE = b" \t\n\v\f\r"


def _refused(path: str, what: str) -> ValueError:
    return ValueError(f"{path}: {what}: not a PNM file the port reads ({ROADMAP})")


class _Numbers:
    """``grfmt_pxm.cpp::ReadNumber`` over ``data`` from ``pos``."""

    def __init__(self, data: bytes, pos: int, path: str):
        self.data, self.pos, self.path = data, pos, path

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise _refused(self.path, "truncated data")
        self.pos += 1
        return self.data[self.pos - 1]

    def number(self, max_digits: int = 0) -> int:
        code = self.byte()
        while not 0x30 <= code <= 0x39:
            if code == 0x23:  # '#': a comment to the end of the line
                while code not in (0x0A, 0x0D):
                    code = self.byte()
                code = self.byte()
            elif code in _SPACE:
                while code in _SPACE:
                    code = self.byte()
            else:
                raise _refused(self.path, f"unexpected byte {code:#x} where a number was due")
        value = digits = 0
        while True:
            value = value * 10 + code - 0x30
            digits += 1
            if value > 0x7FFFFFFF:
                raise _refused(self.path, "a number past INT_MAX")
            if max_digits and digits >= max_digits:
                return value
            code = self.byte()
            if not 0x30 <= code <= 0x39:
                return value


def _ascii_values(data: bytes, pos: int, count: int, digits: int, path: str) -> np.ndarray:
    """``count`` ASCII numbers from ``pos`` as ``ReadNumber`` reads them one
    by one (``digits`` = 1: single digits, P1's samples)."""
    if b"#" in data[pos:]:  # a comment among the samples: walk ReadNumber itself
        nums = _Numbers(data, pos, path)
        return np.array([nums.number(digits) for _ in range(count)], np.int64)
    tokens = re.findall(rb"\d|[^\d\s]" if digits == 1 else rb"\d+|[^\d\s]", data[pos:])[:count]
    if len(tokens) < count:
        raise _refused(path, "truncated data")
    bad = [t for t in tokens if not t.isdigit()]
    if bad:
        raise _refused(path, f"unexpected byte {bad[0][0]:#x} where a number was due")
    values = np.array([int(t) for t in tokens], np.int64)
    if values.size and values.max() > 0x7FFFFFFF:
        raise _refused(path, "a number past INT_MAX")
    return values


def decode_pnm_gray(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """A P1-P6 file's bytes -> ``[H, W]`` uint8 gray (see the module's notes)."""
    kind = data[1:2]
    if kind not in b"123456" or not kind:
        raise _refused(path, f"P{kind.decode(errors='replace')} (only P1-P6 are read)")
    kind = int(kind)
    channels = 3 if kind in (3, 6) else 1
    header = _Numbers(data, 2, path)
    width, height = header.number(), header.number()
    maxval = header.number() if kind not in (1, 4) else 1
    if width <= 0 or height <= 0 or not 0 < maxval < 1 << 16:
        raise _refused(path, f"a {width}x{height} image with maxval {maxval}")
    pos = header.pos
    n = width * height * channels
    if kind == 1:  # one digit each, no separators needed
        bits = _ascii_values(data, pos, n, 1, path).reshape(height, width)
        return np.where(bits != 0, 0, 255).astype(np.uint8)
    if kind == 4:
        pitch = (width + 7) // 8
        raw = np.frombuffer(data[pos:pos + pitch * height], np.uint8)
        if raw.size != pitch * height:
            raise _refused(path, "truncated data")
        bits = np.unpackbits(raw.reshape(height, pitch), axis=1)[:, :width]
        return np.where(bits != 0, 0, 255).astype(np.uint8)
    if kind in (2, 3):
        values = np.minimum(_ascii_values(data, pos, n, 0, path), maxval)
        samples = (values >> 8) if maxval > 255 else values * 255 // maxval
    else:
        wide = maxval > 255
        raw = np.frombuffer(data[pos:pos + n * (2 if wide else 1)], ">u2" if wide else np.uint8)
        if raw.size != n:
            raise _refused(path, "truncated data")
        samples = (raw >> 8) if wide else raw
    samples = samples.astype(np.uint8).reshape(height, width, channels)
    if channels == 1:
        return np.ascontiguousarray(samples[..., 0])
    return imgcodecs_gray(samples[..., 2], samples[..., 1], samples[..., 0])
