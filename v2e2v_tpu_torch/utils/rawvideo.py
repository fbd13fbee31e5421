"""Video frames that need no motion decoder: uncompressed (raw) frames, as
FFmpeg's ``rawvideo`` decoder reads them, and PNG frames, as its ``png``
decoder reads them, each turned into the BGR that ``cv2.VideoCapture``
returns (swscale to ``bgr24``). Found by probing cv2 5.0.0
(FFmpeg avcodec 62.28, swscale 9.5) on files that cv2 writes and on files
written byte by byte.

Raw frames (``raw_to_bgr``), by the fourcc that names their layout (an
AVI's ``biCompression``, an MP4/MOV sample entry, a Matroska
``ColourSpace``), taken as it is written, not upper-cased, as ``rawdec.c``
looks it up:

- ``I420``, ``IYUV``: ``yuv420p``, the Y plane, then Cb, then Cr, each row
  packed (chroma ``ceil(W / 2)`` x ``ceil(H / 2)``); ``YV12``: the same
  with Cr before Cb. Unspecified range, so swscale converts at limited range
  with the chroma sited at the centre (``yuv.yuv420p_to_bgr`` at
  ``VP8_H_POS``), at every size from 1 x 1.
- ``Y800``, ``GREY``: ``gray8``, B = G = R = Y (swscale's palette
  converter). ``rawdec.c`` reads the rows at a stride of the width rounded
  up to 4 when that many rows fit in the packet (``FFALIGN(linesize, 4) *
  height <= size``), else at the width. cv2's writer stores 4:2:0-sized
  packets under ``Y800``, so at a width that is not a multiple of 4 the
  rows read run into the next ones, as cv2 shows them.
- ``RGBA``: top-down rows of R, G, B, A; alpha is dropped.

A packet shorter than a frame makes FFmpeg's decoder fail, and cv2 ends its
read there (no frame from that packet or after it): ``raw_to_bgr`` returns
None for it. Bytes past a frame are ignored (but count in the gray stride's
test).

PNG frames (``png_to_bgr``): ``image_io.decode_png``'s samples, RGB byte
swapped, gray (1, 2 and 4 bits scaled to 8: x255, x85, x17) to B = G = R,
a palette looked up, alpha dropped. FFmpeg applies no ``gAMA``, ``sRGB``
or ``tRNS`` chunk and no EXIF orientation to a video frame. That is not the
gray of ``cv2.imread``: the frame goes to gray by ``cvtColor``
(``yuv.bgr_to_gray``), not by libpng's ``rgb_to_gray``. 16-bit frames
(which swscale dithers down) and interlaced (Adam7) frames are refused with
a ValueError naming ROADMAP.md queue 1, item 4: FFmpeg marks an Adam7
frame interlaced, swscale then refuses to convert it, and cv2 returns
whatever its frame buffer held (the previous frame, or stale memory). cv2's
writer makes progressive 8-bit RGB.
"""

from __future__ import annotations

import numpy as np

from .image_io import GRAY_SCALE, PngImage, decode_png, palette_rgb
from .imgcodecs import ROADMAP
from .yuv import VP8_H_POS, yuv420p_to_bgr

# the raw layouts the port reads, by fourcc
FORMATS = {b"I420": "yuv420p", b"IYUV": "yuv420p", b"YV12": "yvu420p", b"Y800": "gray",
           b"GREY": "gray", b"RGBA": "rgba"}
ROW_ALIGN = 4  # rawdec.c: linesize_align


def frame_size(fmt: str, width: int, height: int) -> int:
    """The bytes of one ``fmt`` frame, rows packed
    (``av_image_get_buffer_size`` at alignment 1)."""
    if fmt == "gray":
        return width * height
    if fmt == "rgba":
        return 4 * width * height
    return width * height + 2 * ((width + 1) // 2) * ((height + 1) // 2)


def raw_to_bgr(data: bytes, fmt: str, width: int, height: int,
               path: str = "<frame>") -> np.ndarray | None:
    """A raw packet of layout ``fmt`` (``FORMATS``' values) -> ``[H, W, 3]``
    uint8 BGR as cv2 returns it, or None for a packet shorter than a frame,
    where cv2's read ends (see the module's notes)."""
    if len(data) < frame_size(fmt, width, height):
        return None
    d = np.frombuffer(data, np.uint8)
    if fmt == "gray":
        aligned = -(-width // ROW_ALIGN) * ROW_ALIGN
        stride = aligned if aligned * height <= len(d) else width
        y = d[:stride * height].reshape(height, stride)[:, :width]
        return np.repeat(y[..., None], 3, axis=2)
    if fmt == "rgba":
        return np.ascontiguousarray(d[:4 * width * height].reshape(height, width, 4)[..., 2::-1])
    n, cw, ch = width * height, (width + 1) // 2, (height + 1) // 2
    y = d[:n].reshape(height, width)
    u = d[n:n + cw * ch].reshape(ch, cw)
    v = d[n + cw * ch:n + 2 * cw * ch].reshape(ch, cw)
    cb, cr = (v, u) if fmt == "yvu420p" else (u, v)
    return yuv420p_to_bgr(y, cb, cr, path, VP8_H_POS)  # raw chroma is sited at the centre


def png_to_bgr(data: bytes, path: str = "<frame>") -> np.ndarray:
    """A PNG video frame -> ``[H, W, 3]`` uint8 BGR as FFmpeg's ``png``
    decoder and swscale give it to cv2 (see the module's notes)."""
    return png_image_bgr(decode_png(data, path), path)


def png_image_bgr(img: PngImage, path: str = "<frame>") -> np.ndarray:
    """``png_to_bgr`` after ``decode_png``: the samples to BGR."""
    if img.interlace:
        raise ValueError(f"{path}: an interlaced (Adam7) PNG video frame, which swscale refuses "
                         f"to convert (cv2 returns its buffer's stale contents): not read by "
                         f"the port ({ROADMAP})")
    if img.depth == 16:
        raise ValueError(f"{path}: a 16-bit PNG video frame (colour type {img.color}), which "
                         f"swscale dithers to 8 bits: not read by the port ({ROADMAP})")
    if img.color == 3:
        rgb = palette_rgb(img, path)
    elif img.color in (0, 4):
        rgb = np.repeat(img.samples[..., :1] * np.uint8(GRAY_SCALE[img.depth]), 3, axis=2)
    else:
        rgb = img.samples[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])
