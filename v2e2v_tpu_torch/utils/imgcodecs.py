"""What every frame decoder of the port shares, as OpenCV's imgcodecs shares
it around its own decoders: its colour to gray, the EXIF orientation that
``cv2.imread`` applies, and the ROADMAP item that every refusal names. A
leaf: it imports no other module of the port, and every decoder imports it.

OpenCV's colour to gray differs by decoder, and each decoder of the port uses
the one its cv2 counterpart uses:

- PNG (``image_io``): libpng's ``rgb_to_gray`` as ``png_set_rgb_to_gray``
  sets it up, with or without the file's gamma (``image_io._to_gray``,
  ``_to_gray16``, ``_gamma_gray``);
- BMP, PPM and TIFF (``bmp``, ``pnm``, ``tiff``): imgcodecs' own 14-bit
  ``icvCvt_BGR2Gray_8u`` (``imgcodecs_gray``, here);
- WebP and every video frame (``webp``, ``video``): ``cvtColor(COLOR_BGR2GRAY)``,
  OpenCV 5's 15-bit one (``yuv.bgr_to_gray``);
- JPEG (``jpeg``): none, libjpeg gives gray itself.
"""

from __future__ import annotations

import struct

import numpy as np

ROADMAP = "ROADMAP.md queue 1, item 4"
# what the port's video path reads, named by every refusal of a video file
VIDEO_READS = ("the port reads MJPEG, MPEG-4 Part 2, MPEG-1/2, VP8, VP9, H.263, Sorenson H.263, "
               "MS-MPEG-4 v2 and v3, WMV1, WMV2, raw (I420, IYUV, YV12, Y800, GREY, RGBA) and PNG "
               "video in AVI files; MJPEG, MPEG-4 Part 2, MPEG-1/2, VP9, raw RGBA and PNG in MP4, "
               "MOV and M4V files, and H.263, Sorenson H.263, MS-MPEG-4 v2 and v3, WMV1 and WMV2 "
               "in MOV files; VP8, VP9, MJPEG, MPEG-4 Part 2, MPEG-1/2, H.263, Sorenson H.263, "
               "MS-MPEG-4 v2 and v3, WMV1, WMV2, raw and PNG in Matroska and WebM files; MPEG-1/2 "
               "(4:2:0, progressive and interlaced) in MPEG program and transport streams; "
               "Sorenson H.263 in FLV files; and MS-MPEG-4 v2 and v3, WMV1, WMV2, MPEG-4 Part 2, "
               "Sorenson H.263 and MJPEG in ASF (WMV) files")


def refuse_video(path: str, what: str) -> ValueError:
    """The ValueError of a video file the port does not read: what it is,
    what the port reads, and the ROADMAP item."""
    return ValueError(f"{path}: {what}: {VIDEO_READS} ({ROADMAP})")

# imgcodecs/utils.cpp: cB, cG, cR at SCALE = 14 bits
CB14, CG14, CR14, SCALE14 = 1868, 9617, 4899, 14


def imgcodecs_gray(b: np.ndarray, g: np.ndarray, r: np.ndarray) -> np.ndarray:
    """imgcodecs' own colour to gray, ``icvCvt_BGR2Gray_8u_C3C1R`` and its
    BGRA, BGR555, BGR565 and palette variants: ``(1868 B + 9617 G + 4899 R +
    8192) >> 14``."""
    b, g, r = (np.asarray(c, np.int32) for c in (b, g, r))  # the sum stays below 2^22
    return ((CB14 * b + CG14 * g + CR14 * r + (1 << (SCALE14 - 1))) >> SCALE14).astype(np.uint8)


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


def oriented(img: np.ndarray, orientation: int | None) -> np.ndarray:
    """``img`` turned by an EXIF orientation value as OpenCV's ``imread``
    turns it: 2 flips left-right, 3 rotates 180, 4 flips up-down, 5
    transposes, 6 rotates 90 clockwise, 7 transverses, 8 rotates 90
    counter-clockwise. Any other value leaves ``img`` as it is."""
    if orientation in (5, 6, 7, 8):
        img = img.T
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def apply_orientation(img: np.ndarray, exif: bytes) -> np.ndarray:
    """``img`` turned by the orientation tag of ``exif`` (see
    ``exif_orientation`` and ``oriented``); no tag leaves it as it is."""
    return oriented(img, exif_orientation(exif))
