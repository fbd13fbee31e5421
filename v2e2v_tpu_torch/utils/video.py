"""Video files: the port's counterpart of ``cv2.VideoCapture`` followed by
``cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)``, which is how the JAX package's
video readers see a video.

``VideoFile(path)`` has ``fps`` and ``frame_count`` as cv2 reports them
(``CAP_PROP_FPS``, ``CAP_PROP_FRAME_COUNT``) and iterates over the frames as
``[H, W]`` uint8 gray, bit for bit what that cv2 pair returns for MJPEG in AVI:

- ``utils/avi.py`` demuxes the file;
- ``utils/jpeg.py::decode_mjpeg_frame`` decodes each frame to its Y, Cb and Cr
  planes as FFmpeg's MJPEG decoder does, its tables carried from frame to
  frame;
- ``utils/yuv.py`` converts the planes to BGR as swscale gives them to
  OpenCV (gray, 4:4:4, 4:2:2, 4:2:0, 4:1:1 and 4:4:0, baseline or
  progressive), then to gray as ``cvtColor`` does.

No EXIF orientation is applied: FFmpeg does not apply one to MJPEG frames.
Other containers and codecs, interlaced MJPEG (a frame of two fields, each
coded at half the stream's height), other sampling factors and frames too
small for swscale's chroma filter raise a ValueError naming ROADMAP.md
queue 1, item 4.
"""

from __future__ import annotations

from .avi import AviFile
from .imgcodecs import ROADMAP
from .jpeg import decode_mjpeg_frame
from .yuv import mjpeg_to_gray


class VideoFile:
    """An MJPEG AVI file's gray frames (see the module's notes)."""

    def __init__(self, path: str):
        self.path = path
        self.avi = AviFile(path)
        self.fps = self.avi.fps
        self.frame_count = self.avi.frame_count

    def decode(self, data: bytes, index: int, tables=None):
        """Frame ``index``'s bytes -> (its planes' frame, as decoded)."""
        where = f"{self.path} frame {index}"
        frame = decode_mjpeg_frame(data, where, tables)
        h = frame.planes[0].shape[0]
        if h < self.avi.height * 3 // 4:  # mjpegdec.c's test for a field of an interlaced frame
            raise ValueError(f"{where}: a {h}-row frame in a {self.avi.height}-row stream, an "
                             f"interlaced MJPEG field, which the port does not read ({ROADMAP})")
        return frame

    def __iter__(self):
        tables = None
        for i, data in enumerate(self.avi.frames()):
            frame = self.decode(data, i, tables)
            tables = frame.tables
            yield mjpeg_to_gray(frame.planes, frame.factors, path=f"{self.path} frame {i}")
