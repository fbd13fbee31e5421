"""Frame-folder pack readers, host side (port of ``v2e2v_tpu/data/video_readers.py``).

- ``read_timestamps_file``: ``timestamps.txt`` uses column 1, other files
  column 0; unit scaling us -> 1e-6, ns -> 1e-9, ms -> 1e-3.
- ``PackReader.update_frame_pack``: the first pack returns N frames; later
  packs N-1 new frames with the cached previous timestamp prepended.
- ``PackReader.update_event_frame_pack``: 'upsampled' accumulates event
  windows until the event budget is reached -> one voxel grid; 'real' splits
  one window into ``round(N / limit)`` chunks -> a list of voxel grids; both
  hot-pixel-filtered and std-normalised on the host
  (``ops/voxel.voxelize_and_preprocess_np``).
- ``ImageReader``: a lazy grayscale frame-folder reader on
  ``utils/image_io.read_gray`` (``.jpg`` and ``.png`` frames: the JAX reader
  lists no other suffix; every PNG and JPEG as ``cv2.imread`` reads it).
- ``VideoReader``: a video file's frames, gray, shrunk by ``ds`` and
  transposed when portrait, on ``utils/video.VideoFile`` (MJPEG, MPEG-4
  Part 2 and MPEG-1/2 in AVI, MPEG-4 Part 2 and MPEG-1/2 in MP4, MOV and
  M4V, VP8, VP9 (profile 0), MJPEG, MPEG-4 Part 2 and MPEG-1/2 in Matroska
  and WebM, MPEG-1/2 in MPEG program and transport streams, as
  ``cv2.VideoCapture`` reads them, cv2's estimated frame counts of program
  and transport streams included; what else a video holds raises naming
  ROADMAP item 4).
"""

from __future__ import annotations

import os

import numpy as np

from ..ops.voxel import voxelize_and_preprocess_np
from ..utils.image_io import read_gray, resize_linear_u8
from ..utils.video import VideoFile
from .event_readers import NpzEventReader, RefTimeEventReader

_TS_NAMES = ("timestamps.txt", "images.txt", "timestamp.txt")
_EVENT_NAMES = ("events.txt", "events.zip", "events.csv")


def read_timestamps_file(path: str, unit: str = "s") -> list[float]:
    col = 1 if os.path.basename(path) == "timestamps.txt" else 0
    out = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if parts:
                out.append(float(parts[col]))
    ts = np.asarray(out, dtype=np.float64)
    if unit == "us":
        ts /= 1e6
    elif unit == "ns":
        ts /= 1e9
    elif unit == "ms":
        ts /= 1e3
    return list(ts)


def _scan_sequence_folder(path_to_sequence: str):
    frames, events, ts_path = [], [], None
    for root, _dirs, files in os.walk(path_to_sequence):
        for name in files:
            ext = name.rsplit(".", 1)[-1]
            if ext in ("jpg", "png"):
                frames.append(os.path.join(root, name))
            elif name in _TS_NAMES:
                ts_path = os.path.join(root, name)
            elif ext == "npz" or name in _EVENT_NAMES:
                events.append(os.path.join(root, name))
    frames.sort()
    events.sort()
    return frames, events, ts_path


class PackReader:
    """Base reader: pack/window logic shared by the sequence readers."""

    def __init__(self, image_dim, num_bins: int = 5, is_with_events: bool = False):
        self.height, self.width = image_dim
        self.prev_ts_cache = np.zeros(1, dtype=np.float64)
        self.frame_id = 0
        self.num_frames = -1
        self.timestamps: list[float] = []
        self.is_with_events = is_with_events
        self.num_bins = num_bins
        self.ending = False
        self.event_window_iterator = None
        self.num_events = 0

    def update_frame(self):
        raise NotImplementedError

    def update_events(self):
        if self.event_window_iterator is None:
            return None
        try:
            window = next(self.event_window_iterator)
        except StopIteration:
            window = None
        return window

    def update_frame_pack(self, num_pack_frames: int):
        """Frames + timestamps for one reconstruction. Later packs return
        ``num_pack_frames - 1`` frames and prepend the cached previous
        timestamp (the reference's continuation rule)."""
        start_frame_id = self.frame_id
        if start_frame_id != 0:
            num_pack_frames -= 1
        num_pack_frames = min(num_pack_frames, self.num_frames - self.frame_id)

        frame_pack, timestamps = [], []
        for _ in range(num_pack_frames):
            frame, t = self.update_frame()
            frame_pack.append(frame)
            timestamps.append(t)
        gt_frame = frame_pack[-1]

        frame_pack = np.stack(frame_pack, 0)
        if start_frame_id != 0:
            timestamps = np.concatenate(
                (self.prev_ts_cache, np.stack(timestamps, 0)), 0
            )
        else:
            timestamps = np.stack(timestamps, 0)
        self.prev_ts_cache[0] = timestamps[-1]
        return frame_pack, gt_frame, timestamps

    def update_event_frame_pack(self, limit_num_events: int = -1, mode: str = "upsampled"):
        """The GT frame + voxelised events for one frame: returns
        ``(list_of_voxel_grids, gt_frame)``, each grid ``[num_bins, H, W]``
        float32. 'real' mode splits the window into ``round(N / limit)``
        chunks, one grid each."""
        if self.frame_id == 0:
            self.update_frame()  # skip first frame

        if limit_num_events > 0 and mode == "upsampled":
            sum_num_events = 0
            event_pack = []
            event_window = np.zeros((0, 4), np.float64)
            while sum_num_events < limit_num_events and self.frame_id < self.num_frames:
                gt_frame, _ = self.update_frame()
                events = self.update_events()
                if events is not None:
                    event_pack.append(events)
                    sum_num_events += len(events)
                if len(event_pack) > 1:
                    event_window = np.concatenate(event_pack, 0)
                elif event_pack:
                    event_window = event_pack[0]
        else:
            gt_frame, _ = self.update_frame()
            event_window = self.update_events()
            if event_window is None:
                event_window = np.zeros((0, 4), np.float64)

        if self.frame_id >= self.num_frames:
            self.ending = True
        self.num_events = len(event_window)

        event_windows = []
        if limit_num_events <= 0 or mode == "upsampled":
            event_windows.append(
                voxelize_and_preprocess_np(
                    event_window, self.num_bins, self.width, self.height,
                    filter_hot_pixel=True,
                )
            )
        else:
            num_chunks = max(round(event_window.shape[0] / limit_num_events), 1)
            for chunk in np.array_split(event_window, num_chunks, axis=0):
                event_windows.append(
                    voxelize_and_preprocess_np(
                        chunk, self.num_bins, self.width, self.height,
                        filter_hot_pixel=True,
                    )
                )
        return event_windows, gt_frame

    def _setup_event_iterator(self, path_to_events, num_load_frames):
        if len(path_to_events) > 1:
            if num_load_frames > 0:
                path_to_events = path_to_events[:num_load_frames]
            self.event_window_iterator = NpzEventReader(path_to_events)
        elif len(path_to_events) == 1:
            self.event_window_iterator = RefTimeEventReader(
                path_to_events[0], self.timestamps
            )


class ImageReader(PackReader):
    """Frame-folder reader (lazy per-frame load, frames cropped to even H, W)."""

    def __init__(self, image_dim, num_bins=5, is_with_events=False, time_unit="s"):
        super().__init__(image_dim, num_bins, is_with_events)
        self.time_unit = time_unit

    def initialize(self, path_to_sequence: str, num_load_frames: int = -1):
        self.frame_id = 0
        self.ending = False
        self.path_to_frames, path_to_events, ts_path = _scan_sequence_folder(
            path_to_sequence
        )
        self.timestamps = read_timestamps_file(ts_path, self.time_unit)
        if num_load_frames > 0:
            self.path_to_frames = self.path_to_frames[:num_load_frames]
            self.timestamps = self.timestamps[:num_load_frames]
        self.num_frames = len(self.path_to_frames)

        demo = read_gray(self.path_to_frames[0])
        self.height = (demo.shape[0] // 2) * 2
        self.width = (demo.shape[1] // 2) * 2
        self.prev_ts_cache = np.zeros(1, dtype=np.float64)

        if self.is_with_events:
            self._setup_event_iterator(path_to_events, num_load_frames)

    def update_frame(self):
        frame = read_gray(self.path_to_frames[self.frame_id])
        frame = frame[: self.height, : self.width]
        t = self.timestamps[self.frame_id]
        self.frame_id += 1
        return frame, t


class VideoReader(PackReader):
    """HFR video-file reader (grayscale, downscaled, portrait transposed),
    the JAX ``VideoReader`` line for line: a positive ``num_load_frames`` N
    loads N + 1 frames (the loop stops once its count passes N), each frame
    stamped ``count / fps``."""

    def __init__(self, image_dim, ds=(0.25, 0.25)):
        super().__init__(image_dim)
        self.ds = ds

    def initialize(self, path_to_video: str, num_load_frames: int = -1):
        video = VideoFile(path_to_video)
        fps = video.fps
        total = video.frame_count
        num_load_frames = total if num_load_frames < 0 else num_load_frames

        self.frames, self.timestamps = [], []
        count = 0
        frames = iter(video)
        while count <= num_load_frames:  # checked before a frame is decoded
            gray = next(frames, None)
            if gray is None:
                break
            self.timestamps.append(count / fps)
            count += 1
            transpose = gray.shape[0] > gray.shape[1]
            gray = resize_linear_u8(
                gray, (int(gray.shape[1] * self.ds[1]), int(gray.shape[0] * self.ds[0])))
            if transpose:
                gray = gray.T
            self.frames.append(gray)

        self.num_frames = len(self.frames)
        self.prev_ts_cache.fill(0)
        self.frame_id = 0
        self.ending = False

    def update_frame(self):
        frame = self.frames[self.frame_id]
        t = self.timestamps[self.frame_id]
        self.frame_id += 1
        return frame, t
