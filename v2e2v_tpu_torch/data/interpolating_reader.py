"""LFR-sequence reader with Super-SloMo adaptive upsampling (port of
``v2e2v_tpu/data/interpolating_reader.py``).

Reference ``VideoInterpolator`` (``data_readers/video_readers.py:185-265``):
read every frame (``.jpg`` and ``.png`` frames, as the JAX reader lists them,
through ``utils/image_io.read_gray``; cropped to even H and W)
and the timestamps of the folder, upsample them at ``initialize`` with one
``Upsampler`` per reader (built on the first sequence), then serve the
upsampled frames as an in-memory reader does; optionally with the
sequence's event iterator, for evaluation.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.image_io import read_gray
from .video_readers import PackReader, _scan_sequence_folder, read_timestamps_file


class InterpolatingReader(PackReader):
    """``device`` runs the upsampler: None means the card, raising without
    one when the first sequence is read; the CPU only when asked for."""

    def __init__(
        self,
        image_dim,
        num_bins: int = 5,
        is_with_events: bool = False,
        time_unit: str = "s",
        ckpt_path: str | None = None,
        device: torch.device | str | None = None,
    ):
        super().__init__(image_dim, num_bins, is_with_events)
        self.time_unit = time_unit
        self.ckpt_path = ckpt_path
        self.device = device
        self._upsampler = None

    def initialize(self, path_to_sequence: str, num_load_frames: int = -1):
        from ..models.superslomo import Upsampler

        self.frame_id = 0
        self.ending = False
        path_to_frames, path_to_events, ts_path = _scan_sequence_folder(path_to_sequence)
        timestamps = read_timestamps_file(ts_path, self.time_unit)
        if num_load_frames > 0:
            path_to_frames = path_to_frames[:num_load_frames]
            timestamps = timestamps[:num_load_frames]

        frames = [read_gray(p) for p in path_to_frames]
        self.height = (frames[0].shape[0] // 2) * 2
        self.width = (frames[0].shape[1] // 2) * 2
        self.prev_ts_cache = np.zeros(1, dtype=np.float64)
        frames = [f[: self.height, : self.width] for f in frames]

        if self._upsampler is None:
            self._upsampler = Upsampler([self.height, self.width], is_train=False,
                                        ckpt_path=self.ckpt_path, device=self.device)
        self.frames, self.timestamps = self._upsampler.upsampling(frames, timestamps)
        self.num_frames = len(self.timestamps)

        if self.is_with_events:
            self._setup_event_iterator(path_to_events, num_load_frames)

    def update_frame(self):
        frame = self.frames[self.frame_id]
        t = self.timestamps[self.frame_id]
        self.frame_id += 1
        return frame, t
