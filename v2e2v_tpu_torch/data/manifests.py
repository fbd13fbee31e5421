"""Training-manifest generators and offline sequence iterators (port of
``v2e2v_tpu/data/manifests.py``).

Equivalent of reference ``upsampling/utils/utils.py`` (:11-92 manifest
writers, :157-183 folder sniffer) and the pair-yielding generators of
``upsampling/utils/dataset.py``: the offline tooling that builds training
datasets from simulated or upsampled sequences. The manifests are the JAX
package's byte for byte; frames are read by the port's PNG decoder.

Manifest formats produced (consumed by ``v2e2v_tpu_torch.data.datasets``):

- ``train_e2v.txt``:   ``seq_id num_events t0 t1 frame0 frame1 events.npz``
- ``train_v2e2v.txt``: ``seq_id  t_0..t_{N-1}  frame_0..frame_{N-1}``
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

IMG_FORMATS = {".png", ".jpg", ".jpeg", ".bmp", ".pbm", ".pgm", ".ppm", ".webp", ".tiff", ".tif"}
VIDEO_FORMATS = {".mp4", ".avi", ".mov", ".mkv", ".webm", ".m4v", ".mpg", ".mpeg", ".wmv", ".flv"}
FRAMES_DIRNAME = "frames"
EVENTS_DIRNAME = "events"


def _list_sequence(path_to_seq: str):
    """Return (frame_relpaths, event_relpaths, timestamps) or None."""
    seq_name = os.path.basename(path_to_seq)
    img_dir = os.path.join(path_to_seq, FRAMES_DIRNAME)
    if not os.path.isdir(img_dir):
        return None
    ts_file = os.path.join(img_dir, "timestamps.txt")
    if not os.path.isfile(ts_file):
        return None

    timestamps = []
    with open(ts_file) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                timestamps.append(parts[1])

    frames = sorted(
        f for f in os.listdir(img_dir) if Path(f).suffix.lower() in IMG_FORMATS
    )
    frames = [os.path.join(seq_name, FRAMES_DIRNAME, f) for f in frames]

    ev_dir = os.path.join(path_to_seq, EVENTS_DIRNAME)
    events = []
    if os.path.isdir(ev_dir):
        events = sorted(f for f in os.listdir(ev_dir) if f.endswith(".npz"))
        events = [os.path.join(seq_name, EVENTS_DIRNAME, f) for f in events]
    return frames, events, timestamps


def make_train_txt(
    data_dir: str, txt_name: str, num_intervals: int, step: int,
    only_sequence: str | None = None,
) -> int:
    """Write an interval manifest over all sequences with events.

    Each line covers ``num_intervals`` consecutive frame intervals:
    ``video_idx t_start t_end frame_0..frame_num_intervals ev_0..ev_{n-1}``.
    Returns the number of lines written.
    """
    lines = []
    video_idx = 0
    for seq_name in sorted(os.listdir(data_dir)):
        if only_sequence is not None and seq_name != only_sequence:
            continue
        listed = _list_sequence(os.path.join(data_dir, seq_name))
        if listed is None:
            continue
        frames, events, timestamps = listed
        if not events:
            continue
        for i in range(0, len(frames) - num_intervals - 1, step):
            evs = " ".join(events[i + j] for j in range(num_intervals))
            frs = " ".join(frames[i + j] for j in range(num_intervals + 1))
            lines.append(
                f"{video_idx} {timestamps[i]} {timestamps[i + num_intervals]} {frs} {evs}"
            )
        video_idx += 1
    with open(os.path.join(data_dir, txt_name), "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
    return len(lines)


def make_train_txt_wo_events(
    data_dir: str, txt_name: str, num_frames: int, step: int
) -> int:
    """Write a frames-only manifest (``train_v2e2v.txt`` format):
    ``video_idx t_0..t_{N-1} frame_0..frame_{N-1}`` per line."""
    lines = []
    video_idx = 1
    for seq_name in sorted(os.listdir(data_dir)):
        listed = _list_sequence(os.path.join(data_dir, seq_name))
        if listed is None:
            continue
        frames, _events, timestamps = listed
        for i in range(0, len(frames) - num_frames + 1, step):
            ts = " ".join(timestamps[i + j] for j in range(num_frames))
            frs = " ".join(frames[i + j] for j in range(num_frames))
            lines.append(f"{video_idx} {ts} {frs}")
        video_idx += 1
    with open(os.path.join(data_dir, txt_name), "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
    return len(lines)


def get_sequence_or_none(path: str):
    """Sniff a folder: returns ``('images', paths, ts)`` for a frame
    sequence, ``('video', path, None)`` for a video file inside, else None
    (reference ``get_sequence_or_none``)."""
    if os.path.isdir(path):
        listed = _list_sequence(path)
        if listed is not None:
            frames, _events, ts = listed
            return ("images", frames, ts)
        vids = [
            f for f in sorted(os.listdir(path))
            if Path(f).suffix.lower() in VIDEO_FORMATS
        ]
        if vids:
            return ("video", os.path.join(path, vids[0]), None)
    elif Path(path).suffix.lower() in VIDEO_FORMATS:
        return ("video", path, None)
    return None


class ImageSequence:
    """Yield consecutive frame pairs ``(img0, img1, t0, t1)`` from a frame
    folder — the offline upsampling iterator (reference ``dataset.py``)."""

    def __init__(self, path_to_seq: str, time_unit: str = "s"):
        from .video_readers import read_timestamps_file

        listed = _list_sequence(path_to_seq)
        assert listed is not None, f"not a frame sequence: {path_to_seq}"
        rel_frames, _, _ = listed
        root = os.path.dirname(path_to_seq)
        self.paths = [os.path.join(root, f) for f in rel_frames]
        self.timestamps = read_timestamps_file(
            os.path.join(path_to_seq, FRAMES_DIRNAME, "timestamps.txt"), time_unit
        )

    def __len__(self):
        return max(len(self.paths) - 1, 0)

    def __iter__(self):
        from ..utils.image_io import read_gray

        for i in range(len(self)):
            img0 = read_gray(self.paths[i])
            img1 = read_gray(self.paths[i + 1])
            yield img0, img1, self.timestamps[i], self.timestamps[i + 1]


class VideoSequence:
    """Consecutive frame pairs of a video file: not ported. It needs a video
    decoder (``cv2.VideoCapture`` in the JAX package), which the port does
    not have."""

    def __init__(self, path_to_video: str):
        raise NotImplementedError(
            f"VideoSequence({path_to_video!r}) is not ported yet (ROADMAP.md queue 1, item 4): "
            "it needs a video decoder (cv2.VideoCapture in the JAX package), which the port "
            "does not have"
        )


def make_train_e2v_txt(data_dir: str, txt_name: str = "train_e2v.txt") -> int:
    """Write a ``TrainFixNEventData`` manifest from sequences with
    per-interval event npz files (e.g. produced by
    ``v2e2v_tpu_torch.cli.generate_events``):

        seq_id num_events t0 t1 frame0 frame1 events.npz

    Returns the number of lines written.
    """
    lines = []
    seq_idx = 0
    for seq_name in sorted(os.listdir(data_dir)):
        listed = _list_sequence(os.path.join(data_dir, seq_name))
        if listed is None:
            continue
        frames, events, timestamps = listed
        if not events:
            continue
        seq_idx += 1
        n = min(len(events), len(frames) - 1)
        for i in range(n):
            ev_path = os.path.join(data_dir, events[i])
            num_events = len(np.load(ev_path)["t"])
            lines.append(
                f"{seq_idx} {num_events} {timestamps[i]} {timestamps[i + 1]} "
                f"{frames[i]} {frames[i + 1]} {events[i]}"
            )
    with open(os.path.join(data_dir, txt_name), "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
    return len(lines)
