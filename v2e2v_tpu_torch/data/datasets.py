"""Training datasets (host side, numpy; port of ``v2e2v_tpu/data/datasets.py``).

Behavioral spec from reference ``data_readers/train_data_loaders.py``
(lsying009/V2E2V):

- ``TrainFixNEventData`` (:106-222) for E2V training: manifest lines are
  ``seq_id num_events t0 t1 frame0 frame1 events.npz``; consecutive intervals
  are greedily grouped until the cumulative event count reaches the budget
  (or a single interval already holds >= 80% of it); ``len_sequence`` groups
  form one training sample; per group the npz events are concatenated and
  voxelized (no hot-pixel filter), optionally noised.
- ``TrainSeqData`` (:10-103) for V2E2V training: manifest lines are
  ``seq_id, N timestamps, N frame paths``; line windows of ``len_sequence``
  stepping 5 lines (tails >= 3 kept); frames stay in 0-255 (the emulator's
  input domain); ground truth is the last frame / 255.

Arrays are NHWC / bins-last, the layout of the models. Frames (every format of
``manifests.IMG_FORMATS``) are read by the port's decoders
(``utils/image_io.read_gray``, ``cv2.imread``'s gray values) and events voxelised by the port's
``voxelize_and_preprocess_np``, so samples equal the JAX package's bit for bit.
"""

from __future__ import annotations

import os

import numpy as np

from ..ops.voxel import voxelize_and_preprocess_np
from ..utils.image_io import read_gray


class TrainFixNEventData:
    """E2V training samples: sequences of fixed-event-count voxel grids."""

    def __init__(self, train_data_txt: str, cfgs):
        self.path_to_train_data = cfgs.path_to_train_data
        self.num_bins = cfgs.num_bins
        self.height, self.width = cfgs.image_dim
        self.limit_num_events = cfgs.num_events
        self.len_sequence = cfgs.len_sequence
        self.add_noise = cfgs.add_noise

        video_cnt, num_events_list = [], []
        self.image_paths, self.next_image_paths, self.event_paths = [], [], []
        with open(train_data_txt) as f:
            for line in f:
                parts = line.strip().split()
                if not parts:
                    continue
                video_cnt.append(int(parts[0]))
                num_events_list.append(int(parts[1]))
                self.image_paths.append(parts[4])
                self.next_image_paths.append(parts[5])
                self.event_paths.append(parts[6])
        self._split_sequences(video_cnt, num_events_list)
        if getattr(cfgs, "drop_seq_tails", False):
            # uniform [T, ...] shapes, which batches of more than one sample
            # and --device_data need (--drop_seq_tails)
            self.sequence_line_id = [
                s for s in self.sequence_line_id if len(s) == self.len_sequence
            ]
        # per-sample seeding (not one sequential stream): identical noise no
        # matter which fork worker loads the sample, or in what order; the
        # train loop bumps ``self.epoch`` so augmentation stays fresh per epoch
        self._noise_seed = getattr(cfgs, "seed", 0)
        self.epoch = 0
        # RAM cache of the noiseless decoded/voxelized samples — the npz
        # inflate + voxelize dominates epoch time on few-core hosts and is
        # identical every epoch (--cache_samples; ~13 MB/sample at 180x240)
        self._cache = {} if getattr(cfgs, "cache_samples", False) else None

    def _split_sequences(self, video_cnt, num_events_list):
        """Greedy grouping (reference :149-184)."""
        prev_video_id = -1
        sum_events = 0
        self.sequence_line_id = []
        group, sequence = [], []
        frame_cnt = single_cnt = 0
        for line_id, video_id in enumerate(video_cnt):
            if video_id != prev_video_id:
                if len(sequence) >= 5:
                    if group:
                        sequence.append(group)
                    self.sequence_line_id.append(sequence)
                sequence, group = [], []
                prev_video_id = video_id
                sum_events = single_cnt = frame_cnt = 0

            sum_events += num_events_list[line_id]
            group.append(line_id)
            single_cnt += 1
            if sum_events >= self.limit_num_events or (
                single_cnt == 1 and sum_events > 0.8 * self.limit_num_events
            ):
                sequence.append(group)
                frame_cnt += 1
                sum_events = single_cnt = 0
                group = []
            if frame_cnt >= self.len_sequence:
                self.sequence_line_id.append(sequence)
                sequence, group = [], []
                frame_cnt = 0

    def __len__(self):
        return len(self.sequence_line_id)

    def _voxelize(self, events: np.ndarray) -> np.ndarray:
        grid = voxelize_and_preprocess_np(
            events, self.num_bins, self.width, self.height, filter_hot_pixel=False
        )
        return np.moveaxis(grid, 0, -1)  # bins-last

    def _load_noiseless(self, index):
        sequence = self.sequence_line_id[index]
        seq_events = []
        for group in sequence:
            windows = []
            for line_id in group:
                data = np.load(
                    os.path.join(self.path_to_train_data, self.event_paths[line_id]),
                    allow_pickle=True,
                )
                windows.append(
                    np.stack((data["t"], data["x"], data["y"], data["p"]), axis=1)
                )
            events = np.concatenate(windows, 0)
            seq_events.append(self._voxelize(events))

        img = read_gray(
            os.path.join(self.path_to_train_data, self.image_paths[sequence[0][0]])
        ).astype(np.float32) / 255.0
        gt = read_gray(
            os.path.join(self.path_to_train_data, self.next_image_paths[sequence[-1][-1]])
        ).astype(np.float32) / 255.0

        return (
            np.stack(seq_events, 0),  # [T, H, W, nb]
            img[..., None],  # [H, W, 1]
            gt[..., None],  # [H, W, 1]
        )

    # cacheable/emit split: the expensive epoch-invariant load vs the cheap
    # per-epoch finalization (noise) — lets the worker pool return raw
    # samples that the PARENT caches (see _PoolSampleStream)
    _load_cacheable = _load_noiseless

    def _emit(self, index, sample):
        seq_events, img, gt = sample
        if self.add_noise:
            rng = np.random.default_rng((self._noise_seed, self.epoch, index))
            noise = 0.1 * rng.normal(size=seq_events.shape).astype(np.float32)
            seq_events = seq_events + noise  # new array; cache stays noiseless
        return seq_events, img, gt

    def __getitem__(self, index):
        if self._cache is not None:
            sample = self._cache.get(index)
            if sample is None:
                sample = self._cache[index] = self._load_noiseless(index)
        else:
            sample = self._load_noiseless(index)
        return self._emit(index, sample)


class TrainSeqData:
    """V2E2V training samples: sequences of HFR frame packs."""

    def __init__(
        self,
        train_data_txt,
        path_to_train_data,
        len_sequence,
        num_pack_frames,
        drop_seq_tails: bool = False,
        cache_samples: bool = False,
    ):
        self.path_to_train_data = path_to_train_data
        self.len_sequence = len_sequence
        self.num_pack_frames = num_pack_frames
        self.drop_seq_tails = drop_seq_tails
        # uint8 frame cache (frames are read as 8-bit gray; cast on emit)
        self._cache = {} if cache_samples else None

        self.timestamps: list[float] = []
        self.image_paths: list[str] = []
        video_lines: list[list[int]] = []
        cur_lines: list[int] = []
        prev_video = 0
        line_id = 0
        with open(train_data_txt) as f:
            for line in f:
                parts = line.strip().split()
                if not parts:
                    continue
                v = int(parts[0])
                if v != prev_video:
                    video_lines.append(cur_lines)
                    cur_lines = []
                    prev_video = v
                cur_lines.append(line_id)
                line_id += 1
                n = self.num_pack_frames
                for i in range(n):
                    self.timestamps.append(float(parts[1 + i]))
                    self.image_paths.append(
                        os.path.join(path_to_train_data, parts[n + 1 + i])
                    )
        video_lines.append(cur_lines)

        self.start_seq_id, self.len_seq = [], []
        step = 5
        for lines in video_lines:
            for idx in range(0, len(lines), step):
                if idx + self.len_sequence <= len(lines):
                    self.start_seq_id.append(lines[idx])
                    self.len_seq.append(self.len_sequence)
                elif len(lines) - idx >= 3 and not self.drop_seq_tails:
                    self.start_seq_id.append(lines[idx])
                    self.len_seq.append(len(lines) - idx)

    def __len__(self):
        return len(self.start_seq_id)

    def _load_raw(self, index):
        seq_id = self.start_seq_id[index]
        cur_len = self.len_seq[index]
        n = self.num_pack_frames

        seq_ts, seq_images = [], []
        for m in range(cur_len):
            start = (seq_id + m) * n
            seq_ts.append(np.asarray(self.timestamps[start : start + n], np.float64))
            seq_images.append(
                np.stack(
                    [read_gray(self.image_paths[start + i]) for i in range(n)], 0
                )  # [N, H, W] uint8
            )
        return np.stack(seq_ts, 0), np.stack(seq_images, 0)

    _load_cacheable = _load_raw

    def _emit(self, index, raw):
        ts, images_u8 = raw
        images = images_u8.astype(np.float32)  # [T, N, H, W], 0-255 (emulator)
        return (
            ts,  # [T, N]
            images,
            images[:, -1, :, :, None] / 255.0,  # [T, H, W, 1] ground truth
        )

    def __getitem__(self, index):
        if self._cache is not None:
            raw = self._cache.get(index)
            if raw is None:
                raw = self._cache[index] = self._load_raw(index)
        else:
            raw = self._load_raw(index)
        return self._emit(index, raw)


# --- worker-pool sample loading -------------------------------------------
# The reference loads samples in torch DataLoader worker processes
# (``train_e2v.py:61``, num_workers=4). Same model here, with SPAWN (not
# fork) workers: the parent runs threads (torch's intra-op pool, the
# prefetch thread, CUDA's), and a forked child can hang on a lock one of
# them held. Spawn startup is expensive, so the pool persists across epochs
# (``SampleLoader`` = torch's persistent_workers=True analog).

_WORKER_DATASET = None


def _pool_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _pool_load_raw(idx):
    return _WORKER_DATASET._load_cacheable(int(idx))


class SampleLoader:
    """Persistent spawn-worker pool for parallel sample loading.

    Workers run only the epoch-invariant numpy load
    (``dataset._load_cacheable``) and never touch the card. Create once,
    call :meth:`stream` per epoch, ``close()`` when training ends (also a
    context manager; ``__del__`` is a safety net).
    """

    def __init__(self, dataset, num_workers: int):
        import copy
        import multiprocessing

        self.dataset = dataset
        self.num_workers = num_workers
        # workers get a cache-less snapshot: the parent owns the cache, and
        # shipping/growing per-worker copies would only burn RAM
        ds_worker = copy.copy(dataset)
        if getattr(ds_worker, "_cache", None) is not None:
            ds_worker._cache = None
        ctx = multiprocessing.get_context("spawn")
        self.pool = ctx.Pool(
            num_workers, initializer=_pool_init, initargs=(ds_worker,)
        )

    def stream(self, order):
        return _PoolSampleStream(self.dataset, order, self)

    def close(self):
        pool, self.pool = getattr(self, "pool", None), None
        if pool is not None:
            pool.terminate()
            pool.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


class _PoolSampleStream:
    """One epoch's ordered sample stream over a ``SampleLoader``.

    - Workers return the epoch-invariant raw sample; the PARENT stores it
      in ``dataset._cache`` (when enabled) and applies the per-epoch
      finalization (``dataset._emit``) — so ``--cache_samples`` composes
      with workers, and cached indices skip the pool entirely.
    - At most ``2*num_workers + 2`` results are in flight (torch
      DataLoader's prefetch_factor analog): a slow consumer cannot
      accumulate an epoch of decoded samples in the parent.
    """

    def __init__(self, dataset, order, loader: SampleLoader):
        self.dataset = dataset
        self.order = [int(i) for i in order]
        self.loader = loader
        self.max_inflight = 2 * loader.num_workers + 2
        self._pos = 0  # next order position to emit
        self._submit_pos = 0  # next order position to consider submitting
        self._inflight = {}  # order position -> AsyncResult

    def _cached(self, idx):
        cache = getattr(self.dataset, "_cache", None)
        return None if cache is None else cache.get(idx)

    def _pump(self):
        pool = self.loader.pool
        while (
            pool is not None
            and len(self._inflight) < self.max_inflight
            and self._submit_pos < len(self.order)
        ):
            pos = self._submit_pos
            idx = self.order[pos]
            if self._cached(idx) is None:
                self._inflight[pos] = pool.apply_async(_pool_load_raw, (idx,))
            self._submit_pos += 1

    def __iter__(self):
        return self

    def __next__(self):
        if self._pos >= len(self.order):
            raise StopIteration
        self._pump()
        pos = self._pos
        idx = self.order[pos]
        raw = self._cached(idx)
        if raw is None:
            res = self._inflight.pop(pos, None)
            raw = res.get() if res is not None else self.dataset._load_cacheable(idx)
            cache = getattr(self.dataset, "_cache", None)
            if cache is not None:
                cache[idx] = raw
        self._pos += 1
        return self.dataset._emit(idx, raw)


def iterate_batches(
    dataset,
    batch_size: int = 1,
    shuffle: bool = True,
    seed: int = 0,
    num_workers: int = 0,
    loader: SampleLoader | None = None,
):
    """Return an iterator of batch-first stacked numpy batches
    ``tuple[np.ndarray [B, ...]]``.

    A batch is flushed early when the next sample's shapes differ
    (variable-length sequence tails — the reference documents that
    ``--batch_size`` must be 1 when sequence length is not fixed).
    Parallel loading: pass a persistent ``loader`` (reused across epochs),
    or ``num_workers > 0`` to spin up an ephemeral pool for this iteration
    (torn down when the iterator is exhausted, abandoned, or GC'd).
    """
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)

    ephemeral = None
    if loader is None and num_workers > 0:
        ephemeral = loader = SampleLoader(dataset, num_workers)

    if loader is not None:
        stream = loader.stream(order)
    else:
        stream = (dataset[int(i)] for i in order)

    def gen():
        def flush(batch):
            return tuple(np.stack(parts, 0) for parts in zip(*batch))

        try:
            batch = []
            for sample in stream:
                if batch and any(
                    b.shape != s.shape for b, s in zip(batch[0], sample)
                ):
                    yield flush(batch)
                    batch = []
                batch.append(sample)
                if len(batch) == batch_size:
                    yield flush(batch)
                    batch = []
            if batch:
                yield flush(batch)
        finally:
            if ephemeral is not None:
                ephemeral.close()

    return gen()
