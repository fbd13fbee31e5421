"""Host-to-device prefetching data pipeline (port of
``v2e2v_tpu/data/prefetch.py``).

The reference used torch DataLoader worker processes (``train_e2v.py:61``).
Here a background thread runs the dataset's loading, decoding and voxelising
ahead of the train step, and each batch is copied to the card one step early
from pinned memory, so the card does not wait on the host.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

DEPTH = 2  # batches held ready ahead of the consumer


def prefetch_iterator(it: Iterable) -> Iterator:
    """Run ``it`` in a background thread with a buffer of ``DEPTH`` items.

    Abandonment-safe: if the consumer drops this generator mid-stream (e.g.
    a train step raised), its ``finally`` signals the producer, which stops
    iterating and CLOSES the source iterator — so resources held by source
    generators (like an ephemeral worker pool in ``iterate_batches``) are
    released instead of leaking behind a thread blocked on ``q.put``.
    """
    q: queue.Queue = queue.Queue(maxsize=DEPTH)
    _END = object()
    err: list[BaseException] = []
    stop = threading.Event()

    def producer():
        src = iter(it)
        try:
            while not stop.is_set():
                try:
                    item = next(src)
                except StopIteration:
                    break
                except BaseException as e:  # surfaced on the consumer side
                    err.append(e)
                    break
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        finally:
            close = getattr(src, "close", None)
            if close is not None:
                close()
            # blocking-with-stop put: the queue may be FULL of unconsumed
            # items here, and dropping _END would hang the consumer forever;
            # only an abandoning consumer (stop set) may discard it
            while not stop.is_set():
                try:
                    q.put(_END, timeout=0.1)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        while True:  # unblock a producer waiting on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5.0)


def device_prefetch(
    batches: Iterable,
    transform: Callable | None = None,
    device: torch.device | str = "cpu",
) -> Iterator:
    """Prefetch host batches (tuples of numpy arrays) and place them on
    ``device`` ahead of consumption, as tuples of tensors.

    ``transform(batch)`` runs on the host first (e.g. axis moves). On a CUDA
    device each array is pinned and copied with ``non_blocking=True`` on the
    current stream of the producer thread (the device's default stream, which
    the consumer's work also runs on unless it sets another), so the copy of
    batch ``i + 1`` overlaps the step on batch ``i``. A consumer on another
    stream must wait for the default stream before it reads a batch.
    """
    device = torch.device(device)

    def place(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    def produce():
        for batch in batches:
            if transform is not None:
                batch = transform(batch)
            yield tuple(place(a) for a in batch)

    return prefetch_iterator(produce())
