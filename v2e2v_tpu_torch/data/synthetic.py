"""A small synthetic dataset in the layout the E2V CLI reads, written with
the port's own PNG writer (no PIL), so the CLI can be driven where only the
port's dependencies are installed.

    sequence_XXXXXXXXXX/
      frames/timestamps.txt + frame_XXXXXXXXXX.png   (8-bit gray)
      events/events_XXXXXXXXXX.npz                   (t, x, y, p per interval)

This is the layout of ``scripts/make_synth_data.py`` without its training
lists; the events are random, not emulated from the frames.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def write_dataset(root: Path, seed: int, sequences: int, frames: int, h: int, w: int,
                  events: tuple[int, int]) -> None:
    """Write ``sequences`` sequences of ``frames`` frames of ``h x w`` under
    ``root``: drifting sinusoids and a moving box, stamps 1 ms apart, and per
    interval a number of events drawn in ``events`` (uniform stamps within the
    interval, uniform pixels, random polarity), all from ``seed``."""
    from ..utils.image_io import write_gray

    root = Path(root)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for s in range(1, sequences + 1):
        fdir = root / f"sequence_{s:010d}" / "frames"
        edir = root / f"sequence_{s:010d}" / "events"
        fdir.mkdir(parents=True)
        edir.mkdir(parents=True)
        kx, ky, drift = rng.uniform(0.02, 0.2), rng.uniform(0.02, 0.2), rng.uniform(0.1, 0.4)
        stamps = np.arange(frames) / 1000.0
        (fdir / "timestamps.txt").write_text(
            "".join(f"{i} {t:.9f}\n" for i, t in enumerate(stamps)))
        for i in range(frames):
            img = 120 + 60 * np.sin(kx * xx + ky * yy + drift * i)
            x0, y0 = (5 * i) % (w - 30), (3 * i) % (h - 30)
            img[y0:y0 + 30, x0:x0 + 30] = 230
            write_gray(str(fdir / f"frame_{i:010d}.png"), np.clip(img, 0, 255).astype(np.uint8))
        for i in range(frames - 1):
            n = int(rng.integers(events[0], events[1] + 1))
            np.savez(edir / f"events_{i:010d}.npz",
                     t=np.sort(rng.uniform(stamps[i], stamps[i + 1], n)),
                     x=rng.integers(0, w, n).astype(np.int16),
                     y=rng.integers(0, h, n).astype(np.int16),
                     p=rng.integers(0, 2, n).astype(np.int16))
