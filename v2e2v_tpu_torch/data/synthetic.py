"""A small synthetic dataset in the layout the E2V CLI reads, written with
the port's own PNG writer (no PIL), so the CLI can be driven where only the
port's dependencies are installed.

    sequence_XXXXXXXXXX/
      frames/timestamps.txt + frame_XXXXXXXXXX.png   (8-bit gray)
      events/events_XXXXXXXXXX.npz                   (t, x, y, p per interval)

This is the layout of ``scripts/make_synth_data.py`` without its training
lists; the events are random, not emulated from the frames.
``write_hfr_dataset`` writes frame folders alone, the input of the V2E2V CLI
and of the event generation tool.
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


def hfr_frames(seed: int, frames: int, h: int, w: int, batch: int = 1,
               base: tuple[float, float] = (30.0, 200.0), fps: float = 250.0):
    """Flickering HFR frames ``[batch, frames, h, w]`` float32 in 0-255 and
    their times ``[frames]`` (seconds, ``i / fps`` in float32): each pixel is
    ``base * exp(a * sin(2 pi f t + phase))``, clipped, with base uniform in
    ``base``, a in [0.2, 1], f in [2, 8] Hz and the phase drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    shape = (batch, 1, h, w)
    b0 = rng.uniform(*base, shape).astype(np.float32)
    amp = rng.uniform(0.2, 1.0, shape).astype(np.float32)
    freq = rng.uniform(2.0, 8.0, shape).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, shape).astype(np.float32)
    t = np.arange(frames, dtype=np.float32) * np.float32(1.0 / fps)
    arg = 2 * np.pi * freq * t[None, :, None, None] + phase
    return np.clip(b0 * np.exp(amp * np.sin(arg)), 0, 255).astype(np.float32), t


def write_hfr_dataset(root: Path, seed: int, sequences: int, frames: int, h: int, w: int,
                      base: tuple[float, float] = (30.0, 200.0), fps: float = 250.0) -> None:
    """Write ``sequences`` folders ``sequence_XXXXXXXXXX/frames`` of
    ``frames`` 8-bit gray PNGs (``hfr_frames`` of seed ``seed + s``, rounded)
    and their ``timestamps.txt`` (``i / fps`` seconds)."""
    from ..utils.image_io import write_gray

    root = Path(root)
    for s in range(1, sequences + 1):
        fdir = root / f"sequence_{s:010d}" / "frames"
        fdir.mkdir(parents=True)
        video, _ = hfr_frames(seed + s, frames, h, w, base=base, fps=fps)
        (fdir / "timestamps.txt").write_text(
            "".join(f"{i} {i / fps:.9f}\n" for i in range(frames)))
        for i, img in enumerate(np.rint(video[0]).astype(np.uint8)):
            write_gray(str(fdir / f"frame_{i:010d}.png"), img)
