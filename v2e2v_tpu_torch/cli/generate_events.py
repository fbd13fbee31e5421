"""V2E generation tool of the port (port of ``scripts/generate_events.py``):
HFR frame sequences -> raw event files.

    python -m v2e2v_tpu_torch.cli.generate_events --path_to_test_data frames/ \\
        -o events_out/ [--C 0.6 --pl 1.5 --ps 0.5 --cutoff_hz 200 ...]

For every sequence folder under ``--path_to_test_data`` (frames and
``timestamps.txt``, read by ``ImageReader``): emulate raw events pack by pack
(``emulate_pack_raw``; leak 0.1 Hz, shot noise 1 Hz), convert their times from
bin units to seconds over each pack's window, split them per frame interval
(each event in one interval), and write
``<output_folder>/<sequence>/events/events_%010d.npz`` (``t`` float64
seconds; ``x``, ``y``, ``p`` int16, p in {-1, 1}).

Every sequence starts from the same noise source made from ``--seed``, as the
JAX tool uses one key for every sequence. It runs on the CUDA card, and on
the CPU only under ``V2E2V_PLATFORM=cpu``.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable

import numpy as np
import torch

from ..models.emulator import EmulatorConfig, GeneratorNoise, Noise, emulate_pack_raw


def emulator_config(cfgs) -> EmulatorConfig:
    """The tool's emulator: the flags' thresholds and filter, raw output,
    leak 0.1 Hz and shot noise 1 Hz, 32 iterations (the JAX tool reads no
    ``--v2e_max_iters``)."""
    return EmulatorConfig(
        output_mode="raw",
        num_bins=cfgs.num_bins,
        pl=cfgs.pl, ps=cfgs.ps, ql=cfgs.ql, qs=cfgs.qs,
        pos_thres=cfgs.C, neg_thres=cfgs.C,
        sigma_thres=cfgs.threshold_sigma,
        cutoff_hz=cfgs.cutoff_hz,
        refractory_period_s=cfgs.refractory_period_s,
        leak_rate_hz=0.1, shot_noise_rate_hz=1.0,
    )


def split_intervals(events: np.ndarray, timestamps: np.ndarray, n_frames: int,
                    num_bins: int):
    """A pack's raw events -> one ``(t, x, y, p)`` tuple per frame interval:
    times to seconds (``t0 + t * span / (num_bins - 1)``), sorted stably, and
    each event put in exactly one interval: interval ``j`` holds
    ``(t_j, t_j+1]``, the first one also everything before, the last one
    also anything past the pack's last frame time. (The JAX tool cuts
    ``[t_j, t_j+1]``, so it writes an event that lies on an interior frame
    time, as an event of a pair's last iteration does, to both intervals;
    ROADMAP.md section 3.)"""
    t0 = float(timestamps[0])
    t_span = float(timestamps[min(len(timestamps), n_frames) - 1]) - t0
    t_sec = t0 + events[:, 0] * (t_span / max(num_bins - 1, 1))
    bounds = np.asarray(timestamps[:n_frames], np.float64)
    order = np.argsort(t_sec, kind="stable")
    t_sorted, ev_sorted = t_sec[order], events[order]
    edges = [0, *np.searchsorted(t_sorted, bounds[1:-1], side="right"), len(t_sorted)]
    return [(t_sorted[lo:hi], *(ev_sorted[lo:hi, c].astype(np.int16) for c in (1, 2, 3)))
            for lo, hi in zip(edges[:-1], edges[1:])]


def generate(cfgs, device: torch.device,
             noise_for_sequence: Callable[[int], Noise] | None = None) -> int:
    """Write the event files of every sequence; returns the total number of
    events. ``noise_for_sequence(i)`` gives sequence ``i``'s noise source
    (default: a generator on ``device`` seeded with ``--seed`` for each)."""
    from ..data.video_readers import ImageReader

    emu = emulator_config(cfgs)
    if noise_for_sequence is None:
        def noise_for_sequence(_):
            return GeneratorNoise(torch.Generator(device=device).manual_seed(cfgs.seed))

    sequences = sorted(
        os.path.join(cfgs.path_to_test_data, d)
        for d in os.listdir(cfgs.path_to_test_data)
        if os.path.isdir(os.path.join(cfgs.path_to_test_data, d))
    )
    grand_total = 0
    for seq_id, path in enumerate(sequences):
        name = os.path.basename(path)
        if cfgs.test_data_name is not None and name != cfgs.test_data_name:
            continue
        reader = ImageReader(cfgs.image_dim, time_unit=cfgs.time_unit)
        reader.initialize(path, cfgs.test_img_num)
        out_dir = os.path.join(cfgs.output_folder, name, "events")
        os.makedirs(out_dir, exist_ok=True)

        noise = noise_for_sequence(seq_id)
        state = None
        pack_idx = interval_idx = total = 0
        n = cfgs.num_pack_frames
        num_packs = int(np.floor(reader.num_frames / (n - 1))) - 1
        for _ in range(max(num_packs, 0)):
            frames, _gt, timestamps = reader.update_frame_pack(n)
            if frames.shape[0] <= 1:
                continue
            events, n_ev, state = emulate_pack_raw(
                emu, state,
                torch.from_numpy(np.asarray(frames, np.float32))[None],
                torch.from_numpy(np.asarray(timestamps, np.float32))[None],
                noise, device=device,
            )
            for t, x, y, p in split_intervals(events, timestamps, frames.shape[0],
                                              cfgs.num_bins):
                np.savez(os.path.join(out_dir, f"events_{interval_idx:010d}.npz"),
                         t=t, x=x, y=y, p=p)
                interval_idx += 1
            total += n_ev
            pack_idx += 1
        grand_total += total
        print(f"{name}: {pack_idx} packs / {interval_idx} intervals, {total} events -> "
              f"{out_dir}")
    return grand_total


def main(argv: list[str] | None = None) -> int:
    from ..utils.configs import set_configs
    from ..utils.profiling import apply_platform_override

    parser = argparse.ArgumentParser(description="V2E raw event generation")
    set_configs(parser)
    cfgs = parser.parse_args(argv)
    return generate(cfgs, apply_platform_override())


if __name__ == "__main__":
    main()
