#!/usr/bin/env python3
"""Where the E2V training CLI's time goes at batch 1 on the card: the loop of
``cli/train_e2v.py`` against its bare train step.

    python3 scripts/time_torch_train_loop.py [--sequences 4] [--frames 601] [--seed 0]

Writes a synthetic E2V dataset (``data/synthetic.write_dataset``: 180x240
frames, 15,000-30,000 events per interval) and its manifest
(``data/manifests.make_train_e2v_txt``) under a temporary directory, then
times, at the CLI's defaults (CISTA-LSTC 180x240, C = 64, depth 5, 5 bins,
windows of 10, batch 1, float32 with TF32 off):

1. the bare step (``training/steps.make_e2v_train_step``) on one batch on the
   card: back to back (CUDA events), and each step followed by a read of its
   loss as the CLI does (host clock), with the host's time to issue it (from
   the call to its return);
2. the data path alone: ``iterate_batches`` and the pinned copy to the card,
   one batch at a time in the main thread;
3. one epoch of ``cli.train_e2v`` three ways: as it runs (a prefetch thread
   loads the batches), without the thread (each batch loaded in the loop),
   and with the thread fed by ``--num_workers 2`` spawned processes. Each
   step is timed from its call to its loss read; what is left of the epoch
   is the loop between steps.

The files are read back from the page cache they were written through. Prints
the card's name and power limit first. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from v2e2v_tpu_torch.cli import train_e2v  # noqa: E402
from v2e2v_tpu_torch.data import prefetch  # noqa: E402
from v2e2v_tpu_torch.data.datasets import TrainFixNEventData, iterate_batches  # noqa: E402
from v2e2v_tpu_torch.data.manifests import make_train_e2v_txt  # noqa: E402
from v2e2v_tpu_torch.data.synthetic import write_dataset  # noqa: E402
from v2e2v_tpu_torch.models.cista import CistaConfig, init_cista_lstc, tie_weights  # noqa: E402
from v2e2v_tpu_torch.training import steps as steps_mod  # noqa: E402

H, W, C, DEPTH, NB, T = 180, 240, 64, 5, 5, 10
EVENTS = (15000, 30000)
WARMUP = 2  # steps left out of each epoch's statistics


def stats(ms: list[float]) -> str:
    return f"median {np.median(ms):.3f}, mean {np.mean(ms):.3f}, min {min(ms):.3f} ms"


def bare_steps(seed: int, n: int) -> None:
    """The step alone on one batch already on the card."""
    cfg = CistaConfig(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB,
                      ista_impl="plain", core_impl="layers")
    sd = tie_weights(init_cista_lstc(torch.Generator().manual_seed(seed), cfg, "cuda"), cfg)
    step = steps_mod.make_e2v_train_step(cfg, steps_mod.make_adam(sd, cfg, 1e-4))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    seq = torch.randn(T, 1, H, W, NB, device="cuda", generator=gen)
    gt = torch.rand(1, H, W, 1, device="cuda", generator=gen)
    for _ in range(3):
        float(step(sd, seq, gt))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(n):
        loss = step(sd, seq, gt)
    ev[1].record()
    ev[1].synchronize()
    print(f"[step] bare, back to back: {ev[0].elapsed_time(ev[1]) / n:.3f} ms per step "
          f"(CUDA events over {n} steps)", flush=True)
    issue, total = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        loss = step(sd, seq, gt)
        t1 = time.perf_counter()
        float(loss)
        t2 = time.perf_counter()
        issue.append(1e3 * (t1 - t0))
        total.append(1e3 * (t2 - t0))
    print(f"[step] bare, each followed by its loss read: {stats(total)} per step (host "
          f"clock over {n} steps); the host issues a step in {stats(issue)}", flush=True)


def data_alone(manifest: Path, argv: list[str]) -> None:
    """The CLI's data path in the main thread, no step beside it."""
    cfgs = train_e2v.parse_flags(argv, "")
    ds = TrainFixNEventData(str(manifest), cfgs)
    ms = []
    t0 = time.perf_counter()
    for seq, _img, gt in iterate_batches(ds, 1, True, seed=cfgs.seed):
        for a in (np.moveaxis(seq, 1, 0), gt):
            torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to("cuda", non_blocking=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ms.append(1e3 * (t1 - t0))
        t0 = t1
    print(f"[data] alone: {len(ms)} batches, {stats(ms)} per batch (npz load, voxelise, "
          f"stack, pinned copy; host clock)", flush=True)


def cli_epoch(argv: list[str], what: str, swaps=()) -> None:
    """One epoch of the CLI, its steps timed from the call to the loss read."""
    marks = []
    build = steps_mod.make_e2v_train_step

    def timed_build(*a, **k):
        step = build(*a, **k)

        def timed(*sa):
            t0 = time.perf_counter()
            loss = step(*sa)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            marks.append((t0, t1, time.perf_counter()))
            return loss

        return timed

    saved = [(m, name, getattr(m, name)) for m, name, _ in swaps]
    for m, name, new in ((steps_mod, "make_e2v_train_step", timed_build), *swaps):
        setattr(m, name, new)
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            train_e2v.main(argv)
        run_s = time.perf_counter() - t0
    finally:
        steps_mod.make_e2v_train_step = build
        for m, name, old in saved:
            setattr(m, name, old)
    kept = marks[WARMUP:]
    step_ms = [1e3 * (c - a) for a, _, c in kept]
    issue_ms = [1e3 * (b - a) for a, b, _ in kept]
    gap_ms = [1e3 * (n[0] - p[2]) for p, n in zip(kept, kept[1:])]
    loop_ms = 1e3 * (kept[-1][2] - kept[0][0]) / len(kept)
    print(f"[cli] {what}: {len(marks)} steps, main() {run_s:.3f} s; over the {len(kept)} steps "
          f"after {WARMUP}: {loop_ms:.3f} ms per step of the loop; the step from its call to "
          f"its loss read {stats(step_ms)} (the host issues it in {stats(issue_ms)}); between "
          f"steps {stats(gap_ms)}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sequences", type=int, default=4)
    ap.add_argument("--frames", type=int, default=601)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=100, help="bare steps per timing")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)

    with tempfile.TemporaryDirectory(prefix="train_loop_") as tmp:
        data, models = Path(tmp) / "data", Path(tmp) / "models"
        t0 = time.perf_counter()
        write_dataset(data, args.seed, args.sequences, args.frames, H, W, EVENTS)
        lines = make_train_e2v_txt(str(data))
        print(f"[data] {args.sequences} sequences of {args.frames} frames {H}x{W}, {lines} "
              f"manifest lines, written in {time.perf_counter() - t0:.1f} s", flush=True)
        argv = ["--path_to_train_data", str(data), "--path_to_model", str(models),
                "--image_dim", str(H), str(W), "-c", str(C), "-d", str(DEPTH), "-b", str(NB),
                "--num_events", str(EVENTS[0]), "--len_sequence", str(T), "--seed",
                str(args.seed), "--epochs", "1"]
        bare_steps(args.seed, args.steps)
        data_alone(data / "train_e2v.txt", argv)
        cli_epoch(argv, "as it runs (prefetch thread)")
        cli_epoch(argv, "without the prefetch thread (each batch loaded in the loop)",
                  swaps=((prefetch, "prefetch_iterator", iter),))
        cli_epoch(argv + ["--num_workers", "2"], "prefetch thread fed by --num_workers 2")


if __name__ == "__main__":
    main()
