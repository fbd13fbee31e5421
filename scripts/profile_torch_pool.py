#!/usr/bin/env python3
"""Where a pool step, a V2E2V pack, or an E2V train step of the PyTorch/CUDA
port spends its time on the card.

    python3 scripts/profile_torch_pool.py [--dtype float32|bfloat16] [--core_impl layers|cuda]
                                          [--fullres_impl ref|fused] [--steps 10]
    python3 scripts/profile_torch_pool.py --v2e2v [--steps 10]
    python3 scripts/profile_torch_pool.py --train B [--steps 3]

Builds the flagship ``StreamPool`` (CISTA-LSTC 180x240, 64 channels, depth 5,
5 bins, capacity 8, all slots active, random weights from ``--seed``, its
half-res core layer by layer or as kernel K2 as ``--core_impl`` says, its
full-resolution convs as the reference shapes them or in the parity domain
as ``--fullres_impl`` says), warms
it up, and traces ``--steps`` pool steps with ``torch.profiler``. With
``--v2e2v`` it traces ``--steps`` packs of ``v2e2v_forward`` on the default
V2E2V path instead (``V2E2VConfig.from_flags`` with the emulator of
``bench.py:170-176``, batch 8, packs of 10 synthetic flickering frames from
``--seed``, float32), then ``--steps`` calls of its ``emulate_pack`` alone on
one pack. With ``--train B`` it traces ``--steps`` E2V train steps at batch
``B`` (``training/steps.make_e2v_train_step``: windows of 10, remat, Adam,
the training config ``ista_impl="plain"``, ``core_impl="layers"``, float32)
on one batch of N(0, 1) voxel grids. Prints the card's name and power limit, the step time on the host
clock, the device's busy and idle share over the traced window, and device
time and launches per step by kind (``CATEGORIES``: kernels K1
(``ista_conv3x3_kernel``, and ``ista_conv3x3_tc_kernel`` in bfloat16), K2
(its ``core_conv3x3_kernel`` or ``core_conv3x3_tc_kernel`` convs and its two
cell kernels) and K3 (``emulator_iters_kernel``), cuDNN's convs, layout
transposes, reflect pads, copies and concats, matmuls, the rest), then the
15 largest kernels. Needs a CUDA card; float32 runs with TF32 off.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import math
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from v2e2v_tpu_torch.models.cista import CistaConfig, init_cista_lstc  # noqa: E402
from v2e2v_tpu_torch.models.emulator import emulate_pack  # noqa: E402
from v2e2v_tpu_torch.models.v2e2v import V2E2VConfig, v2e2v_forward  # noqa: E402
from v2e2v_tpu_torch.serving import StreamPool  # noqa: E402


def pool_steps(cfg, weights, dtype, seed):
    pool = StreamPool(cfg, weights, capacity=8, dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    vox = {pool.attach(): torch.randn(180, 240, 5, device="cuda", generator=gen)
           for _ in range(8)}
    return lambda: pool.step(vox, fetch=False)


def v2e2v_steps(weights, seed, packs, batch=8, n=10):
    """One pack per call, the state carried on; frames flicker per pixel as
    ``base * exp(a * sin(2 pi f t + phase))`` at 250 fps and are made on the
    card before the trace."""
    flags = argparse.Namespace(
        image_dim=[180, 240], base_channels=64, depth=5, num_bins=5, event_mode="voxel_grid",
        pl=1.5, ps=0.5, ql=1.0, qs=0.0, C=0.6, threshold_sigma=0.03, cutoff_hz=200.0,
        refractory_period_s=0.001)
    cfg = V2E2VConfig.from_flags(flags)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (batch, 1, 180, 240)
    base = 30 + 170 * torch.rand(shape, device="cuda", generator=gen)
    amp = 0.2 + 0.8 * torch.rand(shape, device="cuda", generator=gen)
    freq = 2 + 6 * torch.rand(shape, device="cuda", generator=gen)
    phase = 2 * math.pi * torch.rand(shape, device="cuda", generator=gen)
    video = []
    for k in range(packs):
        t = 0.004 * torch.arange(k * (n - 1), k * (n - 1) + n, device="cuda",
                                 dtype=torch.float32)
        arg = 2 * math.pi * freq * t[None, :, None, None] + phase
        frames = (base * torch.exp(amp * torch.sin(arg))).clamp(0, 255)
        video.append((frames, t.expand(batch, n).contiguous()))
    run = {"state": None, "pack": 0}

    def step():
        frames, t = video[run["pack"]]
        if run["pack"] == packs - 1:
            run["before_last"] = run["state"]
        _, run["state"] = v2e2v_forward(weights, cfg, frames, t, run["state"], gen)
        run["pack"] += 1

    def emulate():
        """The emulator alone on the last pack, from the state before it."""
        frames, t = video[-1]
        emulate_pack(cfg.emulator, run["before_last"].emulator, frames, t, gen)

    return step, emulate


def train_steps(cfg, seed, batch, t=10):
    """One E2V train step per call on a fixed batch."""
    from v2e2v_tpu_torch.models.cista import tie_weights
    from v2e2v_tpu_torch.training.steps import make_adam, make_e2v_train_step

    sd = tie_weights(init_cista_lstc(torch.Generator().manual_seed(seed), cfg), cfg)
    step = make_e2v_train_step(cfg, make_adam(sd, cfg, 1e-4))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    seq = torch.randn(t, batch, 180, 240, 5, device="cuda", generator=gen)
    gt = torch.rand(batch, 180, 240, 1, device="cuda", generator=gen)
    return lambda: step(sd, seq, gt)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    ap.add_argument("--core_impl", choices=["layers", "cuda"], default="layers")
    ap.add_argument("--fullres_impl", choices=["ref", "fused"], default="ref")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--v2e2v", action="store_true", help="trace V2E2V packs, not pool steps")
    ap.add_argument("--train", type=int, default=0, metavar="B",
                    help="trace E2V train steps at batch B, not pool steps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = getattr(torch, args.dtype)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)

    cfg = CistaConfig(image_dim=(180, 240), base_channels=64, depth=5, num_bins=5,
                      core_impl=args.core_impl, fullres_impl=args.fullres_impl)
    weights = init_cista_lstc(torch.Generator().manual_seed(args.seed), cfg)
    if args.train:
        cfg = dataclasses.replace(cfg, ista_impl="plain", core_impl="layers")
        trace(train_steps(cfg, args.seed, args.train), args.steps,
              f"E2V train step float32 B={args.train} T=10")
    elif args.v2e2v:
        step, emulate = v2e2v_steps(weights, args.seed, args.steps + 3)
        trace(step, args.steps, "v2e2v float32 batch 8 pack")
        trace(emulate, args.steps, "emulate_pack alone, batch 8 pack")
    else:
        trace(pool_steps(cfg, weights, dtype, args.seed), args.steps,
              f"{args.dtype} core_impl={args.core_impl} fullres_impl={args.fullres_impl} "
              "capacity 8 step")


# kinds of device kernels, by name, first match wins
CATEGORIES = (
    ("K1", ("ista_conv3x3_",)),
    ("K2", ("core_conv3x3_", "core_lstc_cell", "core_lstm_cell")),
    ("K3", ("emulator_iters_kernel",)),
    ("layout transposes", ("nchwToNhwc", "nhwcToNchw", "ToNhwc", "ToNchw")),
    ("cuDNN convs", ("fprop", "implicit", "conv", "cudnn", "fft", "dgrad", "wgrad")),
    ("reflect pads", ("reflection_pad",)),
    ("copies and concats", ("copy", "CatArray", "cat_")),
    ("matmuls", ("gemm", "gemv")),
)


def kind(name: str) -> str:
    return next((label for label, keys in CATEGORIES if any(k in name for k in keys)), "rest")


def trace(step, steps: int, what: str) -> dict:
    """Warm up, trace ``steps`` calls, print the breakdown; returns the step
    time (host clock, traced), the device's busy share and ``{kind: (ms,
    launches)}`` per step."""
    for _ in range(3):
        step()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)

    by_kernel: dict[str, float] = collections.defaultdict(float)
    count: dict[str, int] = collections.Counter()
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            by_kernel[evt.name] += evt.time_range.elapsed_us() / 1e3
            count[evt.name] += 1
    busy_ms = sum(by_kernel.values())
    kinds: dict[str, list] = {label: [0.0, 0] for label, _ in CATEGORIES + (("rest", ()),)}
    for name, ms in by_kernel.items():
        kinds[kind(name)][0] += ms
        kinds[kind(name)][1] += count[name]
    per_step = {k: (ms / steps, n / steps) for k, (ms, n) in kinds.items()}
    parts = [f"{k} {ms:.4f} ms/step in {n:g} launches ({100 * ms * steps / busy_ms:.1f}%)"
             for k, (ms, n) in per_step.items() if n]
    print(f"[profile] {what}: {wall_ms / steps:.3f} ms (host clock, traced), "
          f"device busy {busy_ms / steps:.3f} ms/step = {100 * busy_ms / wall_ms:.1f}%, idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%; {sum(count.values()) // steps} kernels/step; "
          f"{'; '.join(parts)}", flush=True)
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]:
        print(f"[profile]   {ms / steps:8.3f} ms/step {count[name] // steps:4d}x  "
              f"[{kind(name)}] {name[:100]}", flush=True)
    return {"step_ms": wall_ms / steps, "busy": busy_ms / wall_ms, "kinds": per_step}


if __name__ == "__main__":
    main()
