#!/usr/bin/env python3
"""Where a pool step of the PyTorch/CUDA port spends its time on the card.

    python3 scripts/profile_torch_pool.py [--dtype float32|bfloat16] [--steps 10]

Builds the flagship ``StreamPool`` (CISTA-LSTC 180x240, 64 channels, depth 5,
5 bins, capacity 8, all slots active, random weights from ``--seed``), warms
it up, and traces ``--steps`` pool steps with ``torch.profiler``. Prints the
card's name and power limit, the step time on the host clock, the device's
busy and idle share over the traced window, and device time by kernel, with
kernel K1 (``ista_conv3x3_kernel``) apart. Needs a CUDA card; float32 runs
with TF32 off.
"""

from __future__ import annotations

import argparse
import collections
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from v2e2v_tpu_torch.models.cista import CistaConfig, init_cista_lstc  # noqa: E402
from v2e2v_tpu_torch.serving import StreamPool  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = getattr(torch, args.dtype)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)

    cfg = CistaConfig(image_dim=(180, 240), base_channels=64, depth=5, num_bins=5)
    weights = init_cista_lstc(torch.Generator().manual_seed(args.seed), cfg)
    pool = StreamPool(cfg, weights, capacity=8, dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    vox = {pool.attach(): torch.randn(180, 240, 5, device="cuda", generator=gen)
           for _ in range(8)}
    for _ in range(3):
        pool.step(vox, fetch=False)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            pool.step(vox, fetch=False)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)

    by_kernel: dict[str, float] = collections.defaultdict(float)
    count: dict[str, int] = collections.Counter()
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            by_kernel[evt.name] += evt.time_range.elapsed_us() / 1e3
            count[evt.name] += 1
    busy_ms = sum(by_kernel.values())
    k1_ms = sum(v for k, v in by_kernel.items() if "ista_conv3x3_kernel" in k)
    steps = args.steps
    print(f"[profile] {args.dtype} capacity 8: step {wall_ms / steps:.3f} ms (host clock, traced), "
          f"device busy {busy_ms / steps:.3f} ms/step = {100 * busy_ms / wall_ms:.1f}%, idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%; K1 {k1_ms / steps:.3f} ms/step "
          f"({100 * k1_ms / busy_ms:.1f}% of device time); {sum(count.values()) // steps} "
          f"kernels/step")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]:
        print(f"[profile]   {ms / steps:8.3f} ms/step {count[name] // steps:4d}x  {name[:110]}")


if __name__ == "__main__":
    main()
