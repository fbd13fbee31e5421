#!/usr/bin/env python3
"""Time the port's conv kernels on the card at the flagship pool's shape.

    python3 scripts/time_torch_kernels.py [--rounds 2]

Times kernel K1 (``ista_loop``) and, where the tree has it, kernel K2
(``cista_core``) at B = 8, 90x120, C = 64, depth 5 on ``init_cista_lstc``
weights, in float32 (TF32 off) and bfloat16, with CUDA events (3 warm-up and
10 timed calls per round, ``--rounds`` rounds in turns). It imports the
package of the tree it lies in, so a copy of it placed in another checkout
(an unpacked parent commit, say) times that checkout's kernels: run both in
one call to compare two commits on one card. Prints the card's name and power
limit first. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from v2e2v_tpu_torch.models.cista import CistaConfig, init_cista_lstc  # noqa: E402
from v2e2v_tpu_torch.ops.cuda.ista import ista_loop  # noqa: E402

try:
    from v2e2v_tpu_torch.ops.cuda.core import cista_core, core_taps
except ImportError:  # a tree from before K2
    cista_core = None

B, H2, W2, C, DEPTH = 8, 90, 120, 64, 5


def time_ms(fn, warmup: int = 3, iters: int = 10) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    cfg = CistaConfig(image_dim=(2 * H2, 2 * W2), base_channels=C, depth=DEPTH)
    sd = init_cista_lstc(torch.Generator().manual_seed(0), cfg)
    blk = "lista_blocks.0."
    gen = torch.Generator(device="cuda").manual_seed(1)
    calls = {}
    for dtype in (torch.float32, torch.bfloat16):
        x1, z, cell, dg_h, dg_c = (
            (s * torch.randn(B, H2, W2, k, device="cuda", generator=gen)).to(dtype)
            for s, k in ((0.5, C), (0.3, 2 * C), (0.3, 2 * C), (0.3, C), (0.3, C)))
        k1_args = (x1, z, sd[blk + "D.conv2d.weight"].permute(2, 3, 1, 0),
                   sd[blk + "D.conv2d.bias"], sd[blk + "P.conv2d.weight"].permute(2, 3, 1, 0),
                   sd[blk + "P.conv2d.bias"], sd[blk + "Lambda"].reshape(-1))
        name = str(dtype).split(".")[1]
        calls[f"K1 {name}"] = lambda a=k1_args: ista_loop(*a, depth=DEPTH)
        if cista_core is not None:
            k2_args = (core_taps(sd, dtype), x1, z, cell, dg_h, dg_c)
            calls[f"K2 {name}"] = lambda a=k2_args: cista_core(*a, depth=DEPTH)
    times: dict[str, list[float]] = {k: [] for k in calls}
    for _ in range(args.rounds):
        for key, fn in calls.items():
            times[key].append(time_ms(fn))
    for key, ts in times.items():
        print(f"[time] {ROOT.name} {key}: {' / '.join(f'{t:.4f}' for t in ts)} ms per call "
              f"(B={B}, {H2}x{W2}, C={C}, depth={DEPTH})", flush=True)


if __name__ == "__main__":
    main()
