#!/usr/bin/env python3
"""Time the port's conv kernels on the card at the flagship pool's shape and
at the CLIs' batch 1.

    python3 scripts/time_torch_kernels.py [--rounds 2]

Times kernel K1 (``ista_loop``) and, where the tree has it, kernel K2
(``cista_core``) at B = 8 and B = 1, 90x120, C = 64, depth 5 on
``init_cista_lstc`` weights, in float32 (TF32 off) and bfloat16, with CUDA
events (3 warm-up and 10 timed calls per round, ``--rounds`` rounds in
turns), per call as the host issues them. Then each of the seven convs of K1
and K2 alone, through the library's C entry points at both batches, in both
dtypes, with its achieved TFLOP/s (2 * 9 * B*H*W * cin * cout operations per
call) and, in float32, its share of the 67 TFLOP/s of an H100 SXM's CUDA
cores. It imports the
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

BATCHES, H2, W2, C, DEPTH = (8, 1), 90, 120, 64, 5
F32_PEAK = 67e12  # float32 FFMA on CUDA cores, H100 SXM, dense


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
    for b in BATCHES:
        for dtype in (torch.float32, torch.bfloat16):
            x1, z, cell, dg_h, dg_c = (
                (s * torch.randn(b, H2, W2, k, device="cuda", generator=gen)).to(dtype)
                for s, k in ((0.5, C), (0.3, 2 * C), (0.3, 2 * C), (0.3, C), (0.3, C)))
            k1_args = (x1, z, sd[blk + "D.conv2d.weight"].permute(2, 3, 1, 0),
                       sd[blk + "D.conv2d.bias"], sd[blk + "P.conv2d.weight"].permute(2, 3, 1, 0),
                       sd[blk + "P.conv2d.bias"], sd[blk + "Lambda"].reshape(-1))
            name = str(dtype).split(".")[1]
            calls[f"K1 {name}", b] = lambda a=k1_args: ista_loop(*a, depth=DEPTH)
            if cista_core is not None:
                k2_args = (core_taps(sd, dtype), x1, z, cell, dg_h, dg_c)
                calls[f"K2 {name}", b] = lambda a=k2_args: cista_core(*a, depth=DEPTH)
    times: dict[tuple, list[float]] = {k: [] for k in calls}
    for _ in range(args.rounds):
        for key, fn in calls.items():
            times[key].append(time_ms(fn))
    for (key, b), ts in times.items():
        print(f"[time] {ROOT.name} {key}: {' / '.join(f'{t:.4f}' for t in ts)} ms per call "
              f"(B={b}, {H2}x{W2}, C={C}, depth={DEPTH})", flush=True)
    time_convs()


# (name, C entry, epilogue, cin_a, cin_b, cout) of every conv of K1 and K2
CONVS = [("D", "ista", 0, 2 * C, 0, C), ("P", "ista", 1, C, 0, 2 * C),
         ("gates (pre-activation)", "core", 2, C, 2 * C, 4 * C),
         ("P0 (pre-activation)", "core", 2, C, 0, 2 * C),
         ("out gate", "core", 4, 2 * C, 2 * C, 2 * C), ("Dg (relu)", "core", 3, 2 * C, 0, C),
         ("ConvLSTM gates (pre-activation)", "core", 2, C, C, 4 * C)]


def time_convs() -> None:
    """Each conv of K1 and K2 alone at both batches, with its TFLOP/s."""
    from v2e2v_tpu_torch.ops.cuda._lib import load

    try:  # the bfloat16 tensor-core conv reads its taps laid out
        from v2e2v_tpu_torch.ops.cuda.conv_tc import wgmma_taps
    except ImportError:  # a tree from before it
        wgmma_taps = None
    try:  # and so, since its redesign, does the float32 conv
        from v2e2v_tpu_torch.ops.cuda.conv_tc import simt_taps
    except ImportError:  # a tree from before it: plain [9, cin, cout] taps
        simt_taps = None
    lib = load()
    gen = torch.Generator(device="cuda").manual_seed(2)
    stream = torch.cuda.current_stream().cuda_stream
    for (dtype, code), B, (name, entry, epi, cin_a, cin_b, cout) in (
            (d, b, conv) for b in BATCHES for d in ((torch.float32, 0), (torch.bfloat16, 1))
            for conv in CONVS):
        def rand(*shape, s=0.5):
            return (s * torch.randn(*shape, device="cuda", generator=gen)).to(dtype)

        xa, xb = rand(B, H2, W2, cin_a), rand(B, H2, W2, max(cin_b, 8))
        wa, wb = rand(9, cin_a, cout, s=0.05), rand(9, max(cin_b, 8), cout, s=0.05)
        if dtype == torch.bfloat16 and wgmma_taps is not None:
            wa, wb = wgmma_taps(wa), wgmma_taps(wb)
        if dtype == torch.float32 and simt_taps is not None:
            wa, wb = simt_taps(wa), simt_taps(wb)
        bias = torch.zeros(cout, device="cuda")
        lam = torch.full((cout,), 0.01, device="cuda")
        other = (rand(B, H2, W2, cout) if epi in (0, 1) else
                 rand(B, H2, W2, cout).float() if epi == 4 else None)
        out = torch.empty(B, H2, W2, cout, device="cuda",
                          dtype=torch.float32 if epi == 2 else dtype)
        optr = None if other is None else other.data_ptr()

        def call():
            if entry == "ista":
                err = lib.lib.v2e_ista_conv3x3(code, epi, xa.data_ptr(), wa.data_ptr(),
                                               bias.data_ptr(), optr, lam.data_ptr(),
                                               out.data_ptr(), B, H2, W2, cin_a, cout, stream)
            else:
                err = lib.lib.v2e_core_conv3x3(
                    code, epi, xa.data_ptr(), wa.data_ptr(), cin_a, xb.data_ptr(),
                    wb.data_ptr(), cin_b, bias.data_ptr(), optr, lam.data_ptr(),
                    out.data_ptr(), B, H2, W2, cout, stream)
            lib.check(err, f"{name} conv")

        ms = time_ms(call, warmup=3, iters=20)
        flops = 2 * 9 * B * H2 * W2 * (cin_a + cin_b) * cout / (ms * 1e-3)
        share = f", {100 * flops / F32_PEAK:.1f}% of 67" if code == 0 else ""
        print(f"[conv] {ROOT.name} {str(dtype).split('.')[1]} B={B} {name} "
              f"({cin_a}{f'+{cin_b}' if cin_b else ''} -> {cout}): {ms:.4f} ms, "
              f"{flops / 1e12:.1f} TFLOP/s{share}", flush=True)


if __name__ == "__main__":
    main()
