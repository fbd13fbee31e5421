#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``v2e2v_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, one line each (any failure exits non-zero before the last line):

1. device: ``nvidia-smi`` name and power limit, and torch's device name;
2. build: every CUDA source with one ``nvcc`` call (seconds, and
   ``-Xptxas -v``'s registers, shared memory and spills per kernel);
3. kernel K1 (``ista_loop``) against its plain version at the flagship shape
   (B = 8, 90x120, C = 64, depth 5), in float32 with TF32 off and in bfloat16;
4. the slice: a ``StreamPool`` of CISTA-LSTC at 180x240, 64 channels, depth 5,
   5 bins, capacity 8, serving 7 streams (6 at a time, one detached and one
   attached mid-run) whose requests are packets of ~15,000 synthetic events
   voxelised and normalised on the card; the launch counter must rise by
   2 x depth per pool step, and the same voxel grids through the plain ISTA
   must give the same reconstructions. Run in float32 (TF32 off) and bfloat16;
5. times with CUDA events after warm-up: K1, its plain version, the nearest
   library call (cuDNN convs), its bound; the pool's step time, reconstructions
   per second and peak memory;
6. a ``{"kernels": [...]}`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package ``v2e2v_tpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

H, W, C, DEPTH, NB = 180, 240, 64, 5, 5
CAPACITY = 8
NUM_EVENTS = 15000  # events per request packet, the CLI's --num_events
EVENT_CAPACITY = 16384
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # H100 SXM, dense
PEAK_BYTES = 3.35e12
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}  # atol and rtol
K1_SOURCE = "v2e2v_tpu_torch/csrc/ista.cu"
K1_REPLACES = "v2e2v_tpu/ops/pallas/ista.py:88"
DNAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def say(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    say(f"FAIL: {msg}")
    sys.exit(1)


def within(got: torch.Tensor, want: torch.Tensor, tol: float) -> tuple[float, bool]:
    diff = (got.float() - want.float()).abs()
    ok = bool(torch.all(diff <= tol + tol * want.float().abs()))
    return float(diff.max()), ok


def short_name(mangled: str) -> str:
    """K1's instances as ista_conv3x3_kernel<dtype, conv>; others as given."""
    m = re.search(r"ista_conv3x3_kernelI(\w+?)Li([01])E", mangled)
    if not m:
        return mangled[:80]
    dtype = "bfloat16" if "bfloat16" in m.group(1) else "float32"
    return f"ista_conv3x3_kernel<{dtype}, {'D' if m.group(2) == '0' else 'P'} conv>"


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


def ista_inputs(gen: torch.Generator, dtype: torch.dtype, weights: dict):
    """K1's inputs at the pool's shape: x1 and z ~ N(0, 0.5^2) in ``dtype``,
    and the ISTA block (HWIO D and P, biases, Lambda) of the model's weights."""
    b, h, w, c = CAPACITY, H // 2, W // 2, C
    act = [(0.5 * torch.randn(b, h, w, k, generator=gen)).cuda().to(dtype) for k in (c, 2 * c)]
    blk = "lista_blocks.0."
    return (*act, weights[blk + "D.conv2d.weight"].permute(2, 3, 1, 0),
            weights[blk + "D.conv2d.bias"], weights[blk + "P.conv2d.weight"].permute(2, 3, 1, 0),
            weights[blk + "P.conv2d.bias"], weights[blk + "Lambda"].reshape(-1))


def ista_bound_ms(args, depth: int) -> tuple[float, str]:
    x1, z, dw, db, pw, pb, lam = args
    b, h, w, c = x1.shape
    flops = 2 * 9 * b * h * w * (2 * c * c + c * 2 * c) * depth
    elem = x1.element_size()
    n_bytes = elem * (x1.numel() + 2 * z.numel() + dw.numel() + db.numel() + pw.numel()
                      + pb.numel() + lam.numel())
    t_ops, t_bytes = flops / PEAK_FLOPS[x1.dtype], n_bytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def synthetic_packets(rng: np.random.Generator, n_packets: int, device):
    """Packets of ~15,000 events (the CLI's --num_events) over a 30 ms window,
    padded to a static capacity; returns (t, x, y, p, n_valid) on the card."""
    packets = []
    t0 = 0.0
    for _ in range(n_packets):
        n = int(rng.integers(NUM_EVENTS - 1000, NUM_EVENTS + 1))
        t = np.zeros(EVENT_CAPACITY)
        t[:n] = np.sort(t0 + rng.uniform(0.0, 0.03, n))
        t0 += 0.03
        x = np.zeros(EVENT_CAPACITY, np.int32)
        y = np.zeros(EVENT_CAPACITY, np.int32)
        p = np.zeros(EVENT_CAPACITY, np.int8)
        x[:n] = rng.integers(0, W, n)
        y[:n] = rng.integers(0, H, n)
        p[:n] = rng.integers(0, 2, n)
        packets.append(tuple(torch.from_numpy(a).to(device) for a in (t, x, y, p)) + (n,))
    return packets


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("no CUDA card (torch.cuda.is_available() is False)")

    from v2e2v_tpu_torch.models.cista import CistaConfig, init_cista_lstc
    from v2e2v_tpu_torch.ops.cuda import _lib
    from v2e2v_tpu_torch.ops.cuda.ista import ista_loop, ista_loop_plain
    from v2e2v_tpu_torch.ops.voxel import event_preprocess, events_to_voxel_grid
    from v2e2v_tpu_torch.serving import StreamPool

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say(smi)
    kind = torch.cuda.get_device_name(0)
    say(f"[device] torch: {kind}, {torch.cuda.device_count()} card(s), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    lib = _lib.load()
    say(f"[build] {lib.path.name}: nvcc {lib.build_seconds:.1f} s")
    name = None
    for line in lib.log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("registers" in line or "spill" in line):
            say(f"[build]   {short_name(name)}: {line.split('ptxas info    :')[-1].strip()}")
    smem = {cout: lib.lib.v2e_ista_conv3x3_smem_bytes(cout) for cout in (C, 2 * C)}
    say(f"[build] K1 dynamic shared memory per block: D conv (cout={C}) {smem[C]} B, "
        f"P conv (cout={2 * C}) {smem[2 * C]} B")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say(f"[tf32] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    cfg = CistaConfig(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB,
                      ista_impl="cuda")
    weights = init_cista_lstc(torch.Generator().manual_seed(args.seed), cfg, device="cuda")

    # 3. K1 against its plain version at the flagship shape
    k1 = {}
    for dtype in (torch.float32, torch.bfloat16):
        inputs = ista_inputs(torch.Generator().manual_seed(args.seed), dtype, weights)
        got = ista_loop(*inputs, depth=DEPTH)
        want = ista_loop_plain(*inputs, depth=DEPTH)
        torch.cuda.synchronize()
        err, ok = within(got, want, TOL[dtype])
        say(f"[k1] ista_loop {DNAME[dtype]} B={CAPACITY} {H // 2}x{W // 2} C={C} depth={DEPTH}: "
            f"max_abs_err={err:.3e} "
            f"(tol atol=rtol={TOL[dtype]}) {'pass' if ok else 'FAIL'}")
        if not (ok and torch.isfinite(got.float()).all()):
            fail(f"K1 disagrees with its plain version in {DNAME[dtype]}")
        k1[dtype] = {"inputs": inputs, "max_abs_err": err}

    # 4. the slice on the card
    cfg_plain = dataclasses.replace(cfg, ista_impl="plain")
    packets = synthetic_packets(np.random.default_rng(args.seed), 7 * 4, "cuda")

    def voxelize(packet):
        t, x, y, p, n = packet
        grid = events_to_voxel_grid(t, x, y, p, n, num_bins=NB, width=W, height=H)
        return event_preprocess(grid).permute(1, 2, 0)  # [H, W, num_bins]

    # per step: (stream -> request index); "swap" detaches stream 5, attaches 6
    schedule = [{s: 0 for s in range(6)}, {s: 1 for s in range(6)}, "swap",
                {**{s: 2 for s in range(5)}, 6: 0}, {**{s: 3 for s in range(5)}, 6: 1},
                {6: 2}, {6: 3}]

    def serve(pool, voxels=None):
        """Run the schedule; returns {(stream, req): rec [H, W]}, the voxel
        grids served and the launches of each pool step."""
        sid = {s: pool.attach() for s in range(6)}
        recs, voxels, launches = {}, dict(voxels or {}), []
        for entry in schedule:
            if entry == "swap":
                pool.detach(sid.pop(5))
                sid[6] = pool.attach()
                continue
            for s, r in entry.items():
                if (s, r) not in voxels:
                    voxels[(s, r)] = voxelize(packets[4 * s + r])
            before = ista_loop.launches
            out = pool.step({sid[s]: voxels[(s, r)] for s, r in entry.items()}, fetch=False)
            launches.append(ista_loop.launches - before)
            for s, r in entry.items():
                recs[(s, r)] = out[sid[s]].float().clone()
        torch.cuda.synchronize()
        return recs, voxels, launches

    main_launches = {}
    for dtype in (torch.float32, torch.bfloat16):
        ista_loop.launches = 0
        recs, voxels, per_step = serve(StreamPool(cfg, weights, CAPACITY, dtype))
        main_launches[dtype] = ista_loop.launches
        stacked = torch.stack(list(recs.values()))
        finite = bool(torch.isfinite(stacked).all())
        in_range = bool(((stacked >= 0) & (stacked <= 1)).all())
        say(f"[pool] {DNAME[dtype]}: {len(recs)} reconstructions of {H}x{W} from 7 streams in "
            f"{len(per_step)} pool steps; finite={finite} in[0,1]={in_range}; K1 launches "
            f"per step {per_step} (want {2 * DEPTH} each), total {main_launches[dtype]}")
        if not (finite and in_range):
            fail(f"pool reconstructions in {DNAME[dtype]} are not finite values in [0, 1]")
        if any(n != 2 * DEPTH for n in per_step):
            fail("K1's launch counter did not rise by 2 x depth per pool step")
        ref, _, _ = serve(StreamPool(cfg_plain, weights, CAPACITY, dtype), voxels)
        err, ok = within(stacked, torch.stack([ref[k] for k in recs]), TOL[dtype])
        say(f"[pool] {DNAME[dtype]}: kernel vs plain ISTA on the same voxel grids: "
            f"max_abs_err={err:.3e} (tol atol=rtol={TOL[dtype]}) {'pass' if ok else 'FAIL'}")
        if not ok:
            fail(f"the pool through K1 disagrees with the plain ISTA in {DNAME[dtype]}")

    # 5. times
    entries = []
    for dtype in (torch.float32, torch.bfloat16):
        inputs = k1[dtype]["inputs"]
        ms = time_ms(lambda: ista_loop(*inputs, depth=DEPTH))
        plain_ms = time_ms(lambda: ista_loop_plain(*inputs, depth=DEPTH))
        x1, z, dw, db, pw, pb, _ = inputs
        x1c, zc = x1.permute(0, 3, 1, 2), z.permute(0, 3, 1, 2)  # channels_last views
        dwc = dw.to(dtype).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        pwc = pw.to(dtype).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        dbc, pbc = db.to(dtype), pb.to(dtype)

        def library():
            torch.nn.functional.conv2d(zc, dwc, dbc, padding=1)
            torch.nn.functional.conv2d(x1c, pwc, pbc, padding=1)

        library_ms = DEPTH * time_ms(library)
        bound_ms, bound_by = ista_bound_ms(inputs, DEPTH)
        say(f"[time] K1 {DNAME[dtype]}: kernel {ms:.4f} ms/call, plain {plain_ms:.4f} ms, "
            f"library (F.conv2d D + P, zero padding, channels_last) x depth {library_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}; peak {PEAK_FLOPS[dtype] / 1e12:.0f} TFLOP/s, "
            f"{PEAK_BYTES / 1e12} TB/s) = {100 * bound_ms / ms:.1f}% of bound")
        entries.append({
            "name": f"ista_loop ({DNAME[dtype]})", "route": "cuda", "source": K1_SOURCE,
            "replaces": K1_REPLACES, "launches": main_launches[dtype],
            "max_abs_err": k1[dtype]["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        })

        pool = StreamPool(cfg, weights, CAPACITY, dtype)
        sids = [pool.attach() for _ in range(CAPACITY)]
        vox = {sid: voxelize(packets[i]) for i, sid in enumerate(sids)}
        torch.cuda.reset_peak_memory_stats()
        step_times = []
        for i in range(12):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pool.step(vox, fetch=False)
            torch.cuda.synchronize()
            if i >= 2:
                step_times.append(1e3 * (time.perf_counter() - t0))
        front_ms = time_ms(lambda: voxelize(packets[0]))
        step_ms = float(np.median(step_times))
        say(f"[time] pool {DNAME[dtype]} capacity {CAPACITY}, all active: step {step_ms:.3f} ms "
            f"(median of {len(step_times)}, host clock, min {min(step_times):.3f}), "
            f"{CAPACITY * 1e3 / step_ms:.1f} reconstructions/s; K1 share "
            f"{100 * ms / step_ms:.1f}%; front end (voxelise + normalise one packet) "
            f"{front_ms:.4f} ms; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    # 6. kernels, then the result line
    say(json.dumps({"kernels": entries}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
