#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``v2e2v_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, one line each (any failure exits non-zero before the last line):

1. device: ``nvidia-smi`` name and power limit, and torch's device name;
2. build: every CUDA source by its own ``nvcc``, all at once, and one link
   (seconds, and ``-Xptxas -v``'s registers, shared memory and spills per
   kernel); ``cuobjdump --dump-sass`` of the library counts the ``HGMMA``
   (wgmma) and ``HMMA`` instructions of each kernel: every bfloat16 conv
   kernel of K1 and K2 (``*_conv3x3_tc_kernel``) must have ``HGMMA`` and
   spill nothing, every float32 conv kernel (``*_conv3x3_kernel``, FFMA on
   CUDA cores: float32 products and sums) must have neither and spill
   nothing; the float32 conv's tile at the flagship and CLI shapes;
3. kernel K1 (``ista_loop``) against its plain version at the flagship shape
   (B = 8, 90x120, C = 64, depth 5), in float32 with TF32 off and in bfloat16;
4. the slice: a ``StreamPool`` of CISTA-LSTC at 180x240, 64 channels, depth 5,
   5 bins, capacity 8, serving 7 streams (6 at a time, one detached and one
   attached mid-run) whose requests are packets of ~15,000 synthetic events
   voxelised and normalised on the card; the launch counter must rise by
   2 x depth per pool step, and the same voxel grids through the plain ISTA
   must give the same reconstructions. Run in float32 (TF32 off) and bfloat16;
4b. kernel K2 (``cista_core``, the half-res core) against its plain version at
   the flagship pool's shape (B = 8, 90x120, C = 64, depth 5) on the model's
   init weights, all five outputs, in float32 with TF32 off (1e-4) and in
   bfloat16 (3e-2 + 3e-2 |ref|);
4c. the K2 slice: the same ``StreamPool`` with ``core_impl="cuda"``, serving
   the same schedule and voxel grids, with every count set to 0 just before
   it: K2's counter must rise by 7 + 2 x depth per pool step and K1's by 0
   (K2 runs its ISTA convs itself); its reconstructions must equal the pool's
   with ``core_impl="plain"`` (within 1e-4 / 3e-2) and lie within 3e-2 of the
   layers pool of phase 4, finite and in [0, 1];
5. times with CUDA events after warm-up: K1, its plain version, the nearest
   library call (cuDNN convs), its bound; K2, its plain version, the layers
   core it replaces (ConvLSTC, K1, Dg conv, ConvLSTM) and the same with the
   plain ISTA (cuDNN convs only), its bound; each of K1, K2, cuDNN's convs and
   the layers core both per call as the host issues them (``ms``) and as
   device time (``device_ms``: launches back to back after the card spins),
   and for K1 and K2 the host's time to issue a call (``host_ms``); K1
   float32 also at the CLIs' batch 1 (B = 1, 90x120), with its bound and
   cuDNN's D + P at that shape;
   the pool's step time with
   ``core_impl`` "layers" and "cuda" in turns, reconstructions per second and
   peak memory;
6. kernel K3 (``emulator_iters``) against its plain version at the V2E2V
   shape (B = 8, 180x240, 32 iterations, 5 bins): explicit uniforms in the four
   shot x gate cases and internal Philox uniforms, all exact; internal uniforms
   repeat with their seed, and with no threshold events the shot-event total
   is within 5 sigma of Binomial(n, p) for the kernel and for the plain
   version with torch's uniforms;
7. the V2E2V slice: ``v2e2v_forward`` pack by pack (6 packs of 10 frames, a
   new sequence after pack 3, batch 8, CISTA-LSTC 180x240, 64 channels,
   depth 5, 5 bins, the emulator of ``bench.py:170-176``) on synthetic frames
   from ``--seed``. Run A through K3 and K1 with explicit draws; run B through
   the plain versions with the same card generator seed (equal event counts,
   voxel grids and reconstructions within 1e-4, TF32 off); run C on the
   default path (``V2E2VConfig.from_flags``, internal randoms), the main path
   of the slice, with every count set to 0 just before it: finite
   reconstructions in [0, 1], event counts within 1% of run A's; run D through
   the plain versions with run C's seed, its Philox made by the plain
   version (equal event counts, voxel grids and reconstructions within 1e-4).
   K3's counter must rise by 9 and K1's by 10 per pack;
8. times with CUDA events after warm-up: K3 in both modes on the main path's
   inputs, its plain version and its bound; ``emulate_pack`` per pack;
   ``v2e2v_forward`` per pack (host clock), reconstructions per second, peak
   memory;
9. the E2V evaluation CLI (``v2e2v_tpu_torch.cli.test_e2v``): a dataset of
   two sequences of 30 PNG frames at 180x240 (written by the port's
   ``data/synthetic.py``) with one ``.npz`` of 15,000-30,000 events per interval
   from ``--seed``, and a ``.pth.tar`` of ``init_cista_lstc`` weights (64
   channels, depth 5, 5 bins), through the CLI's ``Reconstructor`` with the
   reference CLI's defaults (``--num_events 15000``, ``--test_data_mode
   real``) in float32 (TF32 off) and bfloat16. The same run with
   ``ista_impl="plain"`` first; then the main path, with every count set to
   0 just before it: K1's counter must rise by 2 x depth per reconstruction,
   the native runtime must have built and voxelised every window, the PNGs
   and ``result.csv`` rows must be written and the reconstructions finite, in
   [0, 1] and within 1e-4 (float32) or 3e-2 + 3e-2 |ref| (bfloat16) of the
   plain run's. Then the main path once more, untimed, its reconstructions
   identical to the timed run's: at every call K1's output is held against
   its plain version on the same inputs (B = 1), and at every step the
   state (z, which K1 makes, the cell and the Dg ConvLSTM's h and c) against
   the plain run's, both with the same tolerances; random-init
   reconstructions are nearly constant, so these, not the images, show K1
   right on the CLI's shapes. Times (timed run; the reader and the work after
   the model wrapped from outside): reconstructions per second over
   ``run()`` (host clock), the host's reader + voxelise time per
   reconstruction, the model step per reconstruction (CUDA events),
   normalise + metrics + PNG write per frame, peak memory; then the host
   path alone, part by part (PNG decode, event load, voxelise, each norm,
   the metrics, PNG write);
10. the V2E2V CLI (``v2e2v_tpu_torch.cli.test``): two sequences of 37 HFR
   PNG frames at 180x240, 250 fps (``data/synthetic.write_hfr_dataset``, from
   ``--seed``), a ``.pth.tar`` of ``e2v_net.``-prefixed ``init_cista_lstc``
   weights (64 channels, depth 5, 5 bins) whose ``v2e_params`` (those of
   ``bench.py:170-176``) override other flags; 3 packs of 10 frames per
   sequence. Run 1 through the plain versions and run 2 through K3 and K1
   with the same explicit draws (equal event counts, reconstructions within
   1e-4); run 3, the default path (internal Philox), with every count set to
   0 just before it: K3 launches once per frame pair (9 on a sequence's first
   pack, 8 on the others, whose reader returns 9 new frames), K1 2 x depth
   per pack, the PNGs and event previews written, reconstructions finite in
   [0, 1], event counts within 1% of run 2's. Times of run 3 (packs per
   second, reader, emulate + reconstruct, writes, peak memory);
11. raw-event generation: ``cli.generate_events`` over phase 10's dataset
   (one ``.npz`` per frame interval, every event in one of them: their total
   equals the printed one; no K3 launch); one pack with the same explicit
   draws through ``emulate_pack_raw`` and through ``emulate_pack`` with K3
   (equal counts, binned raw events within 1e-4 of K3's voxel grid), and
   each one's time;
12. CISTA-TC (``init_cista_tc``, 64 channels, depth 5): a ``StreamPool``
   with ``model_mode="cista-tc"`` on phase 4's schedule and voxel grids in
   float32 (TF32 off) and bfloat16 with every count set to 0 just before
   (K1, K2 and K3 stay at 0); stream 0's first 3 steps against the CPU
   (1e-4), bfloat16 within 3e-2 + 3e-2 |ref| of float32, finite in [0, 1];
   the pool's step time; the E2V CLI with ``--model_mode cista-tc`` over
   phase 9's first sequence (frames and the ``result.csv`` row written);
13. a ``{"kernels": [...]}`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package ``v2e2v_tpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
K2_SOURCE = "v2e2v_tpu_torch/csrc/core.cu"
K2_REPLACES = "v2e2v_tpu/ops/pallas/core.py:194"
K2_VS_LAYERS_TOL = 3e-2  # the layers path casts every conv output to the dtype
K3_SOURCE = "v2e2v_tpu_torch/csrc/emulator_iters.cu"
K3_REPLACES = "v2e2v_tpu/ops/pallas/emulator_iters.py:93"
N_FRAMES, PACKS, RESET_AT, MAX_ITERS = 10, 6, 3, 32
V2E2V_TOL = 1e-4  # atol and rtol, float32 with TF32 off
CLI_FRAMES, CLI_SEQUENCES, CLI_EVENTS = 30, 2, (15000, 30000)
HFR_FRAMES, HFR_SEQUENCES = 37, 2  # the V2E2V CLI's dataset: 3 packs of 10 per sequence
# the checkpoint's emulator parameters (bench.py:170-176), and flags that differ
V2E_PARAMS = dict(C=0.6, ps=0.5, pl=1.5, cutoff_hz=200.0, qs=0.0, ql=1.0,
                  refractory_period_s=0.001)
V2E_FLAGS = ["--C", "0.3", "--pl", "1.0", "--ps", "1.0", "--cutoff_hz", "0", "--qs", "1",
             "--ql", "1", "--refractory_period_s", "0"]
# the emulator of bench.py:170-176, as the V2E2V CLI's flags give it
FLAGS = dict(image_dim=[H, W], base_channels=C, depth=DEPTH, num_bins=NB,
             event_mode="voxel_grid", pl=1.5, ps=0.5, ql=1.0, qs=0.0, C=0.6,
             threshold_sigma=0.03, cutoff_hz=200.0, refractory_period_s=0.001)
DNAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
EPILOGUES = ("D conv", "P conv", "pre-activation", "relu", "out gate")
# what runs the convs of K1 and K2 in each dtype
DESIGN = {torch.float32: "FFMA direct conv on CUDA cores (csrc/conv3x3.cuh): 8x32-pixel x "
                         "64-channel tiles (8x16 or 8x8 where the grid would not fill the "
                         "card), 64 float32 accumulators a thread, the next input row "
                         "prefetched into registers, 16-channel chunks staged by cp.async "
                         "(inputs) and one cp.async.bulk (taps laid out once) through a "
                         "2-stage ring, float32 products and sums",
          torch.bfloat16: "wgmma implicit GEMM on tensor cores (csrc/conv3x3_tc.cuh): 16x8-pixel "
                          "tiles staged once per 64-channel chunk for all 9 taps, taps laid out "
                          "once and streamed by cp.async.bulk through a 4-slot ring"}


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
    """K1's and K2's conv instances as <kernel><dtype, epilogue>, K2's cell
    kernels as <kernel><dtype>, K3's as emulator_iters_kernel<shot mode>;
    others as given."""
    m = re.search(r"emulator_iters_kernelILi([012])E", mangled)
    if m:
        return f"emulator_iters_kernel<{('no shot', 'explicit', 'internal')[int(m.group(1))]}>"
    m = re.search(r"((?:ista|core)_conv3x3_tc_kernel)ILi([0-4])ELi(\d+)E", mangled)
    if m:
        return f"{m.group(1)}<bfloat16, {EPILOGUES[int(m.group(2))]}, NB={m.group(3)}>"
    m = re.search(r"((?:ista|core)_conv3x3_kernel)ILi([0-4])ELi([124])E", mangled)
    if m:
        return (f"{m.group(1)}<float32, {EPILOGUES[int(m.group(2))]}, "
                f"8x{8 * int(m.group(3))} tile>")
    m = re.search(r"(core_lst[cm]_cell_kernel)I(\w+?)EEv", mangled)
    if m:
        return f"{m.group(1)}<{'bfloat16' if 'bfloat16' in m.group(2) else 'float32'}>"
    return mangled[:80]


def sass_counts(lib_path, opcode: str) -> dict[str, int]:
    """Instructions of ``opcode`` in each kernel of the built library, from
    ``cuobjdump --dump-sass``."""
    tool = shutil.which("cuobjdump") or str(Path("/usr/local/cuda/bin/cuobjdump"))
    sass = subprocess.run([tool, "--dump-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and re.search(rf"\b{opcode}\b", line):
            counts[fn] += 1
    return counts


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


def issue_ms(fn, warmup: int = 3, iters: int = 20) -> tuple[float, float]:
    """``(device, host)`` ms per call of a launch-bound ``fn``: the card first
    spins (``torch.cuda._sleep``) for three times as long as the host takes
    to enqueue all calls, so the events time the launches back to back,
    without the host's gaps, and the host's clock times its enqueueing alone,
    without waits on the card."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(3 * 2e9 * iters * host_s) + 10_000_000)  # ~2 GHz clock
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, 1e3 * host_s / iters


def device_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Device time per call of a launch-bound ``fn`` (``issue_ms``)."""
    return issue_ms(fn, warmup, iters)[0]


def ista_inputs(gen: torch.Generator, dtype: torch.dtype, weights: dict, b: int = CAPACITY):
    """K1's inputs at the pool's shape (batch ``b``): x1 and z ~ N(0, 0.5^2)
    in ``dtype``, and the ISTA block (HWIO D and P, biases, Lambda) of the
    model's weights."""
    h, w, c = H // 2, W // 2, C
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


def core_inputs(gen: torch.Generator, dtype: torch.dtype, weights: dict):
    """K2's inputs at the pool's shape: the taps of the model's weights in
    ``dtype``, x1 ~ N(0, 0.5^2) and the recurrent state (z, cell, dg_h, dg_c)
    ~ N(0, 0.3^2)."""
    from v2e2v_tpu_torch.ops.cuda.core import core_taps

    b, h, w, c = CAPACITY, H // 2, W // 2, C
    x1 = (0.5 * torch.randn(b, h, w, c, generator=gen)).cuda().to(dtype)
    state = [(0.3 * torch.randn(b, h, w, k, generator=gen)).cuda().to(dtype)
             for k in (2 * c, 2 * c, c, c)]
    return (core_taps(weights, dtype), x1, *state)


def core_bound_ms(args, depth: int) -> tuple[float, str]:
    """Least time for K2's work: 2 * 9 * B*H*W * (32 + 4 depth) * C^2 FLOPs
    (52 C^2 multiply-adds per tap and pixel at depth 5) at the dtype's peak;
    x1 and the four state tensors read once, the four new state tensors
    written once (rec_h is dg_h), the taps and biases read once."""
    taps, x1, z, cell, dg_h, dg_c = args
    b, h, w, c = x1.shape
    flops = 2 * 9 * b * h * w * (32 + 4 * depth) * c * c
    n_bytes = x1.element_size() * (x1.numel() + 2 * (z.numel() + cell.numel() + dg_h.numel()
                                                     + dg_c.numel()))
    n_bytes += sum(t.numel() * t.element_size() for t in taps.values())
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


def hfr_video(seed: int, device) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``PACKS`` packs of ``N_FRAMES`` HFR frames ``[B, N, H, W]`` in 0-255 and
    their ``[B, N]`` times (250 fps), consecutive packs sharing their boundary
    frame as the V2E2V CLI reads them (``test.py``). Each pixel flickers as
    ``base * exp(a * sin(2 pi f t + phase))`` with base in [30, 200], a in
    [0.2, 1], f in [2, 8] Hz, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    shape = (CAPACITY, 1, H, W)
    base = rng.uniform(30, 200, shape).astype(np.float32)
    amp = rng.uniform(0.2, 1.0, shape).astype(np.float32)
    freq = rng.uniform(2.0, 8.0, shape).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, shape).astype(np.float32)
    t = np.arange(PACKS * (N_FRAMES - 1) + 1, dtype=np.float32) * 0.004
    arg = 2 * np.pi * freq * t[None, :, None, None] + phase
    frames = np.clip(base * np.exp(amp * np.sin(arg)), 0, 255).astype(np.float32)
    packs = []
    for p in range(PACKS):
        sl = slice(p * (N_FRAMES - 1), p * (N_FRAMES - 1) + N_FRAMES)
        ts = np.tile(t[sl], (CAPACITY, 1))
        packs.append((torch.from_numpy(frames[:, sl].copy()).to(device),
                      torch.from_numpy(ts).to(device)))
    return packs


def k3_inputs(seed: int, shot: bool, gate_on: bool, internal: bool = False):
    """One frame pair's K3 inputs at the V2E2V shape: counts in [0, 40) (so all
    ``MAX_ITERS`` iterations run and some counts are clipped), polarity in
    {-1, 0, 1}, refractory 0.7 bins, shot probabilities up to 5%."""
    g = torch.Generator().manual_seed(seed)
    b, h, w = CAPACITY, H, W
    counts = torch.randint(0, 40, (b, h, w), generator=g, dtype=torch.int32)
    num_iters = counts.amax(dim=(1, 2)).clamp(1, MAX_ITERS)
    x = dict(
        event_counts=counts, pol=torch.randint(-1, 2, (b, h, w), generator=g).float(),
        timestamp_mem=-torch.rand(b, h, w, generator=g), tr_frames=torch.full((b, h, w), 0.7),
        one_minus_on_prob=1.0 - 0.05 * torch.rand(b, h, w, generator=g),
        off_prob=0.05 * torch.rand(b, h, w, generator=g),
        rand01=torch.rand(MAX_ITERS, b, h, w, generator=g) if shot and not internal else None,
        seed=torch.randint(0, 2**62, (b,), generator=g) if internal else None,
        ts_step=torch.full((b,), 4.0) / num_iters.float(), num_iters=num_iters,
        gate=torch.full((b,), gate_on), tf_base=1.0,
    )
    x = {k: v.cuda() if isinstance(v, torch.Tensor) else v for k, v in x.items()}
    return x, dict(num_bins=NB, max_iters=MAX_ITERS, shot=shot, internal_rng=internal)


def k3_bound_ms(x: dict, kw: dict) -> tuple[float, str]:
    """Least time for K3's work on these inputs: 6 input planes read and
    num_bins + 2 output planes written once, plus the rand01 entries of the
    active iterations in explicit mode; 8 + 2 * num_bins float32 operations
    per pixel and iteration the data needs (to max(count, num_iters) with
    shot noise, to count without), on CUDA cores. Philox's integer operations
    are not counted."""
    b, h, w = x["event_counts"].shape
    nit = x["num_iters"].clamp(max=kw["max_iters"]).long()
    n_bytes = 4 * b * h * w * (6 + kw["num_bins"] + 2)
    if kw["shot"] and not kw["internal_rng"]:
        n_bytes += 4 * h * w * int(nit.sum())
    last = x["event_counts"].long()
    if kw["shot"]:
        last = torch.maximum(last, nit[:, None, None])
    flops = (8 + 2 * kw["num_bins"]) * int(last.clamp(max=kw["max_iters"]).sum())
    t_ops, t_bytes = flops / PEAK_FLOPS[torch.float32], n_bytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def check_k3(emulator_iters, emulator_iters_plain, seed: int) -> dict:
    """K3 against its plain version at the V2E2V shape, and its random modes."""
    errs = {"explicit": 0.0, "internal": 0.0}
    cases = [(shot, gate) for shot in (True, False) for gate in (True, False)]
    for i, (shot, gate) in enumerate(cases + [(True, True)]):
        internal = i == len(cases)
        x, kw = k3_inputs(seed + i, shot, gate, internal)
        got = emulator_iters(**x, **kw)
        want = emulator_iters_plain(**x, **kw)
        torch.cuda.synchronize()
        exact = torch.equal(got[2], want[2]) and torch.equal(got[1], want[1])
        err = float((got[0] - want[0]).abs().max())
        ok = exact and err <= 1e-5
        mode = "internal" if internal else "explicit" if shot else "no shot"
        key = "internal" if internal else "explicit"
        errs[key] = max(errs[key], err)
        say(f"[k3] emulator_iters {mode}, gate {'on' if gate else 'off'}, B={CAPACITY} {H}x{W} "
            f"I={MAX_ITERS} nb={NB}: final and mem equal={exact}, voxel max_abs_err={err:.3e} "
            f"(tol 1e-5) {'pass' if ok else 'FAIL'}")
        if not ok:
            fail(f"K3 disagrees with its plain version ({mode}, gate {gate})")

    # internal uniforms: repeatable, and binomial with no threshold events
    p = 0.01
    x, kw = k3_inputs(seed + 10, True, False, internal=True)
    x |= dict(event_counts=torch.zeros_like(x["event_counts"]),
              pol=torch.where(x["pol"] >= 0, 1.0, -1.0),
              one_minus_on_prob=torch.full_like(x["pol"], 1.0 - p),
              off_prob=torch.full_like(x["pol"], p),
              num_iters=torch.full_like(x["num_iters"], MAX_ITERS),
              ts_step=torch.full_like(x["ts_step"], 4.0 / MAX_ITERS))
    n = CAPACITY * H * W * MAX_ITERS
    mean, sigma = n * p, (n * p * (1 - p)) ** 0.5
    first, again = emulator_iters(**x, **kw), emulator_iters(**x, **kw)
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    total = int(first[2].sum())
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x_plain = dict(x, seed=None, rand01=torch.rand(MAX_ITERS, CAPACITY, H, W, device="cuda",
                                                   generator=gen))
    total_plain = int(emulator_iters_plain(**x_plain, **dict(kw, internal_rng=False))[2].sum())
    ok = same and abs(total - mean) < 5 * sigma and abs(total_plain - mean) < 5 * sigma
    say(f"[k3] internal Philox: same seed twice identical={same}; shot events with p={p} on "
        f"{n} pixel-iterations: kernel {total}, plain with torch uniforms {total_plain}, "
        f"expected {mean:.0f} +- {sigma:.0f} (5 sigma) {'pass' if ok else 'FAIL'}")
    if not ok:
        fail("K3's internal random numbers failed the repeat or binomial check")
    return errs


def run_v2e2v(cfg, weights, video, noise_seed: int, counters, state_before=None,
              explicit_shot: bool = False):
    """Pack by pack through ``v2e2v_forward``, a new sequence at ``RESET_AT``,
    the shot uniforms drawn from the card generator (``explicit_shot``) or made
    by Philox. Returns the outputs, the launches of each counter per pack, and
    (in ``state_before``) the state before the last pack."""
    from v2e2v_tpu_torch.models.emulator import GeneratorNoise
    from v2e2v_tpu_torch.models.v2e2v import v2e2v_forward

    noise = GeneratorNoise(torch.Generator(device="cuda").manual_seed(noise_seed), explicit_shot)
    state, outs, launches = None, [], []
    for p, (frames, ts) in enumerate(video):
        if p == RESET_AT:
            state = None  # a new sequence, as test.py starts one
        if state_before is not None and p == len(video) - 1:
            state_before["state"] = state
        before = [c.launches for c in counters]
        out, state = v2e2v_forward(weights, cfg, frames, ts, state, noise)
        launches.append([c.launches - b for c, b in zip(counters, before)])
        outs.append(out)
    torch.cuda.synchronize()
    return outs, launches


def timed(fn, parts: dict, key: str):
    """``fn``, adding its host-clock seconds and one call to ``parts[key]``
    (a ``[seconds, calls]`` pair)."""
    def wrapper(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            parts[key][0] += time.perf_counter() - t0
            parts[key][1] += 1
    return wrapper


@contextlib.contextmanager
def swapped(*patches):
    """Set each ``(obj, name, value)`` for the block, then restore them."""
    saved = [(obj, name, obj.__dict__[name]) for obj, name, _ in patches]
    for obj, name, value in patches:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def cli_reconstructor(root: Path, model: Path, dtype: torch.dtype, out: str, ista_impl: str):
    """The CLI's ``Reconstructor`` over the dataset at ``root`` with the
    reference CLI's defaults at full width, its ISTA loop as ``ista_impl``."""
    from v2e2v_tpu_torch.cli import test_e2v as cli
    from v2e2v_tpu_torch.utils.configs import set_configs

    parser = argparse.ArgumentParser()
    set_configs(parser)
    cfgs = parser.parse_args([
        "--path_to_test_model", str(model), "--path_to_test_data", str(root),
        "--image_dim", str(H), str(W), "-c", str(C),
        "-d", str(DEPTH), "-b", str(NB), "--num_events", str(NUM_EVENTS), "--test_data_mode",
        "real", "--precision", DNAME[dtype], "-o", str(root.parent / out)])
    rec = cli.Reconstructor(cfgs, "cuda")
    if ista_impl != rec.cfg.ista_impl:
        rec.cfg = dataclasses.replace(rec.cfg, ista_impl=ista_impl)
        rec.step = cli.make_step(rec.cfg, cli.DTYPES[cfgs.precision])
    return rec


def record_steps(rec, keep_state: bool, events: list | None = None) -> list:
    """Wrap ``rec.step``: each step appends ``(reconstruction, state or
    None)`` to the returned list and, given ``events``, its CUDA event pair
    around the step."""
    step, steps = rec.step, []

    def recorded(*a):
        if events is not None:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        out_, st = step(*a)
        if events is not None:
            ev[1].record()
            events.append(ev)
        steps.append((out_, st if keep_state else None))
        return out_, st

    rec.step = recorded
    return steps


def cli_phase(seed: int, cfg, smi: str) -> dict:
    """Phase 9: the E2V evaluation CLI at full width: the plain ISTA first,
    then the main path (K1) with every count set to 0 just before it, then
    the main path again with K1 held against its plain version at every call
    and the state against the plain run's at every step. Returns K1's
    launches on the main path and its largest error per dtype."""
    from v2e2v_tpu_torch import runtime
    from v2e2v_tpu_torch.data.synthetic import write_dataset
    from v2e2v_tpu_torch.models import cista as cista_mod
    from v2e2v_tpu_torch.models.cista import init_cista_lstc
    from v2e2v_tpu_torch.ops import image
    from v2e2v_tpu_torch.ops.cuda.core import cista_core
    from v2e2v_tpu_torch.ops.cuda.emulator_iters import emulator_iters
    from v2e2v_tpu_torch.ops.cuda.ista import ista_loop, ista_loop_plain
    from v2e2v_tpu_torch.ops.voxel import voxelize_and_preprocess_np
    from v2e2v_tpu_torch.utils import data_io

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="v2e2v_cli_"))
    cli_k1 = {}
    try:
        data, model = tmp / "data", tmp / "model.pth.tar"
        t0 = time.perf_counter()
        write_dataset(data, seed, CLI_SEQUENCES, CLI_FRAMES, H, W, CLI_EVENTS)
        sd = init_cista_lstc(torch.Generator().manual_seed(seed), cfg, device="cpu")
        torch.save({"epoch": 0, "state_dict": sd, "v2e_params": None}, model)
        say(f"[cli] dataset: {CLI_SEQUENCES} sequences of {CLI_FRAMES} PNG frames {H}x{W}, "
            f"{CLI_EVENTS[0]}-{CLI_EVENTS[1]} events per interval (.npz), written in "
            f"{time.perf_counter() - t0:.1f} s; native runtime built={runtime.available()} "
            f"({runtime.library_path().name})")
        if not runtime.available():
            fail("the native runtime (g++) did not build on this machine")
        for dtype in (torch.float32, torch.bfloat16):
            name, tol = DNAME[dtype], TOL[dtype]
            plain = cli_reconstructor(data, model, dtype, f"plain_{name}", "plain")
            plain_steps = record_steps(plain, keep_state=True)
            plain.run()

            # the main path, timed: the reader (frames, events, host voxelise)
            # and the work after the model (norms, metrics, PNG write) by
            # wrapping them, the step by CUDA events
            rec = cli_reconstructor(data, model, dtype, f"cuda_{name}", "cuda")
            step_ev = []
            steps = record_steps(rec, keep_state=False, events=step_ev)
            parts = {k: [0.0, 0] for k in ("read", "post", "evaluate")}
            reader = rec.video_renderer
            post = (
                (image, "normalize_image_minmax_u8",
                 timed(image.normalize_image_minmax_u8, parts, "post")),
                (image, "normalize_image_percentile",
                 timed(image.normalize_image_percentile, parts, "post")),
                (data_io.ImageWriter, "__call__",
                 timed(data_io.ImageWriter.__call__, parts, "post")))
            reader.update_event_frame_pack = timed(reader.update_event_frame_pack, parts, "read")
            rec.evaluate = timed(rec.evaluate, parts, "evaluate")
            ista_loop.launches = cista_core.launches = emulator_iters.launches = 0
            served = voxelize_and_preprocess_np.served
            served.update(native=0, numpy=0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            with swapped(*post):
                t0 = time.perf_counter()
                rec.run()
                torch.cuda.synchronize()
                run_s = time.perf_counter() - t0
            k1_n, other_n = ista_loop.launches, cista_core.launches + emulator_iters.launches
            peak = (torch.cuda.max_memory_allocated() - base) / 2**20
            n_rec, n_frames = len(steps), parts["evaluate"][1]
            out_dir = tmp / f"cuda_{name}" / "model.pth"
            pngs = sorted(out_dir.glob("*/frame_*.png"))
            rows = [(out_dir / d.name / "result.csv").read_text().splitlines()
                    for d in sorted(out_dir.iterdir())]
            stacked = torch.stack([r for r, _ in steps])
            finite = bool(torch.isfinite(stacked).all())
            in_range = bool(((stacked >= 0) & (stacked <= 1)).all())
            ok = (finite and in_range and k1_n == 2 * DEPTH * n_rec and other_n == 0
                  and len(pngs) == n_frames == CLI_SEQUENCES * (CLI_FRAMES - 1)
                  and len(rows) == CLI_SEQUENCES and all(len(r) == 2 for r in rows)
                  and served["native"] == n_rec and served["numpy"] == 0)
            say(f"[cli] {name}: {n_frames} frames, {n_rec} reconstructions of {H}x{W} "
                f"(C={C}, depth {DEPTH}, --num_events {NUM_EVENTS}, real); K1 launches {k1_n} "
                f"(want 2 x depth x {n_rec} = {2 * DEPTH * n_rec}), K2 and K3 {other_n}; host "
                f"voxeliser served native {served['native']}, numpy {served['numpy']}; "
                f"{len(pngs)} PNGs, result.csv rows {[r[1] for r in rows]}; finite={finite} "
                f"in[0,1]={in_range} {'pass' if ok else 'FAIL'}")
            if not ok:
                fail(f"the CLI's main path in {name} did not run as it should")
            if len(plain_steps) != n_rec:
                fail(f"the plain run made {len(plain_steps)} reconstructions, not {n_rec}")
            err, ok = within(stacked, torch.stack([r for r, _ in plain_steps]), tol)
            say(f"[cli] {name}: reconstructions through K1 vs the plain ISTA, {n_rec} recurrent "
                f"steps: max_abs_err={err:.3e} (tol {tol} + {tol} |ref|) "
                f"{'pass' if ok else 'FAIL'}")
            if not ok:
                fail(f"the CLI through K1 disagrees with the plain ISTA in {name}")

            # the main path again, untimed: K1 held against its plain version
            # on each call's own inputs (B = 1), the state against the plain
            # run's at each step; launches here are not the main path's
            chk = cli_reconstructor(data, model, dtype, f"check_{name}", "cuda")
            chk_steps, k1_errs = record_steps(chk, keep_state=True), []

            def k1_checked(*a, **k):
                got = ista_loop(*a, **k)
                k1_errs.append(within(got, ista_loop_plain(*a, **k), tol))
                return got

            with swapped((cista_mod, "ista_loop", k1_checked)):
                chk.run()
            same = len(chk_steps) == n_rec and all(
                torch.equal(a, b) for (a, _), (b, _) in zip(chk_steps, steps))
            k1_err = max(e for e, _ in k1_errs)
            ok = same and len(k1_errs) == n_rec and all(o for _, o in k1_errs)
            say(f"[cli] {name}: K1 against its plain version on each of the {len(k1_errs)} "
                f"calls of the CLI path (B=1, {H // 2}x{W // 2}, C={C}, depth {DEPTH}): "
                f"max_abs_err={k1_err:.3e} (tol {tol} + {tol} |ref|); reconstructions "
                f"identical to the timed run's: {same} {'pass' if ok else 'FAIL'}")
            if not ok:
                fail(f"K1 disagrees with its plain version on the CLI path in {name}")
            state_err = {}
            for field in ("z", "cell", "dg h", "dg c"):
                errs = [within(pick(a, field), pick(b, field), tol)
                        for (_, a), (_, b) in zip(chk_steps, plain_steps)]
                state_err[field] = (max(e for e, _ in errs), all(o for _, o in errs))
            ok = all(o for _, o in state_err.values())
            say(f"[cli] {name}: state through K1 vs the plain run at each of {n_rec} steps, "
                f"max_abs_err " + ", ".join(f"{f} {e:.3e}" for f, (e, _) in state_err.items())
                + f" (tol {tol} + {tol} |ref|) {'pass' if ok else 'FAIL'}")
            if not ok:
                fail(f"the CLI's state through K1 disagrees with the plain run's in {name}")
            cli_k1[dtype] = {"cli_launches": k1_n, "cli_max_abs_err": k1_err}
            del plain_steps, chk_steps

            step_ms = sum(a.elapsed_time(b) for a, b in step_ev) / n_rec
            read_ms = 1e3 * parts["read"][0] / n_rec
            post_ms = 1e3 * (parts["post"][0] + parts["evaluate"][0]) / n_frames
            rest_ms = 1e3 * run_s - read_ms * n_rec - post_ms * n_frames - step_ms * n_rec
            say(f"[time] CLI {name} ({smi}): run() {run_s:.3f} s host clock, "
                f"{n_rec / run_s:.1f} reconstructions/s, {n_frames / run_s:.1f} frames/s; per "
                f"reconstruction: reader + voxelise {read_ms:.3f} ms (host), model step "
                f"{step_ms:.3f} ms (CUDA events); per frame: normalise + metrics + PNG write "
                f"{post_ms:.3f} ms (host); the rest of run() (transfers, syncs, Python) "
                f"{rest_ms / n_rec:.3f} ms per reconstruction; max_memory_allocated "
                f"{peak:.1f} MiB above what earlier phases hold ({base / 2**20:.1f} MiB)")
        host_breakdown(data, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"[phase] CLI runs {time.perf_counter() - t_phase:.1f} s")
    return cli_k1


def pick(state, field: str) -> torch.Tensor:
    """One tensor of a ``CistaState``: z, cell, or the Dg ConvLSTM's h or c."""
    return {"z": state.z, "cell": state.cell, "dg h": state.dg[0], "dg c": state.dg[1]}[field]


def host_breakdown(data: Path, smi: str) -> None:
    """Where the CLI's host time goes, part by part, on the first sequence
    (host clock, no model): PNG decode, event window load, host voxelise (per
    reconstruction) and each of the per-frame steps after the model."""
    from v2e2v_tpu_torch.data import event_readers, video_readers
    from v2e2v_tpu_torch.ops import image
    from v2e2v_tpu_torch.utils import evaluate, image_io

    parts = {k: [0.0, 0] for k in ("png decode", "events load", "voxelise", "minmax norm",
                                   "gt percentile norm", "mse+psnr", "ssim", "png write")}
    n_rec = n_frames = 0
    with swapped(
            (video_readers, "read_gray", timed(video_readers.read_gray, parts, "png decode")),
            (video_readers, "voxelize_and_preprocess_np",
             timed(video_readers.voxelize_and_preprocess_np, parts, "voxelise")),
            (event_readers.NpzEventReader, "__next__",
             timed(event_readers.NpzEventReader.__next__, parts, "events load"))):
        reader = video_readers.ImageReader([H, W], num_bins=NB, is_with_events=True)
        reader.initialize(str(sorted(data.iterdir())[0]), -1)
        out = data.parent / "breakdown.png"
        while not reader.ending:
            grids, gt = reader.update_event_frame_pack(NUM_EVENTS, "real")
            n_rec += len(grids)
            n_frames += 1
            pred = np.ascontiguousarray(grids[-1][0] * 0.1 + 0.5, dtype=np.float32)
            u8 = timed(image.normalize_image_minmax_u8, parts, "minmax norm")(pred)
            gt_n = timed(image.normalize_image_percentile, parts, "gt percentile norm")(
                gt.astype(np.float32))
            pred_f = u8 / 255.0
            timed(lambda a, b: (evaluate.mse(a, b), evaluate.psnr(a, b)), parts,
                  "mse+psnr")(pred_f, gt_n)
            timed(evaluate.ssim, parts, "ssim")(pred_f, gt_n)
            timed(image_io.write_gray, parts, "png write")(str(out), u8)
    per = {k: 1e3 * s / (n_rec if k == "voxelise" else n_frames) for k, (s, _) in parts.items()}
    say(f"[time] CLI host path by part ({smi}; {n_frames} frames, {n_rec} reconstructions, "
        f"host clock): per frame read: png decode {per['png decode']:.3f} ms, events load "
        f"{per['events load']:.3f} ms; per reconstruction: voxelise (native) "
        f"{per['voxelise']:.3f} ms; per frame after the model: minmax norm "
        f"{per['minmax norm']:.3f} ms, gt percentile norm {per['gt percentile norm']:.3f} ms, "
        f"mse+psnr {per['mse+psnr']:.3f} ms, ssim {per['ssim']:.3f} ms, png write "
        f"{per['png write']:.3f} ms")


def v2e2v_cli(data: Path, model: Path, out: Path, seed: int, noise_for_sequence=None,
              plain: bool = False):
    """The V2E2V CLI's ``V2E2V`` over ``data`` at full width, the flags'
    emulator parameters overridden by the checkpoint's, writing event
    previews; with ``plain``, through the plain versions of K3 and K1."""
    from v2e2v_tpu_torch.cli import test as cli
    from v2e2v_tpu_torch.models.v2e2v import V2E2VConfig
    from v2e2v_tpu_torch.utils.configs import set_configs

    parser = argparse.ArgumentParser()
    set_configs(parser)
    cfgs = parser.parse_args([
        "--path_to_test_model", str(model), "--path_to_test_data", str(data), "--image_dim",
        str(H), str(W), "-c", str(C), "-d", str(DEPTH), "-b", str(NB), "--seed", str(seed),
        "--is_write_event", "-o", str(out), *V2E_FLAGS])
    run = cli.V2E2V(cfgs, "cuda", noise_for_sequence)
    if plain:
        run.cfg = V2E2VConfig(dataclasses.replace(run.cfg.cista, ista_impl="plain"),
                              dataclasses.replace(run.cfg.emulator, iters_impl="plain"))
    return run


def recorded_forward(records: list, events: list | None = None):
    """Patch ``models.v2e2v.v2e2v_forward`` (the CLI imports it when it runs)
    to append ``(output, [K3, K1] launches, frame pairs)`` per pack and, given
    ``events``, a CUDA event pair around each call."""
    from v2e2v_tpu_torch.models import v2e2v as v2e2v_mod
    from v2e2v_tpu_torch.ops.cuda.emulator_iters import emulator_iters
    from v2e2v_tpu_torch.ops.cuda.ista import ista_loop

    forward = v2e2v_mod.v2e2v_forward

    def recorded(params, cfg, frames, *a, **k):
        before = (emulator_iters.launches, ista_loop.launches)
        if events is not None:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        out, state = forward(params, cfg, frames, *a, **k)
        if events is not None:
            ev[1].record()
            events.append(ev)
        records.append((out, [emulator_iters.launches - before[0],
                              ista_loop.launches - before[1]], frames.shape[1] - 1))
        return out, state

    return swapped((v2e2v_mod, "v2e2v_forward", recorded))


def v2e2v_cli_phase(seed: int, smi: str, root: Path) -> dict:
    """Phase 10: the V2E2V CLI at full width over two sequences of 37 HFR
    frames: run 1 through the plain versions and run 2 through K3 and K1,
    both with the same explicit draws from card generators; then run 3, the
    default path (internal Philox), with every count set to 0 just before it.
    Returns the main path's launches."""
    from v2e2v_tpu_torch.cli import test as cli_test
    from v2e2v_tpu_torch.data.synthetic import write_hfr_dataset
    from v2e2v_tpu_torch.models.cista import CistaConfig, init_cista_lstc
    from v2e2v_tpu_torch.models.emulator import GeneratorNoise
    from v2e2v_tpu_torch.models.v2e2v import V2E2VConfig
    from v2e2v_tpu_torch.ops import image
    from v2e2v_tpu_torch.ops.cuda.core import cista_core
    from v2e2v_tpu_torch.ops.cuda.emulator_iters import emulator_iters
    from v2e2v_tpu_torch.ops.cuda.ista import ista_loop
    from v2e2v_tpu_torch.utils import data_io

    t_phase = time.perf_counter()
    data, model = root / "hfr", root / "v2e2v.pth.tar"
    write_hfr_dataset(data, seed, HFR_SEQUENCES, HFR_FRAMES, H, W)
    cfg = CistaConfig(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB)
    sd = init_cista_lstc(torch.Generator().manual_seed(seed), cfg, device="cpu")
    torch.save({"epoch": 0, "v2e_params": V2E_PARAMS,
                "state_dict": {f"e2v_net.{k}": v for k, v in sd.items()}}, model)

    def explicit(i):
        # the default path's generator seed (run 3), the shot uniforms drawn from it
        return GeneratorNoise(torch.Generator(device="cuda").manual_seed(
            cli_test.sequence_seed(seed, i)), explicit_shot=True)

    runs = {}
    for name, plain in (("run 1 (plain)", True), ("run 2 (K3, K1)", False)):
        run = v2e2v_cli(data, model, root / f"v2e2v_{len(runs)}", seed, explicit, plain)
        records = []
        with recorded_forward(records), contextlib.redirect_stdout(None):
            run.run()
        torch.cuda.synchronize()
        runs[name] = records
    want_emu = V2E2VConfig.from_flags(argparse.Namespace(**FLAGS)).emulator
    if run.cfg.emulator != want_emu:
        fail(f"the checkpoint's v2e_params did not override the flags: {run.cfg.emulator}")
    (r1, r2) = runs.values()
    ev1, ev2 = [int(o.num_events) for o, _, _ in r1], [int(o.num_events) for o, _, _ in r2]
    launches2 = [n for _, n, _ in r2]
    pairs = [p for _, _, p in r2]
    rec2 = torch.stack([o.reconstruction for o, _, _ in r2])
    err, ok = within(rec2, torch.stack([o.reconstruction for o, _, _ in r1]), V2E2V_TOL)
    ok = ok and ev1 == ev2 and len(r2) == 3 * HFR_SEQUENCES and min(ev2) > 0
    ok = ok and [n for _, n, _ in r1] == [[0, 0]] * len(r1)
    ok = ok and launches2 == [[p, 2 * DEPTH] for p in pairs]
    say(f"[v2e2v-cli] {HFR_SEQUENCES} sequences of {HFR_FRAMES} PNG frames {H}x{W} (250 fps), "
        f"{len(r2)} packs of 10 frames; checkpoint v2e_params override "
        f"the flags {' '.join(V2E_FLAGS)}: emulator == bench.py's: True; run 1 (plain) vs run "
        f"2 (K3, K1), same explicit draws: num_events {ev1} vs {ev2} equal={ev1 == ev2}; K3, K1 "
        f"launches per pack in run 2 {launches2} (want frame pairs {pairs}, 2 x depth); "
        f"reconstructions max_abs_err={err:.3e} (tol atol=rtol={V2E2V_TOL}) "
        f"{'pass' if ok else 'FAIL'}")
    if not ok:
        fail("the V2E2V CLI through K3 and K1 disagrees with its plain versions")

    # run 3: the main path, timed from outside (the CLI carries no timers)
    run = v2e2v_cli(data, model, root / "v2e2v_main", seed)
    parts = {k: [0.0, 0] for k in ("read", "write")}
    run.video_renderer.update_frame_pack = timed(run.video_renderer.update_frame_pack, parts,
                                                 "read")
    writes = ((image, "normalize_image_minmax_u8",
               timed(image.normalize_image_minmax_u8, parts, "write")),
              (data_io, "make_event_preview", timed(data_io.make_event_preview, parts, "write")),
              (data_io.ImageWriter, "__call__", timed(data_io.ImageWriter.__call__, parts,
                                                      "write")),
              (data_io.EventWriter, "__call__", timed(data_io.EventWriter.__call__, parts,
                                                      "write")))
    records, step_ev = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ista_loop.launches = cista_core.launches = emulator_iters.launches = 0
    emulator_iters.launches_by_shot = dict.fromkeys(emulator_iters.launches_by_shot, 0)
    with recorded_forward(records, step_ev), swapped(*writes):
        t0 = time.perf_counter()
        run.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    k3_n, k1_n, k2_n = emulator_iters.launches, ista_loop.launches, cista_core.launches
    k3_internal = emulator_iters.launches_by_shot["internal"]
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    n_packs = len(records)
    ev3 = [int(o.num_events) for o, _, _ in records]
    rec3 = torch.stack([o.reconstruction for o, _, _ in records])
    finite = bool(torch.isfinite(rec3).all())
    in_range = bool(((rec3 >= 0) & (rec3 <= 1)).all())
    out_dir = root / "v2e2v_main" / "v2e2v.pth"
    pngs = sorted(out_dir.glob("*/frame_*.png"))
    previews = sorted(out_dir.glob("*/events/events_*.png"))
    close = len(ev3) == len(ev2) and all(abs(a - b) <= 0.01 * b for a, b in zip(ev3, ev2))
    ok = (finite and in_range and close and k2_n == 0 and n_packs == len(r2)
          and k3_n == k3_internal == sum(pairs) and k1_n == 2 * DEPTH * n_packs
          and [n for _, n, _ in records] == [[p, 2 * DEPTH] for p in pairs]
          and len(pngs) == len(previews) == n_packs)
    say(f"[v2e2v-cli] run 3 (default path, internal Philox; counts set to 0 just before): "
        f"{n_packs} packs, K3 launches {k3_n} (internal {k3_internal}; want {sum(pairs)}, one "
        f"per frame pair), K1 {k1_n} (want {2 * DEPTH * n_packs}), K2 {k2_n}; num_events {ev3} "
        f"within 1% of run 2's={close}; {len(pngs)} reconstruction PNGs, {len(previews)} event "
        f"previews; finite={finite} in[0,1]={in_range} {'pass' if ok else 'FAIL'}")
    if not ok:
        fail("the V2E2V CLI's main path did not run as it should")
    step_ms = sum(a.elapsed_time(b) for a, b in step_ev) / n_packs
    read_ms = 1e3 * parts["read"][0] / n_packs
    write_ms = 1e3 * parts["write"][0] / n_packs
    say(f"[time] V2E2V CLI ({smi}), batch 1, {H}x{W}, float32: run() {run_s:.3f} s host clock, "
        f"{n_packs / run_s:.2f} packs/s; per pack: reader {read_ms:.3f} ms (host), emulate + "
        f"reconstruct {step_ms:.3f} ms (CUDA events around v2e2v_forward), minmax norm + "
        f"preview + PNG writes {write_ms:.3f} ms (host), the rest of run() "
        f"{1e3 * run_s / n_packs - read_ms - step_ms - write_ms:.3f} ms; max_memory_allocated "
        f"{peak:.1f} MiB above what earlier phases hold ({base / 2**20:.1f} MiB)")
    say(f"[phase] V2E2V CLI runs {time.perf_counter() - t_phase:.1f} s")
    return {"k3": k3_n, "k1": k1_n, "data": data}


def raw_phase(seed: int, smi: str, root: Path, data: Path) -> None:
    """Phase 11: the generation tool over phase 10's dataset, then one pack
    with the same explicit draws through raw mode and through voxel mode."""
    from v2e2v_tpu_torch.cli import generate_events as gen
    from v2e2v_tpu_torch.data.video_readers import ImageReader
    from v2e2v_tpu_torch.models.emulator import (
        GeneratorNoise,
        bin_raw_events,
        emulate_pack,
        emulate_pack_raw,
    )
    from v2e2v_tpu_torch.models.v2e2v import V2E2VConfig
    from v2e2v_tpu_torch.ops.cuda.emulator_iters import emulator_iters
    from v2e2v_tpu_torch.ops.voxel import event_preprocess
    from v2e2v_tpu_torch.utils.configs import set_configs

    t_phase = time.perf_counter()
    parser = argparse.ArgumentParser()
    set_configs(parser)
    out = root / "generated"
    cfgs = parser.parse_args(["--path_to_test_data", str(data), "--image_dim", str(H), str(W),
                              "-b", str(NB), "--seed", str(seed), "-o", str(out),
                              *[a for k, v in V2E_PARAMS.items() for a in (f"--{k}", str(v))]])
    k3_before = emulator_iters.launches
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(None):
        total = gen.generate(cfgs, torch.device("cuda"))
    gen_s = time.perf_counter() - t0
    files = sorted(out.glob("*/events/events_*.npz"))
    in_files = sum(len(np.load(f)["t"]) for f in files)
    # per sequence: 9 intervals in the first pack, 8 in each later one
    want_files = HFR_SEQUENCES * (9 + 8 * (HFR_FRAMES // 9 - 2))
    ok = len(files) == want_files and in_files == total > 0 and emulator_iters.launches == k3_before
    say(f"[raw] generate_events over phase 10's dataset: {len(files)} .npz files (want "
        f"{want_files}, one per frame interval), {in_files} events in them, printed total "
        f"{total}, K3 launches {emulator_iters.launches - k3_before} (raw mode records events "
        f"with the plain loop); {gen_s:.3f} s host clock {'pass' if ok else 'FAIL'}")
    if not ok:
        fail("the event generation tool did not write every event once")

    reader = ImageReader([H, W])
    reader.initialize(str(sorted(data.iterdir())[0]), -1)
    frames, _, ts = reader.update_frame_pack(10)
    frames = torch.from_numpy(frames.astype(np.float32))[None].cuda()
    ts = torch.from_numpy(ts.astype(np.float32))[None].cuda()
    emu = V2E2VConfig.from_flags(argparse.Namespace(**FLAGS)).emulator
    emu_raw = dataclasses.replace(emu, output_mode="raw")

    def noise():
        return GeneratorNoise(torch.Generator(device="cuda").manual_seed(seed + 7),
                              explicit_shot=True)

    before = emulator_iters.launches
    events, n_raw, _ = emulate_pack_raw(emu_raw, None, frames, ts, noise(), device="cuda")
    raw_k3 = emulator_iters.launches - before
    voxel, n_vox, _ = emulate_pack(emu, None, frames, ts, noise(), device="cuda")
    vox_k3 = emulator_iters.launches - before - raw_k3
    binned = bin_raw_events(events, 1, H, W, NB, device="cuda")
    normed = event_preprocess(binned.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    err, close = within(normed, voxel, V2E2V_TOL)
    ok = close and n_raw == int(n_vox) == len(events) > 0 and raw_k3 == 0 and vox_k3 == 9
    say(f"[raw] one pack of 10 frames {H}x{W}, the same explicit draws: emulate_pack_raw "
        f"{n_raw} events (K3 launches {raw_k3}), emulate_pack {int(n_vox)} (K3 {vox_k3}); raw "
        f"events binned in time and normalised vs K3's voxel grid: max_abs_err={err:.3e} (tol "
        f"atol=rtol={V2E2V_TOL}) {'pass' if ok else 'FAIL'}")
    if not ok:
        fail("raw mode and voxel mode disagree on the card")
    raw_ms = time_ms(lambda: emulate_pack_raw(emu_raw, None, frames, ts, noise(), device="cuda"),
                     1, 3)
    vox_ms = time_ms(lambda: emulate_pack(emu, None, frames, ts, noise(), device="cuda"), 1, 3)
    say(f"[time] one pack, batch 1, {H}x{W} ({smi}): emulate_pack_raw {raw_ms:.3f} ms (plain "
        f"loop, masks to the host, extraction and sorts), emulate_pack {vox_ms:.3f} ms (K3), "
        f"both as the host issues them (CUDA events, explicit draws)")
    say(f"[phase] raw-event generation {time.perf_counter() - t_phase:.1f} s")


def tc_phase(seed: int, smi: str, root: Path, serve, served: dict) -> dict:
    """Phase 12: CISTA-TC at full width: a StreamPool on phase 4's schedule
    and voxel grids in float32 and bfloat16 (counts set to 0 just before;
    K1 and K2 stay at 0), one stream's first 3 steps against the CPU, then the
    E2V CLI with --model_mode cista-tc over one sequence."""
    from v2e2v_tpu_torch.cli import test_e2v as cli
    from v2e2v_tpu_torch.data.synthetic import write_dataset
    from v2e2v_tpu_torch.models.cista import (
        CistaConfig,
        cista_tc_step,
        cista_zero_state,
        init_cista_tc,
    )
    from v2e2v_tpu_torch.ops.cuda.core import cista_core
    from v2e2v_tpu_torch.ops.cuda.emulator_iters import emulator_iters
    from v2e2v_tpu_torch.ops.cuda.ista import ista_loop
    from v2e2v_tpu_torch.serving import StreamPool
    from v2e2v_tpu_torch.utils.configs import set_configs

    t_phase = time.perf_counter()
    cfg = CistaConfig(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB,
                      model_mode="cista-tc")
    sd = init_cista_tc(torch.Generator().manual_seed(seed), cfg, device="cpu")
    recs, launches = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        pool = StreamPool(cfg, sd, CAPACITY, dtype, device="cuda")
        snaps, step = [], pool.step

        def stepped(*a, pool=pool, step=step, snaps=snaps, **k):
            out = step(*a, **k)
            st = pool._states
            snaps.append([t[0].float().clone() for t in (pool._prev, st.z, st.cell, *st.dg)])
            return out

        pool.step = stepped
        ista_loop.launches = cista_core.launches = emulator_iters.launches = 0
        recs[dtype], _, _ = serve(pool, served[dtype])
        launches[dtype] = ista_loop.launches + cista_core.launches + emulator_iters.launches
        stacked = torch.stack(list(recs[dtype].values()))
        finite = bool(torch.isfinite(stacked).all())
        in_range = bool(((stacked >= 0) & (stacked <= 1)).all())
        ok = finite and in_range and launches[dtype] == 0
        say(f"[tc] pool {DNAME[dtype]}: {len(recs[dtype])} reconstructions of {H}x{W} "
            f"(CISTA-TC, C={C}, depth {DEPTH}); K1, K2, K3 launches {launches[dtype]} (want 0: "
            f"no kernel of the port computes CISTA-TC); finite={finite} in[0,1]={in_range} "
            f"{'pass' if ok else 'FAIL'}")
        if not ok:
            fail(f"the CISTA-TC pool in {DNAME[dtype]} did not run as it should")
        if dtype == torch.float32:
            state = cista_zero_state(cfg, 1, torch.float32, "cpu")
            prev = torch.zeros((1, H, W, 1))
            errs = []
            for r in range(3):
                prev, state = cista_tc_step(sd, cfg, served[dtype][(0, r)].float().cpu()[None],
                                            prev, state)
                want = [prev[0], state.z[0], state.cell[0], state.dg[0][0], state.dg[1][0]]
                errs += [within(g.cpu(), w_, TOL[dtype]) for g, w_ in zip(snaps[r], want)]
            ok = all(o for _, o in errs)
            say(f"[tc] float32 stream 0, first 3 steps, card vs CPU (same weights and voxel "
                f"grids): reconstruction and state (z, cell, Dg h, c) max_abs_err="
                f"{max(e for e, _ in errs):.3e} (tol {TOL[dtype]} + {TOL[dtype]} |ref|) "
                f"{'pass' if ok else 'FAIL'}")
            if not ok:
                fail("CISTA-TC on the card disagrees with the CPU")
    err, ok = within(torch.stack(list(recs[torch.bfloat16].values())),
                     torch.stack(list(recs[torch.float32].values())), TOL[torch.bfloat16])
    say(f"[tc] bfloat16 vs float32 pool: max_abs_err={err:.3e} (tol 3e-2 + 3e-2 |ref|) "
        f"{'pass' if ok else 'FAIL'}")
    if not ok:
        fail("the bfloat16 CISTA-TC pool disagrees with float32")

    vox = [served[torch.float32][k] for k in sorted(served[torch.float32])[:CAPACITY]]
    for dtype in (torch.float32, torch.bfloat16):
        pool = StreamPool(cfg, sd, CAPACITY, dtype, device="cuda")
        sids = [pool.attach() for _ in range(CAPACITY)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pool.step({sid: vox[j] for j, sid in enumerate(sids)}, fetch=False)
            torch.cuda.synchronize()
            if i >= 2:
                times.append(1e3 * (time.perf_counter() - t0))
        step_ms = float(np.median(times))
        say(f"[time] CISTA-TC pool {DNAME[dtype]} capacity {CAPACITY}, all active ({smi}): step "
            f"{step_ms:.3f} ms (median of {len(times)}, host clock, min {min(times):.3f}), "
            f"{CAPACITY * 1e3 / step_ms:.1f} reconstructions/s; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        del pool

    data, model = root / "tc_data", root / "tc_model.pth.tar"
    write_dataset(data, seed, 1, CLI_FRAMES, H, W, CLI_EVENTS)  # phase 9's first sequence
    torch.save({"epoch": 0, "state_dict": sd}, model)
    parser = argparse.ArgumentParser()
    set_configs(parser)
    cfgs = parser.parse_args([
        "--path_to_test_model", str(model), "--path_to_test_data", str(data), "--image_dim",
        str(H), str(W), "-c", str(C), "-d", str(DEPTH), "-b", str(NB), "--model_mode",
        "cista-tc", "-o", str(root / "tc_cli")])
    ista_loop.launches = cista_core.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(None):
        cli.Reconstructor(cfgs, "cuda").run()
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    out_dir = root / "tc_cli" / "tc_model.pth"
    pngs = sorted(out_dir.glob("*/frame_*.png"))
    rows = [f.read_text().splitlines() for f in sorted(out_dir.glob("*/result.csv"))]
    k_n = ista_loop.launches + cista_core.launches
    ok = len(pngs) == CLI_FRAMES - 1 and len(rows) == 1 and len(rows[0]) == 2 and k_n == 0
    say(f"[tc] E2V CLI --model_mode cista-tc, float32, one sequence of {CLI_FRAMES} frames: "
        f"{len(pngs)} PNGs, result.csv row {rows[0][1] if rows else None!r}, K1 and K2 "
        f"launches {k_n}; run() {cli_s:.3f} s host clock {'pass' if ok else 'FAIL'}")
    if not ok:
        fail("the E2V CLI with cista-tc did not run as it should")
    say(f"[phase] CISTA-TC {time.perf_counter() - t_phase:.1f} s")
    return launches


def main_path_k3_inputs(cfg, state, frames, ts, internal: bool):
    """The K3 inputs of the first frame pair of a pack on the main path: the
    emulator's own front end, stopped where it calls K3."""
    from v2e2v_tpu_torch.models import emulator as emu

    got = {}

    def record(*args, **kw):
        got["args"], got["kw"] = args, kw
        return emu.k3.emulator_iters(*args, **kw)

    noise = emu.GeneratorNoise(torch.Generator(device="cuda").manual_seed(1))
    st, pack = emu._prepare_pack(cfg, state, frames, ts, noise)
    emu._pair_step(cfg, st, pack, st.base_log_frame, st.timestamp_mem, st.t_previous, 0, noise,
                   record, internal)
    names = ("event_counts", "pol", "timestamp_mem", "tr_frames", "one_minus_on_prob",
             "off_prob", "rand01", "seed", "ts_step", "num_iters", "gate", "tf_base")
    return dict(zip(names, got["args"])), got["kw"]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("no CUDA card (torch.cuda.is_available() is False)")

    from v2e2v_tpu_torch.models.cista import CistaConfig, CistaState, half_res_core, init_cista_lstc
    from v2e2v_tpu_torch.ops.cuda import _lib
    from v2e2v_tpu_torch.ops.cuda.core import cista_core, cista_core_plain, launches_per_call
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
    name, spills = None, {}
    for line in lib.log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("registers" in line or "spill" in line):
            say(f"[build]   {short_name(name)}: {line.split('ptxas info    :')[-1].strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spills[name] = int(m.group(1)) + int(m.group(2))
    hgmma = sass_counts(lib.path, "HGMMA")
    hmma = sass_counts(lib.path, "HMMA")
    tc_kernels = [k for k in hgmma if "conv3x3_tc_kernel" in k]
    f32_kernels = [k for k in hgmma if re.search(r"(ista|core)_conv3x3_kernelI", k)]
    say(f"[build] HGMMA (wgmma) instructions per kernel, cuobjdump --dump-sass: "
        f"{ {short_name(k): v for k, v in hgmma.items()} }")
    if not any("ista_conv3x3_tc" in k for k in tc_kernels) or not any(
            "core_conv3x3_tc" in k for k in tc_kernels):
        fail("the library has no bfloat16 tensor-core conv kernel for K1 or K2")
    if any(hgmma[k] == 0 or spills.get(k, 1) for k in tc_kernels):
        fail("a bfloat16 conv kernel of K1 or K2 has no HGMMA instruction, or spills")
    # 2 ISTA epilogues + 5 core epilogues, each in 3 tile widths
    say(f"[build] float32 conv kernels of K1 and K2: {len(f32_kernels)} (want 21); HGMMA + "
        f"HMMA {sum(hgmma[k] + hmma.get(k, 0) for k in f32_kernels)}, spilled bytes "
        f"{sum(spills.get(k, 1) for k in f32_kernels)} (want 0 and 0: FFMA only)")
    if len(f32_kernels) != 21 or any(hgmma[k] or hmma.get(k, 0) or spills.get(k, 1)
                                     for k in f32_kernels):
        fail("a float32 conv kernel of K1 or K2 is missing, holds a tensor-core instruction, "
             "or spills")
    tiles = {(b, cout): lib.lib.v2e_conv3x3_tile_w(b, H // 2, W // 2, cout)
             for b in (1, CAPACITY) for cout in (C, 2 * C, 4 * C)}
    say(f"[build] K1/K2 float32 conv: tile width (8 rows) by (B, cout) at {H // 2}x{W // 2}: "
        f"{tiles}; dynamic shared memory per block "
        f"{ {tw: lib.lib.v2e_conv3x3_smem_bytes(tw) for tw in (8, 16, 32)} } B by tile width")
    smem = {cout: lib.lib.v2e_conv3x3_tc_smem_bytes(cout) for cout in (C, 2 * C, 4 * C)}
    say(f"[build] K1/K2 bfloat16 (tensor cores) conv dynamic shared memory per block: "
        f"cout={C} {smem[C]} B, cout={2 * C} {smem[2 * C]} B, cout={4 * C} {smem[4 * C]} B "
        f"(chunks of at most 128 output channels)")

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

    def serve(pool, voxels=None, counter=ista_loop):
        """Run the schedule; returns {(stream, req): rec [H, W]}, the voxel
        grids served and the launches of ``counter`` in each pool step."""
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
            before = counter.launches
            out = pool.step({sid[s]: voxels[(s, r)] for s, r in entry.items()}, fetch=False)
            launches.append(counter.launches - before)
            for s, r in entry.items():
                recs[(s, r)] = out[sid[s]].float().clone()
        torch.cuda.synchronize()
        return recs, voxels, launches

    main_launches, layers_recs, served = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        ista_loop.launches = 0
        recs, voxels, per_step = serve(StreamPool(cfg, weights, CAPACITY, dtype))
        main_launches[dtype] = ista_loop.launches
        layers_recs[dtype], served[dtype] = recs, voxels
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

    # 4b. K2 against its plain version at the flagship shape
    k2 = {}
    for dtype in (torch.float32, torch.bfloat16):
        core_args = core_inputs(torch.Generator().manual_seed(args.seed), dtype, weights)
        got = cista_core(*core_args, depth=DEPTH)
        want = cista_core_plain(*core_args, depth=DEPTH)
        torch.cuda.synchronize()
        errs = {name: within(g, w_, TOL[dtype])
                for name, g, w_ in zip(("rec_h", "z", "cell", "dg_h", "dg_c"), got, want)}
        ok = (all(o for _, o in errs.values()) and got[0] is got[3]
              and all(bool(torch.isfinite(g.float()).all()) for g in got))
        err = max(e for e, _ in errs.values())
        say(f"[k2] cista_core {DNAME[dtype]} B={CAPACITY} {H // 2}x{W // 2} C={C} depth={DEPTH}: "
            f"max_abs_err {', '.join(f'{n} {e:.3e}' for n, (e, _) in errs.items())} "
            f"(tol {TOL[dtype]} + {TOL[dtype]} |ref|) {'pass' if ok else 'FAIL'}")
        if not ok:
            fail(f"K2 disagrees with its plain version in {DNAME[dtype]}")
        k2[dtype] = {"inputs": core_args, "max_abs_err": err}

    # 4c. the K2 slice: the pool with core_impl="cuda" on the same voxel grids
    cfg_k2 = dataclasses.replace(cfg, core_impl="cuda")
    k2_launches = {}
    for dtype in (torch.float32, torch.bfloat16):
        cista_core.launches = ista_loop.launches = 0
        recs, _, per_step = serve(StreamPool(cfg_k2, weights, CAPACITY, dtype), served[dtype],
                                  counter=cista_core)
        k2_launches[dtype], k1_in_k2 = cista_core.launches, ista_loop.launches
        stacked = torch.stack(list(recs.values()))
        finite = bool(torch.isfinite(stacked).all())
        in_range = bool(((stacked >= 0) & (stacked <= 1)).all())
        say(f"[pool-k2] {DNAME[dtype]}: {len(recs)} reconstructions, core_impl=cuda; "
            f"finite={finite} in[0,1]={in_range}; K2 launches per step {per_step} (want "
            f"{launches_per_call(DEPTH)} each), total {k2_launches[dtype]}; K1 launches {k1_in_k2} "
            f"(want 0: K2 launches its ISTA convs itself)")
        if not (finite and in_range):
            fail(f"K2 pool reconstructions in {DNAME[dtype]} are not finite values in [0, 1]")
        if any(n != launches_per_call(DEPTH) for n in per_step) or k1_in_k2:
            fail("K2's launch counter did not rise by 7 + 2 x depth per pool step, or K1 ran")
        ref, _, _ = serve(StreamPool(dataclasses.replace(cfg, core_impl="plain"), weights,
                                     CAPACITY, dtype), served[dtype])
        err, ok = within(stacked, torch.stack([ref[k] for k in recs]), TOL[dtype])
        say(f"[pool-k2] {DNAME[dtype]}: K2 vs its plain version (core_impl=plain) on the same "
            f"voxel grids: max_abs_err={err:.3e} (tol atol=rtol={TOL[dtype]}) "
            f"{'pass' if ok else 'FAIL'}")
        if not ok:
            fail(f"the pool through K2 disagrees with the plain K2 in {DNAME[dtype]}")
        err, ok = within(stacked, torch.stack([layers_recs[dtype][k] for k in recs]),
                         K2_VS_LAYERS_TOL)
        say(f"[pool-k2] {DNAME[dtype]}: K2 vs the layers pool (K1 and cuDNN, phase 4): "
            f"max_abs_err={err:.3e} (tol atol=rtol={K2_VS_LAYERS_TOL}) {'pass' if ok else 'FAIL'}")
        if not ok:
            fail(f"the pool through K2 disagrees with the layers pool in {DNAME[dtype]}")

    # 6. K3 against its plain version
    from v2e2v_tpu_torch.models.emulator import emulate_pack
    from v2e2v_tpu_torch.models.v2e2v import V2E2VConfig, v2e2v_forward
    from v2e2v_tpu_torch.ops.cuda.emulator_iters import emulator_iters, emulator_iters_plain

    t_phase = time.perf_counter()
    k3_errs = check_k3(emulator_iters, emulator_iters_plain, args.seed)
    say(f"[phase] K3 checks {time.perf_counter() - t_phase:.1f} s")

    # 7. the V2E2V slice: runs A (kernels, explicit draws), B (plain), C (the
    # default path, internal randoms), D (plain, internal randoms)
    t_phase = time.perf_counter()
    counters = (emulator_iters, ista_loop)
    cfg_c = V2E2VConfig.from_flags(argparse.Namespace(**FLAGS))
    if (cfg_c.emulator.iters_impl, cfg_c.cista.ista_impl) != ("cuda", "cuda"):
        fail(f"from_flags does not take the kernels: {cfg_c}")
    cfg_b = V2E2VConfig(dataclasses.replace(cfg_c.cista, ista_impl="plain"),
                        dataclasses.replace(cfg_c.emulator, iters_impl="plain"))
    video = hfr_video(args.seed, "cuda")
    want_launches = [N_FRAMES - 1, 2 * DEPTH]
    outs_a, per_pack_a = run_v2e2v(cfg_c, weights, video, args.seed, counters,
                                   explicit_shot=True)
    outs_b, per_pack_b = run_v2e2v(cfg_b, weights, video, args.seed, counters,
                                   explicit_shot=True)
    last = {}
    for c in counters:
        c.launches = 0
    emulator_iters.launches_by_shot = dict.fromkeys(emulator_iters.launches_by_shot, 0)
    outs_c, per_pack_c = run_v2e2v(cfg_c, weights, video, args.seed + 1, counters, last)
    main_k3, main_k1 = dict(emulator_iters.launches_by_shot), ista_loop.launches
    outs_d, per_pack_d = run_v2e2v(cfg_b, weights, video, args.seed + 1, counters)
    say(f"[v2e2v] {PACKS} packs of {N_FRAMES} frames, batch {CAPACITY}, {H}x{W}, new sequence "
        f"at pack {RESET_AT}; K3, K1 launches per pack: run A {per_pack_a}, run B (plain) "
        f"{per_pack_b}, run C (default path) {per_pack_c} (want {want_launches} each), "
        f"run D (plain) {per_pack_d}")
    if any(n != want_launches for n in per_pack_a + per_pack_c) or any(
            n != [0, 0] for n in per_pack_b + per_pack_d):
        fail("K3's counter did not rise by N - 1 and K1's by 2 x depth per pack")
    ev_a = [int(o.num_events) for o in outs_a]
    ev_b = [int(o.num_events) for o in outs_b]
    ev_c = [int(o.num_events) for o in outs_c]
    vox_err, vox_ok = within(torch.stack([o.event_voxel_grids for o in outs_a]),
                             torch.stack([o.event_voxel_grids for o in outs_b]), V2E2V_TOL)
    rec_a = torch.stack([o.reconstruction for o in outs_a])
    rec_err, rec_ok = within(rec_a, torch.stack([o.reconstruction for o in outs_b]), V2E2V_TOL)
    say(f"[v2e2v] run A vs run B: num_events {ev_a} vs {ev_b} equal={ev_a == ev_b}; voxel "
        f"max_abs_err={vox_err:.3e}, reconstruction max_abs_err={rec_err:.3e} "
        f"(tol atol=rtol={V2E2V_TOL}) {'pass' if ev_a == ev_b and vox_ok and rec_ok else 'FAIL'}")
    if not (ev_a == ev_b and vox_ok and rec_ok):
        fail("V2E2V through K3 and K1 disagrees with the plain versions")
    rec_c = torch.stack([o.reconstruction for o in outs_c])
    finite = bool(torch.isfinite(rec_c).all())
    in_range = bool(((rec_c >= 0) & (rec_c <= 1)).all())
    close = all(abs(c - a) <= 0.01 * a for a, c in zip(ev_a, ev_c))
    say(f"[v2e2v] run C (from_flags, internal randoms): num_events {ev_c}, within 1% of run "
        f"A's={close}; reconstructions finite={finite} in[0,1]={in_range} "
        f"{'pass' if close and finite and in_range else 'FAIL'}")
    if not (close and finite and in_range and min(ev_a) > 0):
        fail("the default V2E2V path gave bad reconstructions or event counts")
    ev_d = [int(o.num_events) for o in outs_d]
    vox_err, vox_ok = within(torch.stack([o.event_voxel_grids for o in outs_c]),
                             torch.stack([o.event_voxel_grids for o in outs_d]), V2E2V_TOL)
    rec_err, rec_ok = within(rec_c, torch.stack([o.reconstruction for o in outs_d]), V2E2V_TOL)
    ok = ev_c == ev_d and vox_ok and rec_ok
    say(f"[v2e2v] run C vs run D (plain, internal randoms): num_events {ev_c} vs {ev_d} "
        f"equal={ev_c == ev_d}; voxel max_abs_err={vox_err:.3e}, reconstruction "
        f"max_abs_err={rec_err:.3e} (tol atol=rtol={V2E2V_TOL}) {'pass' if ok else 'FAIL'}")
    if not ok:
        fail("the default V2E2V path disagrees with the plain versions")
    say(f"[phase] V2E2V runs {time.perf_counter() - t_phase:.1f} s")

    # 5. times
    def k1_times(inputs, dtype, label):
        """K1 per call as issued and on the device, the host's time to issue
        it, its plain version, cuDNN's D + P convs x depth and its bound."""
        # ms: per call as the host issues them (the wrapper's host work
        # included); device_ms: the launches back to back on the card. In
        # bfloat16 K1's launches take about as long on the card as the host
        # takes to issue them, so the two differ
        ms = time_ms(lambda: ista_loop(*inputs, depth=DEPTH))
        dev_ms, host_ms = issue_ms(lambda: ista_loop(*inputs, depth=DEPTH))
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
        library_dev_ms = DEPTH * device_ms(library)
        bound_ms, bound_by = ista_bound_ms(inputs, DEPTH)
        say(f"[time] K1 {DNAME[dtype]}{label}: kernel {ms:.4f} ms/call as issued, {dev_ms:.4f} "
            f"ms on the device, {host_ms:.4f} ms of the host's to issue it; plain "
            f"{plain_ms:.4f} ms; library (F.conv2d D + P, zero padding, channels_last) x depth "
            f"{library_ms:.4f} ms as issued, {library_dev_ms:.4f} ms on the device; bound "
            f"{bound_ms:.4f} ms ({bound_by}; peak {PEAK_FLOPS[dtype] / 1e12:.0f} TFLOP/s, "
            f"{PEAK_BYTES / 1e12} TB/s) = {100 * bound_ms / ms:.1f}% of bound as issued, "
            f"{100 * bound_ms / dev_ms:.1f}% on the device")
        return {"ms": ms, "device_ms": dev_ms, "host_ms": host_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                "library_device_ms": library_dev_ms}

    entries = []
    for dtype in (torch.float32, torch.bfloat16):
        inputs = k1[dtype]["inputs"]
        times = k1_times(inputs, dtype, "")
        ms = times["ms"]
        entries.append({
            "name": f"ista_loop ({DNAME[dtype]})", "route": "cuda", "source": K1_SOURCE,
            "replaces": K1_REPLACES, "launches": main_launches[dtype],
            "max_abs_err": k1[dtype]["max_abs_err"], **times,
            "tensor_cores": dtype == torch.bfloat16, "design": DESIGN[dtype],
        })
        if dtype == torch.float32:  # the CLIs' batch 1, on the 8x8 and 8x16 tiles
            one = ista_inputs(torch.Generator().manual_seed(args.seed + 1), dtype, weights, b=1)
            err, ok = within(ista_loop(*one, depth=DEPTH), ista_loop_plain(*one, depth=DEPTH),
                             TOL[dtype])
            say(f"[k1] ista_loop float32 B=1 {H // 2}x{W // 2} C={C} depth={DEPTH}: "
                f"max_abs_err={err:.3e} (tol atol=rtol={TOL[dtype]}) {'pass' if ok else 'FAIL'}")
            if not ok:
                fail("K1 disagrees with its plain version in float32 at B = 1")
            entries[-1]["batch1"] = {"max_abs_err": err, **k1_times(one, dtype, " B=1")}

        core_args = k2[dtype]["inputs"]
        k2_ms = time_ms(lambda: cista_core(*core_args, depth=DEPTH))
        k2_dev_ms, k2_host_ms = issue_ms(lambda: cista_core(*core_args, depth=DEPTH))
        k2_plain_ms = time_ms(lambda: cista_core_plain(*core_args, depth=DEPTH))
        _, x1, z, cell, dg_h, dg_c = core_args
        state = CistaState(cell=cell, z=z, dg=(dg_h, dg_c))
        params_dt = {k: v.to(dtype) for k, v in weights.items()}
        layers_ms = time_ms(lambda: half_res_core(params_dt, cfg, x1, state))
        layers_dev_ms = device_ms(lambda: half_res_core(params_dt, cfg, x1, state))
        cudnn_ms = time_ms(lambda: half_res_core(params_dt, cfg_plain, x1, state))
        cudnn_dev_ms = device_ms(lambda: half_res_core(params_dt, cfg_plain, x1, state))
        bound_ms, bound_by = core_bound_ms(core_args, DEPTH)
        say(f"[time] K2 {DNAME[dtype]}: kernel {k2_ms:.4f} ms/call as issued, {k2_dev_ms:.4f} "
            f"ms on the device, {k2_host_ms:.4f} ms of the host's to issue it "
            f"({launches_per_call(DEPTH)} launches); plain {k2_plain_ms:.4f} "
            f"ms; the layers core it replaces (ConvLSTC, K1, Dg conv, ConvLSTM) "
            f"{layers_ms:.4f} ms as issued, {layers_dev_ms:.4f} ms on the device; the same "
            f"with the plain ISTA (cuDNN convs only) {cudnn_ms:.4f} / {cudnn_dev_ms:.4f} ms; "
            f"bound {bound_ms:.4f} ms ({bound_by}; peak {PEAK_FLOPS[dtype] / 1e12:.0f} "
            f"TFLOP/s) = {100 * bound_ms / k2_ms:.1f}% of bound as issued, "
            f"{100 * bound_ms / k2_dev_ms:.1f}% on the device")
        entries.append({
            "name": f"cista_core ({DNAME[dtype]})", "route": "cuda", "source": K2_SOURCE,
            "replaces": K2_REPLACES, "launches": k2_launches[dtype],
            "max_abs_err": k2[dtype]["max_abs_err"], "ms": k2_ms, "device_ms": k2_dev_ms,
            "host_ms": k2_host_ms, "plain_ms": k2_plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None, "layers_core_ms": layers_ms,
            "layers_core_device_ms": layers_dev_ms, "cudnn_core_ms": cudnn_ms,
            "cudnn_core_device_ms": cudnn_dev_ms,
            "tensor_cores": dtype == torch.bfloat16, "design": DESIGN[dtype],
            "note": "no single PyTorch call computes the core; layers_core_ms is the path "
                    "it replaces (cuDNN convs and K1), cudnn_core_ms that path with cuDNN "
                    "convs only",
        })

        vox = {i: voxelize(packets[i]) for i in range(CAPACITY)}
        step_times = {"layers": [], "cuda": []}
        peak = {}
        for impl in ("layers", "cuda", "cuda", "layers"):  # in turns
            pool = StreamPool(dataclasses.replace(cfg, core_impl=impl), weights, CAPACITY, dtype)
            sids = [pool.attach() for _ in range(CAPACITY)]
            torch.cuda.reset_peak_memory_stats()
            for i in range(8):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pool.step({sid: vox[i] for i, sid in enumerate(sids)}, fetch=False)
                torch.cuda.synchronize()
                if i >= 2:
                    step_times[impl].append(1e3 * (time.perf_counter() - t0))
            peak[impl] = max(peak.get(impl, 0.0), torch.cuda.max_memory_allocated() / 2**20)
            del pool
        front_ms = time_ms(lambda: voxelize(packets[0]))
        step_ms = {k: float(np.median(v)) for k, v in step_times.items()}
        say(f"[time] pool {DNAME[dtype]} capacity {CAPACITY}, all active, core_impl layers / "
            f"cuda in turns: step {step_ms['layers']:.3f} / {step_ms['cuda']:.3f} ms (median "
            f"of {len(step_times['cuda'])} each, host clock, min "
            f"{min(step_times['layers']):.3f} / {min(step_times['cuda']):.3f}), "
            f"{CAPACITY * 1e3 / step_ms['layers']:.1f} / {CAPACITY * 1e3 / step_ms['cuda']:.1f} "
            f"reconstructions/s; K1 share of the layers step {100 * ms / step_ms['layers']:.1f}%, "
            f"K2 share of the cuda step {100 * k2_ms / step_ms['cuda']:.1f}%; front end "
            f"(voxelise + normalise one packet) {front_ms:.4f} ms; max_memory_allocated "
            f"{peak['layers']:.1f} / {peak['cuda']:.1f} MiB")

    # 8. K3 and V2E2V times, on the main path's inputs
    t_phase = time.perf_counter()
    frames5, ts5 = video[-1]
    for internal in (True, False):
        x, kw = main_path_k3_inputs(cfg_c.emulator, last["state"].emulator, frames5, ts5, internal)
        ms = device_ms(lambda: emulator_iters(**x, **kw))
        wrapper_ms = time_ms(lambda: emulator_iters(**x, **kw), warmup=3, iters=20)
        plain_ms = time_ms(lambda: emulator_iters_plain(**x, **kw), warmup=1, iters=3)
        bound_ms, bound_by = k3_bound_ms(x, kw)
        mode = "internal" if internal else "explicit"
        say(f"[time] K3 {mode} (main-path inputs, num_iters {x['num_iters'].tolist()}): kernel "
            f"{ms:.4f} ms/call on the device (launches back to back), {wrapper_ms:.4f} ms/call "
            f"through the wrapper as the host issues them; plain {plain_ms:.4f} ms; bound "
            f"{bound_ms:.4f} ms ({bound_by}) = {100 * bound_ms / ms:.1f}% of bound; library: "
            f"none (no PyTorch call computes the loop)")
        entries.append({
            "name": f"emulator_iters ({mode} rng)", "route": "cuda", "source": K3_SOURCE,
            "replaces": K3_REPLACES, "launches": main_k3[mode],
            "max_abs_err": k3_errs[mode], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            **({} if internal else {"note": "explicit-draw instance, not on the main path: "
                                    "launched by the exact checks and run A"}),
        })
    noise = torch.Generator(device="cuda").manual_seed(args.seed)
    state4 = last["state"].emulator
    emu_ms = time_ms(lambda: emulate_pack(cfg_c.emulator, state4, frames5, ts5, noise),
                     warmup=2, iters=10)
    torch.cuda.reset_peak_memory_stats()
    step_times = []
    for rep in range(3):
        state = None
        for p, (frames, ts) in enumerate(video):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, state = v2e2v_forward(weights, cfg_c, frames, ts, None if p == RESET_AT else state,
                                       noise)
            torch.cuda.synchronize()
            if rep:
                step_times.append(1e3 * (time.perf_counter() - t0))
    fwd_ms = float(np.median(step_times))
    say(f"[time] V2E2V default path, batch {CAPACITY}: emulate_pack {emu_ms:.3f} ms/pack "
        f"as the host issues it (CUDA events); v2e2v_forward {fwd_ms:.3f} ms/pack (median of {len(step_times)}, host "
        f"clock, min {min(step_times):.3f}), {CAPACITY * 1e3 / fwd_ms:.1f} reconstructions/s; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    main_launches_line = {"K3 (run C)": main_k3, "K1 (run C)": main_k1}
    say(f"[v2e2v] main path launches, counts set to 0 before run C: {main_launches_line}")
    if main_k3["internal"] == 0 or main_k1 == 0:
        fail("the main path did not launch K3 and K1")
    say(f"[phase] K3 and V2E2V times {time.perf_counter() - t_phase:.1f} s")

    # 9. the E2V evaluation CLI at full width
    cli_k1 = cli_phase(args.seed, cfg, smi)

    # 10-12. the V2E2V CLI, raw-event generation, CISTA-TC
    tmp = Path(tempfile.mkdtemp(prefix="v2e2v_slice5_"))
    try:
        hfr = v2e2v_cli_phase(args.seed, smi, tmp)
        raw_phase(args.seed, smi, tmp, hfr["data"])
        tc_launches = tc_phase(args.seed, smi, tmp, serve, served)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 13. kernels, then the result line
    for e in entries:
        if e["name"].startswith("ista_loop"):
            e.update(cli_k1[torch.float32 if "float32" in e["name"] else torch.bfloat16])
            if "float32" in e["name"]:
                e["v2e2v_cli_launches"] = hfr["k1"]
        if e["name"] == "emulator_iters (internal rng)":
            e.update(v2e2v_cli_launches=hfr["k3"], raw_launches=0)
        e["tc_pool_launches"] = sum(tc_launches.values())
    say(json.dumps({"kernels": entries}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
