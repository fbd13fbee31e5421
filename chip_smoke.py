#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``v2e2v_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, one line each (any failure exits non-zero before the last line):

1. device: ``nvidia-smi`` name and power limit, and torch's device name;
2. build: every CUDA source by its own ``nvcc``, all at once, and one link
   (seconds, and ``-Xptxas -v``'s registers, shared memory and spills per
   kernel); ``cuobjdump --dump-sass`` of the library counts the ``HGMMA``
   (wgmma) instructions of each kernel: every bfloat16 conv kernel of K1 and
   K2 (``*_conv3x3_tc_kernel``) must have some and spill nothing;
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
   and for K1 and K2 the host's time to issue a call (``host_ms``);
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
9. a ``{"kernels": [...]}`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package ``v2e2v_tpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import shutil
import subprocess
import sys
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
# the emulator of bench.py:170-176, as the V2E2V CLI's flags give it
FLAGS = dict(image_dim=[H, W], base_channels=C, depth=DEPTH, num_bins=NB,
             event_mode="voxel_grid", pl=1.5, ps=0.5, ql=1.0, qs=0.0, C=0.6,
             threshold_sigma=0.03, cutoff_hz=200.0, refractory_period_s=0.001)
DNAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
EPILOGUES = ("D conv", "P conv", "pre-activation", "relu", "out gate")
# what runs the convs of K1 and K2 in each dtype
DESIGN = {torch.float32: "SIMT direct conv on CUDA cores (csrc/conv3x3.cuh), exact float32 sums",
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
    m = re.search(r"((?:ista|core)_conv3x3_kernel)I(\w+?)Li([0-4])E", mangled)
    if m:
        dtype = "bfloat16" if "bfloat16" in m.group(2) else "float32"
        return f"{m.group(1)}<{dtype}, {EPILOGUES[int(m.group(3))]}>"
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
    tc_kernels = [k for k in hgmma if "conv3x3_tc_kernel" in k]
    say(f"[build] HGMMA (wgmma) instructions per kernel, cuobjdump --dump-sass: "
        f"{ {short_name(k): v for k, v in hgmma.items()} }")
    if not any("ista_conv3x3_tc" in k for k in tc_kernels) or not any(
            "core_conv3x3_tc" in k for k in tc_kernels):
        fail("the library has no bfloat16 tensor-core conv kernel for K1 or K2")
    if any(hgmma[k] == 0 or spills.get(k, 1) for k in tc_kernels):
        fail("a bfloat16 conv kernel of K1 or K2 has no HGMMA instruction, or spills")
    for label, fn in (("float32 (SIMT)", lib.lib.v2e_conv3x3_smem_bytes),
                      ("bfloat16 (tensor cores)", lib.lib.v2e_conv3x3_tc_smem_bytes)):
        smem = {cout: fn(cout) for cout in (C, 2 * C, 4 * C)}
        say(f"[build] K1/K2 {label} conv dynamic shared memory per block: cout={C} {smem[C]} B, "
            f"cout={2 * C} {smem[2 * C]} B, cout={4 * C} {smem[4 * C]} B (chunks of at most "
            f"128 output channels)")

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
    entries = []
    for dtype in (torch.float32, torch.bfloat16):
        inputs = k1[dtype]["inputs"]
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
        say(f"[time] K1 {DNAME[dtype]}: kernel {ms:.4f} ms/call as issued, {dev_ms:.4f} ms on "
            f"the device, {host_ms:.4f} ms of the host's to issue it; plain {plain_ms:.4f} ms; "
            f"library (F.conv2d D + P, zero padding, channels_last) x depth {library_ms:.4f} "
            f"ms as issued, {library_dev_ms:.4f} ms on the device; bound {bound_ms:.4f} ms "
            f"({bound_by}; peak {PEAK_FLOPS[dtype] / 1e12:.0f} TFLOP/s, {PEAK_BYTES / 1e12} "
            f"TB/s) = {100 * bound_ms / ms:.1f}% of bound as issued, "
            f"{100 * bound_ms / dev_ms:.1f}% on the device")
        entries.append({
            "name": f"ista_loop ({DNAME[dtype]})", "route": "cuda", "source": K1_SOURCE,
            "replaces": K1_REPLACES, "launches": main_launches[dtype],
            "max_abs_err": k1[dtype]["max_abs_err"], "ms": ms, "device_ms": dev_ms,
            "host_ms": host_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms, "library_device_ms": library_dev_ms,
            "tensor_cores": dtype == torch.bfloat16, "design": DESIGN[dtype],
        })

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

    # 9. kernels, then the result line
    say(json.dumps({"kernels": entries}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
