"""Kernel K3: the emulator's per-frame-pair iteration loop (port of
``v2e2v_tpu/ops/pallas/emulator_iters.py``).

For every pixel and iteration ``i < max_iters``: the candidate event
``counts >= i + 1``; shot noise while ``i < num_iters[b]``; suppress-only
refractory gating ``(ts_i - mem) > trf`` on rows whose gate is set, and the
``mem`` update; the event count; and the bilinear-in-time accumulation
``voxel[..., k] += pol * m * max(0, 1 - |ts_i - k|)``. See
``csrc/emulator_iters.cu`` for the kernel.

``emulator_iters`` runs the CUDA kernel for CUDA tensors (one launch, counted
in ``emulator_iters.launches`` and, by shot mode, in
``emulator_iters.launches_by_shot``) and the plain PyTorch version
``emulator_iters_plain`` for CPU tensors. The two round every float operation
alike and give the same outputs bit for bit, in both random modes:

- explicit: ``rand01 [max_iters, B, H, W]`` float32 uniforms are an input;
- internal (``internal_rng=True``): the uniforms come from Philox4x32-10
  keyed by ``seed[b]`` (int64, read as uint64) and counted by
  ``(pixel, i // 4)``; lane ``i % 4`` of the output gives ``(bits >> 8) *
  2**-24``. ``philox4x32_10`` below is the plain version of that generator.

The kernel stops a pixel's loop after its last possible event, which the
plain version does not need to: from ``i >= max(counts, num_iters[b])`` on
(``counts`` alone without shot noise) no event can fire.
"""

from __future__ import annotations

import ctypes

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_SHOT_NONE, _SHOT_EXPLICIT, _SHOT_INTERNAL = 0, 1, 2
SHOT_MODES = ("none", "explicit", "internal")  # by the kernel's template argument
MAX_BINS = 16  # csrc/emulator_iters.cu keeps the bins in registers


def _mulhilo32(a: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """High and low 32 bits of ``a * x`` for a uint32 constant ``a`` and
    int64 ``x`` holding uint32 values, without overflowing int64."""
    p_lo = x * (a & 0xFFFF)  # < 2^48
    p_hi = x * (a >> 16)  # < 2^48; a * x = p_hi * 2^16 + p_lo
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK32
    return hi, lo


def philox4x32_10(
    counter: tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
    key: tuple[torch.Tensor, torch.Tensor],
) -> tuple[torch.Tensor, ...]:
    """Philox4x32-10 on int64 tensors holding uint32 values (broadcasting).

    The same generator as the kernel's (and Random123's and curand's):
    ``philox4x32_10((0, 0, 0, 0), (0, 0)) == (0x6627E8D5, 0xE169C58D,
    0xBC57AC4C, 0x9B00DBD8)``.
    """
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for rnd in range(10):
        if rnd:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo32(_M0, c0)
        hi1, lo1 = _mulhilo32(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _philox_uniforms(seed: torch.Tensor, hw: int, i4: int) -> list[torch.Tensor]:
    """The four ``[B, H*W]`` float32 uniforms of iterations ``4*i4 .. 4*i4+3``."""
    pix = torch.arange(hw, dtype=torch.int64, device=seed.device)[None, :]
    key = ((seed & _MASK32)[:, None], ((seed >> 32) & _MASK32)[:, None])
    zero = torch.zeros_like(pix)
    lanes = philox4x32_10((pix, torch.full_like(pix, i4), zero, zero), key)
    return [(lane >> 8).to(torch.float32) * 2.0**-24 for lane in lanes]


def _check(counts, pol, mem, trf, om, off, rand01, seed, ts_step, num_iters, gate,
           num_bins, max_iters, shot, internal_rng) -> None:
    if counts.dim() != 3:
        raise ValueError(f"event_counts must be [B, H, W], got {tuple(counts.shape)}")
    b, h, w = counts.shape
    planes = {"pol": pol, "timestamp_mem": mem, "tr_frames": trf}
    if shot:
        planes |= {"one_minus_on_prob": om, "off_prob": off}
    want = {name: (t, (b, h, w), torch.float32) for name, t in planes.items()}
    want |= {"event_counts": (counts, (b, h, w), torch.int32),
             "ts_step": (ts_step, (b,), torch.float32),
             "num_iters": (num_iters, (b,), torch.int32),
             "gate": (gate, (b,), torch.bool)}
    if shot and internal_rng:
        want["seed"] = (seed, (b,), torch.int64)
    elif shot:
        want["rand01"] = (rand01, (max_iters, b, h, w), torch.float32)
    for name, (t, shape, dtype) in want.items():
        if t is None:
            raise ValueError(f"{name} is required in this mode")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != counts.device:
            raise ValueError(f"{name} is on {t.device}, event_counts on {counts.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= num_bins <= MAX_BINS or max_iters < 0:
        raise ValueError(f"need 1 <= num_bins <= {MAX_BINS} and max_iters >= 0, got "
                         f"num_bins={num_bins}, max_iters={max_iters}")


def emulator_iters_plain(
    event_counts: torch.Tensor,
    pol: torch.Tensor,
    timestamp_mem: torch.Tensor,
    tr_frames: torch.Tensor,
    one_minus_on_prob: torch.Tensor | None,
    off_prob: torch.Tensor | None,
    rand01: torch.Tensor | None,
    seed: torch.Tensor | None,
    ts_step: torch.Tensor,
    num_iters: torch.Tensor,
    gate: torch.Tensor,
    tf_base: float,
    *,
    num_bins: int,
    max_iters: int,
    shot: bool,
    internal_rng: bool = False,
    collect: bool = False,
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel, with the same signature and one
    more flag, ``collect`` (raw-event mode; the kernel has no such output).

    Args:
      event_counts: ``[B, H, W]`` int32; pol, timestamp_mem, tr_frames,
        one_minus_on_prob, off_prob: ``[B, H, W]`` float32 (the last two only
        with ``shot``); rand01: ``[max_iters, B, H, W]`` float32 (explicit
        shot noise) or None; seed: ``[B]`` int64 (``internal_rng``) or None;
        ts_step ``[B]`` float32, num_iters ``[B]`` int32, gate ``[B]`` bool;
        tf_base: the pair's voxel-time base (a float32 value).
    Returns ``(voxel_add [B, H, W, num_bins], timestamp_mem, final_counts)``;
    with ``collect``, ``(masks [max_iters, B, H, W] bool, ts_all [max_iters,
    B], timestamp_mem, final_counts)`` instead: each iteration's events after
    the refractory gate and its event time (0 from ``num_iters[b]`` on), and
    no voxel grid.
    """
    _check(event_counts, pol, timestamp_mem, tr_frames, one_minus_on_prob, off_prob, rand01,
           seed, ts_step, num_iters, gate, num_bins, max_iters, shot, internal_rng)
    b, h, w = event_counts.shape
    mem = timestamp_mem
    final = torch.zeros_like(event_counts)
    accs = [torch.zeros_like(pol) for _ in range(0 if collect else num_bins)]
    masks, ts_all = [], []
    gate3 = gate[:, None, None]
    uniforms: list[torch.Tensor] = []
    for i in range(max_iters):
        m = event_counts >= i + 1
        active = i < num_iters  # [B]
        if shot:
            if internal_rng:
                if i % 4 == 0:
                    uniforms = _philox_uniforms(seed, h * w, i // 4)
                r = uniforms[i % 4].reshape(b, h, w)
            else:
                r = rand01[i]
            s = ((pol > 0) & (r > one_minus_on_prob)) | ((pol < 0) & (r < off_prob))
            m = m | (s & active[:, None, None])
        ts_b = torch.where(active, tf_base + ts_step * float(i + 1), 0.0)
        ts_i = ts_b[:, None, None]
        m = m & (~gate3 | ((ts_i - mem) > tr_frames))
        mem = torch.where(m & gate3, ts_i, mem)
        final = final + m.to(torch.int32)
        if collect:
            masks.append(m)
            ts_all.append(ts_b)
            continue
        ev = pol * m.to(torch.float32)
        for k in range(num_bins):
            wk = torch.clamp(1.0 - (ts_i - float(k)).abs(), min=0.0)
            accs[k] = accs[k] + ev * wk
    if collect:
        return torch.stack(masks), torch.stack(ts_all), mem, final
    return torch.stack(accs, dim=-1), mem, final


def emulator_iters(
    event_counts: torch.Tensor,
    pol: torch.Tensor,
    timestamp_mem: torch.Tensor,
    tr_frames: torch.Tensor,
    one_minus_on_prob: torch.Tensor | None,
    off_prob: torch.Tensor | None,
    rand01: torch.Tensor | None,
    seed: torch.Tensor | None,
    ts_step: torch.Tensor,
    num_iters: torch.Tensor,
    gate: torch.Tensor,
    tf_base: float,
    *,
    num_bins: int,
    max_iters: int,
    shot: bool,
    internal_rng: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The iteration loop: the CUDA kernel for CUDA tensors (one launch on
    the current stream, counted in ``emulator_iters.launches``), the plain
    version for CPU tensors. Arguments and results as
    ``emulator_iters_plain``."""
    args = (event_counts, pol, timestamp_mem, tr_frames, one_minus_on_prob, off_prob, rand01,
            seed, ts_step, num_iters, gate, tf_base)
    kw = dict(num_bins=num_bins, max_iters=max_iters, shot=shot, internal_rng=internal_rng)
    if event_counts.device.type == "cpu":
        return emulator_iters_plain(*args, **kw)
    if event_counts.device.type != "cuda":
        raise ValueError(f"emulator_iters runs on cuda or cpu, not {event_counts.device}")
    _check(event_counts, pol, timestamp_mem, tr_frames, one_minus_on_prob, off_prob, rand01,
           seed, ts_step, num_iters, gate, num_bins, max_iters, shot, internal_rng)
    from ._lib import load

    lib = load()
    b, h, w = event_counts.shape
    voxel = torch.empty((b, h, w, num_bins), dtype=torch.float32, device=event_counts.device)
    mem_out = torch.empty_like(timestamp_mem)
    final = torch.empty_like(event_counts)
    gate_i = gate.to(torch.int32)
    mode = _SHOT_NONE if not shot else _SHOT_INTERNAL if internal_rng else _SHOT_EXPLICIT

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(event_counts.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lib.v2e_emulator_iters(
            ptr(event_counts), ptr(pol), ptr(timestamp_mem), ptr(tr_frames),
            ptr(one_minus_on_prob), ptr(off_prob), ptr(rand01), ptr(seed), ptr(ts_step),
            ptr(num_iters), ptr(gate_i), ctypes.c_float(tf_base), ptr(voxel), ptr(mem_out),
            ptr(final), b, h, w, num_bins, max_iters, mode, stream,
        )
    lib.check(err, "emulator_iters launch")
    emulator_iters.launches += 1
    emulator_iters.launches_by_shot[SHOT_MODES[mode]] += 1
    return voxel, mem_out, final


emulator_iters.launches = 0
emulator_iters.launches_by_shot = dict.fromkeys(SHOT_MODES, 0)
