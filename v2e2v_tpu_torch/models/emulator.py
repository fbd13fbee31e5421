"""DVS event-camera emulator with sensing diversity (port of
``v2e2v_tpu/models/emulator.py``: voxel-grid mode, ``emulate_pack``, and
raw-event mode, ``emulate_pack_raw``).

Per frame pair: leak subtraction, the difference of the lin-log frame against
the memorised base frame, per-pixel event counts ``floor(|diff| / C)``, an
iteration loop that emits at most one event per pixel per iteration at
linearly spaced timestamps (with shot noise and refractory gating) and
accumulates them bilinearly in time into a voxel grid (kernel K3,
``ops/cuda/emulator_iters.py``); then ``base += pol * count * C``. A pack's
grid is normalised per sample (zero mean, unit std over its events).

The JAX package's deliberate deviations from the reference carry over:

- refractory gating only ever suppresses events: ``mask &= (ts - mem) > Tr``
  (the reference replaces the mask, which can re-trigger sub-threshold pixels
  right after a pack boundary);
- frame times are per batch row (the reference reads row 0's for every row);
- the refractory period in bin units is computed as scale times reciprocal
  of the window, in float32, so that ``tr > ts_step`` agrees bit for bit;
- last-spike times are rebased at every pack boundary;
- ``[B, N+1]`` timestamps (the reference's continuation-pack layout) pair
  their first N entries with the N frames; other widths raise ``ValueError``.

Randomness is explicit: every draw goes through a noise source (``Noise``),
by default ``GeneratorNoise`` over the caller's ``torch.Generator``. The
draws, in order: at initialisation the threshold normals ``pos_large``,
``pos_small``, ``neg_large``, ``neg_small`` (when ``sigma_thres > 0``) and
``leak_rate`` (when ``leak_rate_hz > 0``); then per frame pair one ``leak``
normal (when ``leak_rate_hz > 0``) and, with shot noise, either one ``shot``
uniform ``[max_iters, B, H, W]`` (explicit) or one ``shot_seed`` ``[B]``
(internal: K3 makes the uniforms). The draw is internal on the card, as the
JAX package's TPU path draws it, and explicit on the CPU, where tests replay
given numbers; a noise source with ``explicit_shot = True`` hands over the
uniforms on the card too. The order does not depend on ``iters_impl``. The
pair loop never waits for the device.

Raw-event mode runs the same pair loop with the plain iteration loop, which
records each iteration's events (K3 only accumulates voxel grids), always
with explicit shot uniforms (as the JAX package's raw path draws them), and
extracts the events on the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Protocol

import numpy as np
import torch

from .._device import resolve_device
from ..ops.cuda import emulator_iters as k3
from ..ops.numerics import (
    diversity_lattice_mask,
    div_const,
    div_true,
    lin_log,
    low_pass_filter_step,
    rdiv_true,
    rescale_intensity_frame,
    subtract_leak_current,
)
from ..ops.voxel import event_preprocess

ITERS_IMPLS = ("cuda", "plain")


@dataclass(frozen=True)
class EmulatorConfig:
    """Static emulator configuration (reference constructor, ``v2e_model.py:36-57``).

    ``iters_impl``: 'cuda' (kernel K3 for CUDA tensors, its plain version for
    CPU tensors) or 'plain'. The JAX package's 'auto' takes its Pallas kernel
    only when ``refractory_period_s > 0`` and a plane fits in VMEM
    (``emulator.py:463-470``), a choice between two TPU lowerings; K3 is
    exact against the plain loop with and without the gate and has no plane
    limit, so every CUDA tensor goes through it.
    """

    output_mode: str = "voxel_grid"
    pl: float = 1.0
    ps: float = 1.0
    ql: float = 1.0
    qs: float = 1.0
    num_bins: int = 5
    pos_thres: float = 0.2
    neg_thres: float = 0.2
    sigma_thres: float = 0.03
    cutoff_hz: float = 0.0
    leak_rate_hz: float = 0.1
    refractory_period_s: float = 0.0
    shot_noise_rate_hz: float = 0.0
    leak_jitter_fraction: float = 0.1
    noise_rate_cov_decades: float = 0.1
    max_iters: int = 32  # static bound on events per pixel per frame pair
    shot_noise_inten_factor: float = 0.25
    iters_impl: str = "cuda"

    def __post_init__(self):
        if self.iters_impl not in ITERS_IMPLS:
            raise ValueError(f"iters_impl must be one of {ITERS_IMPLS}, got {self.iters_impl!r}")


class EmulatorState(NamedTuple):
    """The emulator's state between packs (the reference's mutable attributes).
    It holds no random state: draws come from the noise source of each call."""

    base_log_frame: torch.Tensor  # [B,H,W] memorised lin-log values
    lp_log_frame: torch.Tensor  # [B,H,W] IIR low-pass state
    pos_thres: torch.Tensor  # [B,H,W] per-pixel ON threshold
    neg_thres: torch.Tensor  # [B,H,W] per-pixel OFF threshold
    pos_thres_pre_prob: torch.Tensor  # [B,H,W] shot-noise scaler (thres / nominal)
    neg_thres_pre_prob: torch.Tensor
    noise_rate_array: torch.Tensor  # [B,H,W] log-normal leak rates
    timestamp_mem: torch.Tensor  # [B,H,W] last-spike time in bin units
    t_previous: torch.Tensor  # [B] previous frame time, seconds


class EmulatorStats(NamedTuple):
    """Per-pack diagnostics (``emulate_pack(with_stats=True)``)."""

    num_events: torch.Tensor  # int32 scalar
    max_event_count: torch.Tensor  # int32 scalar, BEFORE the max_iters clip
    clipped_pixels: torch.Tensor  # int32 scalar: pixels whose count exceeded the clip


class Noise(Protocol):
    """Where the emulator's random numbers come from. ``what`` names the draw
    (see the module docstring); results are float32 (``normal``, ``uniform``)
    or int64 (``seeds``) tensors on ``device``. A source whose
    ``explicit_shot`` is true is asked for the shot uniforms on the card too
    (exact checks of K3 against its plain version)."""

    explicit_shot: bool

    def normal(self, what: str, shape: tuple[int, ...], device: torch.device) -> torch.Tensor: ...

    def uniform(self, what: str, shape: tuple[int, ...], device: torch.device) -> torch.Tensor: ...

    def seeds(self, what: str, n: int, device: torch.device) -> torch.Tensor: ...


class GeneratorNoise:
    """Draws from one ``torch.Generator`` on the generator's own device, then
    moves the numbers to where they are used. A CPU and a CUDA generator with
    the same seed give different numbers."""

    def __init__(self, generator: torch.Generator, explicit_shot: bool = False):
        self.generator = generator
        self.explicit_shot = explicit_shot

    @classmethod
    def from_seed(cls, seed: int, device: torch.device | str | None = None) -> "GeneratorNoise":
        """A generator on the card (or on ``device``) seeded with ``seed``."""
        return cls(torch.Generator(device=resolve_device(device)).manual_seed(seed))

    def normal(self, what, shape, device):
        g = self.generator
        return torch.randn(shape, generator=g, device=g.device).to(device)

    def uniform(self, what, shape, device):
        g = self.generator
        return torch.rand(shape, generator=g, device=g.device).to(device)

    def seeds(self, what, n, device):
        g = self.generator
        return torch.randint(0, 2**62, (n,), generator=g, device=g.device).to(device)


def as_noise(noise: Noise | torch.Generator) -> Noise:
    return GeneratorNoise(noise) if isinstance(noise, torch.Generator) else noise


def emulator_init(
    noise: Noise | torch.Generator,
    cfg: EmulatorConfig,
    frame_log: torch.Tensor,
    tr_frames: torch.Tensor,
    t0: torch.Tensor | float,
    device: torch.device | str | None = None,
) -> EmulatorState:
    """Initialise the state from the first lin-log frame (reference ``_init``).

    frame_log: ``[B, H, W]``; tr_frames: ``[B, H, W]`` refractory period in
    bin units; t0: scalar or per-row ``[B]`` first timestamp (seconds).
    Per-pixel thresholds are ``pl * C + sigma * N(0,1)`` with the
    ``[0::2, 0::2]`` lattice at ``ps * C``, clamped to >= 0.01.
    """
    device = resolve_device(device)
    noise = as_noise(noise)
    frame_log = torch.as_tensor(frame_log).to(device, torch.float32)
    tr_frames = torch.as_tensor(tr_frames).to(device, torch.float32)
    b, h, w = frame_log.shape
    lattice = diversity_lattice_mask(h, w, device)

    def diverse_threshold(name, nominal):
        if cfg.sigma_thres <= 0:
            # the reference keeps the scalar nominal threshold when sigma == 0
            return torch.full((b, h, w), nominal, dtype=torch.float32, device=device)
        large = cfg.pl * nominal + cfg.sigma_thres * noise.normal(f"{name}_large", (b, h, w), device)
        small = cfg.ps * nominal + cfg.sigma_thres * noise.normal(f"{name}_small", (b, h, w), device)
        return torch.clamp(torch.where(lattice, small, large), min=0.01)

    pos = diverse_threshold("pos", cfg.pos_thres)
    neg = diverse_threshold("neg", cfg.neg_thres)
    noise_rate = torch.ones((b, h, w), dtype=torch.float32, device=device)
    if cfg.leak_rate_hz > 0:
        noise_rate = torch.exp(math.log(10.0) * cfg.noise_rate_cov_decades
                               * noise.normal("leak_rate", (b, h, w), device))
    t0 = torch.as_tensor(t0, dtype=torch.float32).to(device)
    return EmulatorState(
        base_log_frame=frame_log,
        lp_log_frame=frame_log,
        pos_thres=pos,
        neg_thres=neg,
        pos_thres_pre_prob=div_true(pos, cfg.pos_thres),
        neg_thres_pre_prob=div_true(neg, cfg.neg_thres),
        noise_rate_array=noise_rate,
        timestamp_mem=-tr_frames,
        t_previous=t0.broadcast_to((b,)).clone(),
    )


def _per_row_times(t_frames: torch.Tensor, n: int) -> torch.Tensor:
    """Per-batch-row frame times ``[B, N]`` (float32).

    ``[B, 2]`` endpoints are spaced as ``jnp.linspace`` spaces them
    (``start * (1 - k/div) + stop * (k/div)`` for ``k < div``, then ``stop``),
    which ``torch.linspace`` does not reproduce; ``k / div`` is
    ``k * f32(1 / div)``, as XLA compiles it. Deliberate improvement over the
    reference, which reads batch row 0's times for every row.
    """
    t_frames = t_frames.to(torch.float32)
    if t_frames.shape[1] != 2:
        return t_frames[:, :n]
    start, stop = t_frames[:, :1], t_frames[:, 1:]
    div = n - 1
    step = div_const(torch.arange(div, dtype=torch.float32, device=t_frames.device), float(div))
    return torch.cat([start * (1.0 - step) + stop * step, stop], dim=1)


def _refractory_bins(cfg: EmulatorConfig, t_frames: torch.Tensor) -> torch.Tensor:
    """Refractory period in voxel-bin units per row, ``[B]``, from the FULL
    timestamp span: ``((nb - 1) * Tr) * (1 / window)`` in float32."""
    window = (t_frames[:, -1] - t_frames[:, 0]).to(torch.float32)
    scale = float(np.float32(cfg.num_bins - 1) * np.float32(cfg.refractory_period_s))
    return scale * torch.reciprocal(window)


def _check_times(t_frames: torch.Tensor, n: int) -> torch.Tensor:
    """The first N timestamps of a ``[B, N+1]`` continuation row; ``[B, 2]``
    and ``[B, N]`` as they are; anything else raises."""
    if t_frames.shape[1] in (2, n):
        return t_frames
    if t_frames.shape[1] != n + 1:
        raise ValueError(
            f"t_frames has {t_frames.shape[1]} entries for {n} frames; expected 2 "
            "(endpoints), N, or N+1 (reference continuation-pack layout, "
            "video_readers.py:101)"
        )
    return t_frames[:, :n]


def emulator_init_from_pack(
    cfg: EmulatorConfig,
    frames: torch.Tensor,
    t_frames: torch.Tensor,
    noise: Noise | torch.Generator,
    device: torch.device | str | None = None,
) -> EmulatorState:
    """A fresh state from a pack's FIRST frame (the reference's first-pack
    ``_init``). ``emulate_pack(cfg, init_from_pack(pack0), pack0, ...)`` equals
    ``emulate_pack(cfg, None, pack0, ...)`` given the same noise."""
    device = resolve_device(device)
    frames = torch.as_tensor(frames).to(device, torch.float32)
    t_frames = torch.as_tensor(t_frames).to(device, torch.float32)
    b, n, h, w = frames.shape
    tr = _refractory_bins(cfg, t_frames)
    tr_frames = tr[:, None, None].expand(b, h, w).contiguous()
    t_float = _per_row_times(_check_times(t_frames, n), n)
    return emulator_init(noise, cfg, lin_log(frames[:, 0]), tr_frames, t_float[:, 0], device)


def validate_pack_times(t_frames, t_previous=None):
    """Host-side input-contract check for pack timestamps (CLI boundary).

    The reference raises on non-advancing frame times (``v2e_model.py:335-338``).
    Args:
      t_frames: ``[N]``, ``[B, N]``, ``[B, 2]`` or ``[B, N+1]`` timestamps
        (seconds), any array-like.
      t_previous: optional per-row (or scalar) last frame time of the previous
        pack; the FIRST entry may equal it but the second must be later.
    Returns the per-row last timestamps ``[B]`` (float64 numpy).
    Raises ``ValueError`` on non-increasing times within the pack or a pack
    that does not advance past ``t_previous``.
    """
    ts = np.asarray(t_frames, np.float64)
    if ts.ndim == 1:
        ts = ts[None]
    steps = np.diff(ts, axis=1)
    if np.any(steps <= 0):
        bad = float(ts[np.unravel_index(np.argmin(steps), steps.shape)[0], 0])
        raise ValueError(
            "frame times must be strictly increasing within a pack "
            f"(got a non-increasing step in the pack starting at t={bad})"
        )
    if t_previous is not None:
        prev = np.asarray(t_previous, np.float64).reshape(-1)
        second = ts[:, 1] if ts.shape[1] > 1 else ts[:, 0]
        if np.any(second <= prev):
            i = int(np.argmax(second <= prev))
            raise ValueError(
                f"this frame time={second[i]} must be later than "
                f"previous frame time={prev[min(i, prev.size - 1)]}"
            )
    return ts[:, -1]


class _Pack(NamedTuple):
    """What ``_prepare_pack`` hands to the pair loop."""

    filtered: list[torch.Tensor]  # per pair: [B,H,W] (low-passed) lin-log frame
    inten01: list[torch.Tensor]  # per pair: [B,H,W] rescaled intensity
    t_n: list[torch.Tensor]  # per pair: [B] frame time
    tf_base: list[float]  # per pair: voxel-time base (float32 values)
    duration: float
    tr: torch.Tensor  # [B] refractory period in bins
    tr_frames: torch.Tensor  # [B,H,W]


def _prepare_pack(cfg, state, frames, t_frames, noise):
    """Timestamps, refractory scale, lin-log transform, state init or
    pack-boundary rebase, and the IIR low-pass (reference ``forward``
    :290-345). ``frames`` and ``t_frames`` are float32 on the state's device."""
    b, n, h, w = frames.shape
    tr = _refractory_bins(cfg, t_frames)
    tr_frames = tr[:, None, None].expand(b, h, w).contiguous()
    t_float = _per_row_times(_check_times(t_frames, n), n)

    duration = (cfg.num_bins - 1) / (n - 1)
    time_frames = (duration * torch.arange(n, dtype=torch.float32)).tolist()

    frames_rescaled = rescale_intensity_frame(frames)
    frames_log = lin_log(frames)

    if state is None:
        state = emulator_init(noise, cfg, frames_log[:, 0], tr_frames, t_float[:, 0],
                              frames.device)
    else:
        # pack-boundary rebase of last-spike times (reference :329-330)
        mem = state.timestamp_mem
        mem = torch.where(mem > 0, mem - (cfg.num_bins - 1), mem)
        mem = torch.where(mem < 0, -tr_frames, mem)
        state = state._replace(timestamp_mem=mem)
    t_prev = torch.as_tensor(state.t_previous, dtype=torch.float32, device=frames.device)
    state = state._replace(t_previous=t_prev.broadcast_to((b,)))

    if cfg.cutoff_hz > 0:
        lp = state.lp_log_frame
        filtered = []
        for k in range(1, n):
            dt = (t_float[:, k] - t_float[:, k - 1])[:, None, None]
            lp = low_pass_filter_step(frames_log[:, k], lp, frames_rescaled[:, k], dt,
                                      cfg.cutoff_hz, ql=cfg.ql, qs=cfg.qs)
            filtered.append(lp)
        state = state._replace(lp_log_frame=lp)
    else:
        filtered = [frames_log[:, k] for k in range(1, n)]

    pack = _Pack(
        filtered=filtered,
        inten01=[frames_rescaled[:, k] for k in range(1, n)],
        t_n=[t_float[:, k] for k in range(1, n)],
        tf_base=time_frames[:-1],
        duration=duration,
        tr=tr,
        tr_frames=tr_frames,
    )
    return state, pack


def _internal_rng(noise: Noise, device: torch.device) -> bool:
    """Whether K3 makes the shot uniforms: on the card, unless the noise
    source hands them over."""
    return device.type == "cuda" and not getattr(noise, "explicit_shot", False)


def _pair_step(cfg, state, pack, base, mem, t_prev, p, noise, iters_fn, internal,
               collect=False):
    """One frame pair (reference hot loop :362-522). Returns
    ``(base, mem, voxel_add, n_ev, max_cnt, clipped)``; with ``collect``
    (raw-event mode) ``voxel_add`` is ``(masks [I,B,H,W], ts_all [I,B], pol)``
    from the plain loop, which alone records each iteration's events."""
    b, h, w = base.shape
    device = base.device
    delta_time = (pack.t_n[p] - t_prev)[:, None, None]  # [B,1,1], per batch row
    if cfg.leak_rate_hz > 0:
        base = subtract_leak_current(noise, base, cfg.leak_rate_hz, delta_time, state.pos_thres,
                                     cfg.leak_jitter_fraction, state.noise_rate_array)

    diff = pack.filtered[p] - base
    diff = torch.where(diff.abs() > 1e-6, diff, 0.0)
    pol = torch.sign(diff)
    c = torch.where(pol > 0, state.pos_thres, 0.0) + torch.where(pol < 0, state.neg_thres, 0.0)
    event_counts = torch.floor(diff.abs() / (c + 1e-9)).to(torch.int32)
    max_cnt = event_counts.amax()  # pre-clip, for saturation stats
    clipped = (event_counts > cfg.max_iters).sum(dtype=torch.int32)
    num_iters = event_counts.amax(dim=(1, 2)).clamp(1, cfg.max_iters)
    nit_f = num_iters.to(torch.float32)
    ts_step = rdiv_true(pack.duration, nit_f)  # [B]

    shot = cfg.shot_noise_rate_hz > 0
    om = off = rand01 = seed = None
    if shot:
        # shot-noise probabilities (reference :161-207)
        shot_factor = (
            (cfg.shot_noise_rate_hz / 2.0) * delta_time / nit_f[:, None, None]
        ) * ((cfg.shot_noise_inten_factor - 1.0) * pack.inten01[p] + 1.0)
        om = 1.0 - shot_factor * state.pos_thres_pre_prob
        off = shot_factor * state.neg_thres_pre_prob
        if internal:
            seed = noise.seeds("shot_seed", b, device)
        else:
            rand01 = noise.uniform("shot", (cfg.max_iters, b, h, w), device)
    args = (event_counts, pol, mem, pack.tr_frames, om, off, rand01, seed, ts_step, num_iters,
            pack.tr > ts_step, pack.tf_base[p])
    kw = dict(num_bins=cfg.num_bins, max_iters=cfg.max_iters, shot=shot, internal_rng=internal)
    if collect:
        masks, ts_all, mem, final = k3.emulator_iters_plain(*args, **kw, collect=True)
        voxel_add = (masks, ts_all, pol)
    else:
        voxel_add, mem, final = iters_fn(*args, **kw)
    n_ev = final.sum(dtype=torch.int32)
    # the memorised value moves by the emitted events (reference :522)
    base = base + pol * final.to(torch.float32) * c
    return base, mem, voxel_add, n_ev, max_cnt, clipped


@torch.no_grad()
def emulate_pack(
    cfg: EmulatorConfig,
    state: EmulatorState | None,
    frames: torch.Tensor,
    t_frames: torch.Tensor,
    noise: Noise | torch.Generator,
    with_stats: bool = False,
    device: torch.device | str | None = None,
):
    """Emulate events for one pack of consecutive frames.

    Args:
      state: the previous ``EmulatorState``, or ``None`` at a sequence start.
      frames: ``[B, N, H, W]`` intensity frames in 0-255 (N >= 2).
      t_frames: ``[B, 2]`` endpoints, ``[B, N]``, or ``[B, N+1]`` (first N
        used) timestamps in seconds.
      noise: the noise source (a ``torch.Generator`` is wrapped in
        ``GeneratorNoise``).
      with_stats: return an ``EmulatorStats`` (with the pre-clip max event
        count) instead of the bare event count.
      device: where to run; the card unless ``"cpu"`` is given.
    Returns ``(voxel [B, H, W, num_bins] normalised, num_events | stats,
    new_state)``; counts are int32 scalars on the device.
    """
    device = resolve_device(device)
    noise = as_noise(noise)
    frames = torch.as_tensor(frames).to(device, torch.float32)
    t_frames = torch.as_tensor(t_frames).to(device, torch.float32)
    state, pack = _prepare_pack(cfg, state, frames, t_frames, noise)
    iters_fn = k3.emulator_iters if cfg.iters_impl == "cuda" else k3.emulator_iters_plain
    internal = _internal_rng(noise, device)

    base, mem, t_prev = state.base_log_frame, state.timestamp_mem, state.t_previous
    voxel = n_events = None
    max_cnts, clipped = [], []
    for p in range(len(pack.filtered)):
        base, mem, voxel_add, n_ev, max_cnt, clip = _pair_step(
            cfg, state, pack, base, mem, t_prev, p, noise, iters_fn, internal)
        t_prev = pack.t_n[p]
        voxel = voxel_add if voxel is None else voxel + voxel_add
        n_events = n_ev if n_events is None else n_events + n_ev
        max_cnts.append(max_cnt)
        clipped.append(clip)

    voxel = event_preprocess(voxel.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).contiguous()
    new_state = state._replace(base_log_frame=base, timestamp_mem=mem, t_previous=t_prev)
    if with_stats:
        second = EmulatorStats(n_events, torch.stack(max_cnts).amax(),
                               torch.stack(clipped).sum(dtype=torch.int32))
    else:
        second = n_events
    return voxel, second, new_state


def _emulate_pack_dense(cfg, state, frames, t_frames, noise):
    """``emulate_pack``'s pair loop with the dense per-iteration records of
    raw-event mode: ``(masks [P,I,B,H,W] bool, ts [P,I,B], pol [P,B,H,W],
    num_events, new_state)`` on the device. The shot uniforms are always
    drawn from ``noise`` (JAX's raw path draws them explicitly), and the loop
    is the plain version: K3 accumulates voxel grids and records no masks."""
    state, pack = _prepare_pack(cfg, state, frames, t_frames, noise)
    base, mem, t_prev = state.base_log_frame, state.timestamp_mem, state.t_previous
    masks, ts, pols, n_events = [], [], [], None
    for p in range(len(pack.filtered)):
        base, mem, (m, ts_all, pol), n_ev, _, _ = _pair_step(
            cfg, state, pack, base, mem, t_prev, p, noise, None, False, collect=True)
        t_prev = pack.t_n[p]
        masks.append(m)
        ts.append(ts_all)
        pols.append(pol)
        n_events = n_ev if n_events is None else n_events + n_ev
    new_state = state._replace(base_log_frame=base, timestamp_mem=mem, t_previous=t_prev)
    return torch.stack(masks), torch.stack(ts), torch.stack(pols), n_events, new_state


@torch.no_grad()
def emulate_pack_raw(
    cfg: EmulatorConfig,
    state: EmulatorState | None,
    frames: torch.Tensor,
    t_frames: torch.Tensor,
    noise: Noise | torch.Generator,
    device: torch.device | str | None = None,
):
    """Raw-event output mode (reference ``output_mode='raw'``, :504-534).

    Arguments as ``emulate_pack``. Returns ``(events [K, 5] float64 numpy,
    num_events, new_state)``, rows ``[t, x, y, p, batch]`` with ``t`` in
    voxel-bin units, sorted by time and then, stably, by batch row (the
    reference's two sorts). The masks go to the host (``[P, I, B, H, W]``
    bool, 12.4 MB for a pack of 10 frames at 180x240, 32 iterations) and the
    events are extracted there.
    """
    device = resolve_device(device)
    noise = as_noise(noise)
    frames = torch.as_tensor(frames).to(device, torch.float32)
    t_frames = torch.as_tensor(t_frames).to(device, torch.float32)
    masks, ts_iter, pols, num_events, new_state = _emulate_pack_dense(
        cfg, state, frames, t_frames, noise)
    masks, ts_iter, pols = masks.cpu().numpy(), ts_iter.cpu().numpy(), pols.cpu().numpy()

    p_idx, i_idx, b_idx, y_idx, x_idx = np.nonzero(masks)
    events = np.stack(
        [ts_iter[p_idx, i_idx, b_idx], x_idx.astype(np.float64), y_idx.astype(np.float64),
         pols[p_idx, b_idx, y_idx, x_idx], b_idx.astype(np.float64)], axis=1,
    )
    events = events[np.argsort(events[:, 0], kind="stable")]
    events = events[np.argsort(events[:, -1], kind="stable")]
    return events, int(num_events), new_state


def bin_raw_events(events: np.ndarray, batch: int, height: int, width: int, num_bins: int,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """Raw-mode events ``[K, 5]`` (``[t, x, y, p, batch]``, t in bin units)
    binned bilinearly in time into the ``[B, H, W, num_bins]`` grid that voxel
    mode accumulates before it normalises: each event adds
    ``p * max(0, 1 - |t - k|)`` to bin ``k`` of its pixel, in float32."""
    ev = torch.as_tensor(np.asarray(events, np.float64)).to(device)
    t = ev[:, 0].to(torch.float32)
    pol = ev[:, 3].to(torch.float32)
    idx = ((ev[:, 4] * height + ev[:, 2]) * width + ev[:, 1]).long()
    grid = torch.zeros((batch * height * width, num_bins), dtype=torch.float32, device=device)
    for k in range(num_bins):
        grid[:, k].index_add_(0, idx, pol * torch.clamp(1.0 - (t - float(k)).abs(), min=0.0))
    return grid.reshape(batch, height, width, num_bins)
