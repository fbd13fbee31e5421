"""V2E2V composite: HFR frames -> emulated event voxel grids -> CISTA-LSTC
reconstruction (port of ``v2e2v_tpu/models/v2e2v.py``).

The reference composite (``model_v2e2v.py``) owns an event emulator in
voxel-grid mode with hardcoded ``leak_rate_hz=0.1`` and
``shot_noise_rate_hz=1`` (:56-57) and a ``CistaLSTCNet`` (:61); the emulator
is reset whenever the sequence changes (:64-69). Here a sequence change is
``state=None``; the caller tracks sequence ids. The emulator's iteration
loop runs as kernel K3 and the ISTA loop as kernel K1 on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from .._device import resolve_device
from ..ops.cuda import emulator_iters as k3
from .cista import (
    CistaConfig,
    CistaState,
    StateDict,
    cista_lstc_step,
    cista_zero_state,
    remat_step,
    with_derived,
)
from .emulator import (
    EmulatorConfig,
    EmulatorState,
    EmulatorStats,
    Noise,
    as_noise,
    emulate_pack,
    emulator_init_from_pack,
)

# the JAX flag surface names the emulator's loop backends after XLA and Pallas;
# its 'auto' picks between two TPU lowerings, and on the card means K3
_ITERS_IMPL_FLAGS = {"xla": "plain", "pallas": "cuda", "auto": "cuda"}


@dataclass(frozen=True)
class V2E2VConfig:
    cista: CistaConfig
    emulator: EmulatorConfig

    @staticmethod
    def from_flags(cfgs) -> "V2E2VConfig":
        """Build from a reference-compatible flag namespace (the JAX package's
        ``utils/configs.py``), with the composite's hardcoded emulator noise
        settings (``model_v2e2v.py:56-57``). ``v2e_iters_impl`` defaults to
        'auto'; the JAX names 'auto' and 'pallas' mean 'cuda' (K3 for CUDA
        tensors) and 'xla' means 'plain'. ``--num_bins`` above K3's limit
        (``ops/cuda/emulator_iters.MAX_BINS``) is refused here, before any
        work, not at the first pack."""
        if cfgs.num_bins > k3.MAX_BINS:
            raise ValueError(
                f"--num_bins {cfgs.num_bins}: the emulator's iteration kernel K3 keeps the bins "
                f"in registers and takes at most {k3.MAX_BINS} (csrc/emulator_iters.cu)"
            )
        iters_impl = getattr(cfgs, "v2e_iters_impl", "auto")
        cista = CistaConfig(
            image_dim=tuple(cfgs.image_dim),
            base_channels=cfgs.base_channels,
            depth=cfgs.depth,
            num_bins=cfgs.num_bins,
            model_mode="cista-lstc",
        )
        emulator = EmulatorConfig(
            output_mode=cfgs.event_mode,
            num_bins=cfgs.num_bins,
            pl=cfgs.pl,
            ps=cfgs.ps,
            ql=cfgs.ql,
            qs=cfgs.qs,
            pos_thres=cfgs.C,
            neg_thres=cfgs.C,
            sigma_thres=cfgs.threshold_sigma,
            cutoff_hz=cfgs.cutoff_hz,
            refractory_period_s=cfgs.refractory_period_s,
            leak_rate_hz=0.1,
            shot_noise_rate_hz=1.0,
            max_iters=getattr(cfgs, "v2e_max_iters", 32),
            iters_impl=_ITERS_IMPL_FLAGS.get(iters_impl, iters_impl),
        )
        return V2E2VConfig(cista=cista, emulator=emulator)


class V2E2VState(NamedTuple):
    emulator: EmulatorState
    cista: CistaState
    prev_image: torch.Tensor  # [B, H, W, 1]


class V2E2VOutput(NamedTuple):
    reconstruction: torch.Tensor  # [B, H, W, 1]
    event_voxel_grids: torch.Tensor  # [B, H, W, num_bins] (monitoring)
    num_events: torch.Tensor  # int32 scalar
    stats: EmulatorStats | None = None  # with_stats: saturation diagnostics


def v2e2v_forward(
    params: StateDict,
    cfg: V2E2VConfig,
    frames: torch.Tensor,
    timestamps: torch.Tensor,
    state: V2E2VState | None,
    noise: Noise | torch.Generator,
    with_stats: bool = False,
    device: torch.device | str | None = None,
    remat: bool = False,
) -> tuple[V2E2VOutput, V2E2VState]:
    """One V2E2V step: a pack of frames -> one reconstruction.

    Args:
      params: CISTA-LSTC weights on the device (``init_cista_lstc``).
      frames: ``[B, N, H, W]`` HFR intensity frames (0-255).
      timestamps: ``[B, 2]``, ``[B, N]`` or ``[B, N+1]`` seconds.
      state: the previous state, or ``None`` at a sequence start.
      noise: the emulator's noise source (or a ``torch.Generator``).
      with_stats: also return ``EmulatorStats`` in ``output.stats``.
      device: where to run; the card unless ``"cpu"`` is given.
      remat: rematerialise the reconstruction step on the backward pass
        (``models/cista.remat_step``). The emulator runs outside autograd's
        graph (``emulate_pack`` is ``torch.no_grad``, JAX's
        ``stop_gradient``) and outside the rematerialised region, so its
        random draws are made once.
    """
    device = resolve_device(device)
    b, _, h, w = frames.shape
    voxel, second, emu_state = emulate_pack(
        cfg.emulator, None if state is None else state.emulator, frames, timestamps, noise,
        with_stats=with_stats, device=device,
    )
    stats = second if with_stats else None
    num_events = second.num_events if with_stats else second

    if state is not None:
        prev_image, cista_state = state.prev_image, state.cista
    else:
        prev_image = torch.zeros((b, h, w, 1), dtype=voxel.dtype, device=device)
        cista_state = cista_zero_state(cfg.cista, b, voxel.dtype, device)

    if remat:
        rec, cista_state = remat_step(cista_lstc_step, params, cfg.cista, voxel, prev_image,
                                      cista_state)
    else:
        rec, cista_state = cista_lstc_step(params, cfg.cista, voxel, prev_image, cista_state)
    new_state = V2E2VState(emulator=emu_state, cista=cista_state, prev_image=rec)
    return V2E2VOutput(rec, voxel, num_events, stats), new_state


def v2e2v_init_state(
    cfg: V2E2VConfig,
    frames: torch.Tensor,
    t_frames: torch.Tensor,
    noise: Noise | torch.Generator,
    device: torch.device | str | None = None,
) -> V2E2VState:
    """A fresh sequence-start state built from the first pack (the reference's
    ``reset_v2e`` and first-pack ``_init``)."""
    device = resolve_device(device)
    b, _, h, w = frames.shape
    return V2E2VState(
        emulator=emulator_init_from_pack(cfg.emulator, frames, t_frames, noise, device),
        cista=cista_zero_state(cfg.cista, b, torch.float32, device),
        prev_image=torch.zeros((b, h, w, 1), dtype=torch.float32, device=device),
    )


def v2e2v_sequence(
    params: StateDict,
    cfg: V2E2VConfig,
    frames_seq: torch.Tensor,
    ts_seq: torch.Tensor,
    noise: Noise | torch.Generator,
    state: V2E2VState | None = None,
    with_monitor: bool = False,
    with_stats: bool = False,
    remat: bool = False,
    device: torch.device | str | None = None,
) -> Any:
    """Roll the composite over ``T`` packs, one ``v2e2v_forward`` each.

    Args:
      frames_seq: ``[T, B, N, H, W]`` packs of HFR frames.
      ts_seq: ``[T, B, N]`` per-pack timestamps (seconds).
      noise: the emulator's noise source (or a ``torch.Generator``).
      state: the state to continue from; ``None`` starts a sequence.
      with_monitor: also stack the per-pack voxel grids ``[T, B, H, W, nb]``.
      with_stats: also return per-pack emulator saturation scalars
        (``{"num_events", "max_event_count", "clipped_pixels"}``, each ``[T]``).
      remat: rematerialise each pack's reconstruction step on the backward
        pass (see ``v2e2v_forward``); the values and gradients are the same.
    The kernels the reconstruction step derives from the weights
    (``models/cista.with_derived``) are made once, ahead of the packs.
    Returns ``(recs [T, B, H, W, 1], final_state)``; with ``with_stats``,
    ``(recs, final_state, stats_dict)``; with ``with_monitor``,
    ``(recs, final_state, (voxels, stats_dict))``.
    """
    device = resolve_device(device)
    noise = as_noise(noise)
    if state is None:
        state = v2e2v_init_state(cfg, frames_seq[0], ts_seq[0], noise, device)
    params = with_derived(params, cfg.cista, torch.float32)

    collect = with_monitor or with_stats
    recs, voxels, stats = [], [], []
    for frames, ts in zip(frames_seq, ts_seq):
        out, state = v2e2v_forward(params, cfg, frames, ts, state, noise, with_stats=collect,
                                   device=device, remat=remat)
        recs.append(out.reconstruction)
        if with_monitor:
            voxels.append(out.event_voxel_grids)
        if collect:
            stats.append(out.stats)
    recs = torch.stack(recs)
    if not collect:
        return recs, state
    stats_dict = {name: torch.stack([getattr(s, name) for s in stats])
                  for name in EmulatorStats._fields}
    if with_monitor:
        return recs, state, (torch.stack(voxels), stats_dict)
    return recs, state, stats_dict
