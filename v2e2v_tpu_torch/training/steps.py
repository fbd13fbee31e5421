"""Train steps (port of the steps of ``v2e2v_tpu/parallel/mesh.py``).

Each ``make_*_train_step`` takes the config and a ``torch.optim`` optimizer over the
weights (``make_adam``) and returns a step that computes the many-to-one loss
on the window's last reconstruction, backpropagates through time with every
reconstruction step rematerialised (``remat=True``, as the JAX steps), and
updates the weights in place. The JAX steps are ``jit``-compiled over a
``(data, spatial)`` mesh; the port's run on one device (ROADMAP.md queue 1,
item 9 brings more).

The half-resolution core trains layer by layer with the plain ISTA loop
(``CistaConfig(ista_impl="plain", core_impl="layers")``, the counterpart of
JAX's default ``ista_impl="xla"``, ``core_impl="xla"``): kernels K1 and K2
have no backward, and refuse to run under autograd. Every random draw (the
emulator's, the device-data noise) is made outside the rematerialised
region, so the recomputation sees the forward's numbers. Forward and
backward run with TF32 off (``_device.float32_math``).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from .._device import float32_math
from ..models.cista import CistaConfig, StateDict, cista_sequence
from ..ops.cuda import TRAINING_CONFIG
from ..ops.voxel import add_noise_to_voxel
from ..utils.checkpoint import STEP_KEYS
from .losses import many_to_one_loss

CLAMP = (1e-7, 1.0 - 1e-7)  # the V2E2V trainer's output clamp (reference train.py)


def check_trainable(cfg: CistaConfig) -> None:
    """Refuse a config whose ISTA loop or core names a CUDA kernel: K1 and K2
    have no backward."""
    if cfg.ista_impl == "cuda" or cfg.core_impl == "cuda":
        raise ValueError(
            f"ista_impl={cfg.ista_impl!r}, core_impl={cfg.core_impl!r} name a CUDA kernel "
            f"without a backward: train with {TRAINING_CONFIG}"
        )


def trainable_params(params: StateDict, cfg: CistaConfig) -> list[torch.Tensor]:
    """The tensors a step reads, each once (the tied ISTA block and ``alpha``
    under index 0), in the order of ``utils/checkpoint.STEP_KEYS``, marked as
    requiring grad. Pass ``models/cista.tie_weights(params, cfg)`` so every
    ``depth`` name of a tied tensor is the trained one."""
    tensors = [params[k] for k in STEP_KEYS[cfg.model_mode]]
    if len({id(t) for t in tensors}) != len(tensors):
        raise ValueError("two step keys name one tensor")
    for t in tensors:
        if not t.is_leaf:
            raise ValueError("the weights must be leaf tensors")
        t.requires_grad_(True)
    return tensors


def make_adam(params: StateDict, cfg: CistaConfig, lr: float) -> torch.optim.Adam:
    """``torch.optim.Adam`` over ``trainable_params``: the update of optax's
    ``adam`` (betas 0.9 and 0.999, eps 1e-8 outside the square root)."""
    return torch.optim.Adam(trainable_params(params, cfg), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def lr_for_epoch(lr: float, epoch: int) -> float:
    """The reference's schedule: ``lr * 0.9 ** floor(epoch / 10)``
    (``train_e2v.py:75``), set once per epoch."""
    return lr * 0.9 ** math.floor(epoch / 10.0)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def _update(optimizer: torch.optim.Optimizer, loss_fn: Callable):
    """Zero the grads, ``loss_fn()`` (a loss, or ``(loss, aux)``), backward,
    optimizer step, all with TF32 off. The grads stay in ``.grad``."""
    with float32_math():
        optimizer.zero_grad(set_to_none=True)
        out = loss_fn()
        loss, aux = out if isinstance(out, tuple) else (out, None)
        loss.backward()
        optimizer.step()
    return loss.detach(), aux


def e2v_loss(params: StateDict, cfg: CistaConfig, voxel_seq: torch.Tensor, gt: torch.Tensor,
             sample_weights: torch.Tensor | None = None, remat: bool = True) -> torch.Tensor:
    """The many-to-one loss of ``voxel_seq [T, B, H, W, nb]`` against
    ``gt [B, H, W, 1]`` on the last reconstruction."""
    recs, _ = cista_sequence(params, cfg, voxel_seq, remat=remat)
    return many_to_one_loss(recs[-1], gt, sample_weights)


def make_e2v_train_step(cfg: CistaConfig, optimizer: torch.optim.Optimizer):
    """The E2V step: ``step(params, voxel_seq [T, B, H, W, nb], gt [B, H, W, 1])
    -> loss`` (a detached scalar on the device), the weights of ``params``
    (``optimizer``'s) updated in place."""
    check_trainable(cfg)

    def step(params, voxel_seq, gt):
        return _update(optimizer, lambda: e2v_loss(params, cfg, voxel_seq, gt))[0]

    return step


def make_e2v_train_step_device_data(cfg: CistaConfig, optimizer: torch.optim.Optimizer,
                                    noise_std: float = 0.0):
    """The E2V step over a dataset on the device: ``step(params, data
    [N, T, H, W, nb], gt_all [N, H, W, 1], idx [B], generator, w [B]) -> loss``.
    The batch is gathered by index on the device and cast to float32 (the
    data may be bfloat16); ``noise_std > 0`` adds Gaussian noise to every
    entry (``--add_noise``) from ``generator``; ``w`` is 1.0 for real samples
    and 0.0 for the padding of a tail batch, whose loss it masks."""
    check_trainable(cfg)

    def step(params, data, gt_all, idx, generator, w):
        voxel_seq = data.index_select(0, idx).movedim(1, 0).float()
        gt = gt_all.index_select(0, idx).float()
        if noise_std > 0.0:
            voxel_seq = add_noise_to_voxel(generator, voxel_seq, noise_std, noise_fraction=1.0)
        return _update(optimizer, lambda: e2v_loss(params, cfg, voxel_seq, gt, w))[0]

    return step


def v2e2v_loss(params: StateDict, cfg, frames_seq: torch.Tensor, ts_seq: torch.Tensor,
               gt: torch.Tensor, noise, sample_weights: torch.Tensor | None = None,
               monitor: bool = False, remat: bool = True):
    """The V2E2V many-to-one loss and the window's emulator stats.

    ``frames_seq [T, B, N, H, W]`` (0-255) and ``ts_seq [T, B, N]`` run through
    ``v2e2v_sequence`` from a fresh state on ``gt``'s device, the emulator's
    draws from ``noise``; the last reconstruction is clamped to ``CLAMP``.
    Returns ``(loss, stats)``, ``stats`` the window's ``num_events`` (sum),
    ``max_event_count`` (max, before the ``max_iters`` clip) and
    ``clipped_pixels`` (sum), with ``monitor`` also the clamped ``rec`` and
    the last pack's ``voxel`` (detached)."""
    from ..models.v2e2v import v2e2v_sequence

    device = gt.device
    if monitor:
        recs, _, (voxels, st) = v2e2v_sequence(params, cfg, frames_seq, ts_seq, noise,
                                               with_monitor=True, remat=remat, device=device)
    else:
        recs, _, st = v2e2v_sequence(params, cfg, frames_seq, ts_seq, noise, with_stats=True,
                                     remat=remat, device=device)
    rec = torch.clamp(recs[-1], *CLAMP)
    loss = many_to_one_loss(rec, gt, sample_weights)
    stats = {
        "num_events": st["num_events"].sum(),
        "max_event_count": st["max_event_count"].amax(),
        "clipped_pixels": st["clipped_pixels"].sum(),
    }
    if monitor:
        stats.update(rec=rec.detach(), voxel=voxels[-1])
    return loss, stats


def make_v2e2v_train_step(cfg, optimizer: torch.optim.Optimizer, monitor: bool = False):
    """The V2E2V step: ``step(params, frames_seq [T, B, N, H, W], ts_seq
    [T, B, N], gt [B, H, W, 1], noise) -> (loss, stats)`` (see
    ``v2e2v_loss``). The emulator runs outside autograd's graph: on the card
    its iteration loop is kernel K3, once per frame pair."""
    check_trainable(cfg.cista)

    def step(params, frames_seq, ts_seq, gt, noise):
        return _update(optimizer, lambda: v2e2v_loss(
            params, cfg, frames_seq, ts_seq, gt, noise, monitor=monitor))

    return step


def make_v2e2v_train_step_device_data(cfg, optimizer: torch.optim.Optimizer):
    """The V2E2V step over a dataset on the device: ``step(params, frames_u8
    [S, T, N, H, W] uint8, ts_all [S, T, N] float32, idx [B], noise, w [B]) ->
    (loss, stats)``. The batch is gathered by index on the device; ``gt`` is
    its last frame / 255 (``TrainSeqData._emit``); ``w`` masks the padding of
    a tail batch."""
    check_trainable(cfg.cista)

    def step(params, frames_u8, ts_all, idx, noise, w):
        frames_seq = frames_u8.index_select(0, idx).movedim(1, 0).float()
        ts_seq = ts_all.index_select(0, idx).movedim(1, 0)
        gt = frames_seq[-1][:, -1, :, :, None] / 255.0
        return _update(optimizer, lambda: v2e2v_loss(
            params, cfg, frames_seq, ts_seq, gt, noise, sample_weights=w))

    return step
