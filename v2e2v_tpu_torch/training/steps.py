"""Train steps (port of the steps of ``v2e2v_tpu/parallel/mesh.py``).

Each ``make_*_train_step`` takes the config and a ``torch.optim`` optimizer over the
weights (``make_adam``) and returns a step that computes the many-to-one loss
on the window's last reconstruction, backpropagates through time with every
reconstruction step rematerialised (``remat=True``, as the JAX steps), and
updates the weights in place.

The JAX steps are ``jit``-compiled over a ``(data, spatial)`` mesh. Each
builder here takes the data axis, ``mesh`` (``parallel/mesh.make_mesh``),
one rank per process: without one, or with a single rank outside a process
group, the step runs on one device as before. Over a process group the
builder broadcasts rank 0's weights once; the per-batch steps take this
rank's rows of the batch (the trainers cut them on the host, so a rank moves
only its bytes), the device-data steps the whole batch's ``idx`` and ``w``,
of which every rank gathers its rows; every random draw is made for the
global batch and cut to the rank's rows (``parallel/mesh.RowsNoise``,
``ops/voxel.add_noise_to_voxel``'s ``rows``), so a rank's rows see the
numbers one process gives them; after the backward one
all-reduce over a flat buffer averages the loss and the gradients (JAX's
``psum``), or sums them where the loss is weighted (a rank divides its
weighted sum by the whole batch's weight), and the V2E2V stats are summed
(``max_event_count`` maxed). Every rank then takes the same Adam step. A
world of one runs the collectives and gives the numbers of no group, bit
for bit.

The E2V steps also take a mesh with a spatial axis (``make_mesh(n_data,
n_spatial)``): each rank holds its rows and its block of columns of every
batch (the per-batch steps take them so, the device-data steps cut them),
its convs exchange halos with its spatial neighbours, and its loss is the
whole image's, gathered over the spatial group. The spatial ranks'
gradients are partial sums over their columns, so the same all-reduce
sums them over the spatial axis while it averages (or, weighted, sums)
over the data axis; the loss, the same on every spatial rank, is counted
once. The V2E2V steps shard the data axis only, as the JAX package's
(``train.py`` builds ``make_mesh(n_data, 1)``).

While ``utils/profiling.enable_nan_debugging`` is on, a step raises
``FloatingPointError`` at the first NaN in its loss (before the backward, so
no rank is left waiting), its gradients or its updated weights.

The half-resolution core trains layer by layer with the plain ISTA loop
(``CistaConfig(ista_impl="plain", core_impl="layers")``, the counterpart of
JAX's default ``ista_impl="xla"``, ``core_impl="xla"``): kernels K1 and K2
have no backward, and refuse to run under autograd. Every random draw (the
emulator's, the device-data noise) is made outside the rematerialised
region, so the recomputation sees the forward's numbers. Forward and
backward run with TF32 off (``_device.float32_math``).

Every builder takes ``lpips_fn`` (``training/lpips.make_lpips_fn``'s, or None)
and adds its distance to the loss, as the JAX builders' ``lpips_fn`` does.
Its VGG16 weights are frozen: not the optimizer's, never broadcast, never
reduced; only the gradient it sends back into the reconstruction counts.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.distributed as dist

from .._device import float32_math
from ..models.cista import CistaConfig, StateDict, cista_sequence
from ..ops.cuda import TRAINING_CONFIG
from ..ops.voxel import add_noise_to_voxel
from ..parallel.mesh import Mesh, RowsNoise
from ..parallel.spatial import Shard
from ..utils.checkpoint import STEP_KEYS
from ..utils.profiling import nan_debugging
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


def _weights(optimizer: torch.optim.Optimizer) -> list[torch.Tensor]:
    return [p for group in optimizer.param_groups for p in group["params"]]


def process_axis(mesh: Mesh | None) -> Mesh | None:
    """The data axis a step reduces over: the mesh when it is a process group
    (a world of one too), None for no mesh or one device. A mesh of several
    devices in one process raises: a step trains one rank's rows per
    process."""
    if mesh is None or (mesh.group is None and len(mesh.devices) == 1):
        return None
    if mesh.group is None:
        raise ValueError(f"a mesh of {len(mesh.devices)} devices in one process: the train "
                         "steps run one process per device (the --dist_* flags)")
    return mesh


def broadcast_weights(optimizer: torch.optim.Optimizer, axis: Mesh) -> None:
    """Rank 0's weights to every rank, as one flat buffer."""
    params = _weights(optimizer)
    with torch.no_grad():
        flat = torch.cat([p.reshape(-1) for p in params])
        dist.broadcast(flat, src=0, group=axis.group)
        for p, t in zip(params, flat.split([p.numel() for p in params])):
            p.copy_(t.view_as(p))


def _reduce_loss_and_grads(optimizer, loss: torch.Tensor, axis: Mesh, summed: bool):
    """One all-reduce of ``[loss, every gradient]`` over the whole group:
    summed over the spatial axis, and summed or averaged over the data axis;
    the loss from spatial index 0 only (every spatial rank holds the same).
    Returns the reduced loss; the gradients are reduced in place."""
    params = [p for p in _weights(optimizer) if p.grad is not None]
    if axis.spatial_rank:
        loss = torch.zeros_like(loss)
    flat = torch.cat([loss.reshape(1).to(torch.float32)] + [p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=axis.group)
    if not summed:
        flat.div_(axis.n_data)
    parts = flat.split([1] + [p.numel() for p in params])
    for p, g in zip(params, parts[1:]):
        p.grad.copy_(g.view_as(p.grad))
    return parts[0].reshape(())


def reduce_stats(stats: dict, axis: Mesh) -> dict:
    """The V2E2V stats over the ranks: events and clipped pixels summed, the
    largest count maxed."""
    sums = torch.stack([stats["num_events"], stats["clipped_pixels"]]).to(torch.int64)
    dist.all_reduce(sums, group=axis.group)
    top = stats["max_event_count"].clone()
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=axis.group)
    return {**stats, "num_events": sums[0].to(stats["num_events"].dtype),
            "clipped_pixels": sums[1].to(stats["clipped_pixels"].dtype),
            "max_event_count": top}


def _raise_on_nan(what: str, tensors, axis: Mesh | None = None) -> None:
    """``FloatingPointError`` if any of ``tensors`` holds a NaN; with ``axis``
    on every rank as soon as one rank's does. Reads one flag from the
    device."""
    bad = torch.stack([t.detach().isnan().any() for t in tensors]).any().to(torch.int32)
    if axis is not None:
        dist.all_reduce(bad, op=dist.ReduceOp.MAX, group=axis.group)
    if bool(bad):
        raise FloatingPointError(f"NaN in {what} (--debug_nans)")


def _update(optimizer: torch.optim.Optimizer, loss_fn: Callable, axis: Mesh | None = None,
            summed: bool = False):
    """Zero the grads, ``loss_fn()`` (a loss, or ``(loss, aux)``), backward,
    with ``axis`` the reduction of the loss and gradients over the ranks
    (``summed``: add the ranks' shares, else average them), optimizer step,
    all with TF32 off. The grads stay in ``.grad``. Under
    ``enable_nan_debugging`` the loss, the gradients and the updated weights
    are checked for NaNs."""
    check = nan_debugging()
    with float32_math():
        optimizer.zero_grad(set_to_none=True)
        out = loss_fn()
        loss, aux = out if isinstance(out, tuple) else (out, None)
        if check:
            _raise_on_nan("the loss", [loss], axis)
        try:
            loss.backward()
        except RuntimeError as e:  # anomaly mode's report of a NaN made by the backward
            if check and "nan values" in str(e):
                raise FloatingPointError(f"NaN in the backward pass (--debug_nans): {e}") from e
            raise
        loss = loss.detach()
        if axis is not None:
            loss = _reduce_loss_and_grads(optimizer, loss, axis, summed)
        if check:
            _raise_on_nan("a gradient", [p.grad for p in _weights(optimizer) if p.grad is not None])
        optimizer.step()
        if check:
            _raise_on_nan("an updated weight", _weights(optimizer))
    return loss, aux


def _setup(cfg: CistaConfig, optimizer: torch.optim.Optimizer, mesh: Mesh | None):
    """Refuse an untrainable config, or a width the spatial axis cannot
    divide, and over a process group broadcast rank 0's weights; returns the
    step's axis (``process_axis``)."""
    check_trainable(cfg)
    if mesh is not None and mesh.n_spatial > 1:
        mesh.col_slice(cfg.image_dim[1])
    axis = process_axis(mesh)
    if axis is not None:
        broadcast_weights(optimizer, axis)
    return axis


def e2v_loss(params: StateDict, cfg: CistaConfig, voxel_seq: torch.Tensor, gt: torch.Tensor,
             sample_weights: torch.Tensor | None = None, remat: bool = True,
             batch_weights: torch.Tensor | None = None,
             shard: Shard | None = None, lpips_fn=None) -> torch.Tensor:
    """The many-to-one loss of ``voxel_seq [T, B, H, W, nb]`` against
    ``gt [B, H, W, 1]`` on the last reconstruction; with ``shard`` ``W`` is
    this rank's block of columns and the loss the whole image's."""
    recs, _ = cista_sequence(params, cfg, voxel_seq, remat=remat, shard=shard)
    return many_to_one_loss(recs[-1], gt, sample_weights, batch_weights, shard, lpips_fn)


def make_e2v_train_step(cfg: CistaConfig, optimizer: torch.optim.Optimizer,
                        mesh: Mesh | None = None, lpips_fn=None):
    """The E2V step: ``step(params, voxel_seq [T, B, H, W, nb], gt [B, H, W, 1])
    -> loss`` (a detached scalar on the device), the weights of ``params``
    (``optimizer``'s) updated in place. Over a process group ``B`` is this
    rank's rows of the global batch (``Mesh.rows``), ``W`` on a spatial axis
    its columns (``Mesh.cols``), and the loss the global batch's."""
    axis = _setup(cfg, optimizer, mesh)
    shard = None if axis is None else axis.shard

    def step(params, voxel_seq, gt):
        return _update(optimizer, lambda: e2v_loss(params, cfg, voxel_seq, gt, shard=shard,
                                                   lpips_fn=lpips_fn), axis)[0]

    return step


def make_e2v_train_step_device_data(cfg: CistaConfig, optimizer: torch.optim.Optimizer,
                                    noise_std: float = 0.0, mesh: Mesh | None = None,
                                    lpips_fn=None):
    """The E2V step over a dataset on the device: ``step(params, data
    [N, T, H, W, nb], gt_all [N, H, W, 1], idx [B], generator, w [B]) -> loss``.
    The batch is gathered by index on the device and cast to float32 (the
    data may be bfloat16); ``noise_std > 0`` adds Gaussian noise to every
    entry (``--add_noise``) from ``generator``; ``w`` is 1.0 for real samples
    and 0.0 for the padding of a tail batch, whose loss it masks. Over a
    process group every rank holds the whole dataset and gathers its rows
    of ``idx``, and on a spatial axis cuts its columns of them."""
    axis = _setup(cfg, optimizer, mesh)
    shard = None if axis is None else axis.shard

    def step(params, data, gt_all, idx, generator, w):
        batch_w, rows_idx = w, idx
        if axis is not None:
            rows_idx, w = axis.rows(idx), axis.rows(w)
        voxel_seq = data.index_select(0, rows_idx).movedim(1, 0)
        gt = gt_all.index_select(0, rows_idx)
        if shard is not None:
            voxel_seq, gt = axis.cols(voxel_seq, 3), axis.cols(gt, 2)
        voxel_seq, gt = voxel_seq.float(), gt.float()
        if noise_std > 0.0:  # the global batch's draw, this rank's rows and columns of it
            voxel_seq = add_noise_to_voxel(
                generator, voxel_seq, noise_std, noise_fraction=1.0,
                rows=None if axis is None else (1, axis.row_slice(len(idx)), len(idx)),
                cols=None if shard is None else (3, axis.col_slice(data.shape[3]),
                                                 data.shape[3]))
        return _update(optimizer, lambda: e2v_loss(params, cfg, voxel_seq, gt, w,
                                                   batch_weights=batch_w, shard=shard,
                                                   lpips_fn=lpips_fn),
                       axis, summed=True)[0]

    return step


def v2e2v_loss(params: StateDict, cfg, frames_seq: torch.Tensor, ts_seq: torch.Tensor,
               gt: torch.Tensor, noise, sample_weights: torch.Tensor | None = None,
               monitor: bool = False, remat: bool = True,
               batch_weights: torch.Tensor | None = None, lpips_fn=None):
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
    loss = many_to_one_loss(rec, gt, sample_weights, batch_weights, lpips_fn=lpips_fn)
    stats = {
        "num_events": st["num_events"].sum(),
        "max_event_count": st["max_event_count"].amax(),
        "clipped_pixels": st["clipped_pixels"].sum(),
    }
    if monitor:
        stats.update(rec=rec.detach(), voxel=voxels[-1])
    return loss, stats


def _refuse_spatial(mesh: Mesh | None) -> None:
    if mesh is not None and mesh.n_spatial > 1:
        raise ValueError(f"the V2E2V steps shard the data axis only (n_spatial="
                         f"{mesh.n_spatial}): the JAX package's V2E2V trainer has no spatial "
                         "axis either (train.py builds make_mesh(n_data, 1))")


def _v2e2v_update(optimizer, loss_fn, axis, summed=False):
    loss, stats = _update(optimizer, loss_fn, axis, summed)
    return loss, (stats if axis is None else reduce_stats(stats, axis))


def make_v2e2v_train_step(cfg, optimizer: torch.optim.Optimizer, monitor: bool = False,
                          mesh: Mesh | None = None, lpips_fn=None):
    """The V2E2V step: ``step(params, frames_seq [T, B, N, H, W], ts_seq
    [T, B, N], gt [B, H, W, 1], noise) -> (loss, stats)`` (see
    ``v2e2v_loss``). The emulator runs outside autograd's graph: on the card
    its iteration loop is kernel K3, once per frame pair. Over a process
    group ``B`` is this rank's rows of the global batch (``Mesh.rows``), the
    loss and stats are the global batch's, and ``noise`` draws for the global
    batch; ``monitor``'s ``rec`` and ``voxel`` are this rank's rows. A mesh
    with a spatial axis raises ``ValueError``."""
    _refuse_spatial(mesh)
    axis = _setup(cfg.cista, optimizer, mesh)

    def step(params, frames_seq, ts_seq, gt, noise):
        if axis is not None:
            batch = frames_seq.shape[1] * axis.n_data
            noise = RowsNoise(noise, axis.row_slice(batch), batch)
        return _v2e2v_update(optimizer, lambda: v2e2v_loss(
            params, cfg, frames_seq, ts_seq, gt, noise, monitor=monitor, lpips_fn=lpips_fn),
            axis)

    return step


def make_v2e2v_train_step_device_data(cfg, optimizer: torch.optim.Optimizer,
                                      mesh: Mesh | None = None, lpips_fn=None):
    """The V2E2V step over a dataset on the device: ``step(params, frames_u8
    [S, T, N, H, W] uint8, ts_all [S, T, N] float32, idx [B], noise, w [B]) ->
    (loss, stats)``. The batch is gathered by index on the device; ``gt`` is
    its last frame / 255 (``TrainSeqData._emit``); ``w`` masks the padding of
    a tail batch. Over a process group every rank holds the whole dataset and
    gathers its rows of ``idx``. A mesh with a spatial axis raises
    ``ValueError``."""
    _refuse_spatial(mesh)
    axis = _setup(cfg.cista, optimizer, mesh)

    def step(params, frames_u8, ts_all, idx, noise, w):
        batch_w = w
        if axis is not None:
            noise = RowsNoise(noise, axis.row_slice(len(idx)), len(idx))
            idx, w = axis.rows(idx), axis.rows(w)
        frames_seq = frames_u8.index_select(0, idx).movedim(1, 0).float()
        ts_seq = ts_all.index_select(0, idx).movedim(1, 0)
        gt = frames_seq[-1][:, -1, :, :, None] / 255.0
        return _v2e2v_update(optimizer, lambda: v2e2v_loss(
            params, cfg, frames_seq, ts_seq, gt, noise, sample_weights=w,
            batch_weights=batch_w, lpips_fn=lpips_fn), axis, summed=True)

    return step
