"""E2V training CLI of the port (port of the root ``train_e2v.py``).

    python -m v2e2v_tpu_torch.cli.train_e2v --path_to_train_data data/ \\
        [the root train_e2v.py's flags]

Trains CISTA-LSTC or (``--model_mode cista-tc``) CISTA-TC on fixed-event-count
sequences (``train_e2v.txt`` under ``--path_to_train_data``): the
many-to-one loss ``LPIPS + L1 + (1 - SSIM)`` on the last reconstruction of
each ``--len_sequence`` window (without LPIPS when ``$V2E2V_LPIPS_WEIGHTS``
names no file, as the JAX trainer; ``training/lpips.py``), Adam with the
learning rate times 0.9 every 10 epochs, a checkpoint per epoch. Checkpoints are the reference's ``.pth.tar``
(``{epoch, state_dict, optimizer}``) at
``--path_to_model/<name>/<name>_<epoch>.pth.tar``, which the port's
evaluation CLIs and the JAX package's ``load_torch_checkpoint`` load, and
``--load_epoch_for_train`` resumes from, the Adam moments included.

It trains float32 (TF32 off) on the CUDA card, and on the CPU only under
``V2E2V_PLATFORM=cpu``. The core runs layer by layer with the plain ISTA
loop (kernels K1 and K2 have no backward).

Over several processes, one per device (the ``--dist_*`` flags, the
``V2E2V_*`` variables, or torchrun with ``V2E2V_DIST_AUTO=1``;
``parallel/distributed.py``), the data axis is ``--mesh_data``, or
``gcd(batch_size, processes / --mesh_spatial)`` when it is 0, and must
equal the number of processes over ``--mesh_spatial``. ``--mesh_spatial
S`` shards the image width over ``S`` ranks (``parallel/spatial.py``): the
processes are ``n_data x S``, rank ``r`` at data index ``r // S`` and
spatial index ``r % S``, and the width must divide into ``2 S`` equal
blocks. Every rank reads
the same batches, takes its rows (and columns) of each on the host and
all-reduces the gradients (``training/steps.py``); batches that the data
axis cannot divide are dropped, counted and reported at the end of each
epoch. With ``--device_data`` every rank holds the whole dataset and
gathers its rows (and columns) of each batch. Rank 0 alone writes checkpoints;
every rank resumes from the same file. ``--profile_dir`` traces the run
with ``torch.profiler`` (one file per rank) and ``--debug_nans`` raises
``FloatingPointError`` at the first NaN in a step (``utils/profiling.py``).
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch

CHECKPOINT_SUFFIX = ".pth.tar"


def check_train_flags(cfgs) -> None:
    """Raise on ``--device_data`` without ``--drop_seq_tails``, as the JAX
    CLIs do."""
    if cfgs.device_data != "off" and not cfgs.drop_seq_tails:
        raise SystemExit("--device_data requires --drop_seq_tails (uniform [T, ...] sample "
                         "shapes)")


def check_flags(cfgs) -> None:
    if cfgs.model_mode not in ("cista-lstc", "cista-tc"):
        raise ValueError(f"--model_mode must be cista-lstc or cista-tc, got {cfgs.model_mode!r}")
    check_train_flags(cfgs)


def lpips_for_training(device: torch.device):
    """The trainers' LPIPS on ``device`` (``training/lpips.make_lpips_fn``), or
    None, said as the JAX trainers say it."""
    from ..training.lpips import make_lpips_fn

    lpips_fn = make_lpips_fn(device=device)
    if lpips_fn is None:
        print("LPIPS weights unavailable; training with L1 + (1 - SSIM) only")
    return lpips_fn


def epoch_summary(epoch: int, seconds: float, losses: list[float]) -> str:
    return (f"epoch {epoch + 1} done in {seconds:.1f}s, mean loss "
            f"{sum(losses) / max(len(losses), 1):.5f}")


def data_axis(cfgs, device: torch.device):
    """The trainers' mesh: ``--mesh_data``, or when it is 0
    ``gcd(batch_size, processes // --mesh_spatial)`` (``train_e2v.py``'s
    rule), by ``--mesh_spatial``; one process takes ``--mesh_data 1`` and
    ``--mesh_spatial 1`` only."""
    from ..parallel.distributed import world_size
    from ..parallel.mesh import make_mesh

    spatial = max(cfgs.mesh_spatial, 1)
    n_data = (cfgs.mesh_data if cfgs.mesh_data > 0
              else math.gcd(cfgs.batch_size, world_size() // spatial))
    return make_mesh(n_data, spatial, devices=[device])


def drop_unshardable(batches, n_data: int, dropped: dict):
    """The batches whose rows divide over the data axis; the others are
    counted in ``dropped`` (``batches``, ``samples``)."""
    for batch in batches:
        if batch[0].shape[0] % n_data == 0:
            yield batch
        else:
            dropped["batches"] += 1
            dropped["samples"] += batch[0].shape[0]


def dropped_warning(dropped: dict, n_data: int) -> str:
    return (f"warning: dropped {dropped['batches']} tail batch(es) ({dropped['samples']} "
            f"samples) not divisible by the data-mesh axis ({n_data}); use a divisible "
            "batch_size to avoid this")


def save_on_rank0(save, *args) -> None:
    """Rank 0 writes; every rank waits until it has."""
    from ..parallel.distributed import barrier, is_main_process

    if is_main_process():
        save(*args)
    barrier()


def tail_padded(chunk: np.ndarray, bsz: int) -> tuple[np.ndarray, np.ndarray]:
    """A batch of indices padded to ``bsz`` with its first index, and its
    weights: 1.0 for the real samples, 0.0 for the padding."""
    w = np.ones(bsz, np.float32)
    if len(chunk) < bsz:
        w[len(chunk):] = 0.0
        chunk = np.concatenate([chunk, np.full(bsz - len(chunk), chunk[0], chunk.dtype)])
    return chunk, w


class Train:
    """The root CLI's ``Train`` on the port. ``device`` None means the card
    (raising without one)."""

    def __init__(self, cfgs, device: torch.device | str | None = None):
        from .._device import resolve_device
        from ..data.datasets import TrainFixNEventData
        from ..models.cista import CistaConfig, init_cista_lstc, init_cista_tc, tie_weights
        from ..training.steps import (
            lr_for_epoch,
            make_adam,
            make_e2v_train_step,
            make_e2v_train_step_device_data,
        )
        from ..utils.checkpoint import checkpoint_name, load_optimizer_state, load_torch_checkpoint

        check_flags(cfgs)
        self.cfgs = cfgs
        self.device = resolve_device(device)
        self.mesh = data_axis(cfgs, self.device)
        self.model_name = checkpoint_name(cfgs)
        self.path_to_model = os.path.join(cfgs.path_to_model, self.model_name)
        os.makedirs(self.path_to_model, exist_ok=True)

        self.cfg = CistaConfig(
            image_dim=tuple(cfgs.image_dim),
            base_channels=cfgs.base_channels,
            depth=cfgs.depth,
            num_bins=cfgs.num_bins,
            model_mode=cfgs.model_mode,
            ista_impl="plain",
            core_impl="layers",
        )
        resume = None
        if cfgs.load_epoch_for_train:
            resume = self.checkpoint_path(cfgs.load_epoch_for_train)
            sd, _, _ = load_torch_checkpoint(resume, cfgs.model_mode)
            params = {k: v.to(self.device) for k, v in sd.items()}
        else:
            init_fn = init_cista_lstc if cfgs.model_mode == "cista-lstc" else init_cista_tc
            params = init_fn(torch.Generator().manual_seed(cfgs.seed), self.cfg, self.device)
        self.params = tie_weights(params, self.cfg)

        self.train_data = TrainFixNEventData(
            os.path.join(cfgs.path_to_train_data, "train_e2v.txt"), cfgs
        )
        print(f"training sequences: {len(self.train_data)}")

        self.lr_for_epoch = lambda e: lr_for_epoch(cfgs.lr, e)
        self.optimizer = make_adam(self.params, self.cfg, self.lr_for_epoch(cfgs.load_epoch_for_train))
        if resume is not None:
            # a true resume: the Adam moments survive (the reference resets them)
            opt_state = load_optimizer_state(resume)
            if opt_state is not None:
                self.optimizer.load_state_dict(opt_state)
        self.lpips_fn = lpips_for_training(self.device)
        if cfgs.device_data != "off":
            self.train_step = make_e2v_train_step_device_data(
                self.cfg, self.optimizer, noise_std=0.1 if cfgs.add_noise else 0.0,
                mesh=self.mesh, lpips_fn=self.lpips_fn)
        else:
            # each batch's rows are taken on the host (run's to_device_layout)
            self.train_step = make_e2v_train_step(self.cfg, self.optimizer, mesh=self.mesh,
                                                  lpips_fn=self.lpips_fn)

    def checkpoint_path(self, epoch: int) -> str:
        return os.path.join(self.path_to_model,
                            f"{self.model_name}_{epoch}{CHECKPOINT_SUFFIX}")

    def save(self, epoch: int) -> None:
        from ..utils.checkpoint import save_checkpoint

        save_on_rank0(save_checkpoint, self.checkpoint_path(epoch + 1), self.params, epoch,
                      self.optimizer)

    def _upload_dataset(self):
        """--device_data: the whole uniform-shape training set on the device
        once, float32 or bfloat16 (cast on the host, so only the final bytes
        move)."""
        cfgs = self.cfgs
        dtype = torch.bfloat16 if cfgs.device_data == "bf16" else torch.float32
        ds = self.train_data
        seqs, gts = [], []
        for i in range(len(ds)):
            seq_events, _img, gt = ds._load_cacheable(i)
            seqs.append(seq_events.astype(np.float32))
            gts.append(gt)
        data = torch.from_numpy(np.stack(seqs, 0)).to(dtype)  # [N, T, H, W, nb]
        gt_all = torch.from_numpy(np.stack(gts, 0)).to(dtype)  # [N, H, W, 1]
        gbytes = data.numel() * data.element_size() / 2**30
        print(f"uploading dataset to device: {tuple(data.shape)} {cfgs.device_data} "
              f"({gbytes:.1f} GiB)")
        return data.to(self.device), gt_all.to(self.device)

    def _run_device_data(self, logger):
        """The epoch loop over the dataset on the device: per step the host
        sends only the batch's indices."""
        from ..training.steps import set_lr
        from .test import sequence_seed

        cfgs = self.cfgs
        data_dev, gt_dev = self._upload_dataset()
        n = len(self.train_data)
        bsz = cfgs.batch_size
        if n % bsz:
            print(f"note: final {n % bsz}-sample batch each epoch is padded "
                  f"to batch_size and loss-masked (n={n}, batch_size={bsz})")
        step_idx = 0
        for epoch in range(cfgs.load_epoch_for_train, cfgs.epochs):
            lr = float(self.lr_for_epoch(epoch))
            set_lr(self.optimizer, lr)
            print(f"lr: {lr}")
            t_epoch = time.time()
            order = np.arange(n)
            if cfgs.shuffle:
                np.random.default_rng(cfgs.seed + epoch).shuffle(order)
            losses = []
            for start in range(0, n, bsz):
                chunk, w = tail_padded(order[start:start + bsz].astype(np.int64), bsz)
                # noise from (epoch, batch in epoch): a resumed run continues the stream
                gen = torch.Generator(device=self.device).manual_seed(
                    sequence_seed(cfgs.seed + 17, epoch, len(losses)))
                loss = float(self.train_step(
                    self.params, data_dev, gt_dev, torch.from_numpy(chunk).to(self.device), gen,
                    torch.from_numpy(w).to(self.device)))
                if len(losses) % 50 == 0:
                    print(f"Train Epoch: {epoch + 1} [{len(losses) * bsz}/{n}]"
                          f"\tloss: {loss:.6f}")
                    logger.scalar("loss", loss, step_idx)
                losses.append(loss)
                step_idx += 1
            print(epoch_summary(epoch, time.time() - t_epoch, losses))
            logger.scalar("epoch_mean_loss", sum(losses) / max(len(losses), 1), epoch)
            self.save(epoch)
        logger.close()

    def run(self):
        from ..data.datasets import SampleLoader, iterate_batches
        from ..data.prefetch import device_prefetch
        from ..parallel.distributed import is_main_process
        from ..training.steps import set_lr
        from ..utils.logging import ScalarLogger

        cfgs = self.cfgs
        logger = ScalarLogger(os.path.join("summary", self.model_name),
                              enabled=cfgs.is_SummaryWriter and is_main_process())
        if cfgs.device_data != "off":
            self._run_device_data(logger)
            return
        # the persistent spawn-worker pool, reused across epochs
        loader = SampleLoader(self.train_data, cfgs.num_workers) if cfgs.num_workers > 0 else None

        rows, cols = self.mesh.rows, self.mesh.cols

        def to_device_layout(batch):
            seq_events, _img, gt = batch  # [B, T, H, W, nb], ..., [B, H, W, 1]
            # this rank's rows and columns only move to the device:
            # [T, B / n_data, H, W / n_spatial, nb]
            return cols(rows(np.moveaxis(seq_events, 1, 0), 1), 3), cols(rows(gt, 0), 2)

        n_data = self.mesh.n_data
        dropped = {"batches": 0, "samples": 0}
        step_idx = 0
        try:
            for epoch in range(cfgs.load_epoch_for_train, cfgs.epochs):
                lr = float(self.lr_for_epoch(epoch))
                set_lr(self.optimizer, lr)
                print(f"lr: {lr}")
                self.train_data.epoch = epoch  # salts the per-epoch noise draws
                t_epoch = time.time()
                losses = []
                # the host pipeline in a thread, each batch on the device one step early
                for voxel_seq, gt in device_prefetch(
                    drop_unshardable(iterate_batches(self.train_data, cfgs.batch_size,
                                                     cfgs.shuffle, seed=cfgs.seed + epoch,
                                                     loader=loader), n_data, dropped),
                    transform=to_device_layout, device=self.device,
                ):
                    loss = float(self.train_step(self.params, voxel_seq, gt))
                    if len(losses) % 50 == 0:
                        print(f"Train Epoch: {epoch + 1} [{len(losses) * cfgs.batch_size}/"
                              f"{len(self.train_data)}]\tloss: {loss:.6f}")
                        logger.scalar("loss", loss, step_idx)
                    losses.append(loss)
                    step_idx += 1
                print(epoch_summary(epoch, time.time() - t_epoch, losses))
                if dropped["batches"]:
                    print(dropped_warning(dropped, n_data))
                    dropped["batches"] = dropped["samples"] = 0
                logger.scalar("epoch_mean_loss", sum(losses) / max(len(losses), 1), epoch)
                self.save(epoch)
        finally:
            if loader is not None:
                loader.close()
            logger.close()


def parse_flags(argv: list[str] | None, description: str):
    """The reference flag surface, with shuffling always on, as the JAX
    training CLIs set it."""
    from ..utils.configs import set_configs

    parser = argparse.ArgumentParser(description=description)
    set_configs(parser)
    cfgs = parser.parse_args(argv)
    cfgs.shuffle = True
    return cfgs


def run_training(cfgs, train_cls) -> None:
    """The JAX trainers' entry order: the device (``V2E2V_PLATFORM``), the
    process group, NaN debugging under ``--debug_nans``, then the run inside
    ``maybe_profile(--profile_dir)``; on exit the group is torn down and NaN
    debugging turned off. The train steps turn TF32 off around their own
    work (``_device.float32_math``)."""
    from ..parallel.distributed import initialize_from_flags, shutdown
    from ..utils.profiling import apply_platform_override, enable_nan_debugging, maybe_profile

    device = apply_platform_override()
    initialize_from_flags(cfgs)
    try:
        if cfgs.debug_nans:
            enable_nan_debugging()
        with maybe_profile(cfgs.profile_dir, device):
            train_cls(cfgs, device).run()
    finally:
        if cfgs.debug_nans:
            enable_nan_debugging(False)
        shutdown()


def main(argv: list[str] | None = None) -> None:
    cfgs = parse_flags(argv, "E2V training options")
    check_flags(cfgs)
    run_training(cfgs, Train)


if __name__ == "__main__":
    main()
