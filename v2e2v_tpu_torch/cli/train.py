"""V2E2V training CLI of the port (port of the root ``train.py``).

    python -m v2e2v_tpu_torch.cli.train --path_to_train_data frames/ \\
        --path_to_e2v e2v.pth.tar [the root train.py's flags]

Events are emulated on the fly from HFR frame packs (``train_v2e2v.txt``
under ``--path_to_train_data``); CISTA-LSTC trains many-to-one over
``--len_sequence`` packs, its last reconstruction clamped to
``(1e-7, 1 - 1e-7)``, with ``LPIPS + L1 + (1 - SSIM)`` (LPIPS where its
weights are there) and Adam as in ``cli/train_e2v.py``. A fresh run
warm-starts from the ``--path_to_e2v`` ``.pth.tar``. Each epoch writes
``<name>_<epoch>.pth.tar`` with the weights under the composite's ``e2v_net.`` prefix, the Adam state and ``v2e_params``,
from which the port's ``cli/test.py`` rebuilds the emulator.

The emulator runs outside autograd's graph; on the card its iteration loop is
kernel K3, once per frame pair, its shot-noise uniforms made by K3's Philox
from a generator seeded by ``(--seed, step)``. It trains float32 (TF32 off)
on the CUDA card, and on the CPU only under ``V2E2V_PLATFORM=cpu``. Runs over
several processes, ``--profile_dir`` and ``--debug_nans`` work as in
``cli/train_e2v.py``: each rank emulates its rows of every batch from the
global batch's draws (K3 in every rank), and batches the data axis cannot
divide are dropped and reported. ``--mesh_spatial`` above 1 raises: the
V2E2V trainer shards the data axis only, as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from .test import CHECKPOINT_SUFFIXES, V2E_PARAMS, sequence_seed
from .train_e2v import (
    CHECKPOINT_SUFFIX,
    check_train_flags,
    data_axis,
    drop_unshardable,
    dropped_warning,
    epoch_summary,
    lpips_for_training,
    parse_flags,
    run_training,
    save_on_rank0,
    tail_padded,
)


def check_flags(cfgs) -> None:
    if cfgs.model_mode != "cista-lstc":
        raise ValueError(f"--model_mode {cfgs.model_mode}: the V2E2V composite reconstructs "
                         "with cista-lstc")
    if cfgs.mesh_spatial > 1:
        raise ValueError(f"--mesh_spatial {cfgs.mesh_spatial}: the V2E2V trainer shards the "
                         "data axis only; the JAX package's V2E2V trainer has no spatial axis "
                         "either (train.py builds make_mesh(n_data, 1)); cli.train_e2v "
                         "shards the width")
    check_train_flags(cfgs)
    if cfgs.device_data != "off" and cfgs.display_train:
        raise SystemExit("--device_data does not support --display_train (no per-pack voxels "
                         "on the host)")


class Train:
    """The root CLI's ``Train`` on the port. ``device`` None means the card
    (raising without one)."""

    def __init__(self, cfgs, device: torch.device | str | None = None):
        from .._device import resolve_device
        from ..data.datasets import TrainSeqData
        from ..models.cista import init_cista_lstc, tie_weights
        from ..models.v2e2v import V2E2VConfig
        from ..training.steps import (
            lr_for_epoch,
            make_adam,
            make_v2e2v_train_step,
            make_v2e2v_train_step_device_data,
        )
        from ..utils.checkpoint import (
            load_optimizer_state,
            load_torch_checkpoint,
            v2e2v_checkpoint_name,
        )
        from ..parallel.distributed import is_main_process

        check_flags(cfgs)
        self.cfgs = cfgs
        self.device = resolve_device(device)
        self.mesh = data_axis(cfgs, self.device)
        self.model_name = v2e2v_checkpoint_name(cfgs)
        self.path_to_model = os.path.join(cfgs.path_to_model, self.model_name)
        os.makedirs(self.path_to_model, exist_ok=True)

        cfg = V2E2VConfig.from_flags(cfgs)
        # the trainable config: the core layer by layer, the plain ISTA loop
        self.cfg = dataclasses.replace(
            cfg, cista=dataclasses.replace(cfg.cista, ista_impl="plain", core_impl="layers"))
        self.v2e_params = {k: getattr(cfgs, k) for k in V2E_PARAMS}

        resume = None
        if cfgs.load_epoch_for_train:
            resume = self.checkpoint_path(cfgs.load_epoch_for_train)
            sd, _, _ = load_torch_checkpoint(resume, "cista-lstc")
        elif cfgs.path_to_e2v:
            if not cfgs.path_to_e2v.endswith(CHECKPOINT_SUFFIXES):
                raise ValueError(
                    f"--path_to_e2v {cfgs.path_to_e2v}: the port warm-starts from torch "
                    f"checkpoints ({', '.join(CHECKPOINT_SUFFIXES)})")
            sd, _, _ = load_torch_checkpoint(cfgs.path_to_e2v, "cista-lstc")
        else:
            sd = init_cista_lstc(torch.Generator().manual_seed(cfgs.seed), self.cfg.cista, "cpu")
        self.params = tie_weights({k: v.to(self.device) for k, v in sd.items()}, self.cfg.cista)

        self.train_data = TrainSeqData(
            os.path.join(cfgs.path_to_train_data, "train_v2e2v.txt"),
            cfgs.path_to_train_data,
            cfgs.len_sequence,
            cfgs.num_pack_frames,
            drop_seq_tails=cfgs.drop_seq_tails,
            cache_samples=cfgs.cache_samples,
        )
        print(f"training sequences: {len(self.train_data)}")

        self.lr_for_epoch = lambda e: lr_for_epoch(cfgs.lr, e)
        self.optimizer = make_adam(self.params, self.cfg.cista,
                                   self.lr_for_epoch(cfgs.load_epoch_for_train))
        if resume is not None:
            opt_state = load_optimizer_state(resume)
            if opt_state is not None:
                self.optimizer.load_state_dict(opt_state)
        self.lpips_fn = lpips_for_training(self.device)
        if cfgs.device_data != "off":
            self.train_step = make_v2e2v_train_step_device_data(
                self.cfg, self.optimizer, mesh=self.mesh, lpips_fn=self.lpips_fn)
        else:
            # each batch's rows are taken on the host (run)
            self.train_step = make_v2e2v_train_step(
                self.cfg, self.optimizer, monitor=cfgs.display_train, mesh=self.mesh,
                lpips_fn=self.lpips_fn)
        # --display_train: the reference's matplotlib previews as PNG panels
        # every 50 batches, from rank 0 (its first row is the batch's first)
        self.display = None
        if cfgs.display_train and is_main_process():
            from ..utils.data_io import DebugPanelWriter

            self.display = DebugPanelWriter(cfgs, self.model_name, "train")

    def checkpoint_path(self, epoch: int) -> str:
        return os.path.join(self.path_to_model,
                            f"{self.model_name}_{epoch}{CHECKPOINT_SUFFIX}")

    def save(self, epoch: int) -> None:
        from ..utils.checkpoint import save_checkpoint

        save_on_rank0(save_checkpoint, self.checkpoint_path(epoch + 1), self.params, epoch + 1,
                      self.optimizer, self.v2e_params, "e2v_net.")

    def noise(self, *ids: int):
        """The emulator's noise source of one step: a generator on the device
        seeded from ``(--seed, *ids)``."""
        from ..models.emulator import GeneratorNoise

        gen = torch.Generator(device=self.device)
        return GeneratorNoise(gen.manual_seed(sequence_seed(self.cfgs.seed, *ids)))

    def saturation_warning(self, clipped: int, max_count: int) -> str:
        return (f"warning: emulator saturated on {clipped} pixel-pairs this epoch — observed "
                f"max per-pixel event count {max_count} exceeds max_iters="
                f"{self.cfg.emulator.max_iters}; raise --v2e_max_iters to >= {max_count} to "
                "match the reference's unbounded event loop")

    def _upload_dataset(self):
        """--device_data: the whole uniform-shape training set on the device
        once, frames as uint8 and times as float32; the ground truth is made
        on the device from the last frame."""
        ds = self.train_data
        seq_ts, seq_frames = [], []
        for i in range(len(ds)):
            ts, images_u8 = ds._load_cacheable(i)
            seq_ts.append(ts.astype(np.float32))
            seq_frames.append(images_u8)
        frames = np.stack(seq_frames, 0)  # [S, T, N, H, W] uint8
        ts_all = np.stack(seq_ts, 0)  # [S, T, N] float32
        print(f"uploading dataset to device: {frames.shape} uint8 "
              f"({frames.nbytes / 2**30:.1f} GiB)")
        return (torch.from_numpy(frames).to(self.device),
                torch.from_numpy(ts_all).to(self.device))

    def _run_device_data(self, logger):
        from ..training.steps import set_lr

        cfgs = self.cfgs
        frames_dev, ts_dev = self._upload_dataset()
        n = len(self.train_data)
        bsz = cfgs.batch_size
        if n % bsz:
            print(f"note: final {n % bsz}-sample batch each epoch is padded "
                  f"to batch_size and loss-masked (n={n}, batch_size={bsz})")
        sat_clipped = sat_max_count = 0
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
                # (epoch, batch) noise: a resumed run continues the stream
                loss, aux = self.train_step(
                    self.params, frames_dev, ts_dev, torch.from_numpy(chunk).to(self.device),
                    self.noise(epoch, len(losses)), torch.from_numpy(w).to(self.device))
                clip_now = int(aux["clipped_pixels"])
                if clip_now:
                    sat_clipped += clip_now
                    sat_max_count = max(sat_max_count, int(aux["max_event_count"]))
                loss = float(loss)
                if len(losses) % 50 == 0:
                    print(f"Train Epoch: {epoch + 1} [{len(losses) * bsz}/{n}]"
                          f"\tloss: {loss:.6f}")
                    logger.scalar("loss", loss, epoch * ((n // bsz) or 1) + len(losses))
                losses.append(loss)
            print(epoch_summary(epoch, time.time() - t_epoch, losses))
            if sat_clipped:
                print(self.saturation_warning(sat_clipped, sat_max_count))
                logger.scalar("emulator_clipped_pixels", sat_clipped, epoch)
                sat_clipped = sat_max_count = 0
            logger.scalar("epoch_mean_loss", sum(losses) / max(len(losses), 1), epoch)
            self.save(epoch)
        logger.close()

    def run(self):
        from ..data.datasets import SampleLoader, iterate_batches
        from ..models.emulator import validate_pack_times
        from ..parallel.distributed import is_main_process
        from ..training.steps import set_lr
        from ..utils.data_io import make_event_preview
        from ..utils.logging import ScalarLogger

        cfgs = self.cfgs
        logger = ScalarLogger(os.path.join("summary", self.model_name),
                              enabled=cfgs.is_SummaryWriter and is_main_process())
        if cfgs.device_data != "off":
            self._run_device_data(logger)
            return
        loader = SampleLoader(self.train_data, cfgs.num_workers) if cfgs.num_workers > 0 else None

        rows, n_data = self.mesh.rows, self.mesh.n_data
        dropped = {"batches": 0, "samples": 0}
        step_idx = 0
        sat_clipped = sat_max_count = 0
        try:
            for epoch in range(cfgs.load_epoch_for_train, cfgs.epochs):
                lr = float(self.lr_for_epoch(epoch))
                set_lr(self.optimizer, lr)
                print(f"lr: {lr}")
                t_epoch = time.time()
                losses = []
                for n_batches, batch in enumerate(drop_unshardable(iterate_batches(
                        self.train_data, cfgs.batch_size, cfgs.shuffle,
                        seed=cfgs.seed + epoch, loader=loader), n_data, dropped)):
                    seq_ts, seq_images, seq_gt = batch  # [B,T,N], [B,T,N,H,W], [B,T,H,W,1]
                    frames_seq = np.moveaxis(seq_images, 1, 0)  # [T, B, N, H, W]
                    ts_seq = np.moveaxis(seq_ts, 1, 0).astype(np.float32)
                    gt = seq_gt[:, -1]  # the loss is on the last reconstruction
                    # the host's timestamp contract (the reference raises on
                    # frame times that do not advance, v2e_model.py:335-338)
                    t_last = None
                    for t_pack in range(ts_seq.shape[0]):
                        t_last = validate_pack_times(ts_seq[t_pack], t_last)

                    # this rank's rows only move to the device
                    loss, aux = self.train_step(
                        self.params,
                        *(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                          for a in (rows(frames_seq, 1), rows(ts_seq, 1), rows(gt, 0))),
                        self.noise(step_idx))
                    # max_iters bounds the reference's unbounded per-pixel
                    # event loop (v2e/v2e_model.py:449): say when it clips
                    clip_now = int(aux["clipped_pixels"])
                    if clip_now:
                        sat_clipped += clip_now
                        sat_max_count = max(sat_max_count, int(aux["max_event_count"]))
                    if self.display is not None and n_batches % 50 == 0:
                        panels = [frames_seq[-1, 0, -1]]  # the last input frame
                        if cfgs.show_events:
                            panels.append(make_event_preview(
                                np.moveaxis(aux["voxel"][0].cpu().numpy(), -1, 0),
                                mode=cfgs.event_display_mode,
                                num_bins_to_show=cfgs.num_bins_to_show))
                        panels += [aux["rec"][0].cpu().numpy(), gt[0]]
                        self.display(panels, step_idx)
                    loss = float(loss)
                    if n_batches % 50 == 0:
                        print(f"Train Epoch: {epoch + 1} [{n_batches * cfgs.batch_size}/"
                              f"{len(self.train_data)}]\tloss: {loss:.6f}")
                        logger.scalar("loss", loss, step_idx)
                    losses.append(loss)
                    step_idx += 1
                print(epoch_summary(epoch, time.time() - t_epoch, losses))
                if dropped["batches"]:
                    print(dropped_warning(dropped, n_data))
                    dropped["batches"] = dropped["samples"] = 0
                if sat_clipped:
                    print(self.saturation_warning(sat_clipped, sat_max_count))
                    logger.scalar("emulator_clipped_pixels", sat_clipped, epoch)
                    sat_clipped = sat_max_count = 0
                logger.scalar("epoch_mean_loss", sum(losses) / max(len(losses), 1), epoch)
                self.save(epoch)
        finally:
            if loader is not None:
                loader.close()
            logger.close()


def main(argv: list[str] | None = None) -> None:
    cfgs = parse_flags(argv, "V2E2V training options")
    check_flags(cfgs)
    run_training(cfgs, Train)


if __name__ == "__main__":
    main()
