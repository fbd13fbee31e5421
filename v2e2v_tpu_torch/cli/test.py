"""V2E2V end-to-end inference CLI of the port (port of the root ``test.py``).

    python -m v2e2v_tpu_torch.cli.test --path_to_test_model model.pth.tar \\
        --path_to_test_data frames/ [the root test.py's flags]

For every sequence folder under ``--path_to_test_data`` (frames and
``timestamps.txt``): read the HFR frames (or, with ``--reader_type
upsampling``, LFR frames upsampled by Super-SloMo on the run's device,
``data/interpolating_reader.py``; with ``--reader_type video``, every file
there that is not hidden and not a ``.txt``, each a video
``utils/video.VideoFile`` reads (MJPEG or MPEG-4 Part 2 in AVI, MP4, MOV,
M4V; VP8, VP9, MJPEG or MPEG-4 Part 2 in Matroska or WebM) whose gray frames
are shrunk to a quarter, ``data/video_readers.VideoReader``) pack by
pack, emulate events (the
emulator's iteration loop is kernel K3, one launch per frame pair) and
reconstruct one frame per pack with CISTA-LSTC (its ISTA loop is kernel
K1, 2 x depth launches), write the min-max-normalised PNGs, the red-blue event
previews (``--is_write_event``) and the ``--display_test`` panels, and print
the average number of events per reconstruction. The emulator parameters
stored in the checkpoint (``v2e_params``) override the flags.

Each sequence draws from its own noise source: by default a generator on the
run's device seeded from ``(--seed, sequence index)``; on the card K3 makes
the shot-noise uniforms with its own Philox. ``--rng_impl`` (JAX's key
implementation) is not read. It runs float32 (TF32 off on the card), on the
CUDA card, and on the CPU only under ``V2E2V_PLATFORM=cpu``. Over a process
group (the ``--dist_*`` flags, the ``V2E2V_*`` variables or
``V2E2V_DIST_AUTO=1``) each process runs the whole evaluation, as test.py's
do; ``--profile_dir`` is accepted and ignored, as test.py ignores it. Flags
it does not cover yet raise at once, naming the ROADMAP.md item that brings
them.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable

import numpy as np
import torch

from ..models.emulator import GeneratorNoise, Noise
from .test_e2v import make_reader

V2E_PARAMS = ("C", "ps", "pl", "cutoff_hz", "qs", "ql", "refractory_period_s")
CHECKPOINT_SUFFIXES = (".pth.tar", ".pth", ".pt")


def check_flags(cfgs) -> None:
    """Raise on every flag (or environment variable) this CLI does not cover
    yet."""
    if getattr(cfgs, "quant", "none") != "none":
        raise ValueError(f"--quant {cfgs.quant}: the JAX V2E2V CLI (test.py) does not read the "
                         "flag; int8 inference runs in the E2V CLI (cli.test_e2v)")
    if cfgs.precision != "float32":
        raise ValueError(f"--precision {cfgs.precision}: the V2E2V CLI runs float32, as "
                         "test.py does")
    if cfgs.model_mode != "cista-lstc":
        raise ValueError(f"--model_mode {cfgs.model_mode}: the V2E2V composite reconstructs "
                         "with cista-lstc")


def sequence_seed(seed: int, *ids: int) -> int:
    """The default generator seed of sequence ``ids[0]`` (and the training
    CLIs' seed of a step, named by its ids)."""
    return int(np.random.SeedSequence([seed, *ids]).generate_state(1, np.uint64)[0] >> 1)


class V2E2V:
    """The root CLI's ``V2E2V`` on the port. ``device`` None means the card
    (raising without one); ``noise_for_sequence(i)`` gives sequence ``i``'s
    noise source (default: a generator seeded by ``sequence_seed``)."""

    def __init__(self, cfgs, device: torch.device | str | None = None,
                 noise_for_sequence: Callable[[int], Noise] | None = None):
        from .._device import resolve_device
        from ..models.cista import with_derived
        from ..models.v2e2v import V2E2VConfig
        from ..utils.checkpoint import load_torch_checkpoint

        check_flags(cfgs)
        self.cfgs = cfgs
        self.device = resolve_device(device)
        self.num_pack_frames = cfgs.num_pack_frames
        self.num_load_frames = cfgs.test_img_num
        self.test_data_name = cfgs.test_data_name
        root = cfgs.path_to_test_data
        if cfgs.reader_type == "video":  # test.py:33-43
            self.path_to_sequences = sorted(
                os.path.join(root, f) for f in os.listdir(root)
                if os.path.isfile(os.path.join(root, f)) and not f.startswith(".")
                and f.rsplit(".", 1)[-1] != "txt")
        else:
            self.path_to_sequences = sorted(
                os.path.join(root, d) for d in os.listdir(root)
                if os.path.isdir(os.path.join(root, d)))
        self.video_renderer = make_reader(cfgs, self.device, video_files=True)

        path = cfgs.path_to_test_model
        if not path.endswith(CHECKPOINT_SUFFIXES):
            raise ValueError(
                f"{path}: the port loads torch checkpoints ({', '.join(CHECKPOINT_SUFFIXES)}); "
                "an orbax checkpoint of the JAX package is exported with "
                "v2e2v_tpu.utils.checkpoint.export_torch_state_dict and torch.save"
            )
        self.model_name = os.path.splitext(os.path.basename(path))[0]
        sd, _, v2e_params = load_torch_checkpoint(path, "cista-lstc")
        if v2e_params:  # the checkpoint overrides the flags (reference test.py:76-83)
            for k in V2E_PARAMS:
                setattr(cfgs, k, float(v2e_params[k]))
        self.cfg = V2E2VConfig.from_flags(cfgs)
        self.params = with_derived({k: v.to(self.device) for k, v in sd.items()},
                                   self.cfg.cista, torch.float32)
        if noise_for_sequence is None:
            def noise_for_sequence(seq_id):
                gen = torch.Generator(device=self.device)
                return GeneratorNoise(gen.manual_seed(sequence_seed(cfgs.seed, seq_id)))
        self.noise_for_sequence = noise_for_sequence

    @torch.no_grad()
    def run(self):
        from ..models.emulator import validate_pack_times
        from ..models.v2e2v import v2e2v_forward
        from ..ops.image import normalize_image_minmax_u8
        from ..utils.data_io import DebugPanelWriter, EventWriter, ImageWriter, make_event_preview

        for seq_id, path in enumerate(self.path_to_sequences):
            dataset_name = os.path.basename(path).split(".")[0]
            if self.test_data_name is not None and dataset_name != self.test_data_name:
                continue
            noise = self.noise_for_sequence(seq_id)
            self.video_renderer.initialize(path, self.num_load_frames)
            num_packs = (
                int(np.floor(self.video_renderer.num_frames / (self.num_pack_frames - 1))) - 1
            )
            print(f"Sequence {path}: {self.video_renderer.num_frames} frames, "
                  f"{self.num_pack_frames} per reconstruction")

            state = None  # a new sequence: emulator and reconstruction state reset
            t_last = None
            num_events = sat_clipped = sat_max_count = 0
            image_writer = ImageWriter(self.cfgs, self.model_name, dataset_name)
            event_writer = EventWriter(self.cfgs, self.model_name, dataset_name)
            display = (DebugPanelWriter(self.cfgs, self.model_name, dataset_name)
                       if self.cfgs.display_test else None)

            for frame_idx in range(num_packs):
                frames, _gt, timestamps = self.video_renderer.update_frame_pack(
                    self.num_pack_frames)
                if frames.shape[0] <= 1:
                    continue
                t_last = validate_pack_times(timestamps, t_last)
                frames_t = torch.from_numpy(np.asarray(frames, np.float32))[None]
                ts_t = torch.from_numpy(np.asarray(timestamps, np.float32))[None]
                out, state = v2e2v_forward(self.params, self.cfg, frames_t, ts_t, state, noise,
                                           with_stats=True, device=self.device)
                clip_now = int(out.stats.clipped_pixels)
                if clip_now:
                    sat_clipped += clip_now
                    sat_max_count = max(sat_max_count, int(out.stats.max_event_count))
                pred = out.reconstruction[0, ..., 0].cpu().numpy()
                image_writer(normalize_image_minmax_u8(pred), frame_idx + 1)

                voxel_bins_first = np.moveaxis(out.event_voxel_grids[0].cpu().numpy(), -1, 0)
                event_writer(make_event_preview(voxel_bins_first, mode="red-blue"),
                             frame_idx + 1)
                num_events += int(out.num_events)

                if display is not None:
                    panels = [frames[-1]]
                    if self.cfgs.show_events:
                        panels.append(make_event_preview(
                            voxel_bins_first, mode=self.cfgs.event_display_mode,
                            num_bins_to_show=self.cfgs.num_bins_to_show))
                    panels.append(pred)
                    display(panels, frame_idx + 1)

            if num_packs > 0:
                print("Avg number of events per reconstruction: "
                      f"{num_events / num_packs:.1f}")
            if sat_clipped:
                print(f"warning: emulator saturated on {sat_clipped} pixel-pairs (max per-pixel "
                      f"event count {sat_max_count} > max_iters={self.cfg.emulator.max_iters}); "
                      f"raise --v2e_max_iters to >= {sat_max_count}")


def main(argv: list[str] | None = None,
         noise_for_sequence: Callable[[int], Noise] | None = None) -> None:
    from ..parallel.distributed import initialize_from_flags, shutdown
    from ..utils.configs import set_configs
    from ..utils.profiling import apply_platform_override

    parser = argparse.ArgumentParser(description="V2E2V testing options")
    set_configs(parser)
    cfgs = parser.parse_args(argv)
    check_flags(cfgs)
    device = apply_platform_override()
    initialize_from_flags(cfgs)  # each process runs the whole evaluation, as test.py's
    try:
        if device.type == "cuda":
            # float32 means float32: no TF32 in cuDNN's convs or in matmuls
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        V2E2V(cfgs, device, noise_for_sequence).run()
    finally:
        shutdown()


if __name__ == "__main__":
    main()
