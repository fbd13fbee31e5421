"""E2V evaluation CLI of the port (port of the root ``test_e2v.py``).

    python -m v2e2v_tpu_torch.cli.test_e2v --path_to_test_model model.pth.tar \\
        --path_to_test_data data/ [the root test_e2v.py's flags]

For every sequence folder under ``--path_to_test_data``: read the frames (or,
with ``--reader_type upsampling``, the LFR frames upsampled by Super-SloMo on
the run's device, ``data/interpolating_reader.py``; its checkpoint from
``$V2E2V_SUPERSLOMO_CKPT``, random weights with a warning without one) and
events, pack the events to the ``--num_events`` budget ('real' or
'upsampled'), voxelise them on the host, reconstruct with CISTA-LSTC or
(``--model_mode cista-tc``) CISTA-TC on the card with its state fed back
(CISTA-LSTC's ISTA loop is kernel K1; CISTA-TC runs no kernel of the port,
its convs are cuDNN's; with ``--quant int8`` or ``int8-static`` either
network's core convs are int8, kernel K4), normalise each prediction to uint8
(minmax or percentile), write the frames, and report the sequence's mean
MSE/PSNR/SSIM/LPIPS on stdout and in ``result.csv``.

It runs on the CUDA card, and on the CPU only under ``V2E2V_PLATFORM=cpu``.
With the ``--dist_*`` flags, the ``V2E2V_*`` variables or
``V2E2V_DIST_AUTO=1`` it joins a process group
(``parallel/distributed.initialize_from_flags``) and, as the JAX CLI does,
each process runs the whole evaluation. ``--profile_dir`` is accepted and
ignored, as the JAX CLI ignores it. Flags it does not cover yet raise at
once, naming the ROADMAP.md item that brings them. LPIPS is NaN, as in the
JAX CLI without its weights.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from ..models.cista import CistaConfig, CistaState, cista_zero_state, get_step_fn, with_derived

ROADMAP = "ROADMAP.md queue 1"
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def missing(what: str, item: int, why: str = "") -> None:
    """Raise for a flag whose ROADMAP.md queue 1 item is not ported yet."""
    raise NotImplementedError(
        f"{what} is not ported yet ({ROADMAP}, item {item}){': ' + why if why else ''}"
    )


def make_reader(cfgs, device: torch.device, video_files: bool = False, **kw):
    """The frame reader of ``--reader_type``: Super-SloMo upsampling on
    ``device``, a video file's frames shrunk to a quarter (``video``, where
    the CLI reads video files, as test.py does and test_e2v.py does not), or
    the frame folder as it is."""
    from ..data.interpolating_reader import InterpolatingReader
    from ..data.video_readers import ImageReader, VideoReader

    if video_files and cfgs.reader_type == "video":
        return VideoReader(cfgs.image_dim, ds=(0.25, 0.25))
    if cfgs.reader_type == "upsampling":
        return InterpolatingReader(cfgs.image_dim, time_unit=cfgs.time_unit, device=device, **kw)
    return ImageReader(cfgs.image_dim, time_unit=cfgs.time_unit, **kw)


def check_flags(cfgs) -> None:
    """Raise on every flag (or environment variable) this CLI does not cover
    yet."""
    if cfgs.model_mode not in ("cista-lstc", "cista-tc"):
        raise ValueError(f"--model_mode must be cista-lstc or cista-tc, got {cfgs.model_mode!r}")
    lpips = os.environ.get("V2E2V_LPIPS_WEIGHTS")
    if lpips and os.path.exists(lpips):
        missing(f"LPIPS (V2E2V_LPIPS_WEIGHTS={lpips})", 12,
                "unset the variable to report LPIPS as NaN")
    if cfgs.precision not in DTYPES:
        raise ValueError(f"--precision must be float32 or bfloat16, got {cfgs.precision!r}")


def model_config(cfgs, image_dim) -> CistaConfig:
    """The network's config from the flags: ``--quant int8-static`` runs the
    same int8 step as ``int8``, with static scales calibrated on the first
    pack (``Reconstructor.run``)."""
    return CistaConfig(
        image_dim=tuple(image_dim),
        base_channels=cfgs.base_channels,
        depth=cfgs.depth,
        num_bins=cfgs.num_bins,
        model_mode=cfgs.model_mode,
        ista_impl="cuda",
        core_impl="layers",
        quant="int8" if cfgs.quant.startswith("int8") else "none",
    )


def build_model(cfgs, device: torch.device):
    """Config, weights (cast once to ``--precision`` on ``device``; with
    int8, their int8 form made once from the cast weights, as the JAX CLI's
    step makes it), the step and the zero-state function."""
    from ..utils.checkpoint import load_torch_checkpoint

    cfg = model_config(cfgs, cfgs.image_dim)
    sd, _, _ = load_torch_checkpoint(cfgs.path_to_test_model, cfgs.model_mode)
    dtype = DTYPES[cfgs.precision]
    params = with_derived({k: v.to(device, dtype) for k, v in sd.items()}, cfg, dtype)
    return cfg, params, make_step(cfg, dtype), cista_zero_state


def make_step(cfg: CistaConfig, dtype: torch.dtype):
    """The reconstruction step with activations and state cast to ``dtype``
    and the reconstruction returned in float32."""
    step_fn = get_step_fn(cfg)

    @torch.no_grad()
    def step_cast(p, ev, prev, st):
        ev = ev.to(dtype)
        prev = prev.to(dtype)
        st = CistaState(st.cell.to(dtype), st.z.to(dtype), tuple(s.to(dtype) for s in st.dg))
        rec, st = step_fn(p, cfg, ev, prev, st)
        return rec.float(), st

    return step_cast


class Reconstructor:
    """The root CLI's ``Reconstructor`` on the port. ``device`` None means the
    card (raising without one)."""

    def __init__(self, cfgs, device: torch.device | str | None = None):
        from .._device import resolve_device

        check_flags(cfgs)
        self.cfgs = cfgs
        self.device = resolve_device(device)
        self.image_dim = cfgs.image_dim
        self.num_load_frames = cfgs.test_img_num
        self.test_data_name = cfgs.test_data_name
        self.limit_num_events = cfgs.num_events
        self.test_data_mode = cfgs.test_data_mode
        self.dtype = DTYPES[cfgs.precision]

        self.path_to_sequences = sorted(
            os.path.join(cfgs.path_to_test_data, d)
            for d in os.listdir(cfgs.path_to_test_data)
            if os.path.isdir(os.path.join(cfgs.path_to_test_data, d))
        )
        self.video_renderer = make_reader(cfgs, self.device, num_bins=cfgs.num_bins,
                                          is_with_events=True)
        self.cfg, self.params, self.step, self.zero_state = build_model(cfgs, self.device)
        self.model_name = os.path.splitext(os.path.basename(cfgs.path_to_test_model))[0]
        self.calibrated = False

    def evaluate(self, pred_u8: np.ndarray, gt: np.ndarray):
        from ..utils.evaluate import mse, psnr, ssim

        pred = pred_u8 / 255.0
        return [mse(pred, gt), psnr(pred, gt), ssim(pred, gt), float("nan")]

    def _calibrate_static(self, ev, prev, state) -> dict:
        """``--quant int8-static``: static int8 activation scales from one run
        of the int8 step on the first voxel grid (margin 1.25: the recurrent
        state warms past the first pack's range, and values past it
        saturate), used for every sequence. CISTA-LSTC then runs the requant
        chain. Drift gate: if the float-vs-int8 SSIM delta on that grid
        exceeds 0.01, the dynamic scales stay. Returns the weights to run
        with."""
        from ..models.cista import int8_static_drift_check
        from ..ops.qconv import calibrate_step_scales

        step_fn = get_step_fn(self.cfg)
        qp = self.params["_quant"]
        ev, prev = ev.to(self.dtype), prev.to(self.dtype)
        state = CistaState(*(s.to(self.dtype) for s in (state.cell, state.z)),
                           tuple(s.to(self.dtype) for s in state.dg))
        qp_static = calibrate_step_scales(
            lambda: step_fn(self.params, self.cfg, ev, prev, state), qp,
            model_mode=self.cfg.model_mode, depth=self.cfg.depth, margin=1.25)
        cfg_run = self.cfg
        if self.cfg.model_mode == "cista-lstc":
            cfg_run = dataclasses.replace(self.cfg, requant_chain=True)
        p_static = {**self.params, "_quant": qp_static}
        delta, ok = int8_static_drift_check(p_static, cfg_run, ev, prev, state, budget=0.01)
        if not ok:
            print(f"[int8-static] WARNING: float-vs-int8 SSIM delta {delta:.4f} exceeds the "
                  "0.01 budget on the calibration pack — falling back to dynamic int8 scales")
            return self.params
        print("[int8-static] activation scales calibrated on the first pack "
              f"(float-vs-int8 SSIM delta {delta:.4f}, budget 0.01)")
        if cfg_run is not self.cfg:
            self.cfg = cfg_run
            self.step = make_step(self.cfg, self.dtype)
        return p_static

    def run(self):
        from ..ops.image import normalize_image_minmax_u8, normalize_image_percentile
        from ..utils.data_io import EvalWriter, ImageWriter

        for path in self.path_to_sequences:
            dataset_name = os.path.basename(path).split(".")[0]
            if self.test_data_name is not None and dataset_name != self.test_data_name:
                continue
            self.video_renderer.initialize(path, self.num_load_frames)

            h, w = self.video_renderer.height, self.video_renderer.width
            if (h, w) != tuple(self.cfg.image_dim):
                # another resolution: the same weights under a config made
                # from the flags again, as the JAX CLI makes it (quant kept,
                # the requant chain of an int8-static run not)
                self.cfg = model_config(self.cfgs, (h, w))
                self.step = make_step(self.cfg, self.dtype)

            state = self.zero_state(self.cfg, 1, torch.float32, self.device)
            prev_image = torch.zeros((1, h, w, 1), dtype=torch.float32, device=self.device)

            image_writer = ImageWriter(self.cfgs, self.model_name, dataset_name)
            eval_writer = EvalWriter(self.cfgs, self.model_name, dataset_name)

            results = []
            frame_idx = 0
            pred_image = prev_image
            while not self.video_renderer.ending:
                events, gt_frame = self.video_renderer.update_event_frame_pack(
                    self.limit_num_events, self.test_data_mode
                )
                for evs in events:
                    evs = np.ascontiguousarray(np.moveaxis(evs, 0, -1))[None]  # NHWC
                    evs = torch.from_numpy(evs).to(self.device)
                    if self.cfgs.quant == "int8-static" and not self.calibrated:
                        self.params = self._calibrate_static(evs, prev_image, state)
                        self.calibrated = True
                    pred_image, state = self.step(self.params, evs, prev_image, state)
                    prev_image = pred_image

                pred_np = pred_image[0, ..., 0].cpu().numpy()
                if self.cfgs.pred_norm == "percentile":  # the reference's ECD variant
                    pred_u8 = np.uint8(normalize_image_percentile(pred_np) * 255)
                else:  # minmax, the reference's active HQF variant
                    pred_u8 = normalize_image_minmax_u8(pred_np)
                gt_norm = normalize_image_percentile(gt_frame.astype(np.float32))

                image_writer(pred_u8, frame_idx + 1)
                results.append(self.evaluate(pred_u8, gt_norm))
                frame_idx += 1

            results = np.array(results)
            mean_res = results.mean(0)
            print(
                "\nTest set {}: Average MSE for {:d} frames: {:.4f}, PSNR: {:.4f}, "
                "SSIM: {:.4f}, LPIPS: {:.4f} \n".format(
                    dataset_name, len(results), *mean_res
                )
            )
            eval_writer(
                ["Dataset", "MSE", "PSNR", "SSIM", "LPIPS", "N_frames"],
                [dataset_name] + [round(float(x), 4) for x in mean_res] + [len(results)],
            )


def main(argv: list[str] | None = None) -> None:
    from ..parallel.distributed import initialize_from_flags, shutdown
    from ..utils.configs import set_configs
    from ..utils.profiling import apply_platform_override

    parser = argparse.ArgumentParser(description="E2V testing options")
    set_configs(parser)
    cfgs = parser.parse_args(argv)
    check_flags(cfgs)
    device = apply_platform_override()
    initialize_from_flags(cfgs)
    try:
        if device.type == "cuda" and cfgs.precision == "float32":
            # float32 means float32: no TF32 in cuDNN's convs or in matmuls
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        Reconstructor(cfgs, device).run()
    finally:
        shutdown()


if __name__ == "__main__":
    main()
