"""E2V evaluation CLI of the port (port of the root ``test_e2v.py``).

    python -m v2e2v_tpu_torch.cli.test_e2v --path_to_test_model model.pth.tar \\
        --path_to_test_data data/ [the root test_e2v.py's flags]

For every sequence folder under ``--path_to_test_data``: read the frames and
events, pack the events to the ``--num_events`` budget ('real' or
'upsampled'), voxelise them on the host, reconstruct with CISTA-LSTC or
(``--model_mode cista-tc``) CISTA-TC on the card with its state fed back
(CISTA-LSTC's ISTA loop is kernel K1; CISTA-TC runs no kernel of the port,
its convs are cuDNN's), normalise each prediction to uint8 (minmax or
percentile), write the frames, and report the sequence's mean
MSE/PSNR/SSIM/LPIPS on stdout and in ``result.csv``.

It runs on the CUDA card, and on the CPU only under ``V2E2V_PLATFORM=cpu``.
Flags it does not cover yet raise at once, naming the ROADMAP.md item that
brings them. LPIPS is NaN, as in the JAX CLI without its weights.
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


def check_common_flags(cfgs) -> None:
    """Raise on the flags (and environment variables) that neither of the
    port's evaluation CLIs covers yet: int8, Super-SloMo upsampling,
    distributed runs, profiling."""
    if getattr(cfgs, "quant", "none").startswith("int8"):
        missing(f"--quant {cfgs.quant}", 7)
    if cfgs.reader_type == "upsampling":
        missing("--reader_type upsampling", 8)
    check_run_flags(cfgs)


def check_run_flags(cfgs) -> None:
    """Raise on the flags (and environment variables) of a run that no CLI of
    the port covers yet: profiling and distributed runs."""
    if getattr(cfgs, "profile_dir", None):
        missing("--profile_dir", 10)
    dist_flags = [f"--{k}" for k in ("dist_coordinator", "dist_num_processes", "dist_process_id")
                  if getattr(cfgs, k, None) is not None]
    dist_env = [k for k in ("V2E2V_COORDINATOR", "V2E2V_NUM_PROCESSES", "V2E2V_PROCESS_ID")
                if k in os.environ]
    if os.environ.get("V2E2V_DIST_AUTO") == "1":
        dist_env.append("V2E2V_DIST_AUTO=1")
    if dist_flags or dist_env:
        missing(" and ".join(dist_flags + dist_env), 9, "distributed runs")


def check_flags(cfgs) -> None:
    """Raise on every flag (or environment variable) this CLI does not cover
    yet."""
    if cfgs.model_mode not in ("cista-lstc", "cista-tc"):
        raise ValueError(f"--model_mode must be cista-lstc or cista-tc, got {cfgs.model_mode!r}")
    check_common_flags(cfgs)
    lpips = os.environ.get("V2E2V_LPIPS_WEIGHTS")
    if lpips and os.path.exists(lpips):
        missing(f"LPIPS (V2E2V_LPIPS_WEIGHTS={lpips})", 12,
                "unset the variable to report LPIPS as NaN")
    if cfgs.precision not in DTYPES:
        raise ValueError(f"--precision must be float32 or bfloat16, got {cfgs.precision!r}")


def build_model(cfgs, device: torch.device):
    """Config, weights (cast once to ``--precision`` on ``device``), the
    step and the zero-state function."""
    from ..utils.checkpoint import load_torch_checkpoint

    cfg = CistaConfig(
        image_dim=tuple(cfgs.image_dim),
        base_channels=cfgs.base_channels,
        depth=cfgs.depth,
        num_bins=cfgs.num_bins,
        model_mode=cfgs.model_mode,
        ista_impl="cuda",
        core_impl="layers",
    )
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
        from ..data.video_readers import ImageReader

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
        self.video_renderer = ImageReader(
            self.image_dim, num_bins=cfgs.num_bins, is_with_events=True,
            time_unit=cfgs.time_unit,
        )
        self.cfg, self.params, self.step, self.zero_state = build_model(cfgs, self.device)
        self.model_name = os.path.splitext(os.path.basename(cfgs.path_to_test_model))[0]

    def evaluate(self, pred_u8: np.ndarray, gt: np.ndarray):
        from ..utils.evaluate import mse, psnr, ssim

        pred = pred_u8 / 255.0
        return [mse(pred, gt), psnr(pred, gt), ssim(pred, gt), float("nan")]

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
                # another resolution: the same weights under a new config
                self.cfg = dataclasses.replace(self.cfg, image_dim=(h, w))
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
    from ..utils.configs import set_configs
    from ..utils.profiling import apply_platform_override

    parser = argparse.ArgumentParser(description="E2V testing options")
    set_configs(parser)
    cfgs = parser.parse_args(argv)
    check_flags(cfgs)
    device = apply_platform_override()
    if device.type == "cuda" and cfgs.precision == "float32":
        # float32 means float32: no TF32 in cuDNN's convs or in matmuls
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    Reconstructor(cfgs, device).run()


if __name__ == "__main__":
    main()
