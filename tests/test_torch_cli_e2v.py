"""The port's E2V evaluation CLI (python -m v2e2v_tpu_torch.cli.test_e2v)
against the JAX package's root test_e2v.py, both on the CPU on data from
scripts/make_synth_data.py with one .pth.tar of JAX's random weights.

Per-step float reconstructions agree within 1e-4 (the tolerance of
tests/test_torch_cista.py; 6e-8 seen, one ulp). Each CLI's frames are exactly
its own floats through its norms (the port's written by image_io, JAX's by
PIL), so the frames differ only where those floats do: by at most one level,
on at most 0.3% of the pixels. JAX's random init gives reconstructions that
span only 2e-4 to 5e-4 from the 1st to the 99th percentile; both norms
stretch that span to 255 levels, so one-ulp differences move a pixel by 0.03
to 0.07 of a level and truncate to the next level on 0.05-0.22% of them. The
result.csv rows have the same datasets and frame counts, MSE and SSIM within
1e-4 and PSNR within 0.01 dB.
"""

import csv
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401
    assert_off_integers,
    no_new_jax_cache_entries,
    pair_magnitudes,
    write_ckpt,
)
from v2e2v_tpu.data import interpolating_reader as jir
from v2e2v_tpu.models import cista as jcista
from v2e2v_tpu.ops import image as jimage
from v2e2v_tpu.utils import configs as jconfigs
from v2e2v_tpu.data import video_readers as jvr
from v2e2v_tpu.utils.checkpoint import export_torch_state_dict
from v2e2v_tpu_torch.cli import test_e2v as tcli
from v2e2v_tpu_torch.data import interpolating_reader as tir
from v2e2v_tpu_torch.data import video_readers as tvr
from v2e2v_tpu_torch.models import superslomo as tss
from v2e2v_tpu_torch.utils.image_io import read_gray

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, DEPTH = 8, 2
FLOW_SCALE = 67.0  # the upsampling run's flows: 4-6 frames a pair, >= 0.2 from an integer


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    data = root / "data"
    subprocess.run([sys.executable, os.path.join(REPO, "scripts", "make_synth_data.py"),
                    "--out_dir", str(data), "--num_sequences", "2", "--num_frames", "24",
                    "--image_dim", "32", "40", "--num_pack_frames", "6"],
                   check=True, capture_output=True)
    cfg = jcista.CistaConfig(image_dim=(32, 40), base_channels=C, depth=DEPTH, num_bins=5)
    params = jax.tree_util.tree_map(np.asarray, jcista.init_cista_lstc(jax.random.PRNGKey(0), cfg))
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in export_torch_state_dict(params, "cista-lstc", depth=DEPTH).items()}
    model = root / "model.pth.tar"
    torch.save({"epoch": 1, "state_dict": sd, "v2e_params": None}, model)
    spec = importlib.util.spec_from_file_location("jax_test_e2v_cli", os.path.join(REPO,
                                                                               "test_e2v.py"))
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)
    return root, data, model, jcli


def _recording(module, reader_cls, monkeypatch, steps):
    """Record every reconstruction the module's ``make_step`` steps give, and
    a ``None`` where the reader starts a frame's pack."""
    make = module.make_step
    pack = reader_cls.update_event_frame_pack

    def update_event_frame_pack(self, *args):
        steps.append(None)
        return pack(self, *args)

    monkeypatch.setattr(reader_cls, "update_event_frame_pack", update_event_frame_pack)

    def make_step(cfg, dtype):
        step = make(cfg, dtype)

        def recorded(*args):
            rec, st = step(*args)
            steps.append(np.array(rec, dtype=np.float32))
            return rec, st

        return recorded

    monkeypatch.setattr(module, "make_step", make_step)


def _split(steps):
    """Recorded steps -> (every step, the last step of each frame)."""
    frames, last = [], None
    for s in steps + [None]:
        if s is None:
            if last is not None:
                frames.append(last)
            last = None
        else:
            last = s
    return [s for s in steps if s is not None], frames


def _result(folder):
    rows = {}
    with open(folder / "result.csv") as f:
        for header, row in zip(*[csv.reader(f, delimiter="\t")] * 2):
            assert header == ["Dataset", "MSE", "PSNR", "SSIM", "LPIPS", "N_frames"]
            rows[row[0]] = [float(v) for v in row[1:]]
    return rows


def _compare_clis(setup, monkeypatch, argv, tag, model_dir, norm="minmax", amplified=False,
                  readers=(tvr.ImageReader, jvr.ImageReader), min_steps=20):
    """Run the port's CLI and the JAX CLI with ``argv`` and hold them to each
    other: every step's reconstruction, the written frames and the
    result.csv rows. With ``amplified``, two frames may differ by as many
    levels as the norm stretches the two reconstructions' difference, and the
    rows by what that moves (see ``test_int8_cli_matches_jax_cli``).
    ``readers`` are the port's and the JAX CLI's reader classes; the runs
    take more than ``min_steps`` steps."""
    root, data, model, jcli = setup
    monkeypatch.delenv("V2E2V_LPIPS_WEIGHTS", raising=False)
    monkeypatch.setenv("V2E2V_PLATFORM", "cpu")
    out = {}
    for name in ("port", "jax"):
        steps = []
        folder = root / f"{name}_{tag}"
        if name == "port":
            _recording(tcli, readers[0], monkeypatch, steps)
            tcli.main(argv + ["-o", str(folder)])
        else:
            _recording(jcli, readers[1], monkeypatch, steps)
            parser = jcli.argparse.ArgumentParser()
            jconfigs.set_configs(parser)
            jcli.Reconstructor(parser.parse_args(argv + ["-o", str(folder)])).run()
        out[name] = (*_split(steps), folder / model_dir)
    (got_steps, got_frames, got_dir), (want_steps, want_frames, want_dir) = out["port"], out["jax"]
    assert len(got_steps) == len(want_steps) > min_steps
    for g, w in zip(got_steps, want_steps):
        assert g.shape == w.shape == (1, 32, 40, 1)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)

    got_res, want_res = {}, {}
    got_u8, want_u8 = [], []
    for seq in sorted(os.listdir(want_dir)):
        got_res.update(_result(got_dir / seq))
        want_res.update(_result(want_dir / seq))
        frames = sorted(f for f in os.listdir(want_dir / seq) if f.endswith(".png"))
        assert sorted(f for f in os.listdir(got_dir / seq) if f.endswith(".png")) == frames
        got_u8 += [cv2.imread(str(got_dir / seq / f), cv2.IMREAD_UNCHANGED) for f in frames]
        want_u8 += [cv2.imread(str(want_dir / seq / f), cv2.IMREAD_UNCHANGED) for f in frames]
    # each CLI's frames are its own floats through the norms (the JAX
    # package's, cv2 for minmax), then the two CLIs' frames against each other
    assert len(got_frames) == len(want_frames) == len(got_u8) == len(want_u8)
    for frames, written in ((got_frames, got_u8), (want_frames, want_u8)):
        for rec, u8 in zip(frames, written):
            rec = rec[0, ..., 0]
            if norm == "minmax":
                want = jimage.normalize_image_minmax_u8(rec)
            else:
                want = np.uint8(np.asarray(jimage.normalize_image_percentile(rec)) * 255)
            np.testing.assert_array_equal(u8, want)
    diffs = np.concatenate([g.astype(int).ravel() - w.astype(int).ravel()
                            for g, w in zip(got_u8, want_u8)])
    if amplified:
        # minmax: level = 255 (r - min) / span; a difference d in r moves r,
        # min and max by d at most, so a level by 3 * 255 d / span, plus one
        # for the truncation
        for g8, w8, g, w in zip(got_u8, want_u8, got_frames, want_frames):
            levels = 1 + 3 * 255 * float(np.abs(g - w).max()) / float(w.max() - w.min())
            assert np.abs(g8.astype(int) - w8.astype(int)).max() <= levels
    else:
        assert np.abs(diffs).max() <= 1 and np.count_nonzero(diffs) <= 3e-3 * diffs.size
    assert sorted(got_res) == sorted(want_res) and len(got_res) == 2
    for seq, want in want_res.items():
        got = got_res[seq]
        assert got[4] == want[4]  # N_frames
        # rows hold 4 decimals: one unit in the last is 1e-4 (and 2.9e-18 of
        # binary representation, e.g. 0.1129 - 0.1128)
        mse_tol, ssim_tol, psnr_tol = (1e-3, 5e-3, 0.05) if amplified else (1e-4 + 1e-12,) * 2 \
            + (0.01,)
        assert abs(got[0] - want[0]) <= mse_tol and abs(got[2] - want[2]) <= ssim_tol
        assert abs(got[1] - want[1]) <= psnr_tol
        assert np.isnan(got[3]) and np.isnan(want[3])  # LPIPS without its weights


def _argv(data, model, *extra):
    # --image_dim stays 180 240: each sequence rebuilds it
    return ["--path_to_test_model", str(model), "--path_to_test_data", str(data),
            "-c", str(C), "-d", str(DEPTH), "--num_events", "300", *extra]


@pytest.mark.parametrize("mode,norm", [("real", "minmax"), ("real", "percentile"),
                                       ("upsampled", "minmax"), ("upsampled", "percentile")])
def test_cli_matches_jax_cli(setup, monkeypatch, mode, norm):
    root, data, model, jcli = setup
    _compare_clis(setup, monkeypatch,
                  _argv(data, model, "--test_data_mode", mode, "--pred_norm", norm),
                  f"{mode}_{norm}", "model.pth", norm)


def test_upsampling_cli_matches_jax_cli(setup, monkeypatch):
    """``--reader_type upsampling`` over each sequence's first 6 frames, both
    CLIs reading one checkpoint through ``V2E2V_SUPERSLOMO_CKPT`` (the JAX
    package's random weights, the flow scaled so that every pair gives 4 to 6
    frames), under the float CLI test's rules. The upsampled frames are each
    CLI's ground truth: equal stamps and counts, frames within one code
    (``tests/test_torch_interpolating_reader.py`` counts them), which moves
    the rows' metrics by less than their rounding. 'upsampled' mode packs the
    6 event files to 300 events a step over the ~25 frames (11 steps); in
    'real' mode the frames past the 6th event file would be steps without
    events, whose nearly constant reconstructions the minmax norm stretches
    until one ulp is many levels."""
    root, data, model, _ = setup
    monkeypatch.setenv(tss.CKPT_ENV_VAR, str(write_ckpt(root / "scaled.ckpt", FLOW_SCALE)))
    port_init = tir.InterpolatingReader.initialize

    def port_initialize(self, path, num_load_frames):
        port_init(self, path, num_load_frames)
        lfr = [read_gray(str(p)) for p in sorted(Path(path).rglob("*.png"))[:num_load_frames]]
        assert_off_integers(pair_magnitudes(self._upsampler, lfr), 4, 6)

    monkeypatch.setattr(tir.InterpolatingReader, "initialize", port_initialize)
    _compare_clis(setup, monkeypatch,
                  _argv(data, model, "--reader_type", "upsampling", "--test_img_num", "6",
                        "--test_data_mode", "upsampled"),
                  "upsampling", "model.pth", min_steps=10,
                  readers=(tir.InterpolatingReader, jir.InterpolatingReader))


@pytest.fixture(scope="module")
def tc_model_int8(setup):
    """A .pth.tar of JAX's random CISTA-TC weights at the CLI test's widths."""
    cfg = jcista.CistaConfig(image_dim=(32, 40), base_channels=C, depth=DEPTH, num_bins=5,
                             model_mode="cista-tc")
    params = jax.tree_util.tree_map(np.asarray, jcista.init_cista_tc(jax.random.PRNGKey(5), cfg))
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in export_torch_state_dict(params, "cista-tc", depth=DEPTH).items()}
    model = setup[0] / "tc_int8.pth.tar"
    torch.save({"epoch": 1, "state_dict": sd}, model)
    return model


@pytest.mark.parametrize("extra", [["--quant", "int8"], ["--quant", "int8-static"],
                                   ["--model_mode", "cista-tc", "--quant", "int8"]],
                         ids=["int8", "int8-static", "cista-tc-int8"])
def test_int8_cli_matches_jax_cli(setup, tc_model_int8, monkeypatch, capsys, extra):
    """The E2V CLI's int8 inference against the JAX CLI's. Every step's
    reconstruction within the float CLI test's 1e-4 (seen: 2e-5 to 4e-5), and
    each CLI's frames exactly its own reconstructions through the norms. A
    code that flips on a tie (``tests/test_torch_cista_int8.py``) stays in
    the recurrent state for the rest of the sequence, so the reconstructions
    differ by ~2e-5 where the float CLIs' differ by an ulp; the minmax norm
    stretches the random-init reconstructions' span of ~3e-4 to 255 levels,
    so two frames differ by up to ``1 + 3 * 255 * max|d| / span`` levels
    (seen: up to 30 of a bound of 37-80), and the rows' MSE by up to 1e-3
    (seen: 3e-4), SSIM by up to 5e-3 (seen: 1.9e-3), PSNR by 0.05 dB (seen:
    0.012).
    ``int8-static`` calibrates on the first voxel grid of the first sequence
    on both sides and adopts the static scales (the same message)."""
    root, data, model, _ = setup
    tc = "cista-tc" in extra
    _compare_clis(setup, monkeypatch, _argv(data, tc_model_int8 if tc else model, *extra),
                  "_".join(extra).replace("-", ""), "tc_int8.pth" if tc else "model.pth",
                  amplified=True)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[int8-static]")]
    if "int8-static" in extra:
        assert len(lines) == 2 and all("activation scales calibrated" in ln for ln in lines)
    else:
        assert not lines


def test_cli_without_card_or_platform_raises(setup, monkeypatch):
    root, data, model, _ = setup
    monkeypatch.delenv("V2E2V_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--path_to_test_model", str(model), "--path_to_test_data", str(data),
            "-o", str(root / "nocard")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(argv)
    monkeypatch.setenv("V2E2V_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="V2E2V_PLATFORM"):
        tcli.main(argv)


UNSUPPORTED = [
    (["--profile_dir", "trace"], {}, "item 10"),
    (["--dist_coordinator", "localhost:1", "--dist_num_processes", "2",
      "--dist_process_id", "0"], {}, "item 9"),
    ([], {"V2E2V_COORDINATOR": "localhost:1", "V2E2V_NUM_PROCESSES": "2",
          "V2E2V_PROCESS_ID": "0"}, "item 9"),
    ([], {"V2E2V_DIST_AUTO": "1"}, "item 9"),
    ([], {"V2E2V_LPIPS_WEIGHTS": "MODEL"}, "item 12"),
]


@pytest.mark.parametrize("argv,env,item", UNSUPPORTED,
                         ids=["profile",
                              "dist-flags", "dist-env", "dist-auto", "lpips"])
def test_unsupported_flags_raise_with_their_item(setup, monkeypatch, argv, env, item):
    root, data, model, _ = setup
    monkeypatch.setenv("V2E2V_PLATFORM", "cpu")
    for k, v in env.items():
        monkeypatch.setenv(k, str(model) if v == "MODEL" else v)
    with pytest.raises(NotImplementedError, match=item):
        tcli.main(["--path_to_test_model", str(model), "--path_to_test_data", str(data),
                   "-o", str(root / "refused"), *argv])
    assert not (root / "refused").exists()
