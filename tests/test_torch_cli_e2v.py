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

import cv2
import jax
import numpy as np
import pytest
import torch

from _torch_parity import no_new_jax_cache_entries  # noqa: F401
from v2e2v_tpu.models import cista as jcista
from v2e2v_tpu.ops import image as jimage
from v2e2v_tpu.utils import configs as jconfigs
from v2e2v_tpu.data import video_readers as jvr
from v2e2v_tpu.utils.checkpoint import export_torch_state_dict
from v2e2v_tpu_torch.cli import test_e2v as tcli
from v2e2v_tpu_torch.data import video_readers as tvr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, DEPTH = 8, 2


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


@pytest.mark.parametrize("mode,norm", [("real", "minmax"), ("real", "percentile"),
                                       ("upsampled", "minmax"), ("upsampled", "percentile")])
def test_cli_matches_jax_cli(setup, monkeypatch, mode, norm):
    root, data, model, jcli = setup
    monkeypatch.delenv("V2E2V_LPIPS_WEIGHTS", raising=False)
    monkeypatch.setenv("V2E2V_PLATFORM", "cpu")
    argv = ["--path_to_test_model", str(model), "--path_to_test_data", str(data),
            "-c", str(C), "-d", str(DEPTH), "--num_events", "300", "--test_data_mode", mode,
            "--pred_norm", norm]  # --image_dim stays 180 240: each sequence rebuilds it
    out = {}
    for name in ("port", "jax"):
        steps = []
        folder = root / f"{name}_{mode}_{norm}"
        if name == "port":
            _recording(tcli, tvr.ImageReader, monkeypatch, steps)
            tcli.main(argv + ["-o", str(folder)])
        else:
            _recording(jcli, jvr.ImageReader, monkeypatch, steps)
            parser = jcli.argparse.ArgumentParser()
            jconfigs.set_configs(parser)
            jcli.Reconstructor(parser.parse_args(argv + ["-o", str(folder)])).run()
        out[name] = (*_split(steps), folder / "model.pth")
    (got_steps, got_frames, got_dir), (want_steps, want_frames, want_dir) = out["port"], out["jax"]
    assert len(got_steps) == len(want_steps) > 20
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
    assert np.abs(diffs).max() <= 1 and np.count_nonzero(diffs) <= 3e-3 * diffs.size
    assert sorted(got_res) == sorted(want_res) and len(got_res) == 2
    for seq, want in want_res.items():
        got = got_res[seq]
        assert got[4] == want[4]  # N_frames
        # rows hold 4 decimals: one unit in the last is 1e-4 (and 2.9e-18 of
        # binary representation, e.g. 0.1129 - 0.1128)
        assert abs(got[0] - want[0]) <= 1e-4 + 1e-12 and abs(got[2] - want[2]) <= 1e-4 + 1e-12
        assert abs(got[1] - want[1]) <= 0.01
        assert np.isnan(got[3]) and np.isnan(want[3])  # LPIPS without its weights


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
    (["--model_mode", "cista-tc", "--quant", "int8"], {}, "item 7"),
    (["--quant", "int8"], {}, "item 7"),
    (["--quant", "int8-static"], {}, "item 7"),
    (["--reader_type", "upsampling"], {}, "item 8"),
    (["--profile_dir", "trace"], {}, "item 10"),
    (["--dist_coordinator", "localhost:1", "--dist_num_processes", "2",
      "--dist_process_id", "0"], {}, "item 9"),
    ([], {"V2E2V_COORDINATOR": "localhost:1", "V2E2V_NUM_PROCESSES": "2",
          "V2E2V_PROCESS_ID": "0"}, "item 9"),
    ([], {"V2E2V_DIST_AUTO": "1"}, "item 9"),
    ([], {"V2E2V_LPIPS_WEIGHTS": "MODEL"}, "item 12"),
]


@pytest.mark.parametrize("argv,env,item", UNSUPPORTED,
                         ids=["cista-tc", "int8", "int8-static", "upsampling", "profile",
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
