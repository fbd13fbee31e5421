"""The port's metrics, flags, writers and checkpoint loader
(v2e2v_tpu_torch.utils) against the JAX package's."""

import argparse
from types import SimpleNamespace

import cv2
import jax
import numpy as np
import pytest
import torch

from _torch_parity import no_new_jax_cache_entries  # noqa: F401
from v2e2v_tpu.models import cista as jcista
from v2e2v_tpu.utils import configs as jconfigs
from v2e2v_tpu.utils import data_io as jdata_io
from v2e2v_tpu.utils import evaluate as jevaluate
from v2e2v_tpu.utils.checkpoint import export_torch_state_dict
from v2e2v_tpu_torch.utils import checkpoint as tcheckpoint
from v2e2v_tpu_torch.utils import configs as tconfigs
from v2e2v_tpu_torch.utils import data_io as tdata_io
from v2e2v_tpu_torch.utils import evaluate as tevaluate
from v2e2v_tpu_torch.utils.checkpoint import params_from_jax


def _pairs():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (45, 61))
    yield "random", a, rng.uniform(0, 1, (45, 61))
    yield "close", a, np.clip(a + 0.01 * rng.standard_normal(a.shape), 0, 1)
    yield "equal", a, a.copy()
    yield "batch", rng.uniform(0, 1, (3, 1, 20, 24)), rng.uniform(0, 1, (3, 1, 20, 24))
    yield "u8", np.uint8(255 * a) / 255.0, a.astype(np.float32)


@pytest.mark.parametrize("metric", ["mse", "psnr", "ssim"])
@pytest.mark.parametrize("case", list(_pairs()), ids=lambda c: c[0])
def test_metrics_equal_jax(metric, case):
    _, a, b = case
    got = getattr(tevaluate, metric)(a, b)
    want = getattr(jevaluate, metric)(a, b)
    assert type(got) is float and got == want


ARGVS = [
    [],
    ["--path_to_test_model", "m.pth.tar", "--path_to_test_data", "d", "-c", "8", "-d", "2",
     "-b", "3", "--num_events", "300", "--test_data_mode", "upsampled", "--pred_norm",
     "percentile", "--image_dim", "32", "40", "--precision", "bfloat16", "--no_write_image"],
    ["--quant", "int8-static", "--reader_type", "upsampling", "--profile_dir", "p",
     "--dist_coordinator", "h:1", "--dist_num_processes", "2", "--dist_process_id", "1",
     "--no_shuffle", "--is_write_event", "--device_data", "bf16", "--v2e_iters_impl", "xla"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "test_e2v", "additions"])
def test_set_configs_parses_as_jax(argv):
    parsers = []
    for mod in (tconfigs, jconfigs):
        parser = argparse.ArgumentParser()
        mod.set_configs(parser)
        parsers.append(parser)
    assert vars(parsers[0].parse_args(argv)) == vars(parsers[1].parse_args(argv))


def test_writers_match_jax(tmp_path):
    img = np.random.default_rng(1).integers(0, 256, (30, 41)).astype(np.uint8)
    rows = (["Dataset", "MSE", "PSNR", "SSIM", "LPIPS", "N_frames"],
            ["seq", 0.1234, 9.5, 0.1, float("nan"), 23])
    out = {}
    for name, mod in (("port", tdata_io), ("jax", jdata_io)):
        cfgs = SimpleNamespace(output_folder=str(tmp_path / name), test_data_name=None,
                               is_write_image=True)
        mod.ImageWriter(cfgs, "model", "seq")(img, 7)
        writer = mod.EvalWriter(cfgs, "model", "seq")
        writer(*rows)
        writer(*rows)
        folder = tmp_path / name / "model" / "seq"
        out[name] = (cv2.imread(str(folder / "frame_0000000007.png"), cv2.IMREAD_UNCHANGED),
                     (folder / "result.csv").read_bytes())
    np.testing.assert_array_equal(out["port"][0], img)
    np.testing.assert_array_equal(out["port"][0], out["jax"][0])
    assert out["port"][1] == out["jax"][1]
    off = SimpleNamespace(output_folder=str(tmp_path / "off"), test_data_name="s",
                          is_write_image=False)
    tdata_io.ImageWriter(off, "model")(img, 1)
    tdata_io.EvalWriter(off, "model")(*rows)
    assert not (tmp_path / "off" / "model").exists()


@pytest.fixture(scope="module")
def jax_params():
    cfg = jcista.CistaConfig(image_dim=(16, 24), base_channels=8, depth=2, num_bins=5)
    return jax.tree_util.tree_map(np.asarray, jcista.init_cista_lstc(jax.random.PRNGKey(3), cfg))


@pytest.mark.parametrize("layout", ["bare", "wrapped", "v2e2v"])
def test_load_torch_checkpoint_gives_params_from_jax(tmp_path, jax_params, layout):
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in export_torch_state_dict(jax_params, "cista-lstc", depth=2).items()}
    v2e = {"C": 0.6, "pl": 1.5}
    if layout == "bare":
        payload, want_epoch, want_v2e = sd, 0, None
    elif layout == "wrapped":
        payload, want_epoch, want_v2e = {"epoch": 4, "state_dict": sd}, 4, None
    else:  # a V2E2V checkpoint: the E2V net under e2v_net., emulator params beside
        payload = {"epoch": 9, "v2e_params": v2e,
                   "state_dict": {**{f"e2v_net.{k}": v for k, v in sd.items()},
                                  "v2e_net.log_c": torch.zeros(3)}}
        want_epoch, want_v2e = 9, v2e
    path = tmp_path / "model.pth.tar"
    torch.save(payload, path)
    got, epoch, v2e_params = tcheckpoint.load_torch_checkpoint(str(path), "cista-lstc")
    want = params_from_jax(jax_params, depth=2)
    assert (epoch, v2e_params) == (want_epoch, want_v2e)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], v), k


def test_load_torch_checkpoint_refuses(tmp_path, jax_params):
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match=r"export.*\.pth\.tar"):
        tcheckpoint.load_torch_checkpoint(str(tmp_path / "orbax"))
    with pytest.raises(ValueError, match="model_mode"):
        tcheckpoint.load_torch_checkpoint(str(tmp_path / "x.pth.tar"), "cista-xx")
    torch.save({"state_dict": {"We.conv2d.weight": torch.zeros(1)}}, tmp_path / "bad.pth.tar")
    with pytest.raises(KeyError, match="missing"):
        tcheckpoint.load_torch_checkpoint(str(tmp_path / "bad.pth.tar"))
    # a cista-lstc checkpoint is not a cista-tc one
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in export_torch_state_dict(jax_params, "cista-lstc", depth=2).items()}
    torch.save({"state_dict": sd}, tmp_path / "lstc.pth.tar")
    with pytest.raises(KeyError, match="not a cista-tc checkpoint.*alpha.0"):
        tcheckpoint.load_torch_checkpoint(str(tmp_path / "lstc.pth.tar"), "cista-tc")
