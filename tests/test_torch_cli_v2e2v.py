"""The port's V2E2V CLI (python -m v2e2v_tpu_torch.cli.test) against the JAX
package's root test.py, both on the CPU, on two sequences of 19 flickering
HFR frames at 32x40 (``data/synthetic.write_hfr_dataset``, intensities <= 19,
where ``lin_log`` is exact in both) and one .pth.tar of JAX's random weights.
The port replays JAX's key chain per sequence (``JaxKeyNoise`` of
``fold_in(key(--seed, rbg), sequence index)``, test.py:79,97).

The printed averages are equal and the red-blue event previews identical. The
reconstruction PNGs are equal or differ by one level on at most 0.5% of the
pixels: random-init reconstructions span a few 1e-4, which the minmax norm
stretches to 255 levels, so one-ulp float differences cross a truncation
(tests/test_torch_cli_e2v.py measures the same effect on the E2V CLI).
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_parity import JaxKeyNoise, no_new_jax_cache_entries  # noqa: F401
from v2e2v_tpu.models import cista as jcista
from v2e2v_tpu.utils import configs as jconfigs
from v2e2v_tpu.utils.checkpoint import export_torch_state_dict
from v2e2v_tpu_torch.cli import test as tcli
from v2e2v_tpu_torch.data.synthetic import write_hfr_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, C, DEPTH, SEED = 32, 40, 8, 2, 3
V2E = {"C": 0.5, "ps": 0.6, "pl": 1.4, "cutoff_hz": 150.0, "qs": 0.0, "ql": 1.0,
       "refractory_period_s": 0.0005}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("v2e2v_cli")
    data = root / "data"
    write_hfr_dataset(data, 0, 2, 19, H, W, base=(4.0, 7.0))
    cfg = jcista.CistaConfig(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=5)
    params = jax.tree_util.tree_map(np.asarray, jcista.init_cista_lstc(jax.random.PRNGKey(0), cfg))
    sd = {f"e2v_net.{k}": torch.from_numpy(np.array(v))
          for k, v in export_torch_state_dict(params, "cista-lstc", depth=DEPTH).items()}
    model = root / "v2e2v.pth.tar"
    torch.save({"epoch": 2, "state_dict": sd, "v2e_params": V2E}, model)
    spec = importlib.util.spec_from_file_location("jax_test_cli", os.path.join(REPO, "test.py"))
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)
    return root, data, model, jcli


def _argv(data, model, out, *extra):
    return ["--path_to_test_model", str(model), "--path_to_test_data", str(data),
            "--image_dim", str(H), str(W), "-c", str(C), "-d", str(DEPTH),
            "--num_pack_frames", "5", "--seed", str(SEED), "-o", str(out), *extra]


def _jax_noise(seq_id):
    return JaxKeyNoise(jax.random.fold_in(jax.random.key(SEED, impl="rbg"), seq_id))


def _pngs(folder):
    return {p.relative_to(folder).as_posix(): np.asarray(Image.open(p))
            for p in sorted(folder.rglob("*.png"))}


def test_cli_matches_jax_cli(setup, monkeypatch, capsys):
    root, data, model, jcli = setup
    monkeypatch.setenv("V2E2V_PLATFORM", "cpu")
    extra = ("--is_write_event", "--display_test")
    tcli.main(_argv(data, model, root / "port", *extra), noise_for_sequence=_jax_noise)
    got_out = capsys.readouterr().out
    parser = jcli.argparse.ArgumentParser()
    jconfigs.set_configs(parser)
    jcli.V2E2V(parser.parse_args(_argv(data, model, root / "jax", *extra))).run()
    want_out = capsys.readouterr().out

    def averages(text):
        return [line for line in text.splitlines() if line.startswith("Avg number of events")]

    assert len(averages(want_out)) == 2 and averages(got_out) == averages(want_out)
    assert float(averages(want_out)[0].split(": ")[1]) > 100
    got, want = _pngs(root / "port"), _pngs(root / "jax")
    assert sorted(got) == sorted(want)
    kinds = {k.split("/")[-1].split("_")[0] for k in want}
    assert kinds == {"frame", "events", "panel"}
    assert sum(k.split("/")[-1].startswith("frame_") for k in want) == 2 * 3
    diffs = []
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype == np.uint8, name
        if "/events/" in name:
            np.testing.assert_array_equal(g, w, err_msg=name)
            assert w.ndim == 3 and w[..., 0].any() and w[..., 2].any()
        elif "/frame_" in name:
            diffs.append(g.astype(int).ravel() - w.astype(int).ravel())
        else:  # panel: input frame | event preview | reconstruction, same rule
            part = w.shape[1] - W
            np.testing.assert_array_equal(g[:, :part], w[:, :part], err_msg=name)
            diffs.append(g[:, part:].astype(int).ravel() - w[:, part:].astype(int).ravel())
    diffs = np.concatenate(diffs)
    assert np.abs(diffs).max() <= 1 and np.count_nonzero(diffs) <= 5e-3 * diffs.size


def test_checkpoint_v2e_params_override_the_flags(setup, monkeypatch):
    root, data, model, jcli = setup
    monkeypatch.setenv("V2E2V_PLATFORM", "cpu")
    parser = jcli.argparse.ArgumentParser()
    jconfigs.set_configs(parser)
    argv = _argv(data, model, root / "override")
    want = jcli.V2E2V(parser.parse_args(argv)).cfg.emulator
    got = tcli.V2E2V(parser.parse_args(argv), "cpu").cfg.emulator
    for name in ("pos_thres", "neg_thres", "ps", "pl", "cutoff_hz", "qs", "ql",
                 "refractory_period_s", "leak_rate_hz", "shot_noise_rate_hz", "num_bins",
                 "sigma_thres", "max_iters"):
        assert getattr(got, name) == getattr(want, name), name
    assert (got.pos_thres, got.pl, got.refractory_period_s) == (0.5, 1.4, 0.0005)


UNSUPPORTED = [
    (["--reader_type", "video"], {}, NotImplementedError, "item 4.*video decoder"),
    (["--reader_type", "upsampling"], {}, NotImplementedError, "item 8"),
    (["--quant", "int8"], {}, ValueError, "JAX V2E2V CLI .* does not read the flag"),
    (["--profile_dir", "trace"], {}, NotImplementedError, "item 10"),
    (["--dist_coordinator", "localhost:1"], {}, NotImplementedError, "item 9"),
    ([], {"V2E2V_DIST_AUTO": "1"}, NotImplementedError, "item 9"),
    (["--precision", "bfloat16"], {}, ValueError, "runs float32"),
    (["--model_mode", "cista-tc"], {}, ValueError, "cista-lstc"),
    (["-b", "17"], {}, ValueError, "at most 16"),
]


@pytest.mark.parametrize("argv,env,error,match", UNSUPPORTED,
                         ids=["video", "upsampling", "int8", "profile", "dist-flags",
                              "dist-auto", "bfloat16", "cista-tc", "bins"])
def test_refused_flags_raise(setup, monkeypatch, argv, env, error, match):
    root, data, model, _ = setup
    monkeypatch.setenv("V2E2V_PLATFORM", "cpu")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(error, match=match):
        tcli.main(_argv(data, model, root / "refused", *argv))
    assert not (root / "refused").exists()


def test_refuses_a_checkpoint_that_is_not_torch(setup, monkeypatch):
    root, data, _, _ = setup
    monkeypatch.setenv("V2E2V_PLATFORM", "cpu")
    with pytest.raises(ValueError, match="orbax"):
        tcli.main(_argv(data, root / "ckpt_dir", root / "orbax"))


def test_without_card_or_platform_raises(setup, monkeypatch):
    root, data, model, _ = setup
    monkeypatch.delenv("V2E2V_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(_argv(data, model, root / "nocard"))
