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
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_parity import (  # noqa: F401
    JaxKeyNoise,
    assert_off_integers,
    no_new_jax_cache_entries,
    pair_magnitudes,
    run_flags,
    torch_threads,
    write_ckpt,
)
from v2e2v_tpu.data import interpolating_reader as jir
from v2e2v_tpu.models import cista as jcista
from v2e2v_tpu.utils import configs as jconfigs
from v2e2v_tpu.utils.checkpoint import export_torch_state_dict
from v2e2v_tpu_torch.cli import test as tcli
from v2e2v_tpu_torch.data import interpolating_reader as tir
from v2e2v_tpu_torch.models import superslomo as tss
from v2e2v_tpu_torch.utils.image_io import read_gray
from v2e2v_tpu_torch.data.synthetic import write_hfr_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, C, DEPTH, SEED = 32, 40, 8, 2, 3
FLOW_SCALE = 66.0  # the upsampling run's flows: 4 frames a pair, >= 0.4 from an integer
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


def _compare_clis(setup, monkeypatch, capsys, tag, n_packs, *extra):
    """Run both CLIs with ``extra`` and hold them to each other: the printed
    averages, the previews and panels' input frames equal, the
    reconstructions within one level on at most 0.5% of the pixels."""
    root, data, model, jcli = setup
    monkeypatch.setenv("V2E2V_PLATFORM", "cpu")
    extra = ("--is_write_event", "--display_test", *extra)
    tcli.main(_argv(data, model, root / f"port{tag}", *extra), noise_for_sequence=_jax_noise)
    got_out = capsys.readouterr().out
    parser = jcli.argparse.ArgumentParser()
    jconfigs.set_configs(parser)
    jcli.V2E2V(parser.parse_args(_argv(data, model, root / f"jax{tag}", *extra))).run()
    want_out = capsys.readouterr().out

    def averages(text):
        return [line for line in text.splitlines() if line.startswith("Avg number of events")]

    assert len(averages(want_out)) == 2 and averages(got_out) == averages(want_out)
    assert float(averages(want_out)[0].split(": ")[1]) > 100
    got, want = _pngs(root / f"port{tag}"), _pngs(root / f"jax{tag}")
    assert sorted(got) == sorted(want)
    kinds = {k.split("/")[-1].split("_")[0] for k in want}
    assert kinds == {"frame", "events", "panel"}
    assert sum(k.split("/")[-1].startswith("frame_") for k in want) == 2 * n_packs
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


def test_cli_matches_jax_cli(setup, monkeypatch, capsys):
    _compare_clis(setup, monkeypatch, capsys, "", 3)


def test_upsampling_cli_matches_jax_cli(setup, monkeypatch, capsys):
    """``--reader_type upsampling`` over each sequence's first 4 frames, both
    CLIs reading one checkpoint through ``V2E2V_SUPERSLOMO_CKPT`` (the JAX
    package's random weights, the flow scaled so that every pair gives 4
    frames: 13 a sequence, 2 packs of 5). Each reader upsamples; the two
    upsampled sequences have equal stamps and frames within one code
    (``tests/test_torch_interpolating_reader.py`` counts them), and the JAX
    reader then serves the port's frames, so that the emulators see the same
    frames and the events compare exactly."""
    root, data, model, jcli = setup
    monkeypatch.setenv(tss.CKPT_ENV_VAR, str(write_ckpt(root / "scaled.ckpt", FLOW_SCALE)))
    served = []
    port_init, jax_init = tir.InterpolatingReader.initialize, jir.InterpolatingReader.initialize

    def port_initialize(self, path, num_load_frames):
        port_init(self, path, num_load_frames)
        lfr = [read_gray(str(p)) for p in sorted(Path(path).rglob("*.png"))[:num_load_frames]]
        assert_off_integers(pair_magnitudes(self._upsampler, lfr), 4, 4)
        served.append((self.frames, self.timestamps))

    def jax_initialize(self, *args):
        jax_init(self, *args)
        frames, stamps = served.pop(0)
        np.testing.assert_array_equal(self.timestamps, stamps)
        assert np.abs(self.frames.astype(int) - frames.astype(int)).max() <= 1
        self.frames = frames

    monkeypatch.setattr(tir.InterpolatingReader, "initialize", port_initialize)
    monkeypatch.setattr(jir.InterpolatingReader, "initialize", jax_initialize)
    _compare_clis(setup, monkeypatch, capsys, "_upsampling", 2,
                  "--reader_type", "upsampling", "--test_img_num", "4")
    assert not served


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
    (["--quant", "int8"], {}, ValueError, "JAX V2E2V CLI .* does not read the flag"),
    (["--precision", "bfloat16"], {}, ValueError, "runs float32"),
    (["--model_mode", "cista-tc"], {}, ValueError, "cista-lstc"),
    (["-b", "17"], {}, ValueError, "at most 16"),
]


@pytest.fixture(scope="module")
def plain_run(setup):
    """The port's CLI once, without run flags."""
    root, data, model, _ = setup
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("V2E2V_PLATFORM", "cpu")
        with torch_threads(1):  # as the runs it is held against
            tcli.main(_argv(data, model, root / "plain"))
    finally:
        mp.undo()
    return root / "plain"


@pytest.mark.parametrize("case", ["profile", "dist-flags", "dist-auto"])
def test_run_flags_are_honoured(setup, plain_run, monkeypatch, capsys, tmp_path, case):
    """A world of one over ``gloo`` is made and torn down, and
    ``--profile_dir`` is accepted and ignored, as test.py ignores it: the
    written frames equal those of the run without them."""
    root, data, model, _ = setup
    argv, env = run_flags(case, tmp_path / "trace")
    monkeypatch.setenv("V2E2V_PLATFORM", "cpu")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with torch_threads(1):  # beside the suite's other workers
        tcli.main(_argv(data, model, tmp_path / "out", *argv))
    out = capsys.readouterr().out
    assert not torch.distributed.is_initialized()
    if case == "profile":
        assert not (tmp_path / "trace").exists()
    else:
        assert "process 0/1, 1 local / 1 global devices (gloo)" in out
    got, want = _pngs(tmp_path / "out"), _pngs(plain_run)
    assert want and sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)


@pytest.mark.parametrize("argv,env,error,match", UNSUPPORTED,
                         ids=["video", "int8", "bfloat16", "cista-tc", "bins"])
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
