"""The port's event generation tool (python -m v2e2v_tpu_torch.cli.generate_events)
against scripts/generate_events.py run in-process (``sys.argv`` patched, JAX on
the CPU), on two sequences of flickering HFR frames with intensities <= 19
(``lin_log`` exact in both). The port replays the JAX tool's one key for every
sequence (``JaxKeyNoise(PRNGKey(--seed))`` anew per sequence,
scripts/generate_events.py:47,76).

The same events come out, file by file: ``x``, ``y``, ``p`` exact (int16) and
``t`` within 1e-9 relative (bin-unit times are float32 in both; the
conversion to seconds is float64 numpy in both), with one repair: the JAX
tool cuts interval ``j`` as ``[t_j, t_j+1]`` and so writes an event that lies
on an interior frame time into two files (a pair's last-iteration events do;
30% more events in the files than emulated here), where the port writes each
event once, in ``(t_j, t_j+1]``. So each port file is the JAX file without
its events at ``t_j``, and the port's files hold exactly the printed total.
"""

import importlib.util
import os
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_parity import JaxKeyNoise, no_new_jax_cache_entries  # noqa: F401
from v2e2v_tpu_torch.cli import generate_events as tgen
from v2e2v_tpu_torch.data.synthetic import write_hfr_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, SEED = 24, 32, 4


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("gen")
    write_hfr_dataset(root / "frames", 1, 2, 17, H, W, base=(4.0, 7.0))
    return root


def _argv(data, out, *extra):
    return ["--path_to_test_data", str(data / "frames"), "--image_dim", str(H), str(W),
            "--num_pack_frames", "5", "--C", "0.5", "--pl", "1.5", "--ps", "0.5",
            "--cutoff_hz", "200", "--qs", "0", "--seed", str(SEED), "-o", str(out), *extra]


def _files(folder):
    return {p.relative_to(folder).as_posix(): dict(np.load(p))
            for p in sorted(folder.rglob("*.npz"))}


def test_event_files_match_jax_tool(data, monkeypatch, capsys):
    monkeypatch.setenv("V2E2V_NO_COMPILE_CACHE", "1")
    monkeypatch.delenv("V2E2V_PLATFORM", raising=False)
    spec = importlib.util.spec_from_file_location(
        "jax_generate_events", os.path.join(REPO, "scripts", "generate_events.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    monkeypatch.setattr(sys, "argv", ["generate_events.py", *_argv(data, data / "jax")])
    jtool.main()
    want_out = capsys.readouterr().out

    monkeypatch.setenv("V2E2V_PLATFORM", "cpu")
    total = tgen.generate(_parse(_argv(data, data / "port")), torch.device("cpu"),
                          noise_for_sequence=lambda _: JaxKeyNoise(jax.random.PRNGKey(SEED)))
    got_out = capsys.readouterr().out
    assert got_out.replace(str(data / "port"), "OUT") == want_out.replace(str(data / "jax"), "OUT")

    got, want = _files(data / "port"), _files(data / "jax")
    assert sorted(got) == sorted(want) and len(want) == 2 * 10
    dropped = 0
    for name, w in want.items():
        g = got[name]
        assert sorted(g) == sorted(w) == ["p", "t", "x", "y"]
        # file k of a sequence lies between frame times t_k and t_k+1
        seq, k = name.split("/")[0], int(name.rsplit("_", 1)[1][:-4])
        keep = w["t"] > _stamps(data, seq)[k]
        dropped += int(np.count_nonzero(~keep))
        for key in "xyp":
            assert g[key].dtype == w[key].dtype == np.int16
            np.testing.assert_array_equal(g[key], w[key][keep], err_msg=f"{name} {key}")
        assert g["t"].dtype == w["t"].dtype == np.float64
        np.testing.assert_allclose(g["t"], w["t"][keep], rtol=1e-9, atol=0, err_msg=name)
    assert sum(len(g["t"]) for g in got.values()) == total > 500
    assert sum(len(w["t"]) for w in want.values()) == total + dropped and dropped > 0


def test_each_event_is_written_to_one_interval(data, monkeypatch, capsys):
    """The repair's pin: the files hold the printed total, and every event of
    an interval file lies after its first frame time."""
    monkeypatch.setenv("V2E2V_PLATFORM", "cpu")
    out = data / "once"
    total = tgen.main(_argv(data, out))
    files = _files(out)
    assert sum(len(f["t"]) for f in files.values()) == total
    for name, f in files.items():
        seq, k = name.split("/")[0], int(name.rsplit("_", 1)[1][:-4])
        assert np.all(f["t"] > _stamps(data, seq)[k]), name


def _stamps(data, seq):
    from v2e2v_tpu_torch.data.video_readers import read_timestamps_file

    return read_timestamps_file(str(data / "frames" / seq / "frames" / "timestamps.txt"))


def _parse(argv):
    import argparse

    from v2e2v_tpu_torch.utils.configs import set_configs

    parser = argparse.ArgumentParser()
    set_configs(parser)
    return parser.parse_args(argv)


def test_main_runs_on_the_cpu_and_writes_the_total(data, monkeypatch, capsys):
    monkeypatch.setenv("V2E2V_PLATFORM", "cpu")
    out = data / "main"
    total = tgen.main(_argv(data, out, "--test_data_name", "sequence_0000000002"))
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and lines[0].startswith("sequence_0000000002: 3 packs / 10 "
                                                   f"intervals, {total} events")
    files = _files(out)
    assert len(files) == 10 and total > 300
    for f in files.values():
        assert np.all(np.diff(f["t"]) >= 0) and set(np.unique(f["p"])) <= {-1, 1}
        assert f["x"].max() < W and f["y"].max() < H


def test_main_without_card_or_platform_raises(data, monkeypatch):
    monkeypatch.delenv("V2E2V_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.main(_argv(data, data / "nocard"))
