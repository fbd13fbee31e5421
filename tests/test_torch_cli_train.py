"""The port's training CLIs (``python -m v2e2v_tpu_torch.cli.train_e2v`` and
``python -m v2e2v_tpu_torch.cli.train``) on the CPU, on data from
scripts/make_synth_data.py (two sequences of 24 frames at 32x40, C = 8,
depth 2, windows of 3): two epochs of E2V training write ``.pth.tar``
checkpoints that the port's evaluation CLI runs and the JAX package's
``load_torch_checkpoint`` loads to the same weights; resuming from epoch 1
equals a straight run of two epochs, the Adam moments included; the
device-data and worker paths train; V2E2V training warm-starts from the E2V
checkpoint and writes one that the port's V2E2V CLI rebuilds its emulator
from. Each flag neither CLI covers yet raises, naming its ROADMAP.md item;
``--mesh_spatial 2`` trains ``cli.train_e2v`` over two processes and is
refused by ``cli.train`` (the JAX package's V2E2V trainer has no spatial
axis either); the run flags of ROADMAP.md items 9 (the data axis) and 10 work: a world of
one over ``gloo`` from the ``--dist_*`` flags or torchrun's variables is
made and torn down around a run that writes its checkpoint,
``--profile_dir`` writes a trace, ``--debug_nans`` raises
``FloatingPointError`` on a batch holding a NaN and writes no checkpoint,
and ``--mesh_data 2`` in one process raises ``ValueError``.
The step's numbers against JAX's are in tests/test_torch_train_step.py.
"""

import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parity import free_port, no_new_jax_cache_entries, one_torch_thread  # noqa: F401
from v2e2v_tpu.utils import checkpoint as jckpt
from v2e2v_tpu_torch.data import datasets as tdatasets
from v2e2v_tpu_torch.cli import test as tcli_v2e2v
from v2e2v_tpu_torch.cli import test_e2v as tcli_e2v
from v2e2v_tpu_torch.cli import train as ttrain
from v2e2v_tpu_torch.cli import train_e2v as ttrain_e2v
from v2e2v_tpu_torch.utils.checkpoint import load_torch_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET = ["--image_dim", "32", "40", "-c", "8", "-d", "2", "--len_sequence", "3"]
E2V_NAME = "_cista-lstc_b5_d2_c8"
V2E2V_NAME = "_C0.6_1_1_fc0_1_1"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    out = tmp_path_factory.mktemp("train_cli") / "data"
    subprocess.run([sys.executable, os.path.join(REPO, "scripts", "make_synth_data.py"),
                    "--out_dir", str(out), "--num_sequences", "2", "--num_frames", "24",
                    "--image_dim", "32", "40", "--num_pack_frames", "5", "--seed", "3"],
                   check=True, capture_output=True)
    return out


def _e2v_argv(data, models, *extra):
    return ["--path_to_train_data", str(data), "--num_events", "500", "--path_to_model",
            str(models), *NET, *extra]


def _train_e2v(monkeypatch, data, models, *extra):
    monkeypatch.setenv("V2E2V_PLATFORM", "cpu")
    ttrain_e2v.main(_e2v_argv(data, models, *extra))
    return models / E2V_NAME


def _ckpt(folder, name, epoch):
    return folder / f"{name}_{epoch}.pth.tar"


@pytest.fixture(scope="module")
def e2v_run(data, tmp_path_factory):
    """Two epochs of E2V training with --add_noise and --cache_samples."""
    models = tmp_path_factory.mktemp("e2v_models")
    mp = pytest.MonkeyPatch()
    try:
        folder = _train_e2v(mp, data, models, "--epochs", "2", "--add_noise", "--cache_samples")
    finally:
        mp.undo()
    return folder


def test_e2v_checkpoints_load_in_both_packages(e2v_run):
    path = _ckpt(e2v_run, E2V_NAME, 2)
    sd, epoch, v2e = load_torch_checkpoint(str(path))
    assert epoch == 1 and v2e is None
    raw = torch.load(path, map_location="cpu", weights_only=False)
    assert set(raw) == {"epoch", "state_dict", "optimizer"}
    assert {"lista_blocks.0.Lambda", "lista_blocks.1.Lambda"} <= set(sd)
    assert torch.equal(sd["lista_blocks.1.P.conv2d.weight"], sd["lista_blocks.0.P.conv2d.weight"])
    first, _, _ = load_torch_checkpoint(str(_ckpt(e2v_run, E2V_NAME, 1)))
    assert not torch.equal(first["We.conv2d.weight"], sd["We.conv2d.weight"])  # it trained
    params, jepoch, _ = jckpt.load_torch_checkpoint(str(path), "cista-lstc")
    assert jepoch == 1
    back = jckpt.export_torch_state_dict(params, "cista-lstc", depth=2)
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_e2v_checkpoint_runs_in_the_evaluation_cli(e2v_run, data, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("V2E2V_PLATFORM", "cpu")
    tcli_e2v.main(["--path_to_test_model", str(_ckpt(e2v_run, E2V_NAME, 2)),
                   "--path_to_test_data", str(data), *NET, "-o", str(tmp_path / "out")])
    assert capsys.readouterr().out.count("Test set sequence_") == 2
    assert len(list((tmp_path / "out").rglob("frame_*.png"))) > 10


def test_resume_equals_a_straight_run(e2v_run, data, tmp_path, monkeypatch):
    """--load_epoch_for_train 1 --epochs 2 from the straight run's epoch-1
    checkpoint gives its epoch-2 weights and Adam moments bit for bit."""
    folder = tmp_path / E2V_NAME
    folder.mkdir()
    shutil.copy(_ckpt(e2v_run, E2V_NAME, 1), _ckpt(folder, E2V_NAME, 1))
    _train_e2v(monkeypatch, data, tmp_path, "--epochs", "2", "--add_noise", "--cache_samples",
               "--load_epoch_for_train", "1")
    want = torch.load(_ckpt(e2v_run, E2V_NAME, 2), map_location="cpu", weights_only=False)
    got = torch.load(_ckpt(folder, E2V_NAME, 2), map_location="cpu", weights_only=False)
    assert got["epoch"] == want["epoch"] == 1
    for k, v in want["state_dict"].items():
        assert torch.equal(got["state_dict"][k], v), k
    for i, s in want["optimizer"]["state"].items():
        for name, v in s.items():
            assert torch.equal(got["optimizer"]["state"][i][name], v), (i, name)


@pytest.mark.parametrize("extra", [
    ("--num_workers", "2", "--batch_size", "1"),
    ("--device_data", "f32", "--drop_seq_tails", "--batch_size", "2", "--add_noise"),
    ("--device_data", "bf16", "--drop_seq_tails", "--batch_size", "2"),
    ("--model_mode", "cista-tc", "--is_SummaryWriter"),
], ids=["workers", "device_data-f32", "device_data-bf16", "cista-tc"])
def test_e2v_training_paths(data, tmp_path, monkeypatch, capsys, extra):
    monkeypatch.chdir(tmp_path)  # the scalar logger writes summary/ here
    _train_e2v(monkeypatch, data, tmp_path, "--epochs", "1", *extra)
    out = capsys.readouterr().out
    mode = "cista-tc" if "cista-tc" in extra else "cista-lstc"
    name = E2V_NAME.replace("cista-lstc", mode)
    sd, _, _ = load_torch_checkpoint(str(_ckpt(tmp_path / name, name, 1)), mode)
    assert all(torch.isfinite(v).all() for v in sd.values())
    loss = float(out.split("mean loss ")[1].split()[0])
    assert 0.0 < loss < 2.0
    if "--device_data" in extra:
        assert "uploading dataset to device" in out and "padded" in out
    if "--is_SummaryWriter" in extra:
        assert os.listdir(tmp_path / "summary" / name)


def test_device_data_needs_drop_seq_tails(data, tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="drop_seq_tails"):
        _train_e2v(monkeypatch, data, tmp_path, "--device_data", "f32")


@pytest.fixture(scope="module")
def v2e2v_run(e2v_run, data, tmp_path_factory):
    """One epoch of V2E2V training warm-started from the E2V checkpoint."""
    models = tmp_path_factory.mktemp("v2e2v_models")
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("V2E2V_PLATFORM", "cpu")
        ttrain.main(["--path_to_train_data", str(data), "--path_to_model", str(models),
                     "--path_to_e2v", str(_ckpt(e2v_run, E2V_NAME, 2)), "--num_pack_frames",
                     "5", *NET, "--epochs", "1", "--display_train", "-o",
                     str(models / "panels")])
    finally:
        mp.undo()
    return models


def test_v2e2v_training_warm_starts_and_feeds_the_v2e2v_cli(v2e2v_run, e2v_run, data, tmp_path,
                                                           monkeypatch, capsys):
    path = _ckpt(v2e2v_run / V2E2V_NAME, V2E2V_NAME, 1)
    raw = torch.load(path, map_location="cpu", weights_only=False)
    assert raw["epoch"] == 1 and all(k.startswith("e2v_net.") for k in raw["state_dict"])
    assert raw["v2e_params"] == {"C": 0.6, "ps": 1.0, "pl": 1.0, "cutoff_hz": 0.0, "qs": 1.0,
                                 "ql": 1.0, "refractory_period_s": 0.001}
    assert list((v2e2v_run / "panels").rglob("panel_*.png"))
    sd, _, _ = load_torch_checkpoint(str(path))
    start, _, _ = load_torch_checkpoint(str(_ckpt(e2v_run, E2V_NAME, 2)))
    assert set(sd) == set(start)
    assert not torch.equal(sd["W0.conv2d.weight"], start["W0.conv2d.weight"])
    params, _, v2e = jckpt.load_torch_checkpoint(str(path), "cista-lstc")
    assert v2e == raw["v2e_params"]
    np.testing.assert_array_equal(jckpt.export_torch_state_dict(params, depth=2)["We.conv2d.weight"],
                                  sd["We.conv2d.weight"].numpy())

    # the V2E2V CLI rebuilds the emulator from v2e_params, over the flags
    monkeypatch.setenv("V2E2V_PLATFORM", "cpu")
    cfgs = ttrain_e2v.parse_flags(["--path_to_test_model", str(path), "--path_to_test_data",
                                   str(data), *NET, "--num_pack_frames", "5", "--C", "0.3",
                                   "-o", str(tmp_path / "out")], "test")
    runner = tcli_v2e2v.V2E2V(cfgs, "cpu")
    assert runner.cfg.emulator.pos_thres == 0.6 and runner.cfg.emulator.refractory_period_s == 1e-3
    runner.run()
    assert "Avg number of events per reconstruction" in capsys.readouterr().out
    assert list((tmp_path / "out").rglob("frame_*.png"))


def test_v2e2v_resume_and_device_data(v2e2v_run, data, tmp_path, monkeypatch, capsys):
    folder = tmp_path / V2E2V_NAME
    folder.mkdir()
    shutil.copy(_ckpt(v2e2v_run / V2E2V_NAME, V2E2V_NAME, 1), _ckpt(folder, V2E2V_NAME, 1))
    monkeypatch.setenv("V2E2V_PLATFORM", "cpu")
    ttrain.main(["--path_to_train_data", str(data), "--path_to_model", str(tmp_path),
                 "--num_pack_frames", "5", *NET, "--epochs", "2", "--load_epoch_for_train",
                 "1", "--device_data", "f32", "--drop_seq_tails", "--batch_size", "2"])
    assert "uploading dataset to device" in capsys.readouterr().out
    got = torch.load(_ckpt(folder, V2E2V_NAME, 2), map_location="cpu", weights_only=False)
    assert got["epoch"] == 2 and got["optimizer"]["state"]


def _refusals():
    cases = []
    for cli in ("train_e2v", "train"):
        for argv, env, item in [
            (["--mesh_spatial", "2"], {}, "no spatial axis either" if cli == "train" else None),
        ]:
            name = (argv[0].lstrip("-") if argv else next(iter(env))).lower()
            cases.append(pytest.param(cli, argv, env, item, id=f"{cli}-{name}"))
    return cases


def _train_e2v_over_two_processes(data, tmp_path, *argv):
    """``cli.train_e2v`` with ``argv`` as two gloo ranks of one epoch, each
    writing under its own ``--path_to_model``; rank 0's output."""
    worker = os.path.join(REPO, "tests", "_torch_dist_worker.py")
    env = {**os.environ, "V2E2V_PLATFORM": "cpu", "OMP_NUM_THREADS": "1"}
    port = str(free_port())
    procs = [subprocess.Popen(
        [sys.executable, worker, "train_e2v", str(r), "2", port, str(tmp_path),
         *_e2v_argv(data, tmp_path / f"rank{r}", "--epochs", "1", *argv)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    return outs[0]


@pytest.mark.parametrize("cli,argv,env,item", _refusals())
def test_unsupported_flags_raise_with_their_item(cli, argv, env, item, data, tmp_path,
                                                 monkeypatch):
    """Each flag raises, naming its ROADMAP.md item or why; ``--mesh_spatial 2``
    (``item`` None) trains ``cli.train_e2v`` over two processes, rank 0
    alone writing the checkpoint."""
    if item is None:
        out = _train_e2v_over_two_processes(data, tmp_path, *argv)
        assert "distributed: process 0/2" in out and "Train Epoch: 1" in out
        assert _ckpt(tmp_path / "rank0" / E2V_NAME, E2V_NAME, 1).exists()
        assert not list((tmp_path / "rank1").rglob("*.pth.tar"))
        return
    module = ttrain_e2v if cli == "train_e2v" else ttrain
    monkeypatch.setenv("V2E2V_PLATFORM", "cpu")
    weights = tmp_path / "vgg.pth"
    weights.write_bytes(b"")
    for k, v in env.items():
        monkeypatch.setenv(k, str(weights) if v == "FILE" else v)
    error = ValueError if argv else NotImplementedError
    with pytest.raises(error, match=item):
        module.main(_e2v_argv(data, tmp_path / "models", *argv))
    assert not (tmp_path / "models").exists()


LIFTED = ["mesh_data", "dist_coordinator", "v2e2v_dist_auto", "profile_dir", "debug_nans"]


def _with_nan(cls, part):
    """``cls._emit`` with a NaN in the sample's part ``part``."""
    emit = cls._emit

    def nan_emit(self, index, sample):
        out = list(emit(self, index, sample))
        out[part] = np.array(out[part], np.float32)
        out[part].flat[-1] = np.nan  # the last frame: the V2E2V loss reads its gt
        return tuple(out)

    return nan_emit


@pytest.mark.parametrize("cli,flag", [pytest.param(cli, flag, id=f"{cli}-{flag}")
                                      for cli in ("train_e2v", "train") for flag in LIFTED])
def test_lifted_flags_are_honoured(cli, flag, data, tmp_path, monkeypatch, capsys):
    module = ttrain_e2v if cli == "train_e2v" else ttrain
    name = E2V_NAME if cli == "train_e2v" else V2E2V_NAME
    models = tmp_path / "models"
    argv = _e2v_argv(data, models, "--epochs", "1",
                     *(["--num_pack_frames", "5"] if cli == "train" else []))
    monkeypatch.setenv("V2E2V_PLATFORM", "cpu")
    if flag == "mesh_data":
        with pytest.raises(ValueError, match="n_data=2 needs 2 devices"):
            module.main(argv + ["--mesh_data", "2"])
        assert not models.exists()
        return
    if flag == "debug_nans":
        # E2V: a NaN in a voxel grid; V2E2V: in the ground truth
        cls, part = ((tdatasets.TrainFixNEventData, 0) if cli == "train_e2v"
                     else (tdatasets.TrainSeqData, 2))
        monkeypatch.setattr(cls, "_emit", _with_nan(cls, part))
        with pytest.raises(FloatingPointError, match="NaN in the loss"):
            module.main(argv + ["--debug_nans"])
        assert "Train Epoch" not in capsys.readouterr().out  # its first step raised
        assert not list(models.rglob("*.pth.tar")) and not torch.is_anomaly_enabled()
        return
    port = str(free_port())
    if flag == "dist_coordinator":
        argv += ["--dist_coordinator", f"localhost:{port}", "--dist_num_processes", "1",
                 "--dist_process_id", "0"]
    elif flag == "v2e2v_dist_auto":
        for k, v in {"V2E2V_DIST_AUTO": "1", "MASTER_ADDR": "localhost", "MASTER_PORT": port,
                     "RANK": "0", "WORLD_SIZE": "1"}.items():
            monkeypatch.setenv(k, v)
    else:
        argv += ["--profile_dir", str(tmp_path / "trace")]
    module.main(argv)
    out = capsys.readouterr().out
    assert _ckpt(models / name, name, 1).exists()
    assert not torch.distributed.is_initialized()
    if flag == "profile_dir":
        traces = list((tmp_path / "trace").glob("rank0.*.pt.trace.json"))
        assert len(traces) == 1 and traces[0].stat().st_size > 0
    else:
        assert "process 0/1, 1 local / 1 global devices (gloo)" in out


# ------------------------------------------------------------------ LPIPS

class _FirstStep(Exception):
    """Raised by a wrapped train step after its first loss."""


def _stop_after_first_step(monkeypatch, module, name, losses):
    """``module.name`` (a step builder) with its step's first loss recorded
    in ``losses``, then ``_FirstStep``."""
    make = getattr(module, name)

    def wrapped(*args, **kw):
        step = make(*args, **kw)

        def first(*a):
            out = step(*a)
            # the port: loss or (loss, stats); JAX: (params, opt_state, loss[, stats])
            loss = out if isinstance(out, torch.Tensor) else out[0] if len(out) == 2 else out[2]
            losses.append(float(loss))
            raise _FirstStep

        return first

    monkeypatch.setattr(module, name, wrapped)


@pytest.fixture(scope="module")
def lpips_setup(tmp_path_factory):
    """Random VGG16 weights in the ``{'vgg', 'lin'}`` layout, HFR frames of
    intensity <= 19 (where the emulator's ``lin_log`` is exact in both
    packages) with a V2E2V manifest, a .pth.tar of JAX's initial weights at
    seed 0, and the JAX trainers loaded from the root."""
    import importlib.util

    import jax
    from test_torch_lpips import write_vgg
    from v2e2v_tpu.models import cista as jcista
    from v2e2v_tpu_torch.data.manifests import make_train_txt_wo_events
    from v2e2v_tpu_torch.data.synthetic import write_hfr_dataset

    root = tmp_path_factory.mktemp("lpips_train")
    weights = write_vgg(root / "vgg.pth", "vgg_lin")
    hfr = root / "hfr"
    write_hfr_dataset(hfr, 7, 2, 13, 32, 40, base=(2.0, 19.0))
    make_train_txt_wo_events(str(hfr), "train_v2e2v.txt", num_frames=5, step=4)
    cfg = jcista.CistaConfig(image_dim=(32, 40), base_channels=8, depth=2, num_bins=5)
    params = jax.tree_util.tree_map(np.asarray, jcista.init_cista_lstc(jax.random.PRNGKey(0),
                                                                         cfg))
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
          jckpt.export_torch_state_dict(params, "cista-lstc", depth=2).items()}
    e2v = root / "e2v.pth.tar"
    torch.save({"epoch": 1, "state_dict": sd, "v2e_params": None}, e2v)
    clis = {}
    for name in ("train_e2v", "train"):
        spec = importlib.util.spec_from_file_location(f"jax_{name}_cli",
                                                      os.path.join(REPO, f"{name}.py"))
        clis[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(clis[name])
    return weights, hfr, e2v, params, clis


@pytest.mark.parametrize("cli", ["train_e2v", "train"])
def test_lpips_trainers_match_the_jax_trainers(cli, lpips_setup, data, tmp_path, monkeypatch,
                                               capsys):
    """With ``V2E2V_LPIPS_WEIGHTS`` naming a file, each trainer trains on
    ``LPIPS + L1 + (1 - SSIM)``: its first loss equals the JAX trainer's
    within 1e-5 relative, from the same weights (the port's E2V init replaced
    by JAX's seed-0 weights; the V2E2V trainers warm-started from them) and,
    for V2E2V, the same emulator draws (JAX's key chain replayed)."""
    import jax
    from v2e2v_tpu.parallel import mesh as jmesh
    from v2e2v_tpu.utils import configs as jconfigs
    from v2e2v_tpu_torch.models import cista as tcista
    from v2e2v_tpu_torch.training import steps as tsteps
    from v2e2v_tpu_torch.utils.checkpoint import params_from_jax
    from _torch_parity import JaxKeyNoise

    weights, hfr, e2v, params, clis = lpips_setup
    # the JAX trainers on the reference full-resolution layout, of which their
    # default fused one is an exact rewrite: its compile takes a minute on the CPU
    from v2e2v_tpu.models import cista as jcista
    from v2e2v_tpu.models import v2e2v as jv2e2v

    @dataclasses.dataclass(frozen=True)
    class RefLayout(jcista.CistaConfig):
        fullres_impl: str = "ref"

    monkeypatch.setattr(jcista, "CistaConfig", RefLayout)
    monkeypatch.setattr(jv2e2v, "CistaConfig", RefLayout)
    monkeypatch.setenv("V2E2V_PLATFORM", "cpu")
    monkeypatch.setenv("V2E2V_LPIPS_WEIGHTS", weights)
    if cli == "train_e2v":
        argv = _e2v_argv(data, tmp_path / "models", "--epochs", "1")
        builder, module = "make_e2v_train_step", ttrain_e2v
        monkeypatch.setattr(tcista, "init_cista_lstc",
                            lambda *a, **k: {n: v.contiguous() for n, v in
                                             params_from_jax(params, 2).items()})
    else:
        argv = ["--path_to_train_data", str(hfr), "--path_to_model", str(tmp_path / "models"),
                "--path_to_e2v", str(e2v), "--num_pack_frames", "5", *NET, "--epochs", "1"]
        builder, module = "make_v2e2v_train_step", ttrain
        monkeypatch.setattr(ttrain.Train, "noise", lambda self, step: JaxKeyNoise(
            jax.random.fold_in(jax.random.key(0, impl="rbg"), step)))
    losses = {"port": [], "jax": []}
    _stop_after_first_step(monkeypatch, tsteps, builder, losses["port"])
    _stop_after_first_step(monkeypatch, jmesh, builder, losses["jax"])
    with pytest.raises(_FirstStep):
        module.main(argv)
    assert "LPIPS weights unavailable" not in capsys.readouterr().out
    parser = jconfigs.argparse.ArgumentParser()
    jconfigs.set_configs(parser)
    cfgs = parser.parse_args(argv)
    cfgs.shuffle = True
    with pytest.raises(_FirstStep):
        clis[cli].Train(cfgs).run()
    assert len(losses["port"]) == len(losses["jax"]) == 1
    np.testing.assert_allclose(losses["port"][0], losses["jax"][0], rtol=1e-5)
    # without the weights the same step's loss is lower by the distance
    monkeypatch.delenv("V2E2V_LPIPS_WEIGHTS")
    with pytest.raises(_FirstStep):
        module.main(argv)
    assert "LPIPS weights unavailable" in capsys.readouterr().out
    assert losses["port"][1] < losses["port"][0]
