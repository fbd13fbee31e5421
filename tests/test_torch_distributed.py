"""The port's data axis over processes (``v2e2v_tpu_torch/parallel``,
``training/steps.py`` with ``mesh``) on the CPU: two ranks over ``gloo``, each
a process of tests/_torch_dist_worker.py on one torch thread, at 32x40, C = 8,
depth 2, T = 3, a global batch of 4.

- The 2-rank E2V, E2V device-data (its padding all on rank 1) and V2E2V steps
  against ``v2e2v_tpu/parallel/mesh.py``'s steps on ``make_mesh(2, 1)`` (the
  suite's virtual CPU devices), on the same weights, batch and (V2E2V) JAX
  key chain, replayed to the ranks; the JAX steps on
  ``fullres_impl="ref"``, as the port trains. Held: the loss to rtol 1e-6
  and each gradient to ``2e-5 * max |g|`` (tests/test_torch_train_step.py's
  tolerances), the ranks' numbers equal to each other.
- The same ranks against the port's single-process steps: the same
  tolerances, the V2E2V stats equal, and the device-data noise (drawn for
  the global batch, cut to a rank's rows) too.
- ``cli.train_e2v`` and ``cli.train`` as two processes with the ``--dist_*``
  flags against one process: the checkpoints within 2e-5 of each tensor's
  largest entry (observed 1.07e-5 for ``cli.train_e2v``), and only rank 0
  writes.
- ``initialize_from_flags``'s sources, ``make_mesh``'s rules and
  ``RowsNoise``.
"""

import argparse
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401
    JaxKeyNoise,
    free_port,
    no_new_jax_cache_entries,
    one_torch_thread,
)
from test_torch_train_step import C, DEPTH, H, NB, T, W, _run_jax, _weights, grad_keeper
from test_torch_train_v2e2v import EMU, N
from v2e2v_tpu.models import emulator as jemu
from v2e2v_tpu.models import v2e2v as jv2e2v
from v2e2v_tpu.parallel import mesh as jmesh
from v2e2v_tpu_torch.models import cista as tcista
from v2e2v_tpu_torch.models import emulator as temu
from v2e2v_tpu_torch.models import v2e2v as tv2e2v
from v2e2v_tpu_torch.parallel import distributed, mesh as tmesh
from v2e2v_tpu_torch.training import steps
from v2e2v_tpu_torch.utils.checkpoint import STEP_KEYS, params_from_jax
from v2e2v_tpu_torch.utils.configs import set_configs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_dist_worker.py")
B = 4  # the global batch: 2 rows a rank
GRAD_TOL = 2e-5
# of each tensor's largest entry, after 8 Adam steps: Adam scales every
# gradient entry to about +-lr, so entries near zero, whose sign the order of
# the ranks' sums decides, move a weight by up to lr a step (observed 1.07e-5)
CKPT_TOL = 2e-5


def start_ranks(job, workdir, *extra, world=2):
    port = str(free_port())
    env = {**os.environ, "V2E2V_PLATFORM": "cpu", "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen([sys.executable, WORKER, job, str(r), str(world), port,
                              str(workdir), *extra], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for r in range(world)]


def wait_ranks(procs, timeout=300):
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=timeout)
        assert p.returncode == 0, out
        outs.append(out)
    return outs


class Recording:
    """Records every draw of a noise source, in order."""

    def __init__(self, noise):
        self.noise, self.draws = noise, []
        self.explicit_shot = noise.explicit_shot

    def _keep(self, what, x):
        self.draws.append((what, x.clone()))
        return x

    def normal(self, what, shape, device):
        return self._keep(what, self.noise.normal(what, shape, device))

    def uniform(self, what, shape, device):
        return self._keep(what, self.noise.uniform(what, shape, device))


def _grads(sd):
    return {k: sd[k].grad.clone() for k in STEP_KEYS["cista-lstc"]}


def _inputs():
    jcfg, params, tcfg, _ = _weights("cista-lstc")
    jcfg = dataclasses.replace(jcfg, fullres_impl="ref")
    weights = params_from_jax(params, DEPTH, "cista-lstc")
    rng = np.random.default_rng(11)
    data = rng.normal(size=(6, T, H, W, NB)).astype(np.float32)
    gt_all = rng.uniform(size=(6, H, W, 1)).astype(np.float32)
    # frames of intensity <= 20, where lin_log is exact in both packages
    base = rng.uniform(2.0, 20.0, (B, 1, H, W)).astype(np.float32)
    rate = rng.uniform(-0.5, 0.5, (B, 1, H, W)).astype(np.float32)
    i = np.arange(T * (N - 1) + 1, dtype=np.float32).reshape(1, -1, 1, 1)
    video = np.clip(base * np.exp(rate * np.sin(i * 0.7)), 0, 20).astype(np.float32)
    t = np.arange(T * (N - 1) + 1, dtype=np.float32) * 0.004
    frames = np.stack([video[:, p * (N - 1):p * (N - 1) + N] for p in range(T)])
    ts = np.stack([np.tile(t[p * (N - 1):p * (N - 1) + N], (B, 1)) for p in range(T)])
    vcfg = tv2e2v.V2E2VConfig(cista=tcfg, emulator=temu.EmulatorConfig(**EMU, iters_impl="cuda"))
    jvcfg = jv2e2v.V2E2VConfig(cista=jcfg, emulator=jemu.EmulatorConfig(**EMU, iters_impl="xla"))
    return dict(
        cfg=tcfg, v2e2v_cfg=vcfg, weights=weights, noise_seed=7,
        seq=torch.from_numpy(rng.normal(size=(T, B, H, W, NB)).astype(np.float32)),
        gt=torch.from_numpy(rng.uniform(size=(B, H, W, 1)).astype(np.float32)),
        data=torch.from_numpy(data), gt_all=torch.from_numpy(gt_all),
        # a tail batch of 3 padded to 4: rank 0 rows [4, 1], rank 1 [3, pad]
        idx=torch.tensor([4, 1, 3, 3]), w=torch.tensor([1.0, 1.0, 1.0, 0.0]),
        frames=torch.from_numpy(frames), ts=torch.from_numpy(ts),
        vgt=torch.from_numpy(rng.uniform(size=(B, H, W, 1)).astype(np.float32)),
    ), (jcfg, jvcfg, params)


def _one_process(inp, jkey):
    """The port's single-process steps; the V2E2V one records JAX's draws."""
    cfg, vcfg, out = inp["cfg"], inp["v2e2v_cfg"], {}

    def fresh(c):
        sd = tcista.tie_weights({k: v.clone() for k, v in inp["weights"].items()}, c)
        return sd, steps.make_adam(sd, c, 1e-4)

    sd, opt = fresh(vcfg.cista)
    noise = Recording(JaxKeyNoise(jkey))
    loss, stats = steps.make_v2e2v_train_step(vcfg, opt)(
        sd, inp["frames"], inp["ts"], inp["vgt"], noise)
    out["v2e2v"] = {"loss": loss, "grads": _grads(sd),
                    "stats": {k: int(v) for k, v in stats.items()}}
    inp["draws"] = noise.draws

    sd, opt = fresh(cfg)
    out["e2v"] = {"loss": steps.make_e2v_train_step(cfg, opt)(sd, inp["seq"], inp["gt"]),
                  "grads": _grads(sd)}
    for name, noise_std in (("device_data", 0.0), ("device_data_noise", 0.1)):
        sd, opt = fresh(cfg)
        step = steps.make_e2v_train_step_device_data(cfg, opt, noise_std=noise_std)
        gen = torch.Generator().manual_seed(inp["noise_seed"])
        out[name] = {"loss": step(sd, inp["data"], inp["gt_all"], inp["idx"], gen, inp["w"]),
                     "grads": _grads(sd)}
    return out


def _jax_steps(inp, jcfg, jvcfg, params, jkey):
    mesh = jmesh.make_mesh(2, 1, devices=jax.devices("cpu")[:2])
    np_ = lambda t: np.array(t.numpy())  # noqa: E731
    out = {}
    step = jmesh.make_e2v_train_step(jcfg, grad_keeper(), mesh)
    (_, _, loss), grads = _run_jax(step, params, np_(inp["seq"]), np_(inp["gt"]))
    out["e2v"] = {"loss": float(loss), "grads": grads}
    step = jmesh.make_e2v_train_step_device_data(jcfg, grad_keeper(), mesh)
    (_, _, loss), grads = _run_jax(step, params, np_(inp["data"]), np_(inp["gt_all"]),
                                   np_(inp["idx"]).astype(np.int32), jax.random.PRNGKey(0),
                                   np_(inp["w"]))
    out["device_data"] = {"loss": float(loss), "grads": grads}
    step = jmesh.make_v2e2v_train_step(jvcfg, grad_keeper(), mesh)
    (_, _, loss, stats), grads = _run_jax(step, params, np_(inp["frames"]), np_(inp["ts"]),
                                          np_(inp["vgt"]), jkey)
    out["v2e2v"] = {"loss": float(loss), "grads": grads,
                    "stats": {k: int(v) for k, v in stats.items()}}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(one process, [rank 0, rank 1], JAX)``: the ranks run while this
    process compiles JAX's steps."""
    workdir = tmp_path_factory.mktemp("dist_steps")
    inp, (jcfg, jvcfg, params) = _inputs()
    jkey = jax.random.PRNGKey(5)
    single = _one_process(inp, jkey)
    torch.save(inp, workdir / "inputs.pt")
    procs = start_ranks("steps", workdir)
    try:
        jax_out = _jax_steps(inp, jcfg, jvcfg, params, jkey)
    finally:
        wait_ranks(procs)
    ranks = [torch.load(workdir / f"out{r}.pt", weights_only=False) for r in range(2)]
    return single, ranks, jax_out


def _assert_close(got, want, grad_tol=GRAD_TOL):
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-6)
    for k, g in got["grads"].items():
        w = np.asarray(want["grads"][k]).reshape(g.shape)
        tol = grad_tol * float(np.abs(w).max())
        err = float(np.abs(g.numpy() - w).max())
        assert err <= tol and float(np.abs(w).max()) > 0, (k, err, tol)


@pytest.mark.parametrize("name", ["e2v", "device_data", "v2e2v"])
def test_two_ranks_match_jax_on_a_mesh_of_two(runs, name):
    _, ranks, jax_out = runs
    _assert_close(ranks[0][name], jax_out[name])
    if name == "v2e2v":
        assert ranks[0][name]["stats"] == jax_out[name]["stats"]
        assert ranks[0][name]["stats"]["num_events"] > 1000


@pytest.mark.parametrize("name", ["e2v", "device_data", "device_data_noise", "v2e2v"])
def test_two_ranks_match_one_process(runs, name):
    single, ranks, _ = runs
    _assert_close(ranks[0][name], single[name])
    if name == "v2e2v":
        assert ranks[0][name]["stats"] == single[name]["stats"]
    # every rank holds the same reduced loss and gradients
    assert float(ranks[1][name]["loss"]) == float(ranks[0][name]["loss"])
    for k, g in ranks[0][name]["grads"].items():
        assert torch.equal(ranks[1][name]["grads"][k], g), k


@pytest.fixture(scope="module")
def train_data(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_train") / "data"
    subprocess.run([sys.executable, os.path.join(REPO, "scripts", "make_synth_data.py"),
                    "--out_dir", str(out), "--num_sequences", "2", "--num_frames", "18",
                    "--image_dim", "32", "40", "--num_pack_frames", "5", "--seed", "3"],
                   check=True, capture_output=True)
    return out


def _trainer_ranks_against_one(cli, flags, tmp_path, name, epoch):
    """``cli`` (``train_e2v`` or ``train``) as two ranks and as one process,
    side by side; each rank writes under its own ``--path_to_model``, so
    rank 1's must stay empty. Returns rank 0's and the one process's
    checkpoints of ``epoch``."""
    env = {**os.environ, "V2E2V_PLATFORM": "cpu", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": REPO}
    one = subprocess.Popen([sys.executable, "-m", f"v2e2v_tpu_torch.cli.{cli}", *flags,
                            "--path_to_model", str(tmp_path / "one")], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    port = str(free_port())
    procs = [subprocess.Popen(
        [sys.executable, WORKER, cli, str(r), "2", port, str(tmp_path), *flags,
         "--path_to_model", str(tmp_path / f"rank{r}")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = wait_ranks(procs + [one])
    assert "distributed: process 0/2" in outs[0] and "warning: dropped" not in outs[0]
    got = torch.load(tmp_path / "rank0" / name / f"{name}_{epoch}.pth.tar", weights_only=False)
    want = torch.load(tmp_path / "one" / name / f"{name}_{epoch}.pth.tar", weights_only=False)
    assert not list((tmp_path / "rank1").rglob("*.pth.tar"))
    return got, want


def _assert_checkpoints_close(got, want):
    worst = 0.0
    for k, w in want["state_dict"].items():
        scale = float(w.abs().max())
        err = float((got["state_dict"][k] - w).abs().max())
        worst = max(worst, err / max(scale, 1e-30))
        assert err <= CKPT_TOL * scale, (k, err, scale)
    print(f"largest checkpoint difference: {worst:.3g} of the tensor's largest entry")


def test_trainer_across_two_processes_matches_one(train_data, tmp_path):
    """Two epochs of ``cli.train_e2v`` as two ranks against one process."""
    flags = ["--path_to_train_data", str(train_data), "--image_dim", "32", "40", "-c", "8",
             "-d", "2", "--len_sequence", "3", "--num_events", "500", "--batch_size", "2",
             "--epochs", "2", "--add_noise"]
    _assert_checkpoints_close(*_trainer_ranks_against_one(
        "train_e2v", flags, tmp_path, "_cista-lstc_b5_d2_c8", 2))


def test_v2e2v_trainer_across_two_processes_matches_one(train_data, tmp_path):
    """One epoch of ``cli.train`` as two ranks against one process: each rank
    hands the step its rows of the batch and the emulator draws for the
    global batch (``RowsNoise``)."""
    flags = ["--path_to_train_data", str(train_data), "--image_dim", "32", "40", "-c", "8",
             "-d", "2", "--len_sequence", "3", "--num_pack_frames", "5", "--batch_size", "2",
             "--epochs", "1"]
    _assert_checkpoints_close(*_trainer_ranks_against_one(
        "train", flags, tmp_path, "_C0.6_1_1_fc0_1_1", 1))


def _cfgs(*argv):
    parser = argparse.ArgumentParser()
    set_configs(parser)
    return parser.parse_args(list(argv))


def test_initialize_takes_flags_then_variables_and_refuses_half_a_source(monkeypatch):
    for k in distributed.COORDINATOR_ENV + ("V2E2V_DIST_AUTO",):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize_from_flags(_cfgs()) is False
    assert distributed.initialize_from_flags(None) is False
    with pytest.raises(ValueError, match="--dist_num_processes and --dist_process_id"):
        distributed.initialize_from_flags(_cfgs("--dist_coordinator", "localhost:1"))
    monkeypatch.setenv("V2E2V_COORDINATOR", "localhost:1")
    with pytest.raises(ValueError, match="V2E2V_NUM_PROCESSES"):
        distributed.initialize_from_flags(_cfgs())
    assert not torch.distributed.is_initialized()


def test_a_world_of_one_over_the_variables(monkeypatch, capsys):
    """``V2E2V_*`` make a group of one; the mesh is the group; a step on it
    gives the numbers of no mesh, bit for bit; teardown leaves no group."""
    monkeypatch.setenv("V2E2V_PLATFORM", "cpu")
    monkeypatch.setenv("V2E2V_COORDINATOR", f"localhost:{free_port()}")
    monkeypatch.setenv("V2E2V_NUM_PROCESSES", "1")
    monkeypatch.setenv("V2E2V_PROCESS_ID", "0")
    assert distributed.initialize_from_flags(_cfgs()) is True
    try:
        assert "distributed: process 0/1, 1 local / 1 global devices (gloo)" in \
            capsys.readouterr().out
        assert distributed.is_main_process() and distributed.process_local_rows(6) == slice(0, 6)
        with pytest.raises(ValueError, match="one device per process"):
            tmesh.make_mesh(2)
        mesh = tmesh.make_mesh()
        assert mesh.n_data == 1 and mesh.group is not None and mesh.devices == (
            torch.device("cpu"),)
        _, _, tcfg, _ = _weights("cista-lstc")
        rng = np.random.default_rng(3)
        seq = torch.from_numpy(rng.normal(size=(T, 2, H, W, NB)).astype(np.float32))
        gt = torch.from_numpy(rng.uniform(size=(2, H, W, 1)).astype(np.float32))
        results = []
        for m in (None, mesh):
            sd = _weights("cista-lstc")[3]
            loss = steps.make_e2v_train_step(tcfg, steps.make_adam(sd, tcfg, 1e-4), mesh=m)(
                sd, seq, gt)
            results.append((loss, {k: sd[k].detach().clone() for k in STEP_KEYS["cista-lstc"]}))
        assert torch.equal(results[0][0], results[1][0])
        assert all(torch.equal(results[0][1][k], results[1][1][k]) for k in results[0][1])
    finally:
        distributed.shutdown()
    assert not torch.distributed.is_initialized()


def test_mesh_rules_and_rows():
    mesh = tmesh.make_mesh(4, devices=["cpu"] * 4)
    assert mesh.n_data == 4 and mesh.group is None and mesh.rows(torch.arange(8)).tolist() == [0, 1]
    assert tmesh.make_mesh(devices=["cpu"] * 3).n_data == 3
    with pytest.raises(ValueError):
        tmesh.make_mesh(2, devices=["cpu"])
    spatial = tmesh.Mesh((torch.device("cpu"),) * 2, group=object(), n_spatial=2,
                         spatial_rank=1)
    assert (spatial.n_data, spatial.rank, spatial.spatial_rank) == (1, 0, 1)
    assert spatial.rows(torch.arange(4)).tolist() == [0, 1, 2, 3]
    assert spatial.cols(np.arange(8).reshape(1, 8), 1).tolist() == [[4, 5, 6, 7]]
    assert spatial.shard == tmesh.Shard(None, 1, 2) and mesh.shard is None
    rank1 = tmesh.Mesh((torch.device("cpu"),) * 2, group=object(), rank=1)
    x = np.arange(12).reshape(2, 6)
    assert rank1.rows(x, 1).tolist() == [[3, 4, 5], [9, 10, 11]]
    with pytest.raises(ValueError, match="does not divide"):
        rank1.rows(np.arange(5))
    _, _, tcfg, sd = _weights("cista-lstc")
    with pytest.raises(ValueError, match="one process per device"):
        steps.make_e2v_train_step(tcfg, steps.make_adam(sd, tcfg, 1e-4), mesh=mesh)


def test_rows_noise_draws_the_global_batch():
    """Each draw is the global batch's, cut to the rows: the shot uniforms
    along their second axis."""
    def source():
        return temu.GeneratorNoise(torch.Generator().manual_seed(4), explicit_shot=True)

    whole, rows = source(), tmesh.RowsNoise(source(), slice(2, 4), 4)
    for what, shape, local, dim in (("pos_large", (4, 3, 5), (2, 3, 5), 0),
                                    ("shot", (7, 4, 3, 5), (7, 2, 3, 5), 1)):
        want = whole.uniform(what, shape, "cpu").narrow(dim, 2, 2)
        got = rows.uniform(what, local, "cpu")
        assert got.is_contiguous() and torch.equal(got, want)
    assert torch.equal(rows.seeds("shot_seed", 2, "cpu"), whole.seeds("shot_seed", 4, "cpu")[2:])
    with pytest.raises(ValueError, match="not 2 rows"):
        rows.normal("leak", (4, 3, 5), "cpu")


def test_voxel_noise_rows_are_the_global_draws():
    """``add_noise_to_voxel`` with ``rows`` adds those rows of the whole
    tensor's draws, at a noise fraction of 1 and below."""
    from v2e2v_tpu_torch.ops.voxel import add_noise_to_voxel

    voxel = torch.arange(3 * 4 * 5, dtype=torch.float32).reshape(3, 4, 5)
    for fraction in (1.0, 0.5):
        whole = add_noise_to_voxel(torch.Generator().manual_seed(2), voxel, 0.1, fraction)
        share = add_noise_to_voxel(torch.Generator().manual_seed(2), voxel[:, 2:], 0.1, fraction,
                                   rows=(1, slice(2, 4), 4))
        assert torch.equal(share, whole[:, 2:])
