"""Port's CISTA-TC (``cista_tc_step``, its checkpoint names, ``StreamPool``
and the E2V CLI with ``--model_mode cista-tc``) against v2e2v_tpu.

JAX runs its reference-shaped path (``fullres_impl='ref'``). Tolerances:
float32 within 2e-5 over 3 steps with the state fed back (observed: about
1e-7); bfloat16 within 3e-2 (a few bf16 ulps, as the LSTC pool's parity in
tests/test_torch_serving.py); the pool within 2e-5; the CLI as
tests/test_torch_cli_e2v.py holds the LSTC CLI.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import no_new_jax_cache_entries  # noqa: F401
from test_torch_cli_e2v import _recording, _result, _split, setup  # noqa: F401
from v2e2v_tpu import serving as jserving
from v2e2v_tpu.data import video_readers as jvr
from v2e2v_tpu.models import cista as jcista
from v2e2v_tpu.utils import configs as jconfigs
from v2e2v_tpu.utils.checkpoint import convert_torch_state_dict, export_torch_state_dict
from v2e2v_tpu_torch import serving as tserving
from v2e2v_tpu_torch.cli import test_e2v as tcli
from v2e2v_tpu_torch.data import video_readers as tvr
from v2e2v_tpu_torch.models import cista as tcista
from v2e2v_tpu_torch.utils import checkpoint as tcheckpoint
from v2e2v_tpu_torch.utils.checkpoint import params_from_jax

H, W, C, NB, DEPTH = 32, 40, 8, 5, 2
TC = "cista-tc"


def _jcfg():
    return jcista.CistaConfig(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB,
                              model_mode=TC, fullres_impl="ref")


def _tcfg():
    return tcista.CistaConfig(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB,
                              model_mode=TC)


def _params_np(seed=0, cfg=None):
    params = jcista.init_cista_tc(jax.random.PRNGKey(seed), cfg or _jcfg())
    return jax.tree_util.tree_map(np.asarray, params)


def _voxels(steps=3, b=2, seed=0):
    return np.random.default_rng(seed).standard_normal((steps, b, H, W, NB)).astype(np.float32)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 3e-2)])
def test_step_matches_jax_over_three_steps(dtype, tol):
    params = _params_np()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), params)
    sd = {k: v.to(tdt) for k, v in params_from_jax(params, DEPTH, TC).items()}
    vox = _voxels()
    jstate = jcista.cista_zero_state(_jcfg(), 2, jdt)
    tstate = tcista.cista_zero_state(_tcfg(), 2, tdt, "cpu")
    jprev = jnp.zeros((2, H, W, 1), jdt)
    tprev = torch.zeros((2, H, W, 1), dtype=tdt)
    for ev in vox:
        jprev, jstate = jcista.cista_tc_step(jparams, _jcfg(), jnp.asarray(ev, jdt), jprev, jstate)
        tprev, tstate = tcista.cista_tc_step(sd, _tcfg(), torch.from_numpy(ev).to(tdt), tprev,
                                             tstate)
        got = [tprev, tstate.cell, tstate.z, *tstate.dg]
        want = [jprev, jstate.cell, jstate.z, *jstate.dg]
        for g, w in zip(got, want):
            assert g.dtype == tdt
            np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                       rtol=0, atol=tol)
    assert not torch.any(tstate.cell)  # cista-tc carries the cell unused


def test_sequence_runs_the_tc_step():
    params = _params_np(1)
    vox = _voxels(seed=1)
    want, want_state = jcista.cista_sequence(params, _jcfg(), jnp.asarray(vox))
    got, got_state = tcista.cista_sequence(params_from_jax(params, DEPTH, TC), _tcfg(),
                                           torch.from_numpy(vox))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)
    np.testing.assert_allclose(got_state.z.numpy(), np.asarray(want_state.z), rtol=0, atol=2e-5)


def test_checkpoint_round_trip(tmp_path):
    """JAX export -> .pth.tar -> the port's loader gives ``params_from_jax``;
    the port's own export equals JAX's; JAX reads the port's state dict back
    to the same tree."""
    params = _params_np(2)
    want_sd = export_torch_state_dict(params, TC, depth=DEPTH)
    assert {"alpha.0", f"alpha.{DEPTH - 1}", "P0.conv2d.weight",
            "one_conv_for_prev.conv2d.weight", "one_conv_for_cur.conv2d.bias"} <= set(want_sd)
    port_sd = tcheckpoint.export_torch_state_dict(params, DEPTH, TC)
    assert set(port_sd) == set(want_sd)
    for k, v in want_sd.items():
        np.testing.assert_array_equal(port_sd[k], v)
    torch.save({"epoch": 3, "state_dict": {f"e2v_net.{k}": torch.from_numpy(np.array(v))
                                           for k, v in want_sd.items()}},
               tmp_path / "tc.pth.tar")
    got, epoch, v2e = tcheckpoint.load_torch_checkpoint(str(tmp_path / "tc.pth.tar"), TC)
    assert (epoch, v2e) == (3, None)
    ref = params_from_jax(params, DEPTH, TC)
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert torch.equal(got[k], v), k
    back = convert_torch_state_dict({k: v.numpy() for k, v in got.items()}, TC)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(params),
                            jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_init_cista_tc_names_and_ties():
    cfg = dataclasses.replace(_tcfg(), depth=3)
    sd = tcista.init_cista_tc(torch.Generator().manual_seed(0), cfg, device="cpu")
    want = set(tcheckpoint.export_torch_state_dict(_params_np(cfg=dataclasses.replace(
        _jcfg(), depth=3)), 3, TC))
    assert set(sd) == want
    assert sd["alpha.2"] is sd["alpha.0"] and sd["lista_blocks.2.Lambda"] is \
        sd["lista_blocks.0.Lambda"]
    assert tuple(sd["alpha.0"].shape) == (1, 2 * C, 1, 1)
    assert 0 <= float(sd["alpha.0"].min()) and float(sd["alpha.0"].max()) < 1e-3
    bound = 1 / np.sqrt(C * 9)
    assert float(sd["P0.conv2d.weight"].abs().max()) <= bound


def test_pool_matches_jax_pool():
    params = _params_np(3)
    jcfg, tcfg = _jcfg(), _tcfg()
    jpool = jserving.StreamPool(jcfg, params, capacity=3, dtype=jnp.float32)
    tpool = tserving.StreamPool(tcfg, params_from_jax(params, DEPTH, TC), capacity=3,
                                dtype=torch.float32, device="cpu")
    vox = _voxels(steps=4, b=3, seed=3)
    js = [jpool.attach() for _ in range(2)]
    ts = [tpool.attach() for _ in range(2)]
    schedule = [(0, 1), (0,), "swap", (0, 1), (1,)]
    step = 0
    for entry in schedule:
        if entry == "swap":
            jpool.detach(js[1])
            tpool.detach(ts[1])
            js[1], ts[1] = jpool.attach(), tpool.attach()
            continue
        want = jpool.step({js[i]: vox[step, i] for i in entry})
        got = tpool.step({ts[i]: vox[step, i] for i in entry})
        for i in entry:
            np.testing.assert_allclose(got[ts[i]], np.asarray(want[js[i]]), rtol=0, atol=2e-5)
        step += 1


def test_config_refuses_k2_for_tc():
    with pytest.raises(ValueError, match="cista-tc runs with core_impl='layers'"):
        tcista.CistaConfig(model_mode=TC, core_impl="cuda")
    with pytest.raises(ValueError, match="cista-tc runs with core_impl='layers'"):
        tcista.CistaConfig(model_mode=TC, core_impl="plain")


@pytest.fixture(scope="module")
def tc_model(setup):  # noqa: F811
    root = setup[0]
    cfg = jcista.CistaConfig(image_dim=(32, 40), base_channels=C, depth=DEPTH, num_bins=NB,
                             model_mode=TC)
    params = jax.tree_util.tree_map(np.asarray, jcista.init_cista_tc(jax.random.PRNGKey(5), cfg))
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in export_torch_state_dict(params, TC, depth=DEPTH).items()}
    model = root / "tc_model.pth.tar"
    torch.save({"epoch": 1, "state_dict": sd}, model)
    return model


def test_cli_with_cista_tc_matches_jax_cli(setup, tc_model, monkeypatch):  # noqa: F811
    root, data, _, jcli = setup
    monkeypatch.delenv("V2E2V_LPIPS_WEIGHTS", raising=False)
    monkeypatch.setenv("V2E2V_PLATFORM", "cpu")
    argv = ["--path_to_test_model", str(tc_model), "--path_to_test_data", str(data),
            "-c", str(C), "-d", str(DEPTH), "--num_events", "300", "--model_mode", TC]
    out = {}
    for name in ("port", "jax"):
        steps = []
        folder = root / f"tc_{name}"
        if name == "port":
            _recording(tcli, tvr.ImageReader, monkeypatch, steps)
            tcli.main(argv + ["-o", str(folder)])
        else:
            _recording(jcli, jvr.ImageReader, monkeypatch, steps)
            parser = jcli.argparse.ArgumentParser()
            jconfigs.set_configs(parser)
            jcli.Reconstructor(parser.parse_args(argv + ["-o", str(folder)])).run()
        out[name] = (*_split(steps), folder / "tc_model.pth")
    (got_steps, _, got_dir), (want_steps, _, want_dir) = out["port"], out["jax"]
    assert len(got_steps) == len(want_steps) > 20
    for g, w in zip(got_steps, want_steps):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    seqs = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == seqs and len(seqs) == 2
    for seq in seqs:
        frames = sorted(f for f in os.listdir(want_dir / seq) if f.endswith(".png"))
        assert sorted(f for f in os.listdir(got_dir / seq) if f.endswith(".png")) == frames
        got, want = _result(got_dir / seq), _result(want_dir / seq)
        assert sorted(got) == sorted(want) == [seq]
        g, w = got[seq], want[seq]
        assert g[4] == w[4] > 0
        assert abs(g[0] - w[0]) <= 1e-4 + 1e-12 and abs(g[2] - w[2]) <= 1e-4 + 1e-12
        assert abs(g[1] - w[1]) <= 0.01
