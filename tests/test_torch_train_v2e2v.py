"""The port's V2E2V train steps (``v2e2v_tpu_torch/training/steps.py``)
against ``v2e2v_tpu/parallel/mesh.py::make_v2e2v_train_step`` on the CPU, at
32x40, C = 8, depth 2, T = 3 packs of 5 frames, B = 2, the JAX weights carried
over with ``params_from_jax``. The port replays JAX's key chain
(``JaxKeyNoise``) on frames of intensity <= 20, where ``lin_log`` is exact in
both: the stats are equal, the loss within rtol 1e-6 and every gradient
within ``2e-5 * max |g|`` (tests/test_torch_train_step.py's tolerances and
its gradient-keeping optax transformation).
"""

import jax
import numpy as np
import pytest
import torch

from _torch_parity import JaxKeyNoise, no_new_jax_cache_entries, one_torch_thread  # noqa: F401
from test_torch_train_step import (  # noqa: I001
    B, C, DEPTH, H, NB, T, W, _assert_grads, _run_jax, _weights, grad_keeper,
)
from v2e2v_tpu.models import emulator as jemu
from v2e2v_tpu.models import v2e2v as jv2e2v
from v2e2v_tpu.parallel import mesh as jmesh
from v2e2v_tpu_torch.models import cista as tcista
from v2e2v_tpu_torch.models import emulator as temu
from v2e2v_tpu_torch.models import v2e2v as tv2e2v
from v2e2v_tpu_torch.training import steps

N = 5
EMU = dict(pos_thres=0.6, neg_thres=0.6, sigma_thres=0.03, pl=1.5, ps=0.5, cutoff_hz=200.0,
           ql=1.0, qs=0.0, refractory_period_s=0.001, leak_rate_hz=0.1,
           shot_noise_rate_hz=100.0, num_bins=NB)


def _v2e2v():
    cfg, params, _, sd = _weights("cista-lstc")
    jcfg = jv2e2v.V2E2VConfig(cista=cfg, emulator=jemu.EmulatorConfig(**EMU, iters_impl="xla"))
    tcfg = tv2e2v.V2E2VConfig(
        cista=tcista.CistaConfig(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB,
                                 ista_impl="plain"),
        emulator=temu.EmulatorConfig(**EMU, iters_impl="cuda"))
    rng = np.random.default_rng(6)
    base = rng.uniform(2.0, 20.0, (B, 1, H, W)).astype(np.float32)
    rate = rng.uniform(-0.5, 0.5, (B, 1, H, W)).astype(np.float32)
    i = np.arange(T * (N - 1) + 1, dtype=np.float32).reshape(1, -1, 1, 1)
    video = np.clip(base * np.exp(rate * np.sin(i * 0.7)), 0, 20).astype(np.float32)
    t = np.arange(T * (N - 1) + 1, dtype=np.float32) * 0.004
    frames = np.stack([video[:, p * (N - 1):p * (N - 1) + N] for p in range(T)])
    ts = np.stack([np.tile(t[p * (N - 1):p * (N - 1) + N], (B, 1)) for p in range(T)])
    gt = rng.uniform(size=(B, H, W, 1)).astype(np.float32)
    return jcfg, params, tcfg, sd, frames, ts, gt


def test_v2e2v_step_matches_jax():
    jcfg, params, tcfg, sd, frames, ts, gt = _v2e2v()
    key = jax.random.PRNGKey(5)
    jstep = jmesh.make_v2e2v_train_step(jcfg, grad_keeper(), jmesh.make_mesh(1, 1))
    (_, _, jloss, jstats), jgrads = _run_jax(jstep, params, frames, ts, gt, key)
    frames_t = torch.from_numpy(frames).requires_grad_(True)
    opt = steps.make_adam(sd, tcfg.cista, 1e-4)
    loss, stats = steps.make_v2e2v_train_step(tcfg, opt)(
        sd, frames_t, torch.from_numpy(ts), torch.from_numpy(gt), JaxKeyNoise(key))
    assert {k: int(v) for k, v in stats.items()} == {k: int(v) for k, v in jstats.items()}
    assert int(stats["num_events"]) > 1000
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    # the gradients reach the E2V weights and nothing of the emulator
    _assert_grads(sd, "cista-lstc", jgrads)
    assert frames_t.grad is None


def test_v2e2v_monitor_and_device_data_steps():
    """``monitor`` adds the clamped reconstruction and the last voxel grid
    and changes nothing else; the device-data step gathers the same batch
    from uint8 frames, makes ``gt`` from its last frame, and a masked tail
    gives the loss of its real sample."""
    _, _, tcfg, _, frames, ts, _ = _v2e2v()
    frames = np.rint(frames)  # uint8 frames on the device
    gt = frames[-1][:, -1, :, :, None] / 255.0
    runs = []
    for monitor in (False, True):
        sd = _v2e2v()[3]
        step = steps.make_v2e2v_train_step(tcfg, steps.make_adam(sd, tcfg.cista, 0.0),
                                           monitor=monitor)
        runs.append(step(sd, torch.from_numpy(frames), torch.from_numpy(ts),
                         torch.from_numpy(gt.astype(np.float32)),
                         torch.Generator().manual_seed(1)))
    (l0, s0), (l1, s1) = runs
    assert float(l0) == float(l1) and all(int(s0[k]) == int(s1[k]) for k in s0)
    assert s1["rec"].shape == (B, H, W, 1) and s1["voxel"].shape == (B, H, W, NB)
    assert 1e-7 <= float(s1["rec"].min()) and float(s1["rec"].max()) <= 1 - 1e-7

    frames_u8 = torch.from_numpy(np.moveaxis(frames, 1, 0).astype(np.uint8))  # [S, T, N, H, W]
    ts_all = torch.from_numpy(np.moveaxis(ts, 1, 0).copy())

    def device_step(idx, w):
        sd = _v2e2v()[3]
        step = steps.make_v2e2v_train_step_device_data(tcfg, steps.make_adam(sd, tcfg.cista, 0.0))
        return step(sd, frames_u8, ts_all, torch.tensor(idx), torch.Generator().manual_seed(1),
                    torch.tensor(w))

    loss, stats = device_step([0, 1], [1.0, 1.0])
    assert float(loss) == pytest.approx(float(l0), rel=1e-6)
    assert int(stats["num_events"]) == int(s0["num_events"])
    tail, _ = device_step([1, 1], [1.0, 0.0])
    sd = _v2e2v()[3]
    one, _ = steps.v2e2v_loss(sd, tcfg, torch.from_numpy(frames[:, 1:2]),
                              torch.from_numpy(ts[:, 1:2]),
                              torch.from_numpy(gt[1:2].astype(np.float32)),
                              torch.Generator().manual_seed(1))
    assert float(tail) == pytest.approx(float(one), rel=1e-5)
