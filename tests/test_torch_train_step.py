"""The port's train steps (``v2e2v_tpu_torch/training/steps.py``) against the
JAX package's (``v2e2v_tpu/parallel/mesh.py``) on the CPU, at 32x40, C = 8,
depth 2, T = 3, B = 2, on the same weights (``params_from_jax``) and inputs.

The JAX steps run as the JAX CLIs build them (``make_mesh(1, 1)``, the
default ``CistaConfig``: ``fullres_impl="fused"``), and the port's E2V step
is held against them on its ``fullres_impl="ref"`` path (the reference's
way, of which the fused path is an exact rewrite) and on its
``fullres_impl="fused"`` path, with an optax transformation that
keeps the gradients in its state, so the jitted step hands back its own
gradients. Held: the loss to rtol 1e-6 and every gradient tensor to
``2e-5 * max |g|`` (observed: loss within 1.2e-7, gradients within 5e-6 of
their largest entry). The optimizer is held apart (Adam's first step is
``g / (|g| + eps)``, which flips sign on gradients near zero): three steps of
``torch.optim.Adam`` against ``optax.adam`` on the same gradients, atol 1e-7.
The V2E2V steps are in tests/test_torch_train_v2e2v.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import no_new_jax_cache_entries, one_torch_thread  # noqa: F401
from v2e2v_tpu.models import cista as jcista
from v2e2v_tpu.parallel import mesh as jmesh
from v2e2v_tpu.utils.checkpoint import export_torch_state_dict
from v2e2v_tpu_torch.models import cista as tcista
from v2e2v_tpu_torch.ops.cuda.core import cista_core, core_taps
from v2e2v_tpu_torch.ops.cuda.ista import ista_loop
from v2e2v_tpu_torch.training import steps
from v2e2v_tpu_torch.utils.checkpoint import STEP_KEYS, params_from_jax

H, W, C, DEPTH, NB, T, B = 32, 40, 8, 2, 5, 3, 2
GRAD_TOL = 2e-5  # of the tensor's largest JAX gradient


def grad_keeper():
    """An optax transformation whose state is the last gradients and whose
    updates are zero."""
    def init(params):
        return {"g": jax.tree_util.tree_map(jnp.zeros_like, params)}

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), {"g": grads}

    return optax.GradientTransformation(init, update)


def _weights(mode):
    cfg = jcista.CistaConfig(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB,
                             model_mode=mode)
    init = jcista.init_cista_lstc if mode == "cista-lstc" else jcista.init_cista_tc
    params = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0), cfg))
    tcfg = tcista.CistaConfig(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB,
                              model_mode=mode, ista_impl="plain", core_impl="layers")
    return cfg, params, tcfg, tcista.tie_weights(params_from_jax(params, DEPTH, mode), tcfg)


def _run_jax(step, params, *args):
    tx_state = grad_keeper().init(params)
    out = step(params, tx_state, *args)
    return out, export_torch_state_dict(jax.tree_util.tree_map(np.asarray, out[1]["g"]),
                                        "cista-lstc" if "P0" in params and "gates" in params["P0"]
                                        else "cista-tc", DEPTH)


def _assert_grads(sd, mode, jax_sd):
    for k in STEP_KEYS[mode]:
        got = sd[k].grad.numpy()
        want = jax_sd[k].reshape(got.shape)
        tol = GRAD_TOL * float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        assert err <= tol and float(np.abs(want).max()) > 0, (k, err, tol)


def _voxels(seed, n=B):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(T, n, H, W, NB)).astype(np.float32),
            rng.uniform(size=(n, H, W, 1)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_e2v_step(mode):
    """JAX's default E2V step on ``_voxels(1)``: ``(loss, gradients as a
    state dict)``, compiled once per mode for the tests below."""
    cfg, params, _, _ = _weights(mode)
    jstep = jmesh.make_e2v_train_step(cfg, grad_keeper(), jmesh.make_mesh(1, 1))
    (_, _, jloss), jgrads = _run_jax(jstep, params, *_voxels(1))
    return float(jloss), jgrads


@pytest.mark.parametrize("mode", ["cista-lstc", "cista-tc"])
def test_e2v_step_matches_jax(mode):
    _, _, tcfg, sd = _weights(mode)
    seq, gt = _voxels(1)
    jloss, jgrads = _jax_e2v_step(mode)
    opt = steps.make_adam(sd, tcfg, 1e-4)
    before = {k: sd[k].detach().clone() for k in STEP_KEYS[mode]}
    loss = steps.make_e2v_train_step(tcfg, opt)(sd, torch.from_numpy(seq), torch.from_numpy(gt))
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-6)
    _assert_grads(sd, mode, jgrads)
    # the tied ISTA block: every depth name is the one trained tensor
    for leaf in ("D.conv2d.weight", "Lambda"):
        assert sd[f"lista_blocks.1.{leaf}"] is sd[f"lista_blocks.0.{leaf}"]
    assert all(not torch.equal(sd[k], before[k]) for k in ("We.conv2d.weight", "final_conv.conv2d.bias"))


@pytest.mark.parametrize("mode", ["cista-lstc", "cista-tc"])
def test_fused_e2v_step_matches_jax(mode):
    """The port's step on the fused full-resolution path, the JAX default's,
    with the fused ConvLSTC (an exact rewrite; CISTA-TC has none): the
    kernels are made once per window (``cista_sequence``), and the gradients
    reach the stored convs through them."""
    _, _, tcfg, sd = _weights(mode)
    tcfg = dataclasses.replace(tcfg, fullres_impl="fused", lstc_impl="fused")
    seq, gt = _voxels(1)
    jloss, jgrads = _jax_e2v_step(mode)
    step = steps.make_e2v_train_step(tcfg, steps.make_adam(sd, tcfg, 1e-4))
    loss = step(sd, torch.from_numpy(seq), torch.from_numpy(gt))
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-6)
    _assert_grads(sd, mode, jgrads)


def test_e2v_device_data_step_with_a_masked_tail_matches_jax():
    cfg, params, tcfg, sd = _weights("cista-lstc")
    rng = np.random.default_rng(2)
    data = rng.normal(size=(3, T, H, W, NB)).astype(np.float32)
    gt_all = rng.uniform(size=(3, H, W, 1)).astype(np.float32)
    idx, w = np.array([2, 2], np.int32), np.array([1.0, 0.0], np.float32)  # a padded tail
    jstep = jmesh.make_e2v_train_step_device_data(cfg, grad_keeper(), jmesh.make_mesh(1, 1))
    (_, _, jloss), jgrads = _run_jax(jstep, params, data, gt_all, idx, jax.random.PRNGKey(0), w)
    opt = steps.make_adam(sd, tcfg, 1e-4)
    step = steps.make_e2v_train_step_device_data(tcfg, opt)
    loss = step(sd, torch.from_numpy(data), torch.from_numpy(gt_all),
                torch.from_numpy(idx.astype(np.int64)), torch.Generator(), torch.from_numpy(w))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    _assert_grads(sd, "cista-lstc", jgrads)
    # the masked tail is the one real sample's loss
    _, _, tcfg2, sd2 = _weights("cista-lstc")
    want = steps.e2v_loss(sd2, tcfg2, torch.from_numpy(data[2:3]).movedim(1, 0),
                          torch.from_numpy(gt_all[2:3]))
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)


def test_device_data_noise_is_drawn_from_the_generator():
    """--add_noise on the device: 0.1 * randn from the step's generator,
    outside the rematerialised region (the same generator seed gives the
    same step)."""
    _, _, tcfg, sd = _weights("cista-lstc")
    data, gt = _voxels(3, n=2)
    data = np.moveaxis(data, 1, 0).copy()
    args = (torch.from_numpy(data), torch.from_numpy(gt), torch.tensor([0, 1]))
    losses = []
    for seed in (7, 7, 8):
        _, _, _, sd = _weights("cista-lstc")
        step = steps.make_e2v_train_step_device_data(tcfg, steps.make_adam(sd, tcfg, 0.0),
                                                     noise_std=0.1)
        losses.append(float(step(sd, *args, torch.Generator().manual_seed(seed),
                                 torch.ones(2))))
    noisy = torch.from_numpy(data).movedim(1, 0) + 0.1 * torch.randn(
        (T, 2, H, W, NB), generator=torch.Generator().manual_seed(7))
    _, _, _, sd = _weights("cista-lstc")
    want = float(steps.e2v_loss(sd, tcfg, noisy, torch.from_numpy(gt)))
    assert losses[0] == losses[1] == pytest.approx(want, rel=1e-6) and losses[2] != losses[0]


@pytest.mark.parametrize("mode", ["cista-lstc", "cista-tc"])
def test_remat_equals_no_remat(mode):
    """``cista_sequence(remat=True)`` gives the values and gradients of
    ``remat=False`` (tests/test_cista.py:123's tolerances)."""
    _, _, tcfg, sd = _weights(mode)
    seq, gt = _voxels(4)
    keys = STEP_KEYS[mode]
    results = []
    for remat in (False, True):
        tensors = steps.trainable_params(sd, tcfg)
        recs, _ = tcista.cista_sequence(sd, tcfg, torch.from_numpy(seq), remat=remat)
        loss = torch.mean((recs[-1] - torch.from_numpy(gt)) ** 2)
        results.append((recs.detach(), loss.detach(), torch.autograd.grad(loss, tensors)))
    (r0, l0, g0), (r1, l1, g1) = results
    assert torch.equal(r0, r1)
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    for k, a, b in zip(keys, g0, g1):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6, rtol=1e-5, err_msg=k)


def test_adam_matches_optax_over_three_steps():
    _, params, tcfg, sd = _weights("cista-lstc")
    rng = np.random.default_rng(5)
    grads = [{k: rng.normal(scale=10.0 ** rng.integers(-9, -2), size=sd[k].shape)
              .astype(np.float32) for k in STEP_KEYS["cista-lstc"]} for _ in range(3)]
    opt = steps.make_adam(sd, tcfg, 1e-3)
    tx = optax.adam(1e-3)
    jp = {k: jnp.asarray(np.array(sd[k].detach())) for k in STEP_KEYS["cista-lstc"]}
    state = tx.init(jp)
    for g in grads:
        for k in STEP_KEYS["cista-lstc"]:
            sd[k].grad = torch.from_numpy(g[k])
        opt.step()
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k in STEP_KEYS["cista-lstc"]:
            np.testing.assert_allclose(sd[k].detach().numpy(), np.asarray(jp[k]), atol=1e-7,
                                       rtol=0, err_msg=k)


def test_lr_schedule_and_trainable_params():
    for epoch in range(35):
        assert steps.lr_for_epoch(3e-4, epoch) == 3e-4 * (0.9 ** np.floor(epoch / 10.0))
    _, _, tcfg, sd = _weights("cista-tc")
    tensors = steps.trainable_params(sd, tcfg)
    assert len(tensors) == len({id(t) for t in sd.values()}) == len(STEP_KEYS["cista-tc"])
    assert all(t.requires_grad for t in tensors)
    for impl in ({"ista_impl": "cuda"}, {"core_impl": "cuda"}):
        cfg = dataclasses.replace(tcfg, model_mode="cista-lstc", **impl)
        with pytest.raises(ValueError, match="ista_impl=\"plain\", core_impl=\"layers\""):
            steps.make_e2v_train_step(cfg, torch.optim.SGD(tensors, lr=0.0))


def _k1_args(requires_grad):
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.normal(scale=0.1, size=shape).astype(np.float32))

    args = [t(1, 4, 6, 8), t(1, 4, 6, 16), t(3, 3, 16, 8), t(8), t(3, 3, 8, 16), t(16), t(16)]
    args[2].requires_grad_(requires_grad)
    return args


def test_kernels_refuse_to_run_under_autograd():
    """K1 and K2 have no backward: on every device (the CPU here, before it
    takes the plain version) they raise when grad is enabled and an argument
    requires grad, naming the config that trains; under ``torch.no_grad`` or
    with no argument requiring grad they run."""
    with pytest.raises(RuntimeError, match='ista_impl="plain", core_impl="layers"'):
        ista_loop(*_k1_args(True), depth=2)
    with torch.no_grad():
        ista_loop(*_k1_args(True), depth=2)
    ista_loop(*_k1_args(False), depth=2)

    _, _, tcfg, sd = _weights("cista-lstc")
    taps = core_taps(sd, torch.float32)
    rng = np.random.default_rng(1)
    state = [torch.from_numpy(rng.normal(size=(1, 4, 6, ch)).astype(np.float32))
             for ch in (C, 2 * C, 2 * C, C, C)]
    grad_taps = {**taps, "w_d": taps["w_d"].detach().clone().requires_grad_(True)}
    with pytest.raises(RuntimeError, match="cista_core"):
        cista_core(grad_taps, *state, depth=DEPTH)
    with pytest.raises(RuntimeError, match="cista_core"):
        cista_core(taps, state[0].clone().requires_grad_(True), *state[1:], depth=DEPTH)
    with torch.no_grad():
        cista_core(grad_taps, *state, depth=DEPTH)
    # the default config's sequence under autograd refuses; the training config runs
    cfg = dataclasses.replace(tcfg, ista_impl="cuda")
    steps.trainable_params(sd, tcfg)
    seq, _ = _voxels(8)
    with pytest.raises(RuntimeError, match="ista_loop"):
        tcista.cista_sequence(sd, cfg, torch.from_numpy(seq))
    recs, _ = tcista.cista_sequence(sd, tcfg, torch.from_numpy(seq))
    assert recs.grad_fn is not None
