"""The port's full-resolution 'fused' path, fused ConvLSTC and parity IO in
the CISTA nets (``v2e2v_tpu_torch/models/cista.py``, ``serving.py``,
``models/v2e2v.py``, ``utils/checkpoint.py``) against the JAX package's
default step (``fullres_impl="fused"``), on the same seeded inputs and
``params_from_jax`` weights, at 16x24 and 18x30 (odd half-res), C = 8,
depth 2.

Tolerances: one float32 step from a random state within 2e-5 (observed on
the CPU: about 5e-7), and within 2e-5 of the port's own ref step; sequences
as tests/test_fused.py:242 holds parity IO (reconstructions 2e-5, states
2e-4). The bfloat16 fused pool is held against JAX's in
tests/test_torch_serving.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import no_new_jax_cache_entries, one_torch_thread  # noqa: F401
from v2e2v_tpu.models import cista as jcista
from v2e2v_tpu.ops import fused as jfused
from v2e2v_tpu_torch import serving as tserving
from v2e2v_tpu_torch.models import cista as tcista
from v2e2v_tpu_torch.ops import fused as tfused
from v2e2v_tpu_torch.utils import checkpoint as tcheckpoint
from v2e2v_tpu_torch.utils.checkpoint import params_from_jax

C, NB, DEPTH = 8, 5, 2
SIZES = [(16, 24), (18, 30)]
LSTC, TC = "cista-lstc", "cista-tc"


def _cfgs(hw, mode=LSTC, **port):
    """JAX's default config (``fullres_impl="fused"``) and the port's with
    ``fullres_impl="fused"`` and ``port``'s overrides."""
    kw = dict(image_dim=hw, base_channels=C, depth=DEPTH, num_bins=NB, model_mode=mode)
    return jcista.CistaConfig(**kw), tcista.CistaConfig(**kw, **{"fullres_impl": "fused", **port})


@functools.lru_cache(maxsize=None)
def _params(mode=LSTC, seed=0):
    """JAX params (numpy) with JAX's fused kernels injected as its
    ``cista_sequence`` injects them (its eager folds take seconds: made once
    here), and the port's state dict of the same weights (no kernels)."""
    cfg = jcista.CistaConfig(image_dim=(16, 24), base_channels=C, depth=DEPTH, num_bins=NB,
                             model_mode=mode)
    init = jcista.init_cista_lstc if mode == LSTC else jcista.init_cista_tc
    params = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(seed), cfg))
    sd = params_from_jax(params, DEPTH, mode)
    return {**params, "_fullres_fused": jfused.precompute_fused_kernels(params)}, sd


def _state(hw, b, seed):
    rng = np.random.default_rng(seed)
    h2, w2 = hw[0] // 2, hw[1] // 2
    return [(0.3 * rng.standard_normal((b, h2, w2, ch))).astype(np.float32)
            for ch in (2 * C, 2 * C, C, C)]


def _inputs(hw, b, seed, steps=None):
    rng = np.random.default_rng(seed)
    lead = (b,) if steps is None else (steps, b)
    return (rng.standard_normal((*lead, *hw, NB)).astype(np.float32),
            rng.uniform(size=(b, *hw, 1)).astype(np.float32))


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("mode", [LSTC, TC])
def test_fused_step_matches_jax_default_step(hw, mode):
    jcfg, tcfg = _cfgs(hw, mode)
    params, sd = _params(mode)
    ev, img = _inputs(hw, 2, 1)
    st = _state(hw, 2, 2)
    jstep = jax.jit(jcista.get_step_fn(jcfg), static_argnums=1)
    tstep = tcista.get_step_fn(tcfg)
    want, wst = jstep(params, jcfg, jnp.asarray(ev), jnp.asarray(img),
                      jcista.CistaState(*map(jnp.asarray, st[:2]), dg=tuple(map(jnp.asarray,
                                                                             st[2:]))))
    tst = tcista.CistaState(*map(torch.from_numpy, st[:2]), dg=tuple(map(torch.from_numpy,
                                                                         st[2:])))
    got, gst = tstep(sd, tcfg, torch.from_numpy(ev), torch.from_numpy(img), tst)
    assert tuple(got.shape) == (2, *hw, 1)
    _close(got, want, 2e-5)
    for g, w in zip([gst.cell, gst.z, *gst.dg], [wst.cell, wst.z, *wst.dg]):
        _close(g, w, 2e-5)
    # and the port's ref step on the same inputs (an exact rewrite)
    ref, rst = tstep(sd, dataclasses.replace(tcfg, fullres_impl="ref"), torch.from_numpy(ev),
                     torch.from_numpy(img), tst)
    _close(got, ref.numpy(), 2e-5)
    _close(gst.z, rst.z.numpy(), 2e-5)


@pytest.mark.parametrize("ista_impl", ["cuda", "plain"])
def test_fused_lstc_sequence_matches_jax(ista_impl):
    """``cista_sequence`` with ``lstc_impl="fused"`` on both sides (the
    ConvLSTC's two-conv rewrite) and the fused full-res path."""
    hw = SIZES[1]
    jcfg, tcfg = _cfgs(hw, ista_impl=ista_impl, lstc_impl="fused")
    jcfg = dataclasses.replace(jcfg, lstc_impl="fused")
    params, sd = _params(seed=1)
    seq, img = _inputs(hw, 2, 3, steps=3)
    want, wst = jcista.cista_sequence(params, jcfg, jnp.asarray(seq), prev_image=jnp.asarray(img))
    got, gst = tcista.cista_sequence(sd, tcfg, torch.from_numpy(seq),
                                     prev_image=torch.from_numpy(img))
    _close(got, want, 2e-5)
    for g, w in zip([gst.cell, gst.z, *gst.dg], [wst.cell, wst.z, *wst.dg]):
        _close(g, w, 2e-4)


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("input_packed", [False, True])
def test_parity_io_sequence_matches_jax(hw, input_packed):
    """``io_layout="parity"``: the sequence packed once (or, with
    ``input_packed``, given as the producer's parity grids) and every step in
    the parity domain; equal to JAX's and to the port's full-layout run."""
    jcfg, tcfg = _cfgs(hw, io_layout="parity")
    jcfg = dataclasses.replace(jcfg, io_layout="parity")
    params, sd = _params(seed=2)
    seq, img = _inputs(hw, 2, 4, steps=3)
    if input_packed:
        t, b = seq.shape[:2]
        seq = np.asarray(jfused.space_to_depth(jnp.asarray(seq.reshape(t * b, *hw, NB)))).reshape(
            t, b, hw[0] // 2, hw[1] // 2, 4 * NB)
        img = np.asarray(jfused.space_to_depth(jnp.asarray(img)))
    want, wst = jcista.cista_sequence(params, jcfg, jnp.asarray(seq), prev_image=jnp.asarray(img),
                                      input_packed=input_packed)
    got, gst = tcista.cista_sequence(sd, tcfg, torch.from_numpy(seq),
                                     prev_image=torch.from_numpy(img), input_packed=input_packed)
    assert tuple(got.shape) == (3, 2, *hw, 1)
    _close(got, want, 2e-5)
    for g, w in zip([gst.cell, gst.z, *gst.dg], [wst.cell, wst.z, *wst.dg]):
        _close(g, w, 2e-4)
    if not input_packed:
        full, _ = tcista.cista_sequence(sd, dataclasses.replace(tcfg, io_layout="full"),
                                        torch.from_numpy(seq), prev_image=torch.from_numpy(img))
        _close(got, full.numpy(), 2e-5)


def test_config_checks_and_parity_io_conditions():
    for name in ("fullres_impl", "lstc_impl", "io_layout"):
        with pytest.raises(ValueError, match=name):
            tcista.CistaConfig(**{name: "pallas"})
    cfg = tcista.CistaConfig(image_dim=(16, 24), base_channels=C, depth=DEPTH, num_bins=NB,
                             ista_impl="plain", io_layout="parity")
    assert not tcista.parity_io(cfg)  # JAX's conditions: fullres_impl="fused" too
    assert tcista.parity_io(dataclasses.replace(cfg, fullres_impl="fused"))
    assert not tcista.parity_io(dataclasses.replace(cfg, fullres_impl="fused", model_mode=TC))
    _, sd = _params(seed=1)
    seq = torch.zeros(1, 1, 16, 24, NB)
    with pytest.raises(ValueError, match="input_packed requires io_layout='parity'"):
        tcista.cista_sequence(sd, cfg, seq, input_packed=True)
    # unmet conditions run the full layout, as in the JAX package
    got, _ = tcista.cista_sequence(sd, cfg, seq)
    want, _ = tcista.cista_sequence(sd, dataclasses.replace(cfg, io_layout="full"), seq)
    assert torch.equal(got, want)


def test_derived_kernels_are_made_once_and_never_saved(monkeypatch, tmp_path):
    """The pool makes the fused kernels at construction, not per step;
    ``v2e2v_sequence`` once per call; a checkpoint of a state dict that
    carries them holds only the weights."""
    from v2e2v_tpu_torch.models import v2e2v as tv2e2v
    from v2e2v_tpu_torch.models.emulator import GeneratorNoise

    calls = []
    real = tcista.precompute_fused_kernels
    monkeypatch.setattr(tcista, "precompute_fused_kernels",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    hw = (16, 24)
    _, tcfg = _cfgs(hw, ista_impl="plain", lstc_impl="fused")
    _, sd = _params(seed=1)
    pool = tserving.StreamPool(tcfg, sd, capacity=2, dtype=torch.float32, device="cpu")
    assert len(calls) == 1 and {"_fullres_fused", "_lstc_fused"} <= set(pool.params)
    sid = pool.attach()
    for seed in range(3):
        pool.step({sid: _inputs(hw, 1, seed)[0][0]})
    assert len(calls) == 1

    cfg = tv2e2v.V2E2VConfig(tcfg, tv2e2v.EmulatorConfig(num_bins=NB, iters_impl="plain"))
    frames = torch.rand(2, 1, 4, *hw, generator=torch.Generator().manual_seed(0)) * 200 + 20
    ts = 0.004 * (3 * torch.arange(2.0)[:, None, None] + torch.arange(4.0)).expand(2, 1, 4)
    tv2e2v.v2e2v_sequence(sd, cfg, frames, ts, GeneratorNoise(torch.Generator()), device="cpu")
    assert len(calls) == 2

    path = tmp_path / "m.pth.tar"
    tcheckpoint.save_checkpoint(str(path), pool.params, 1)
    saved = torch.load(path, weights_only=False)["state_dict"]
    assert set(saved) == set(sd)
    loaded, epoch, _ = tcheckpoint.load_torch_checkpoint(str(path))
    assert epoch == 1 and set(loaded) == set(sd)
