"""Port's CISTA-LSTC model and weight bridge against v2e2v_tpu.

The 3-step sequence is held against the JAX ``cista_sequence`` on the
reference-shaped path (``fullres_impl='ref'``, ``ista_impl='xla'``; the Pallas
ISTA kernel is pinned to that path by tests/test_pallas_ista.py) in float32 at
atol 1e-4 after the recurrence; on the CPU the observed error is 6e-8 on the
images and 5e-7 on the recurrent states.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import no_new_jax_cache_entries  # noqa: F401
from v2e2v_tpu.models import cista as jcista
from v2e2v_tpu.utils.checkpoint import convert_torch_state_dict, export_torch_state_dict
from v2e2v_tpu_torch.models import cista as tcista
from v2e2v_tpu_torch.utils.checkpoint import params_from_jax

H, W, C, NB, DEPTH = 16, 24, 8, 5, 2


def _jcfg():
    return jcista.CistaConfig(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB,
                              fullres_impl="ref", ista_impl="xla")


def _params_np(seed=0):
    params = jcista.init_cista_lstc(jax.random.PRNGKey(seed), _jcfg())
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("ista_impl", ["cuda", "plain"])
def test_sequence_matches_jax(ista_impl):
    params_np = _params_np()
    rng = np.random.default_rng(0)
    vox = rng.standard_normal((3, 2, H, W, NB)).astype(np.float32)
    want, want_state = jcista.cista_sequence(params_np, _jcfg(), jnp.asarray(vox))

    cfg = tcista.CistaConfig(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB,
                             ista_impl=ista_impl)
    got, got_state = tcista.cista_sequence(params_from_jax(params_np, DEPTH), cfg,
                                           torch.from_numpy(vox))
    assert tuple(got.shape) == (3, 2, H, W, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    for g, w in zip([got_state.cell, got_state.z, *got_state.dg],
                    [want_state.cell, want_state.z, *want_state.dg]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_params_from_jax_equals_jax_export():
    params_np = _params_np(1)
    want = export_torch_state_dict(params_np, "cista-lstc", depth=DEPTH)
    got = params_from_jax(params_np, DEPTH)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert got["lista_blocks.0.Lambda"].shape == (1, 2 * C, 1, 1)


def test_params_from_jax_round_trips_through_jax_convert():
    params_np = _params_np(2)
    sd = params_from_jax(params_np, DEPTH)
    back = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()}, "cista-lstc")
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params_np)


def test_init_has_reference_names_shapes_and_tied_ista():
    cfg = tcista.CistaConfig(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB)
    sd = tcista.init_cista_lstc(torch.Generator().manual_seed(0), cfg, device="cpu")
    want = export_torch_state_dict(_params_np(), "cista-lstc", depth=DEPTH)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: v.shape for k, v in want.items()}
    assert sd["lista_blocks.1.D.conv2d.weight"] is sd["lista_blocks.0.D.conv2d.weight"]
    bound = 1 / np.sqrt(3 * 3 * 2 * C)
    assert float(sd["Dg.conv.conv2d.weight"].abs().max()) <= bound
    lam = sd["lista_blocks.0.Lambda"]
    assert float(lam.min()) >= 0 and float(lam.max()) < 1e-3
    again = tcista.init_cista_lstc(torch.Generator().manual_seed(0), cfg, device="cpu")
    for k in sd:
        torch.testing.assert_close(sd[k], again[k], rtol=0, atol=0)


def test_config_and_step_fn_refuse_what_is_not_ported():
    with pytest.raises(ValueError, match="ista_impl"):
        tcista.CistaConfig(ista_impl="pallas")
    cfg = tcista.CistaConfig()
    assert tcista.get_step_fn(cfg) is tcista.cista_lstc_step
    assert tcista.get_step_fn(dataclasses.replace(cfg, model_mode="cista-tc")) \
        is tcista.cista_tc_step
    with pytest.raises(ValueError, match="model_mode"):
        dataclasses.replace(cfg, model_mode="cista-xx")
    with pytest.raises(ValueError, match="cista-tc runs with core_impl='layers'"):
        dataclasses.replace(cfg, model_mode="cista-tc", core_impl="cuda")
