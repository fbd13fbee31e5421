"""Port's conv primitives (v2e2v_tpu_torch.ops.conv) against v2e2v_tpu.ops.conv,
float32 on the CPU, atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import no_new_jax_cache_entries  # noqa: F401
from v2e2v_tpu.ops import conv as jconv
from v2e2v_tpu_torch.ops import conv as tconv

ATOL = 1e-5


def _conv_params(rng, cin, cout, k=3):
    w = (0.2 * rng.standard_normal((k, k, cin, cout))).astype(np.float32)
    b = (0.2 * rng.standard_normal(cout)).astype(np.float32)
    return {"weight": w, "bias": b}


def _j(p):
    return {k: (_j(v) if isinstance(v, dict) else jnp.asarray(v)) for k, v in p.items()}


def _t(p):
    out = {}
    for k, v in p.items():
        if isinstance(v, dict):
            out[k] = _t(v)
        elif k == "weight":
            out[k] = torch.from_numpy(tconv.hwio_to_torch_conv(v).copy())
        else:
            out[k] = torch.from_numpy(v)
    return out


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("activation", [None, "relu", "sigmoid", "tanh"])
def test_conv_layer_reflect_matches_jax(stride, activation):
    rng = np.random.default_rng(stride)
    x = _x(rng, 2, 16, 24, 6)
    p = _conv_params(rng, 6, 8)
    want = jconv.conv_layer(jnp.asarray(x), _j(p), stride=stride, padding=1,
                            activation=activation)
    got = tconv.conv_layer(torch.from_numpy(x), _t(p), stride=stride, padding=1,
                           activation=activation)
    assert tuple(got.shape) == want.shape
    _close(got, want)


def test_conv2d_reflect_pads_like_torch_padding_mode():
    rng = np.random.default_rng(3)
    x = _x(rng, 1, 5, 7, 3)
    p = _t(_conv_params(rng, 3, 4))
    ref = torch.nn.functional.conv2d(
        torch.nn.functional.pad(torch.from_numpy(x).permute(0, 3, 1, 2), (1, 1, 1, 1),
                                mode="reflect"),
        p["weight"], p["bias"],
    ).permute(0, 2, 3, 1)
    conv = torch.nn.Conv2d(3, 4, 3, padding=1, padding_mode="reflect")
    with torch.no_grad():
        conv.weight.copy_(p["weight"])
        conv.bias.copy_(p["bias"])
        by_module = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    got = tconv.conv2d(torch.from_numpy(x), p, padding=1)
    torch.testing.assert_close(got, ref, atol=ATOL, rtol=0)
    torch.testing.assert_close(got, by_module, atol=ATOL, rtol=0)


@pytest.mark.parametrize("in_hw,out_hw", [((8, 12), (16, 24)), ((9, 13), (20, 27)),
                                          ((2, 3), (4, 6))])
def test_bilinear_upsample_matches_jax_edges_included(in_hw, out_hw):
    rng = np.random.default_rng(4)
    x = _x(rng, 2, *in_hw, 3)
    want = np.asarray(jconv.bilinear_resize(jnp.asarray(x), *out_hw))
    got = tconv.bilinear_resize(torch.from_numpy(x), *out_hw).numpy()
    _close(torch.from_numpy(got), want)
    # the edges explicitly: first/last rows and columns
    for sl in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        np.testing.assert_allclose(got[sl], want[sl], atol=ATOL)


def test_bilinear_resize_refuses_downsampling():
    with pytest.raises(ValueError, match="upsamples only"):
        tconv.bilinear_resize(torch.zeros(1, 8, 8, 1), 4, 4)


@pytest.mark.parametrize("out_hw", [None, (18, 26)])
def test_upsample_conv_layer_matches_jax(out_hw):
    rng = np.random.default_rng(5)
    x = _x(rng, 2, 8, 12, 4)
    p = _conv_params(rng, 4, 5)
    want = jconv.upsample_conv_layer(jnp.asarray(x), _j(p), activation="relu", out_hw=out_hw)
    got = tconv.upsample_conv_layer(torch.from_numpy(x), _t(p), activation="relu",
                                    out_hw=out_hw)
    _close(got, want)


def test_conv_lstm_step_matches_jax_gate_order():
    rng = np.random.default_rng(6)
    c = 4
    x, h, cell = _x(rng, 2, 8, 12, c), _x(rng, 2, 8, 12, c), _x(rng, 2, 8, 12, c)
    p = {"Gates": _conv_params(rng, 2 * c, 4 * c)}
    want_h, (_, want_c) = jconv.conv_lstm_step(_j(p), jnp.asarray(x),
                                               (jnp.asarray(h), jnp.asarray(cell)))
    got_h, (got_h2, got_c) = tconv.conv_lstm_step(
        _t(p), torch.from_numpy(x), (torch.from_numpy(h), torch.from_numpy(cell)))
    _close(got_h, want_h)
    _close(got_c, want_c)
    assert got_h2 is got_h


def test_conv_lstc_step_matches_jax_gate_order():
    rng = np.random.default_rng(7)
    c = 4
    x, z, cell = _x(rng, 2, 8, 12, c), _x(rng, 2, 8, 12, 2 * c), _x(rng, 2, 8, 12, 2 * c)
    p = {
        "gates": _conv_params(rng, 3 * c, 4 * c),
        "out_gates": _conv_params(rng, 4 * c, 2 * c),
        "P0": _conv_params(rng, c, 2 * c),
    }
    want_out, want_cell = jconv.conv_lstc_step(_j(p), jnp.asarray(x), jnp.asarray(z),
                                               jnp.asarray(cell))
    got_out, got_cell = tconv.conv_lstc_step(_t(p), torch.from_numpy(x), torch.from_numpy(z),
                                             torch.from_numpy(cell))
    _close(got_out, want_out)
    _close(got_cell, want_cell)


def test_hwio_conversions_are_inverse_and_match_jax():
    w = np.random.default_rng(8).standard_normal((5, 3, 3, 3)).astype(np.float32)
    np.testing.assert_array_equal(tconv.torch_conv_to_hwio(w), jconv.torch_conv_to_hwio(w))
    np.testing.assert_array_equal(tconv.hwio_to_torch_conv(tconv.torch_conv_to_hwio(w)), w)
