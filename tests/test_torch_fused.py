"""The port's full-resolution rewrites (``v2e2v_tpu_torch/ops/fused.py``) and
fused ConvLSTC (``ops/conv.py``) against the JAX package's
(``v2e2v_tpu/ops/fused.py``, ``ops/conv.py``) on the same seeded inputs and
``params_from_jax`` weights, float32, at 16x24 and 18x30 (odd half-res
9x15), C = 8. Tolerance: tests/test_fused.py's atol 2e-5 for every function
(observed on the CPU: at most ~6e-7); the precomputed kernels leaf by leaf
at 1e-6; gradients through the precomputed kernels against the reference
chain's at test_fused.py's atol 2e-4, rtol 1e-4. The parity voxel grid is
held exactly."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import no_new_jax_cache_entries, one_torch_thread  # noqa: F401
from v2e2v_tpu.models import cista as jcista
from v2e2v_tpu.ops import conv as jconv
from v2e2v_tpu.ops import fused as jfused
from v2e2v_tpu.ops import voxel as jvoxel
from v2e2v_tpu_torch.ops import conv as tconv
from v2e2v_tpu_torch.ops import fused as tfused
from v2e2v_tpu_torch.ops import voxel as tvoxel
from v2e2v_tpu_torch.utils.checkpoint import params_from_jax

C, NB, DEPTH = 8, 5, 2
SIZES = [(16, 24), (18, 30)]
ATOL = 2e-5


def _weights(seed=0):
    """JAX params (numpy) and the port's state dict of the same weights."""
    cfg = jcista.CistaConfig(image_dim=(16, 24), base_channels=C, depth=DEPTH, num_bins=NB)
    params = jax.tree_util.tree_map(np.asarray, jcista.init_cista_lstc(jax.random.PRNGKey(seed),
                                                                        cfg))
    return params, params_from_jax(params, DEPTH)


def _conv(sd, name):
    return {"weight": sd[name + ".weight"], "bias": sd[name + ".bias"]}


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=rtol)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@functools.lru_cache(maxsize=None)
def _kernels(seed):
    """JAX's and the port's precomputed kernels of the same weights (JAX's
    eager folds take seconds; made once per seed)."""
    params, sd = _weights(seed)
    return jfused.precompute_fused_kernels(params), tfused.precompute_fused_kernels(sd)


def test_space_to_depth_matches_jax_and_round_trips():
    x = _normal(0, (2, 8, 12, 3))
    got = tfused.space_to_depth(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfused.space_to_depth(jnp.asarray(x))))
    np.testing.assert_array_equal(tfused.depth_to_space(got).numpy(), x)


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("fn", ["heads_fused", "heads_fused_edgek"])
def test_heads_match_jax(hw, fn):
    params, sd = _weights()
    ev, img = _normal(1, (2, *hw, NB)), _normal(2, (2, *hw, 1))
    # JAX's side from its precomputed kernels (its eager folds take seconds),
    # the port's folding its own
    want = getattr(jfused, fn)(params, jnp.asarray(ev), jnp.asarray(img), kernels=_kernels(0)[0])
    got = getattr(tfused, fn)(sd, torch.from_numpy(ev), torch.from_numpy(img))
    assert tuple(got.shape) == (2, hw[0] // 2, hw[1] // 2, C)
    _close(got, want)


@pytest.mark.parametrize("hw", SIZES)
def test_heads_parity_edgek_matches_jax(hw):
    params, sd = _weights()
    ev, img = _normal(3, (2, *hw, NB)), _normal(4, (2, *hw, 1))
    want = jfused.heads_parity_edgek(params, jfused.space_to_depth(jnp.asarray(ev)),
                                     jfused.space_to_depth(jnp.asarray(img)), kernels=_kernels(0)[0])
    got = tfused.heads_parity_edgek(sd, tfused.space_to_depth(torch.from_numpy(ev)),
                                    tfused.space_to_depth(torch.from_numpy(img)))
    _close(got, want)


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("activation", [None, "relu"])
@pytest.mark.parametrize("fn", ["upsample_conv_parity", "upsample_conv_parity_edgek"])
def test_upsample_conv_parity_matches_jax(hw, activation, fn):
    params, sd = _weights()
    h = _normal(5, (2, hw[0] // 2, hw[1] // 2, C))
    want = getattr(jfused, fn)(params["upsamp_conv"], jnp.asarray(h), activation=activation,
                               kernels=_kernels(0)[0])
    got = getattr(tfused, fn)(_conv(sd, "upsamp_conv.conv2d"), torch.from_numpy(h),
                              activation=activation)
    assert tuple(got.shape) == (2, hw[0] // 2, hw[1] // 2, 4 * C)
    _close(got, want)


@pytest.mark.parametrize("hw", SIZES)
def test_final_conv_parity_matches_jax(hw):
    params, sd = _weights()
    y = _normal(6, (2, hw[0] // 2, hw[1] // 2, 4 * C))
    want = jfused.final_conv_parity(params["final_conv"], jnp.asarray(y), kernels=_kernels(0)[0])
    got = tfused.final_conv_parity(_conv(sd, "final_conv.conv2d"), torch.from_numpy(y))
    assert tuple(got.shape) == (2, *hw, 1)
    _close(got, want)


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("packed", [False, True])
def test_final_conv_parity_edgek_matches_jax(hw, packed):
    params, sd = _weights()
    y = _normal(7, (2, hw[0] // 2, hw[1] // 2, 4 * C))
    want = jfused.final_conv_parity_edgek(params["final_conv"], jnp.asarray(y), packed=packed,
                                          kernels=_kernels(0)[0])
    got = tfused.final_conv_parity_edgek(_conv(sd, "final_conv.conv2d"), torch.from_numpy(y),
                                         packed=packed)
    _close(got, want)


def test_precompute_fused_kernels_matches_jax_leaf_by_leaf():
    jk, tk = _kernels(2)
    want, got = dict(_leaves(jk)), dict(_leaves(tk))
    merged = {f"/{kind}_borders/{m}" for kind in ("heads", "upsamp", "final")
              for m in ("tb", "lr", "corners")}
    assert got.keys() == want.keys() | merged
    for name, w in want.items():
        g = got[name]
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, err_msg=name)
    # the port's merged border forms are JAX's leaves rearranged
    for kind in ("heads", "upsamp", "final"):
        jb = {k: torch.from_numpy(np.asarray(v)) for k, v in jk[f"{kind}_borders"].items()}
        for m, w in tfused._merge_borders(jb, kind).items():
            np.testing.assert_allclose(got[f"/{kind}_borders/{m}"].numpy(), w.numpy(), atol=1e-6,
                                       err_msg=f"{kind} {m}")
    # conv leaves are channels_last OIHW in memory: cuDNN reads them as they are
    for name in ("/heads/0", "/upsamp/0", "/final/0", "/heads_borders/tb", "/final_borders/lr"):
        assert got[name].permute(3, 2, 0, 1).is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("hw", SIZES)
def test_edgek_paths_with_precomputed_kernels_match_jax(hw):
    params, sd = _weights(2)
    jk, tk = _kernels(2)
    ev, img = _normal(8, (1, *hw, NB)), _normal(9, (1, *hw, 1))
    _close(tfused.heads_fused_edgek(sd, torch.from_numpy(ev), torch.from_numpy(img), kernels=tk),
           jfused.heads_fused_edgek(params, jnp.asarray(ev), jnp.asarray(img), kernels=jk))
    h = _normal(10, (1, hw[0] // 2, hw[1] // 2, C))
    want = jfused.final_conv_parity_edgek(
        params["final_conv"],
        jfused.upsample_conv_parity_edgek(params["upsamp_conv"], jnp.asarray(h),
                                          activation="relu", kernels=jk), kernels=jk)
    got = tfused.final_conv_parity_edgek(
        _conv(sd, "final_conv.conv2d"),
        tfused.upsample_conv_parity_edgek(_conv(sd, "upsamp_conv.conv2d"), torch.from_numpy(h),
                                          activation="relu", kernels=tk), kernels=tk)
    _close(got, want)


def test_fused_decoder_chain_grads_match_the_reference_chain():
    """Gradients reach the stored convs through the precomputed kernels and
    equal those of the reference-shaped chain (tests/test_fused.py holds the
    JAX pair so; the E2V train step holds the port's against JAX's)."""
    sd = {k: v.contiguous() for k, v in _weights(3)[1].items()}  # a trained tensor's layout
    h = torch.from_numpy(_normal(11, (1, 5, 6, C)))
    names = [f"{m}.conv2d.{leaf}" for m in ("upsamp_conv", "final_conv")
             for leaf in ("weight", "bias")]
    for n in names:
        sd[n].requires_grad_(True)
    up, fin = _conv(sd, "upsamp_conv.conv2d"), _conv(sd, "final_conv.conv2d")

    def fused():
        k = tfused.precompute_fused_kernels(sd)
        y = tfused.upsample_conv_parity_edgek(up, h, activation="relu", kernels=k)
        return tfused.final_conv_parity_edgek(fin, y, kernels=k)

    def ref():
        y = tconv.upsample_conv_layer(h, up, activation="relu")
        return tconv.conv_layer(y, fin, padding=1)

    (v_got, *g_got), (v_want, *g_want) = (
        (v, *torch.autograd.grad(v, [sd[n] for n in names]))
        for v in ((torch.sigmoid(f()) ** 2).sum() for f in (fused, ref)))
    assert float(v_got.detach()) == pytest.approx(float(v_want.detach()), rel=1e-5)
    for n, g, w in zip(names, g_got, g_want):
        assert float(w.abs().max()) > 0
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-4, rtol=1e-4, err_msg=n)


def test_conv_lstc_fuse_and_fused_step_match_jax():
    params, sd = _weights(4)
    p0 = {n: _conv(sd, f"P0.{n}") for n in ("gates", "out_gates", "P0")}
    jf, tf = jconv.conv_lstc_fuse(params["P0"]), tconv.conv_lstc_fuse(p0)
    for k in ("W1", "W2"):
        np.testing.assert_array_equal(tf[k]["weight"].numpy(),
                                      tconv.hwio_to_torch_conv(np.asarray(jf[k]["weight"])))
        np.testing.assert_array_equal(tf[k]["bias"].numpy(), np.asarray(jf[k]["bias"]))
    x, z, cell = (_normal(12 + i, (2, 8, 12, ch)) for i, ch in enumerate((C, 2 * C, 2 * C)))
    want = jconv.conv_lstc_step_fused(jf, *map(jnp.asarray, (x, z, cell)))
    got = tconv.conv_lstc_step_fused(tf, *map(torch.from_numpy, (x, z, cell)))
    ref = tconv.conv_lstc_step(p0, *map(torch.from_numpy, (x, z, cell)))
    for g, w, r in zip(got, want, ref):
        _close(g, w)
        _close(g, r.numpy())


@pytest.mark.parametrize("n,capacity", [(400, 400), (300, 512), (0, 8)])
def test_parity_voxel_grid_equals_jax_exactly(n, capacity):
    h, w = 12, 16
    rng = np.random.default_rng(n + capacity)
    ev = np.zeros((capacity, 4))
    ev[:n, 0] = np.sort(rng.uniform(0, 0.05, n))
    ev[:n, 1], ev[:n, 2], ev[:n, 3] = rng.integers(0, w, n), rng.integers(0, h, n), \
        rng.integers(0, 2, n)
    kw = dict(num_bins=NB, width=w, height=h)
    want = np.asarray(jvoxel.events_to_voxel_grid(
        *(jnp.asarray(ev[:, i]) for i in range(4)), jnp.asarray(n), method="scatter",
        layout="parity", **kw))
    cols = [torch.from_numpy(ev[:, i]) for i in range(4)]
    got = tvoxel.events_to_voxel_grid(*cols, n, layout="parity", **kw)
    assert tuple(got.shape) == (h // 2, w // 2, 4 * NB) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    full = tvoxel.events_to_voxel_grid(*cols, n, **kw).permute(1, 2, 0)[None]
    np.testing.assert_array_equal(got.numpy(), tfused.space_to_depth(full)[0].numpy())
    with pytest.raises(ValueError, match="even"):
        tvoxel.events_to_voxel_grid(*cols, n, num_bins=NB, width=w, height=h - 1,
                                    layout="parity")
    with pytest.raises(ValueError, match="layout"):
        tvoxel.events_to_voxel_grid(*cols, n, layout="packed", **kw)
