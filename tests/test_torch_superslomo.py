"""The port's Super-SloMo upsampler (``v2e2v_tpu_torch/models/superslomo.py``,
``ops/image.CropParameters``, ``ops/conv.bilinear_resize(align_corners=True)``)
against the JAX package's, on the CPU in float32, inputs from numpy seeds and
weights carried across by ``utils/checkpoint.unet_state_dict_from_jax``.

With its random weights the flow net's largest flow is below 0.1 pixel, so
``count = ceil(max |flow|) = 1`` and the interpolation net never runs. The
flow net ends in a leaky ReLU, so scaling its output conv by ``s`` scales
every flow by ``s``: the upsampler test writes a checkpoint with the flow
net's ``conv3`` scaled so that each pair's count is 3-5, and asserts that
every magnitude is at least 0.1 from an integer (where the two packages'
float32 roundings cannot put their counts one apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401
    assert_off_integers,
    jax_unet_params,
    no_new_jax_cache_entries,
    one_torch_thread,
    pair_magnitudes,
    write_ckpt,
)
from v2e2v_tpu.models import superslomo as jss
from v2e2v_tpu.ops import conv as jconv
from v2e2v_tpu.ops import image as jimage
from v2e2v_tpu_torch.models import superslomo as tss
from v2e2v_tpu_torch.ops import conv as tconv
from v2e2v_tpu_torch.ops import image as timage
from v2e2v_tpu_torch.utils.checkpoint import load_superslomo_checkpoint, unet_state_dict_from_jax

UNET_TOL = 1e-4  # seen: 1.2e-7 (the JAX package's own torch-oracle test allows 5e-4)
FLOW_SCALE = 45.0  # the upsampler test's flows: counts 4, magnitudes >= 0.3 from an integer


@pytest.mark.parametrize("h,w", [(32, 40), (180, 240), (33, 7), (5, 2)])
def test_crop_parameters_pad_and_crop_equal_jax(h, w):
    rng = np.random.default_rng(h * w)
    want, got = jimage.CropParameters(w, h, 5), timage.CropParameters(w, h, 5)
    assert vars(got) == vars(want)
    for shape in ((h, w), (1, h, w, 3), (2, h, w, 1)):
        x = rng.normal(size=shape).astype(np.float32)
        padded = np.asarray(want.pad(jnp.asarray(x)))
        got_padded = got.pad(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got_padded, padded)
        np.testing.assert_array_equal(got.crop(torch.from_numpy(got_padded)).numpy(),
                                      np.asarray(want.crop(jnp.asarray(padded))))
        np.testing.assert_array_equal(got.crop(torch.from_numpy(got_padded)).numpy(), x)


@pytest.mark.parametrize("in_hw,out_hw", [((6, 8), (12, 16)), ((9, 13), (20, 27)),
                                          ((12, 16), (5, 7))])
def test_bilinear_align_corners_matches_jax(in_hw, out_hw):
    x = np.random.default_rng(7).normal(size=(2, *in_hw, 3)).astype(np.float32)
    want = np.asarray(jconv.bilinear_resize(jnp.asarray(x), *out_hw, align_corners=True))
    got = tconv.bilinear_resize(torch.from_numpy(x), *out_hw, align_corners=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_backwarp_matches_jax_out_of_bounds_included():
    rng = np.random.default_rng(1)
    n, h, w = 2, 12, 16
    img = rng.normal(size=(n, h, w, 3)).astype(np.float32)
    flow = (3 * rng.normal(size=(n, h, w, 2))).astype(np.float32)
    gx = np.arange(w) + flow[..., 0]
    assert (gx < 0).any() and (gx > w - 1).any()  # some sample points fall outside
    want = np.asarray(jss.backwarp(jnp.asarray(img), jnp.asarray(flow)))
    got = tss.backwarp(torch.from_numpy(img), torch.from_numpy(flow)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_backwarp_zero_flow_quirk():
    """Zero flow is identity only at the top-left pixel (the reference
    normalises the grid by W, not W - 1), as in the JAX package."""
    img = np.random.default_rng(0).normal(size=(1, 8, 10, 3)).astype(np.float32)
    zero = np.zeros((1, 8, 10, 2), np.float32)
    got = tss.backwarp(torch.from_numpy(img), torch.from_numpy(zero)).numpy()
    want = np.asarray(jss.backwarp(jnp.asarray(img), jnp.asarray(zero)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[:, 0, 0], img[:, 0, 0], atol=1e-5)
    assert np.abs(got[:, -1, -1] - img[:, -1, -1]).max() > 1e-2


@pytest.mark.parametrize("which", ["flow", "interp"])
def test_unet_matches_jax(which):
    flow, intrp = jax_unet_params()
    params, in_ch, out_ch = (flow, 6, 4) if which == "flow" else (intrp, 20, 5)
    net = tss.UNet(in_ch, out_ch)
    net.load_state_dict(unet_state_dict_from_jax(params))
    x = np.random.default_rng(2).normal(size=(1, 32, 64, in_ch)).astype(np.float32)
    want = np.asarray(jax.jit(jss.unet_apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 32, 64, out_ch)
    np.testing.assert_allclose(got, want, rtol=0, atol=UNET_TOL)


@pytest.mark.parametrize("t", [0.25, 0.5])
def test_interp_at_t_matches_jax(t):
    _, intrp = jax_unet_params()
    net = tss.UNet(20, 5)
    net.load_state_dict(unet_state_dict_from_jax(intrp))
    rng = np.random.default_rng(4)
    i0, i1 = (rng.normal(scale=0.3, size=(1, 32, 64, 3)).astype(np.float32) for _ in range(2))
    f01, f10 = (rng.normal(scale=2.0, size=(1, 32, 64, 2)).astype(np.float32) for _ in range(2))
    want = np.asarray(jss._interp_at_t(intrp, *map(jnp.asarray, (i0, i1, f01, f10)), t))
    with torch.no_grad():
        got = tss.interp_at_t(net, *map(torch.from_numpy, (i0, i1, f01, f10)), t).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=UNET_TOL)


def test_upsampling_matches_jax(tmp_path):
    """Four frames at 32x40, stamps unevenly spaced, a checkpoint whose flows
    give 4 frames a pair: the same counts and timestamps, frames within one
    code (the truncating uint8 cast of a float32 gray)."""
    ckpt = str(write_ckpt(tmp_path / "scaled.ckpt", FLOW_SCALE))
    rng = np.random.default_rng(3)
    h, w = 32, 40
    frames = [rng.uniform(0, 255, (h, w)).astype(np.uint8) for _ in range(4)]
    ts = [0.0, 0.1, 0.25, 0.3]
    want_up = jss.Upsampler([h, w], ckpt_path=ckpt)
    got_up = tss.Upsampler([h, w], ckpt_path=ckpt, device="cpu")
    assert want_up.pretrained and got_up.pretrained
    counts = assert_off_integers(pair_magnitudes(got_up, frames), 3, 5)

    want_frames, want_ts = want_up.upsampling(frames, ts)
    got_frames, got_ts = got_up.upsampling(frames, ts)
    assert got_frames.dtype == np.uint8 and got_ts.dtype == np.float64
    np.testing.assert_array_equal(got_ts, want_ts)
    assert len(got_ts) == sum(counts) + 1  # the interpolation net ran count - 1 times a pair
    assert [int(((got_ts > a) & (got_ts < b)).sum()) for a, b in zip(ts, ts[1:])] == \
        [c - 1 for c in counts]
    assert got_frames.shape == want_frames.shape == (len(want_ts), h, w)
    diff = got_frames.astype(int) - want_frames.astype(int)
    assert np.abs(diff).max() <= 1, f"{np.count_nonzero(diff)} of {diff.size} codes differ"
    # seen: 0 on these random frames; on smooth ones up to a few percent
    # (tests/test_torch_interpolating_reader.py says why)
    assert np.count_nonzero(diff) <= 0.05 * diff.size
    for i, k in ((0, 0), (counts[0], 1), (len(got_ts) - 1, 3)):  # the input frames survive
        np.testing.assert_allclose(got_frames[i].astype(int), frames[k].astype(int), atol=2)


def test_checkpoint_loads_the_same_weights_in_both_packages(tmp_path):
    ckpt = str(write_ckpt(tmp_path / "SuperSloMo.ckpt", 3.0))
    want_flow, want_intrp = jss.load_superslomo_checkpoint(ckpt)
    got_flow, got_intrp = load_superslomo_checkpoint(ckpt)
    for got, want, shapes in ((got_flow, want_flow, (6, 4)), (got_intrp, want_intrp, (20, 5))):
        ref = unet_state_dict_from_jax(want)
        assert sorted(got) == sorted(ref) and len(got) == 46
        for k in ref:
            assert got[k].dtype == torch.float32
            torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0)
        tss.UNet(*shapes).load_state_dict(got)  # strict: every name is the original's
    np.testing.assert_array_equal(got_flow["conv3.bias"].numpy(),
                                  jax_unet_params(3.0)[0]["conv3"]["bias"])


def test_missing_checkpoint_warns_and_runs_on_random_weights(tmp_path, monkeypatch):
    """Without a checkpoint both packages warn and use random weights (the
    port's from a generator seeded 0, the same each time); their flows stay
    below one pixel, so both return the input frames alone, equal. The
    environment variable names a checkpoint when no path is given."""
    monkeypatch.delenv(tss.CKPT_ENV_VAR, raising=False)
    missing = str(tmp_path / "missing.ckpt")
    with pytest.warns(UserWarning, match="RANDOM"):
        got_up = tss.Upsampler([32, 40], ckpt_path=missing, device="cpu")
    with pytest.warns(UserWarning, match="RANDOM"):
        want_up = jss.Upsampler([32, 40], ckpt_path=missing)
    assert not got_up.pretrained
    with pytest.warns(UserWarning, match="RANDOM"):
        again = tss.Upsampler([32, 40], ckpt_path=missing, device="cpu")
    for a, b in zip(got_up.flow_net.state_dict().values(), again.flow_net.state_dict().values()):
        assert torch.equal(a, b)
    rng = np.random.default_rng(5)
    frames = [rng.uniform(0, 255, (32, 40)).astype(np.uint8) for _ in range(3)]
    got = got_up.upsampling(frames, [0.0, 0.1, 0.2])
    want = want_up.upsampling(frames, [0.0, 0.1, 0.2])
    assert len(got[1]) == 3
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])

    monkeypatch.setenv(tss.CKPT_ENV_VAR, str(write_ckpt(tmp_path / "env.ckpt", 1.0)))
    assert tss.Upsampler([32, 40], device="cpu").pretrained


def test_upsampler_without_device_needs_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tss.Upsampler([32, 40], ckpt_path=str(tmp_path / "missing.ckpt"))
