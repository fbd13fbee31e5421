"""The port's evaluation normalisations (v2e2v_tpu_torch.ops.image) against the
JAX package's (v2e2v_tpu.ops.image, which calls cv2 for minmax)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import no_new_jax_cache_entries  # noqa: F401
from v2e2v_tpu.ops import image as jimage
from v2e2v_tpu_torch.ops import image as timage

KINDS = ["uniform", "sigmoid", "narrow", "constant", "wide", "tiny"]


def _images(kind, n=60):
    """Seeded float32 images of one kind, odd and even sizes."""
    rng = np.random.default_rng(KINDS.index(kind))
    for _ in range(n):
        h, w = (int(v) for v in rng.integers(1, 70, 2))
        if kind == "uniform":
            img = rng.uniform(0, 1, (h, w))
        elif kind == "sigmoid":  # the model's output range
            img = 1 / (1 + np.exp(-rng.normal(0, 3, (h, w))))
        elif kind == "narrow":
            img = 0.5 + 1e-4 * rng.standard_normal((h, w))
        elif kind == "constant":
            img = np.full((h, w), rng.uniform(-2, 2))
        elif kind == "wide":
            img = rng.normal(0, 1e3, (h, w))
        else:
            img = 1e-6 * rng.standard_normal((h, w))
        yield img.astype(np.float32)


@pytest.mark.parametrize("kind", KINDS)
def test_minmax_u8_is_bit_exact_with_cv2(kind):
    for img in _images(kind):
        want = jimage.normalize_image_minmax_u8(img)
        got = timage.normalize_image_minmax_u8(img)
        assert got.dtype == np.uint8 and got.shape == img.shape
        np.testing.assert_array_equal(got, want)
        if kind == "constant":
            assert not got.any()


def test_minmax_u8_takes_float32_only():
    with pytest.raises(TypeError, match="float32"):
        timage.normalize_image_minmax_u8(np.zeros((4, 4)))


# x * a + b whose float64 sum lands on a float32 tie while the exact sum lies
# 2**-60 above or below it: one rounding (a fused multiply-add) goes the exact
# sum's way, rounding the float64 sum again goes to even
TIE_CASES = [
    (1.4409501552581787, 1.3413119316101074, 8.981261047369404e-12, 1.932763695716858),
    (1.687732219696045, 1.6701745986938477, -1.4097168744842126e-11, 2.818807363510132),
]


@pytest.mark.parametrize("x,a,b,want", TIE_CASES)
def test_fma_rounds_once_at_float32_ties(x, a, b, want):
    x, a, b = np.array([x], np.float32), np.float32(a), np.float32(b)
    twice = np.float32(np.float64(x[0]) * np.float64(a) + np.float64(b))
    assert twice != np.float32(want)
    assert timage._fma_f32(x, a, b)[0] == np.float32(want)


@pytest.mark.parametrize("kind", ["uniform", "sigmoid", "wide"])
def test_percentile_matches_jax(kind):
    for i, img in enumerate(_images(kind, 20)):
        want = jimage.normalize_image_percentile(img)
        got = timage.normalize_image_percentile(img)
        assert type(got) is type(want) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        if i >= 5:  # each shape is a new XLA compile
            continue
        want_j = np.asarray(jimage.normalize_image_percentile(jnp.asarray(img)))
        got_t = timage.normalize_image_percentile(torch.from_numpy(img)).numpy()
        # float32 on both sides; jnp and torch interpolate between the two
        # nearest order statistics in another order of operations (2e-6 seen)
        np.testing.assert_allclose(got_t, want_j, atol=1e-5)
