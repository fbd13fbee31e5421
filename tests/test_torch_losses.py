"""The port's training losses (``v2e2v_tpu_torch/training/losses.py``)
against ``v2e2v_tpu/training/losses.py`` on the same numpy inputs from a
seed: values and gradients with respect to both images, float32, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import no_new_jax_cache_entries, one_torch_thread  # noqa: F401
from v2e2v_tpu.training import losses as jl
from v2e2v_tpu_torch.training import losses as tl

B, H, W = 2, 32, 40
ATOL = 1e-6


def _images(seed, channels=1, flat=False):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 1.0, (B, H, W, channels)).astype(np.float32)
    b = np.clip(a + rng.normal(0.0, 0.1, a.shape), 0, 1).astype(np.float32)
    if flat:  # near-constant windows: the variance term cancels
        a = (0.5 + 1e-3 * a).astype(np.float32)
    return a, b


def _torch_value_and_grads(fn, a, b):
    ta, tb = (torch.from_numpy(x).requires_grad_(True) for x in (a, b))
    value = fn(ta, tb)
    ga, gb = torch.autograd.grad(value, (ta, tb))
    return value.detach().numpy(), ga.numpy(), gb.numpy()


def _jax_value_and_grads(fn, a, b):
    value, (ga, gb) = jax.value_and_grad(fn, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    return np.asarray(value), np.asarray(ga), np.asarray(gb)


def _assert_same(got, want):
    for g, w, what in zip(got, want, ("value", "grad img1", "grad img2")):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=what)


def test_gaussian_kernel_is_the_jax_one():
    np.testing.assert_array_equal(tl._gaussian_kernel1d(11, 1.5), jl._gaussian_kernel1d(11, 1.5))


@pytest.mark.parametrize("channels,flat", [(1, False), (1, True), (3, False)],
                         ids=["gray", "near-constant", "three-channels"])
def test_ssim_value_and_grads(channels, flat):
    a, b = _images(0, channels, flat)
    got = _torch_value_and_grads(tl.ssim, a, b)
    _assert_same(got, _jax_value_and_grads(jl.ssim, a, b))
    assert -1.0 <= float(got[0]) <= 1.0


def test_per_sample_ssim():
    a, b = _images(1)
    got = tl._per_sample_ssim(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jl._per_sample_ssim(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == (B,)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_l1_loss_value_and_grads():
    a, b = _images(2)
    _assert_same(_torch_value_and_grads(tl.l1_loss, a, b),
                 _jax_value_and_grads(jl.l1_loss, a, b))


@pytest.mark.parametrize("weights", [None, [1.0, 1.0], [1.0, 0.0], [0.0, 0.0], [0.3, 2.0]],
                         ids=["none", "ones", "masked-tail", "all-zero", "uneven"])
def test_many_to_one_loss_value_and_grads(weights):
    a, b = _images(3)

    def port(x, y):
        w = None if weights is None else torch.tensor(weights)
        return tl.many_to_one_loss(x, y, sample_weights=w)

    def ref(x, y):
        w = None if weights is None else jnp.asarray(weights, jnp.float32)
        return jl.many_to_one_loss(x, y, sample_weights=w)

    _assert_same(_torch_value_and_grads(port, a, b), _jax_value_and_grads(ref, a, b))


def test_masked_tail_equals_the_unpadded_batch():
    """A tail batch padded with a copy of its first sample and weights
    [1, 0] gives the loss and gradient of the one real sample."""
    a, b = _images(4)
    x = torch.from_numpy(a).requires_grad_(True)
    padded = torch.cat([x[:1], x[:1]])
    loss = tl.many_to_one_loss(padded, torch.from_numpy(b[[0, 0]]), torch.tensor([1.0, 0.0]))
    (grad,) = torch.autograd.grad(loss, x)
    x1 = torch.from_numpy(a[:1]).requires_grad_(True)
    want = tl.many_to_one_loss(x1, torch.from_numpy(b[:1]))
    (want_grad,) = torch.autograd.grad(want, x1)
    torch.testing.assert_close(loss, want, atol=ATOL, rtol=0)
    torch.testing.assert_close(grad[:1], want_grad, atol=ATOL, rtol=0)
    assert float(grad[1].abs().max()) == 0.0


def test_blur_runs_with_tf32_off_and_restores_the_settings(monkeypatch):
    """The blur's convs see TF32 off, and the caller's settings come back."""
    seen = []
    conv2d = torch.nn.functional.conv2d

    def spy(*args, **kwargs):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    a, b = _images(5)
    tl.ssim(torch.from_numpy(a), torch.from_numpy(b))
    assert seen and all(s == (False, False) for s in seen)
    assert torch.backends.cudnn.allow_tf32 is True
