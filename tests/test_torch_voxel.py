"""Port's request front end (v2e2v_tpu_torch.ops.voxel) against the JAX
device path, the numpy oracle and the JAX ``event_preprocess`` (float32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import no_new_jax_cache_entries  # noqa: F401
from v2e2v_tpu.ops import voxel as jvoxel
from v2e2v_tpu_torch.ops import voxel as tvoxel

H, W, NB = 12, 16, 5


def _events(rng, n, t0):
    t = np.sort(t0 + rng.uniform(0, 0.05, n))
    x = rng.integers(0, W, n)
    y = rng.integers(0, H, n)
    p = rng.integers(0, 2, n)
    return np.stack([t, x, y, p], axis=1)


def _padded(ev, capacity):
    pad = np.zeros((capacity - len(ev), 4))
    pad[:, 1:3] = 7  # padding must not land anywhere
    pad[:, 3] = 1
    return np.concatenate([ev, pad])


@pytest.mark.parametrize("n,capacity,t0", [(300, 300, 0.0), (300, 512, 0.0), (1, 8, 0.0),
                                          (0, 8, 0.0), (300, 512, 1.5e3)])
def test_voxel_grid_matches_jax_scatter_and_numpy(n, capacity, t0):
    rng = np.random.default_rng(n + capacity)
    ev = _events(rng, n, t0)
    full = _padded(ev, capacity)
    kw = dict(num_bins=NB, width=W, height=H)
    want = np.asarray(jvoxel.events_to_voxel_grid(
        *(jnp.asarray(full[:, i]) for i in range(4)), jnp.asarray(n), method="scatter", **kw))
    got = tvoxel.events_to_voxel_grid(
        *(torch.from_numpy(full[:, i]) for i in range(4)), n, **kw).numpy()
    assert got.shape == (NB, H, W) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)
    # stamps are cast to float32 before the first is subtracted (as in the
    # JAX package), so only windows that start near 0 match the float64 oracle
    if n and t0 == 0.0:
        np.testing.assert_allclose(got, jvoxel.events_to_voxel_grid_np(ev, NB, W, H),
                                   atol=1e-4)


def test_voxel_grid_same_stamps_and_tensor_n_valid():
    ev = _events(np.random.default_rng(9), 50, 0.0)
    ev[:, 0] = 42.0  # deltaT == 0 -> 1
    kw = dict(num_bins=NB, width=W, height=H)
    want = np.asarray(jvoxel.events_to_voxel_grid(
        *(jnp.asarray(ev[:, i]) for i in range(4)), jnp.asarray(50), method="scatter", **kw))
    got = tvoxel.events_to_voxel_grid(*(torch.from_numpy(ev[:, i]) for i in range(4)),
                                      torch.tensor(50), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_event_preprocess_matches_jax_per_sample():
    rng = np.random.default_rng(11)
    vox = rng.standard_normal((3, NB, H, W)).astype(np.float32)
    vox[vox < 0.3] = 0
    vox[1] *= 7.0  # other statistics per sample
    vox[2] = 0  # no events: unchanged
    want = np.asarray(jvoxel.event_preprocess(jnp.asarray(vox), mode="std"))
    got = tvoxel.event_preprocess(torch.from_numpy(vox)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got[0], tvoxel.event_preprocess(torch.from_numpy(vox[0])).numpy(),
                               atol=1e-6)
