"""The port's host voxeliser and native runtime (v2e2v_tpu_torch.ops.voxel,
v2e2v_tpu_torch.runtime) against the JAX package's same paths, bit for bit,
and the device normalisation's 'maxmin' and hot-pixel modes against JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import no_new_jax_cache_entries  # noqa: F401
from v2e2v_tpu import runtime as jruntime
from v2e2v_tpu.ops import voxel as jvoxel
from v2e2v_tpu_torch import runtime as truntime
from v2e2v_tpu_torch.ops import voxel as tvoxel

H, W, NB = 30, 40, 5
native = pytest.mark.skipif(
    not (truntime.available() and jruntime.available()), reason="no C++ toolchain (g++)"
)


def _events(n, seed, hot=False, t0=0.0):
    rng = np.random.default_rng(seed)
    t = np.sort(t0 + rng.uniform(0.0, 0.1, n))
    x = rng.integers(0, W, n)
    y = rng.integers(0, H, n)
    if hot:  # a few pixels fire often enough to pass the hot-pixel threshold
        x[: n // 4], y[: n // 4] = 3, 4
    p = rng.choice([0.0, 1.0, -1.0], n)
    return np.stack([t, x, y, p], 1)


CASES = [(0, 0, False), (1, 1, False), (7, 2, False), (2000, 3, False), (2000, 4, True),
         (3000, 5, True)]


def test_runtime_builds_outside_the_package():
    if not truntime.available():
        pytest.skip("no C++ toolchain (g++)")
    path = truntime.library_path()
    assert path.exists() and path.parent.name == "runtime" and path.parent.parent.name == "build"
    assert truntime._SRC.parent not in path.parents


@native
@pytest.mark.parametrize("n,seed,hot", CASES)
def test_native_voxeliser_is_bit_exact_with_jax_native(n, seed, hot):
    ev = _events(n, seed, hot)
    before = dict(tvoxel.voxelize_and_preprocess_np.served)
    for fhp in (False, True):
        want = jvoxel.voxelize_and_preprocess_np(ev, NB, W, H, filter_hot_pixel=fhp)
        got = tvoxel.voxelize_and_preprocess_np(ev, NB, W, H, filter_hot_pixel=fhp)
        assert got.dtype == np.float32 and got.shape == (NB, H, W)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(truntime.voxelize_events(ev, NB, W, H),
                                      jruntime.voxelize_events(ev, NB, W, H))
    assert tvoxel.voxelize_and_preprocess_np.served["native"] == before["native"] + 2
    assert tvoxel.voxelize_and_preprocess_np.served["numpy"] == before["numpy"]


@pytest.mark.parametrize("n,seed,hot", CASES)
def test_numpy_voxeliser_is_bit_exact_with_jax_numpy(monkeypatch, n, seed, hot):
    monkeypatch.setattr(truntime, "available", lambda: False)
    monkeypatch.setattr(jruntime, "available", lambda: False)
    ev = _events(n, seed, hot, t0=1.5e3)
    before = tvoxel.voxelize_and_preprocess_np.served["numpy"]
    for fhp in (False, True):
        want = jvoxel.voxelize_and_preprocess_np(ev, NB, W, H, filter_hot_pixel=fhp)
        got = tvoxel.voxelize_and_preprocess_np(ev, NB, W, H, filter_hot_pixel=fhp)
        np.testing.assert_array_equal(got, want)
        grid = tvoxel.events_to_voxel_grid_np(ev, NB, W, H)
        np.testing.assert_array_equal(grid, jvoxel.events_to_voxel_grid_np(ev, NB, W, H))
        for mode in ("std", "maxmin", "none"):
            np.testing.assert_array_equal(
                tvoxel.event_preprocess_np(grid, mode, fhp),
                jvoxel.event_preprocess_np(grid, mode, fhp))
    assert tvoxel.voxelize_and_preprocess_np.served["numpy"] == before + 2


@native
def test_port_runtime_matches_its_numpy_path(tmp_path):
    """As tests/test_runtime.py holds the JAX runtime against its numpy path."""
    ev = _events(2000, 9)
    np.testing.assert_allclose(truntime.voxelize_events(ev, NB, W, H),
                               tvoxel.events_to_voxel_grid_np(ev, NB, W, H), atol=1e-4)
    raw = tvoxel.events_to_voxel_grid_np(ev, NB, W, H)
    want = tvoxel.event_preprocess_np(raw, mode="std", filter_hot_pixel=True)
    got = truntime.voxelize_events(ev, NB, W, H, preprocess=True, hot_pixel_threshold=25.0 / NB)
    # the native normalisation sums in float64, numpy in float32: ~1e-4
    # relative; voxels at the hot-pixel threshold may flip either way
    stable = np.abs(np.abs(raw) - 25.0 / NB) > 1e-3
    np.testing.assert_allclose(got[stable], want[stable], rtol=2e-3, atol=2e-4)
    assert not truntime.voxelize_events(np.zeros((0, 4)), NB, W, H).any()
    with pytest.raises(IndexError, match="outside"):
        truntime.voxelize_events(_events(10, 1) * [1, 10, 10, 1], NB, W, H)
    path = tmp_path / "events.txt"
    path.write_text("".join(f"{t:.9f} {int(x)} {int(y)} {int(p)}\n" for t, x, y, p in ev))
    np.testing.assert_array_equal(truntime.parse_events_txt(str(path)),
                                  jruntime.parse_events_txt(str(path)))
    path.write_text("0.1 3 4 1\nnot an event\n")
    with pytest.raises(truntime.NativeUnavailable):
        truntime.parse_events_txt(str(path))


@pytest.mark.parametrize("mode,tol", [("maxmin", 1e-6), ("none", 0.0), ("std", 1e-5)])
@pytest.mark.parametrize("fhp,thr", [(False, None), (True, None), (True, 0.5)])
def test_device_preprocess_modes_match_jax(mode, tol, fhp, thr):
    """'none' is the hot-pixel filter alone (exact); 'std' sums in another
    order than XLA, at the tolerance of tests/test_torch_voxel.py."""
    rng = np.random.default_rng(3)
    vox = rng.standard_normal((3, NB, H, W)).astype(np.float32) * 2
    vox[vox < 0.3] = 0
    vox[1] *= 3.0  # other statistics per sample, more hot voxels
    vox[2] = 0
    want = np.asarray(jvoxel.event_preprocess(jnp.asarray(vox), mode=mode, filter_hot_pixel=fhp,
                                              hot_pixel_threshold=thr))
    got = tvoxel.event_preprocess(torch.from_numpy(vox), mode=mode, filter_hot_pixel=fhp,
                                  hot_pixel_threshold=thr).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
