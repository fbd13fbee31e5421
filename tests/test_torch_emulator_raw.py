"""Port's raw-event mode (``emulate_pack_raw``) against
``v2e2v_tpu/models/emulator.py::emulate_pack_raw``, with the noise replayed
(``JaxKeyNoise``), on input where ``lin_log`` is exact in both (intensities
<= 20; tests/test_torch_emulator.py explains why).

The events must be equal in order, x, y, polarity and batch row, their times
(bin units, float32 in both) within 1e-6, and ``num_events`` equal, over two
packs with the state carried, with and without refractory gating and shot
noise. The raw events binned in time equal voxel mode's grid on the same
draws, before and after its normalisation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import JaxKeyNoise, no_new_jax_cache_entries  # noqa: F401
from test_torch_emulator import KW, video
from v2e2v_tpu.models import emulator as jemu
from v2e2v_tpu_torch.models import emulator as temu
from v2e2v_tpu_torch.ops.voxel import event_preprocess

B, H, W, NB = 2, 16, 24, 5


def _kw(refractory, shot):
    return dict(KW, refractory_period_s=refractory, shot_noise_rate_hz=shot)


@pytest.mark.parametrize("refractory", [0.0, 0.001], ids=["refr0", "refr1ms"])
@pytest.mark.parametrize("shot", [0.0, 1.0], ids=["shot0", "shot1Hz"])
def test_raw_events_match_jax_over_two_packs(refractory, shot):
    packs = video(5, 0.0, 20.0)[:2]
    key = jax.random.PRNGKey(7)
    jcfg = jemu.EmulatorConfig(output_mode="raw", **_kw(refractory, shot))
    tcfg = temu.EmulatorConfig(output_mode="raw", **_kw(refractory, shot))
    noise = JaxKeyNoise(key)
    jstate = tstate = None
    for frames, t in packs:
        want, want_n, jstate = jemu.emulate_pack_raw(
            jcfg, jstate, jnp.asarray(frames), jnp.asarray(t), key=key)
        got, got_n, tstate = temu.emulate_pack_raw(tcfg, tstate, frames, t, noise, device="cpu")
        assert got.dtype == want.dtype == np.float64
        assert got_n == want_n == len(want) > 50
        np.testing.assert_array_equal(got[:, 1:], want[:, 1:])  # x, y, p, batch in order
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tstate.timestamp_mem.numpy(),
                                      np.asarray(jstate.timestamp_mem))
        np.testing.assert_allclose(tstate.base_log_frame.numpy(),
                                   np.asarray(jstate.base_log_frame), rtol=0, atol=1e-6)


def test_raw_events_sorted_by_time_then_batch():
    frames, t = video(6, 0.0, 20.0)[0]
    events, n, _ = temu.emulate_pack_raw(temu.EmulatorConfig(output_mode="raw", **KW), None,
                                         frames, t, torch.Generator().manual_seed(0),
                                         device="cpu")
    assert n == len(events) > 0
    batch = events[:, 4]
    assert np.all(np.diff(batch) >= 0) and set(np.unique(batch)) == {0.0, 1.0}
    for b in (0.0, 1.0):
        assert np.all(np.diff(events[batch == b, 0]) >= 0)
    assert set(np.unique(events[:, 3])) <= {-1.0, 1.0}


@pytest.mark.parametrize("refractory", [0.0, 0.001], ids=["refr0", "refr1ms"])
def test_binned_raw_events_equal_voxel_mode(refractory, monkeypatch):
    """The same draws through raw mode and through voxel mode (K3's plain
    version on the CPU), two packs with the state carried: equal counts,
    equal grids before voxel mode normalises (per pixel the same float32
    sums in the same order) and after."""
    cfg = temu.EmulatorConfig(**_kw(refractory, 100.0))
    adds = []

    def recorded(*a, **k):
        out = plain(*a, **k)
        adds.append(out[0])
        return out

    plain = temu.k3.emulator_iters_plain
    monkeypatch.setattr(temu.k3, "emulator_iters_plain", recorded)
    raw_noise, vox_noise = (torch.Generator().manual_seed(11) for _ in range(2))
    raw_state = vox_state = None
    for frames, t in video(8, 0.0, 20.0)[:2]:
        events, n, raw_state = temu.emulate_pack_raw(cfg, raw_state, frames, t, raw_noise,
                                                     device="cpu")
        adds.clear()
        voxel, n_vox, vox_state = temu.emulate_pack(cfg, vox_state, frames, t, vox_noise,
                                                    device="cpu")
        assert n == int(n_vox) > 50 and len(adds) == frames.shape[1] - 1
        binned = temu.bin_raw_events(events, B, H, W, NB)
        np.testing.assert_allclose(binned.numpy(), sum(adds).numpy(), rtol=0, atol=1e-5)
        normed = event_preprocess(binned.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(normed.numpy(), voxel.numpy(), rtol=0, atol=1e-4)
