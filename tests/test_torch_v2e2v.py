"""Port's V2E2V composite (``v2e2v_tpu_torch/models/v2e2v.py``) against
``v2e2v_tpu/models/v2e2v.py``: the same frames, the JAX weights carried over
with ``params_from_jax``, and the emulator's noise replayed from the JAX key
chain (``JaxKeyNoise``).

float32; reconstructions to atol 1e-4 after the recurrence, voxel grids to
1e-5, event counts exact. ``v2e2v_forward`` runs on the input where
``lin_log`` is exact in both (intensities <= 20) and on the full range
[30, 220], where the ulp gap of ``log`` could flip a count (none seen here;
tests/test_torch_emulator.py measures it).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import JaxKeyNoise, no_new_jax_cache_entries  # noqa: F401
from test_torch_emulator import KW, video
from v2e2v_tpu.models import cista as jcista
from v2e2v_tpu.models import emulator as jemu
from v2e2v_tpu.models import v2e2v as jv2e2v
from v2e2v_tpu_torch.models import cista as tcista
from v2e2v_tpu_torch.models import emulator as temu
from v2e2v_tpu_torch.models import v2e2v as tv2e2v
from v2e2v_tpu_torch.utils.checkpoint import params_from_jax

H, W, C, DEPTH, NB = 16, 24, 8, 2, 5


def _configs():
    jcfg = jv2e2v.V2E2VConfig(
        cista=jcista.CistaConfig(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB,
                                 fullres_impl="ref", ista_impl="xla"),
        emulator=jemu.EmulatorConfig(**KW, iters_impl="xla"),
    )
    tcfg = tv2e2v.V2E2VConfig(
        cista=tcista.CistaConfig(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB),
        emulator=temu.EmulatorConfig(**KW, iters_impl="cuda"),
    )
    params = jax.tree_util.tree_map(np.asarray, jcista.init_cista_lstc(jax.random.PRNGKey(0),
                                                                       jcfg.cista))
    return jcfg, tcfg, params, params_from_jax(params, DEPTH)


@pytest.mark.parametrize("lo,hi", [(0.0, 20.0), (30.0, 220.0)], ids=["exact_lin_log", "full"])
def test_forward_over_three_packs_with_a_reset(lo, hi):
    jcfg, tcfg, params, sd = _configs()
    packs = video(7, lo, hi)
    keys = [jax.random.PRNGKey(1), None, jax.random.PRNGKey(2)]  # pack 2 starts a sequence
    jstate = tstate = noise = None
    for (frames, t), key in zip(packs, keys):
        if key is not None:
            jstate = tstate = None
            noise = JaxKeyNoise(key)
        jout, jstate = jv2e2v.v2e2v_forward(params, jcfg, jnp.asarray(frames), jnp.asarray(t),
                                            jstate, key=key, with_stats=True)
        tout, tstate = tv2e2v.v2e2v_forward(sd, tcfg, frames, t, tstate, noise, with_stats=True,
                                            device="cpu")
        assert int(tout.num_events) == int(jout.num_events) > 100
        assert int(tout.stats.max_event_count) == int(jout.stats.max_event_count)
        np.testing.assert_allclose(tout.event_voxel_grids.numpy(),
                                   np.asarray(jout.event_voxel_grids), atol=1e-5, rtol=0)
        np.testing.assert_allclose(tout.reconstruction.numpy(), np.asarray(jout.reconstruction),
                                   atol=1e-4, rtol=0)
        for g, w in zip([tstate.cista.cell, tstate.cista.z, *tstate.cista.dg],
                        [jstate.cista.cell, jstate.cista.z, *jstate.cista.dg]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)


def test_sequence_with_stats_and_monitor():
    jcfg, tcfg, params, sd = _configs()
    packs = video(8, 0.0, 20.0)
    frames_seq = np.stack([f for f, _ in packs])
    ts_seq = np.stack([t for _, t in packs])
    key = jax.random.PRNGKey(3)
    jrecs, _, jstats = jv2e2v.v2e2v_sequence(params, jcfg, jnp.asarray(frames_seq),
                                             jnp.asarray(ts_seq), key=key, with_stats=True)
    trecs, tstate, tstats = tv2e2v.v2e2v_sequence(sd, tcfg, frames_seq, ts_seq,
                                                  JaxKeyNoise(key), with_stats=True,
                                                  device="cpu")
    assert set(tstats) == set(jstats)
    for name, v in jstats.items():
        np.testing.assert_array_equal(tstats[name].numpy(), np.asarray(v), err_msg=name)
    np.testing.assert_allclose(trecs.numpy(), np.asarray(jrecs), atol=1e-4, rtol=0)

    recs, _, (voxels, stats) = tv2e2v.v2e2v_sequence(
        sd, tcfg, frames_seq, ts_seq, JaxKeyNoise(key), with_monitor=True, device="cpu")
    assert voxels.shape == (len(packs), 2, H, W, NB) and torch.equal(recs, trecs)
    assert torch.equal(stats["num_events"], tstats["num_events"])
    # a state built from the first pack continues exactly like state=None
    noise = JaxKeyNoise(key)
    state = tv2e2v.v2e2v_init_state(tcfg, frames_seq[0], ts_seq[0], noise, device="cpu")
    again, _ = tv2e2v.v2e2v_sequence(sd, tcfg, frames_seq, ts_seq, noise, state=state,
                                     device="cpu")
    assert torch.equal(again, trecs)
    with pytest.raises(NotImplementedError, match="remat"):
        tv2e2v.v2e2v_sequence(sd, tcfg, frames_seq, ts_seq, noise, remat=True, device="cpu")


def test_from_flags():
    flags = types.SimpleNamespace(
        image_dim=[180, 240], base_channels=64, depth=5, num_bins=5, event_mode="voxel_grid",
        pl=1.5, ps=0.5, ql=1.0, qs=0.0, C=0.6, threshold_sigma=0.03, cutoff_hz=200.0,
        refractory_period_s=0.001)
    cfg = tv2e2v.V2E2VConfig.from_flags(flags)
    want = jv2e2v.V2E2VConfig.from_flags(flags)
    assert cfg.cista.image_dim == (180, 240) and cfg.cista.ista_impl == "cuda"
    for name in ("pl", "ps", "ql", "qs", "pos_thres", "neg_thres", "sigma_thres", "cutoff_hz",
                 "refractory_period_s", "leak_rate_hz", "shot_noise_rate_hz", "max_iters"):
        assert getattr(cfg.emulator, name) == getattr(want.emulator, name), name
    assert cfg.emulator.iters_impl == "cuda"
    for flag, impl in (("xla", "plain"), ("pallas", "cuda"), ("auto", "cuda")):
        flags.v2e_iters_impl = flag
        assert tv2e2v.V2E2VConfig.from_flags(flags).emulator.iters_impl == impl
