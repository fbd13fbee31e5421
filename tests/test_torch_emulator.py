"""Port's DVS emulator (``v2e2v_tpu_torch/models/emulator.py``) against
``v2e2v_tpu/models/emulator.py``, with the noise replayed: ``JaxKeyNoise``
redraws the JAX emulator's own key chain and hands the numbers to the port.

Tolerances and why:
- With intensities <= 20 ``lin_log`` is linear and exact in both, so the
  event counts, ``num_events``, ``EmulatorStats``, the thresholds and
  ``timestamp_mem`` are equal; the float state to 1e-6 (the log-normal leak
  rates go through XLA's and torch's ``exp``, which differ by an ulp, and
  JAX compiles its low-pass scan); the normalised voxel grid to 1e-5.
- Over the full range [30, 220] the 1-2 ulp gap of ``log`` may move a
  pixel's ``|diff| / C`` across an integer, which flips one count. Measured:
  no flip in 24 packs (8 seeds x 3 packs of 520-1,080 events each); the test
  allows 2 events per pack and compares the voxel grids of equal packs to 1e-5.
- One pair step fed JAX's own ``_prepare_pack`` outputs is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import JaxKeyNoise, no_new_jax_cache_entries  # noqa: F401
from v2e2v_tpu.models import emulator as jemu
from v2e2v_tpu_torch.models import emulator as temu

B, N, H, W, PACKS = 2, 5, 16, 24, 3
KW = dict(pos_thres=0.6, neg_thres=0.6, sigma_thres=0.03, pl=1.5, ps=0.5, cutoff_hz=200.0,
          ql=1.0, qs=0.0, refractory_period_s=0.001, leak_rate_hz=0.1,
          shot_noise_rate_hz=100.0)
FLOAT_STATE = ("base_log_frame", "lp_log_frame", "noise_rate_array")


def video(seed, lo, hi):
    """``PACKS`` packs ``[B, N, H, W]`` of a flickering scene in [lo, hi] and
    their ``[B, N]`` timestamps (4 ms apart)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(lo, hi, (B, 1, H, W)).astype(np.float32)
    rate = rng.uniform(-0.5, 0.5, (B, 1, H, W)).astype(np.float32)
    i = np.arange(PACKS * N, dtype=np.float32).reshape(1, -1, 1, 1)
    f = np.clip(base * np.exp(rate * np.sin(i * 0.7)), lo, hi).astype(np.float32)
    t = np.arange(PACKS * N, dtype=np.float32) * 0.004
    return [(f[:, p * N:(p + 1) * N], np.tile(t[p * N:(p + 1) * N], (B, 1)))
            for p in range(PACKS)]


def run_jax(impl, packs, key):
    cfg = jemu.EmulatorConfig(**KW, iters_impl=impl)
    state, outs = None, []
    for frames, t in packs:
        voxel, stats, state = jemu.emulate_pack(cfg, state, jnp.asarray(frames), jnp.asarray(t),
                                                key=key if state is None else None,
                                                with_stats=True)
        outs.append((np.asarray(voxel), jax.tree_util.tree_map(np.asarray, stats),
                     jax.tree_util.tree_map(np.asarray, state)))
    return outs


def run_port(impl, packs, noise, **cfg_kw):
    cfg = temu.EmulatorConfig(**KW, iters_impl=impl, **cfg_kw)
    state, outs = None, []
    for frames, t in packs:
        voxel, stats, state = temu.emulate_pack(cfg, state, frames, t, noise, with_stats=True,
                                                device="cpu")
        outs.append((voxel.numpy(), stats, state))
    return outs


@pytest.mark.parametrize("jax_impl,port_impl", [("xla", "plain"), ("pallas", "cuda")])
def test_three_packs_match_jax_where_lin_log_is_exact(jax_impl, port_impl):
    packs = video(0, 0.0, 20.0)
    key = jax.random.PRNGKey(42)
    want = run_jax(jax_impl, packs, key)
    got = run_port(port_impl, packs, JaxKeyNoise(key))
    for (jv, js, jst), (tv, ts, tst) in zip(want, got):
        assert int(js.num_events) > 100
        for name in temu.EmulatorStats._fields:
            assert int(getattr(ts, name)) == int(getattr(js, name)), name
        for name in temu.EmulatorState._fields:
            g, w = getattr(tst, name).numpy(), getattr(jst, name)
            if name in FLOAT_STATE:
                np.testing.assert_allclose(g, w, atol=1e-6, rtol=0, err_msg=name)
            else:
                np.testing.assert_array_equal(g, w, err_msg=name)
        np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=0)


def test_three_packs_match_jax_over_the_full_range():
    flips = 0
    for seed in (1, 2):
        packs = video(seed, 30.0, 220.0)
        key = jax.random.PRNGKey(seed)
        for (jv, js, _), (tv, ts, _) in zip(run_jax("xla", packs, key),
                                            run_port("plain", packs, JaxKeyNoise(key))):
            n_j, n_t = int(js.num_events), int(ts.num_events)
            assert n_j > 500
            assert abs(n_t - n_j) <= 2, (n_t, n_j)
            flips += n_t != n_j
            if n_t == n_j:
                np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=0)
    assert flips < 2 * PACKS  # most packs agree exactly


def test_pair_step_on_jax_prepared_inputs_is_exact():
    (frames, t), *_ = video(3, 30.0, 220.0)
    cfg = jemu.EmulatorConfig(**KW, iters_impl="xla")
    jstate, (filtered, inten, t_n, tf_base), consts = jemu._prepare_pack(
        cfg, None, jnp.asarray(frames), jnp.asarray(t), jax.random.PRNGKey(5))
    pair = jemu._make_pair_step(cfg, jstate, consts, collect=False)

    def tt(x):
        return torch.from_numpy(np.array(x))

    state = temu.EmulatorState(**{f: tt(getattr(jstate, f)) for f in temu.EmulatorState._fields})
    pack = temu._Pack(filtered=[tt(x) for x in filtered], inten01=[tt(x) for x in inten],
                      t_n=[tt(x) for x in t_n], tf_base=[float(x) for x in tf_base],
                      duration=consts["duration"], tr=tt(consts["tr"]),
                      tr_frames=tt(consts["tr_frames"]))
    noise = JaxKeyNoise(jstate.key)
    tcfg = temu.EmulatorConfig(**KW, iters_impl="plain")
    carry = (jstate.base_log_frame, jstate.timestamp_mem, jstate.t_previous, jstate.key)
    base, mem, t_prev = state.base_log_frame, state.timestamp_mem, state.t_previous
    for p in range(N - 1):
        carry, (voxel_add, n_ev, max_cnt, clipped) = pair(
            carry, (filtered[p], inten[p], t_n[p], tf_base[p]))
        base, mem, got_voxel, got_n, got_max, got_clip = temu._pair_step(
            tcfg, state, pack, base, mem, t_prev, p, noise, temu.k3.emulator_iters_plain, False)
        t_prev = pack.t_n[p]
        np.testing.assert_array_equal(base.numpy(), np.asarray(carry[0]))
        np.testing.assert_array_equal(mem.numpy(), np.asarray(carry[1]))
        np.testing.assert_array_equal(got_voxel.numpy(), np.asarray(voxel_add))
        assert (int(got_n), int(got_max), int(got_clip)) == (int(n_ev), int(max_cnt),
                                                            int(clipped))
    assert int(got_n) > 0


def test_init_from_pack_equals_a_sequence_start():
    (frames, t), *_ = video(4, 30.0, 220.0)
    cfg = temu.EmulatorConfig(**KW, iters_impl="plain")
    key = jax.random.PRNGKey(9)
    jst = jemu.emulator_init_from_pack(jemu.EmulatorConfig(**KW), jnp.asarray(frames),
                                       jnp.asarray(t), key)
    st = temu.emulator_init_from_pack(cfg, frames, t, JaxKeyNoise(key), device="cpu")
    for name in ("pos_thres", "neg_thres", "timestamp_mem", "t_previous"):
        np.testing.assert_array_equal(getattr(st, name).numpy(), np.asarray(getattr(jst, name)))
    np.testing.assert_array_max_ulp(st.base_log_frame.numpy(), np.asarray(jst.base_log_frame),
                                    maxulp=2)  # lin_log over the full range
    g = torch.Generator().manual_seed(0)
    fresh = temu.emulate_pack(cfg, None, frames, t, g, device="cpu")
    g = torch.Generator().manual_seed(0)
    st = temu.emulator_init_from_pack(cfg, frames, t, g, device="cpu")
    again = temu.emulate_pack(cfg, st, frames, t, g, device="cpu")
    assert torch.equal(fresh[0], again[0]) and int(fresh[1]) == int(again[1]) > 0


def test_draws_in_order_and_independent_of_iters_impl(monkeypatch):
    (frames, t), *_ = video(5, 30.0, 220.0)

    class Recorder(temu.GeneratorNoise):
        def __init__(self, seed):
            super().__init__(torch.Generator().manual_seed(seed))
            self.log = []

        def normal(self, what, shape, device):
            self.log.append(what)
            return super().normal(what, shape, device)

        def uniform(self, what, shape, device):
            self.log.append(what)
            return super().uniform(what, shape, device)

        def seeds(self, what, n, device):
            self.log.append(what)
            return super().seeds(what, n, device)

    outs = {}
    for impl in ("plain", "cuda"):
        for rng in ("explicit", "internal"):
            # the card's internal draws, made here on CPU tensors
            monkeypatch.setattr(temu, "_internal_rng", lambda noise, device: rng == "internal")
            cfg = temu.EmulatorConfig(**KW, iters_impl=impl)
            noise = Recorder(0)
            outs[impl, rng] = temu.emulate_pack(cfg, None, frames, t, noise, device="cpu")
            shot = "shot" if rng == "explicit" else "shot_seed"
            assert noise.log == ["pos_large", "pos_small", "neg_large", "neg_small",
                                 "leak_rate"] + ["leak", shot] * (N - 1)
    for rng in ("explicit", "internal"):
        assert torch.equal(outs["plain", rng][0], outs["cuda", rng][0])
        assert int(outs["plain", rng][1]) == int(outs["cuda", rng][1]) > 0


def test_continuation_layout_and_bad_widths():
    (frames, t), *_ = video(6, 30.0, 220.0)
    cfg = temu.EmulatorConfig(**KW, iters_impl="plain")
    t_next = np.concatenate([t, t[:, -1:] + 0.004], axis=1)  # [B, N+1]
    a = temu.emulate_pack(cfg, None, frames, t, torch.Generator().manual_seed(0), device="cpu")
    b_ = temu.emulate_pack(cfg, None, frames, t_next, torch.Generator().manual_seed(0),
                           device="cpu")
    assert torch.equal(a[0], b_[0]) and int(a[1]) == int(b_[1])
    for bad in (t[:, :3], np.concatenate([t_next, t_next], axis=1)):
        with pytest.raises(ValueError, match="expected 2"):
            temu.emulate_pack(cfg, None, frames, bad, torch.Generator(), device="cpu")
        with pytest.raises(ValueError, match="expected 2"):
            temu.emulator_init_from_pack(cfg, frames, bad, torch.Generator(), device="cpu")


@pytest.mark.parametrize("t,prev", [
    (np.array([0.0, 0.01, 0.02]), None),
    (np.array([[0.0, 0.04], [1.0, 1.04]]), np.array([0.0, 1.0])),
    (np.array([[0.0, 0.01, 0.01]]), None),
    (np.array([[0.0, 0.01]]), 0.01),
])
def test_validate_pack_times_matches_jax(t, prev):
    try:
        want = jemu.validate_pack_times(t, prev)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(" (")[0].split("=")[0]):
            temu.validate_pack_times(t, prev)
    else:
        np.testing.assert_array_equal(temu.validate_pack_times(t, prev), want)


def test_config_choices(monkeypatch):
    for bad in ("pallas", "auto"):
        with pytest.raises(ValueError, match="iters_impl"):
            temu.EmulatorConfig(iters_impl=bad)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    gen = temu.GeneratorNoise(torch.Generator())
    assert temu._internal_rng(gen, cuda) and not temu._internal_rng(gen, cpu)
    assert not temu._internal_rng(temu.GeneratorNoise(torch.Generator(), explicit_shot=True), cuda)
    assert not temu._internal_rng(JaxKeyNoise(jax.random.PRNGKey(0)), cuda)
    # the default goes through the kernel's wrapper with and without the
    # refractory gate; 'plain' never does
    calls = []

    def wrapper(*args, **kw):
        calls.append(kw["internal_rng"])
        return temu.k3.emulator_iters_plain(*args, **kw)

    monkeypatch.setattr(temu.k3, "emulator_iters", wrapper)
    (frames, t), *_ = video(0, 30.0, 220.0)
    for refractory, impl, launches in ((0.0, "cuda", N - 1), (0.001, "cuda", N - 1),
                                       (0.001, "plain", 0)):
        cfg = temu.EmulatorConfig(**dict(KW, refractory_period_s=refractory), iters_impl=impl)
        calls.clear()
        temu.emulate_pack(cfg, None, frames, t, torch.Generator().manual_seed(0), device="cpu")
        assert calls == [False] * launches, (refractory, impl)
    assert temu.EmulatorConfig().iters_impl == "cuda"
