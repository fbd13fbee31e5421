"""Kernel K3's plain version (``v2e2v_tpu_torch/ops/cuda/emulator_iters.py``)
against the Pallas kernel ``emulator_iters_pallas`` run in interpret mode,
on the same numpy inputs, over the shot x gate grid of
tests/test_pallas_emulator.py.

Tolerances: event counts and ``timestamp_mem`` exact (they are selects and
compares of the same float32 values); the voxel to atol 1e-5, since both sum
the same terms in the same order but XLA may contract a multiply-add.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import no_new_jax_cache_entries  # noqa: F401
from v2e2v_tpu.ops.pallas.emulator_iters import emulator_iters_pallas
from v2e2v_tpu_torch.ops.cuda import emulator_iters as k3

B, H, W, NB, MI = 2, 16, 24, 5, 8


def _inputs(seed, gate_on):
    rng = np.random.default_rng(seed)
    return dict(
        counts=rng.integers(0, 7, (B, H, W)).astype(np.int32),
        pol=rng.choice([-1.0, 0.0, 1.0], (B, H, W)).astype(np.float32),
        mem=rng.uniform(-1, 0, (B, H, W)).astype(np.float32),
        trf=np.full((B, H, W), 0.7, np.float32),
        om=rng.uniform(0.95, 1.0, (B, H, W)).astype(np.float32),
        off=rng.uniform(0.0, 0.05, (B, H, W)).astype(np.float32),
        rand01=rng.uniform(0, 1, (MI, B, H, W)).astype(np.float32),
        num_iters=np.array([6, 4], np.int32),
        gate=np.array([gate_on, gate_on]),
    )


def _plain(x, shot, fn=k3.emulator_iters_plain):
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    ts_step = 4.0 / t["num_iters"].to(torch.float32)
    return fn(t["counts"], t["pol"], t["mem"], t["trf"], t["om"], t["off"],
              t["rand01"] if shot else None, None, ts_step, t["num_iters"], t["gate"], 1.0,
              num_bins=NB, max_iters=MI, shot=shot)


@pytest.mark.parametrize("shot", [True, False])
@pytest.mark.parametrize("gate_on", [True, False])
def test_plain_matches_pallas_interpret(shot, gate_on):
    x = _inputs(0 if shot else 1, gate_on)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    want = emulator_iters_pallas(
        j["counts"], j["pol"], j["mem"], j["trf"], j["om"], j["off"], j["rand01"],
        jnp.zeros((B,), jnp.int32), 4.0 / j["num_iters"].astype(jnp.float32), j["num_iters"],
        j["gate"], jnp.asarray(1.0, jnp.float32), num_bins=NB, max_iters=MI, shot=shot,
        interpret=True,
    )
    voxel, mem, final = _plain(x, shot)
    np.testing.assert_array_equal(final.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(mem.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(voxel.numpy(), np.asarray(want[0]), atol=1e-5)
    assert final.dtype == torch.int32 and voxel.shape == (B, H, W, NB)


def test_wrapper_takes_the_plain_version_for_cpu_tensors():
    x = _inputs(2, True)
    before = k3.emulator_iters.launches
    got = _plain(x, True, fn=k3.emulator_iters)
    assert k3.emulator_iters.launches == before
    for g, w in zip(got, _plain(x, True)):
        assert torch.equal(g, w)


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox4x32-10."""
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        got = k3.philox4x32_10(tuple(torch.tensor([c]) for c in ctr),
                               tuple(torch.tensor([k]) for k in key))
        assert [int(v) for v in got] == list(want)


def test_internal_rng_is_deterministic_and_binomial():
    """No threshold events, shot probability p on every pixel and iteration:
    the event total is Binomial(n, p) within 5 sigma, and a seed gives the
    same numbers twice while another seed gives others."""
    b, h, w, mi, p = 2, 32, 48, 16, 0.05
    g = torch.Generator().manual_seed(0)
    pol = torch.where(torch.rand(b, h, w, generator=g) < 0.5, -1.0, 1.0)
    zeros = torch.zeros(b, h, w)
    args = (torch.zeros(b, h, w, dtype=torch.int32), pol, zeros, zeros,
            torch.full((b, h, w), 1.0 - p), torch.full((b, h, w), p), None)
    tail = (torch.full((b,), 4.0 / mi), torch.full((b,), mi, dtype=torch.int32),
            torch.zeros(b, dtype=torch.bool), 0.0)
    kw = dict(num_bins=5, max_iters=mi, shot=True, internal_rng=True)
    seed = torch.tensor([12345, -7], dtype=torch.int64)
    _, _, f1 = k3.emulator_iters_plain(*args, seed, *tail, **kw)
    _, _, f2 = k3.emulator_iters_plain(*args, seed, *tail, **kw)
    _, _, f3 = k3.emulator_iters_plain(*args, seed + 1, *tail, **kw)
    assert torch.equal(f1, f2) and not torch.equal(f1, f3)
    n = b * h * w * mi
    total = int(f1.sum())
    assert abs(total - n * p) < 5 * (n * p * (1 - p)) ** 0.5, (total, n * p)


def test_checks_refuse_bad_inputs():
    x = _inputs(3, True)
    bad = dict(x, counts=x["counts"].astype(np.int64))
    with pytest.raises(ValueError, match="event_counts must be torch.int32"):
        _plain(bad, True)
    with pytest.raises(ValueError, match="rand01"):
        _plain(dict(x, rand01=x["rand01"][:3]), True)
    with pytest.raises(ValueError, match="num_bins"):
        t = {k: torch.from_numpy(v) for k, v in x.items()}
        k3.emulator_iters_plain(t["counts"], t["pol"], t["mem"], t["trf"], None, None, None, None,
                                torch.ones(B), t["num_iters"], t["gate"], 0.0,
                                num_bins=17, max_iters=MI, shot=False)
