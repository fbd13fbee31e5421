"""Port's kernel K2 (the CISTA-LSTC half-res core) against v2e2v_tpu.

The plain version ``cista_core_plain`` is held against the Pallas kernel
``cista_core_pallas`` in interpret mode at the shapes of
tests/test_pallas_core.py (float32 atol = rtol = 2e-5, bfloat16 3e-2); the
3-step sequence and the pool through ``core_impl='cuda'`` on CPU tensors (the
plain version) against JAX's ``core_impl='pallas'`` and its default path in
float32 at 2e-5. On the card the CUDA kernel is held against the plain
version by tests/test_torch_cuda.py and chip_smoke.py.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import no_new_jax_cache_entries  # noqa: F401
from v2e2v_tpu.models import cista as jcista
from v2e2v_tpu.ops.pallas import core as jcore
from v2e2v_tpu.serving import StreamPool as JPool
from v2e2v_tpu_torch.models import cista as tcista
from v2e2v_tpu_torch.ops.cuda.core import (
    BIAS_KEYS,
    TAP_KEYS,
    TC_KEYS,
    cista_core,
    cista_core_plain,
    core_taps,
    launches_per_call,
)
from v2e2v_tpu_torch.ops.cuda.conv_tc import wgmma_taps
from v2e2v_tpu_torch.serving import StreamPool
from v2e2v_tpu_torch.utils.checkpoint import params_from_jax

NAMES = ("rec_h", "z", "cell", "dg_h", "dg_c")


def _jax_params(c, depth, seed=0, h=32, w=64):
    cfg = jcista.CistaConfig(image_dim=(h, w), base_channels=c, depth=depth, num_bins=5)
    return jax.tree_util.tree_map(np.asarray, jcista.init_cista_lstc(jax.random.PRNGKey(seed), cfg))


def _core_inputs(b, h, w, c, seed=1):
    rng = np.random.default_rng(seed)
    x1 = rng.standard_normal((b, h, w, c)).astype(np.float32)
    state = [0.3 * rng.standard_normal((b, h, w, k)).astype(np.float32)
             for k in (2 * c, 2 * c, c, c)]
    return [x1, *state]


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 3e-2)])
def test_plain_core_matches_pallas_kernel(dtype, tol):
    b, h, w, c, depth = 2, 16, 32, 16, 3
    params = _jax_params(c, depth)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jdt), params)
    inputs = _core_inputs(b, h, w, c)
    want = jcore.cista_core_pallas(
        jcore.core_taps(jparams, jdt), *(jnp.asarray(a).astype(jdt) for a in inputs),
        depth=depth, interpret=True,
    )
    sd = params_from_jax(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jparams),
                         depth)
    got = cista_core_plain(core_taps(sd, tdt), *(torch.from_numpy(a).to(tdt) for a in inputs),
                           depth=depth)
    assert got[0] is got[3]
    for name, g, w_ in zip(NAMES, got, want):
        assert g.dtype == tdt and tuple(g.shape) == w_.shape, name
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w_, np.float32),
                                   atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_core_taps_equal_jax_core_taps(dtype):
    c, depth = 8, 2
    params = _jax_params(c, depth, seed=3)
    want = jcore.core_taps(params, getattr(jnp, dtype))
    got = core_taps(params_from_jax(params, depth), getattr(torch, dtype))
    assert set(want) == set(TAP_KEYS) | set(BIAS_KEYS)
    assert set(got) == set(want) | (set(TC_KEYS) if dtype == "bfloat16" else set())
    for k, tk in zip(TAP_KEYS, TC_KEYS):  # the tensor-core conv's layout of the same taps
        if tk in got:
            assert torch.equal(got[tk], wgmma_taps(got[k])), tk
    for k, w_ in want.items():
        g = got[k]
        assert tuple(g.shape) == w_.shape, k
        assert g.dtype == (torch.float32 if k in BIAS_KEYS else getattr(torch, dtype)), k
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w_, np.float32), err_msg=k)


def test_sequence_through_core_matches_jax_pallas_core(monkeypatch):
    """core_impl='cuda' on CPU tensors (the plain K2) over 3 steps against JAX
    core_impl='pallas' in interpret mode, and against the port's layers path."""
    monkeypatch.setattr(jcore, "cista_core_pallas",
                        partial(jcore.cista_core_pallas, interpret=True))
    h, w, c, depth, nb = 32, 64, 16, 2, 5
    jcfg = jcista.CistaConfig(image_dim=(h, w), base_channels=c, depth=depth, num_bins=nb,
                              fullres_impl="ref", core_impl="pallas")
    params = _jax_params(c, depth, h=h, w=w)
    vox = np.random.default_rng(3).standard_normal((3, 2, h, w, nb)).astype(np.float32)
    want, want_state = jcista.cista_sequence(params, jcfg, jnp.asarray(vox))

    sd = params_from_jax(params, depth)
    cfg = tcista.CistaConfig(image_dim=(h, w), base_channels=c, depth=depth, num_bins=nb,
                             core_impl="cuda")
    got, got_state = tcista.cista_sequence(sd, cfg, torch.from_numpy(vox))
    layers, layers_state = tcista.cista_sequence(
        sd, dataclasses.replace(cfg, core_impl="layers"), torch.from_numpy(vox))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got.numpy(), layers.numpy(), atol=2e-5, rtol=2e-5)
    leaves = [want_state.cell, want_state.z, *want_state.dg]
    for g, l_, w_ in zip([got_state.cell, got_state.z, *got_state.dg],
                         [layers_state.cell, layers_state.z, *layers_state.dg], leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(g.numpy(), l_.numpy(), atol=2e-5, rtol=2e-5)


def test_pool_through_core_matches_jax_pool():
    h, w, c, depth, nb = 16, 20, 8, 2, 5
    jcfg = jcista.CistaConfig(image_dim=(h, w), base_channels=c, depth=depth, num_bins=nb,
                              fullres_impl="ref")
    params = _jax_params(c, depth, h=h, w=w)
    jpool = JPool(jcfg, params, capacity=3, dtype=jnp.float32)
    cfg = tcista.CistaConfig(image_dim=(h, w), base_channels=c, depth=depth, num_bins=nb,
                             core_impl="cuda")
    pool = StreamPool(cfg, params_from_jax(params, depth), capacity=3, dtype=torch.float32,
                      device="cpu")
    assert set(pool.params["_core_taps"]) == set(TAP_KEYS) | set(BIAS_KEYS)
    ids = [(jpool.attach(), pool.attach()) for _ in range(3)]
    rng = np.random.default_rng(5)
    for entry in ([0, 1, 2], [1], [0, 2], [0, 1, 2]):
        reqs = {i: rng.standard_normal((h, w, nb)).astype(np.float32) for i in entry}
        want = jpool.step({ids[i][0]: v for i, v in reqs.items()})
        got = pool.step({ids[i][1]: v for i, v in reqs.items()})
        for i in entry:
            np.testing.assert_allclose(got[ids[i][1]], want[ids[i][0]], atol=2e-5, rtol=2e-5)


def test_core_wrapper_on_cpu_runs_the_plain_version():
    c, depth = 8, 2
    sd = params_from_jax(_jax_params(c, depth), depth)
    inputs = [torch.from_numpy(a) for a in _core_inputs(1, 6, 10, c)]
    copies = [a.clone() for a in inputs]
    before = cista_core.launches
    got = cista_core(core_taps(sd, torch.float32), *inputs, depth=depth)
    want = cista_core_plain(core_taps(sd, torch.float32), *inputs, depth=depth)
    assert cista_core.launches == before  # only kernel launches count
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=0, atol=0)
    for a, c_ in zip(inputs, copies):
        assert torch.equal(a, c_)
    assert launches_per_call(5) == 17


def test_core_wrapper_refuses_bad_inputs():
    c = 8
    taps = core_taps(params_from_jax(_jax_params(c, 1), 1), torch.float32)
    x1, z, cell, dg_h, dg_c = (torch.from_numpy(a) for a in _core_inputs(1, 6, 10, c))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cista_core(taps, x1.double(), z, cell, dg_h, dg_c)
    with pytest.raises(ValueError, match="cell must have shape"):
        cista_core(taps, x1, z, cell[..., :c], dg_h, dg_c)
    with pytest.raises(ValueError, match="wg_x"):
        cista_core({**taps, "wg_x": taps["wg_x"][:, :4]}, x1, z, cell, dg_h, dg_c)
    with pytest.raises(ValueError, match="contiguous"):
        cista_core(taps, x1, z.transpose(1, 2).contiguous().transpose(1, 2), cell, dg_h, dg_c)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        cista_core({k: v.to("meta") for k, v in taps.items()},
                   *(a.to("meta") for a in (x1, z, cell, dg_h, dg_c)))


def test_core_impl_choices_and_refusals(monkeypatch):
    base = tcista.CistaConfig(image_dim=(8, 8), base_channels=8, depth=1)
    assert base.core_impl == "layers"
    for impl in ("layers", "cuda", "plain"):
        assert dataclasses.replace(base, core_impl=impl).core_impl == impl
    for impl in ("xla", "pallas"):
        with pytest.raises(ValueError, match="JAX package's names"):
            dataclasses.replace(base, core_impl=impl)
    with pytest.raises(ValueError, match="core_impl must be"):
        dataclasses.replace(base, core_impl="fused")
    with pytest.raises(ValueError, match="cista-tc runs with core_impl='layers'"):
        dataclasses.replace(base, model_mode="cista-tc", core_impl="cuda")

    # which core function each choice calls, on CPU tensors
    calls = []
    for name in ("cista_core", "cista_core_plain"):
        real = getattr(tcista, name)
        monkeypatch.setattr(tcista, name,
                            lambda *a, _n=name, _f=real, **k: calls.append(_n) or _f(*a, **k))
    sd = tcista.init_cista_lstc(torch.Generator().manual_seed(0), base, device="cpu")
    vox = torch.zeros(1, 1, 8, 8, 5)
    for impl, want in (("cuda", ["cista_core"]), ("plain", ["cista_core_plain"]),
                       ("layers", [])):
        calls.clear()
        tcista.cista_sequence(sd, dataclasses.replace(base, core_impl=impl), vox)
        assert calls == want, impl
