"""Port's StreamPool against the JAX StreamPool (reference-shaped full-res
path, and the fused one in bfloat16) on one attach/step/detach sequence:
float32 at atol 1e-4, bfloat16 at atol = rtol = 3e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import no_new_jax_cache_entries  # noqa: F401
from v2e2v_tpu.models.cista import CistaConfig as JCfg, init_cista_lstc as jinit
from v2e2v_tpu.serving import StreamPool as JPool
from v2e2v_tpu_torch.models.cista import CistaConfig
from v2e2v_tpu_torch.parallel.mesh import make_mesh
from v2e2v_tpu_torch.serving import StreamPool
from v2e2v_tpu_torch.utils.checkpoint import params_from_jax

H, W, NB, C, DEPTH = 16, 20, 5, 8, 2


def _pools(capacity=3, dtype="float32", fullres_impl="ref"):
    jcfg = JCfg(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB,
                fullres_impl=fullres_impl)
    params = jinit(jax.random.PRNGKey(0), jcfg)
    jpool = JPool(jcfg, params, capacity=capacity, dtype=getattr(jnp, dtype))
    cfg = CistaConfig(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB,
                      fullres_impl=fullres_impl)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, params), DEPTH)
    return jpool, StreamPool(cfg, sd, capacity=capacity, dtype=getattr(torch, dtype),
                             device="cpu")


def _vox(seed):
    return np.random.default_rng(seed).normal(size=(H, W, NB)).astype(np.float32)


def _run_schedule(jpool, pool, tol):
    ids = [(jpool.attach(), pool.attach()) for _ in range(3)]
    schedule = [[0, 1, 2], [1], [0, 2], "detach 1", "attach", [0, 1, 2], [2]]
    seed = 0
    for entry in schedule:
        if entry == "detach 1":
            jpool.detach(ids[1][0])
            pool.detach(ids[1][1])
            continue
        if entry == "attach":  # takes the freed slot, which must start from zero
            ids[1] = (jpool.attach(), pool.attach())
            continue
        reqs = {i: _vox(seed + i) for i in entry}
        seed += 10
        want = jpool.step({ids[i][0]: v for i, v in reqs.items()})
        got = pool.step({ids[i][1]: v for i, v in reqs.items()})
        for i in entry:
            g, w = got[ids[i][1]], want[ids[i][0]]
            assert g.shape == (H, W) and g.dtype == np.float32
            np.testing.assert_allclose(g, w, **tol)


def test_pool_sequence_matches_jax_pool():
    _run_schedule(*_pools(), dict(atol=1e-4))


def test_pool_sequence_matches_jax_pool_bfloat16():
    """bfloat16 pools, each framework rounding its own convs and elementwise
    ops to bfloat16, on the same float32 weights and voxel grids."""
    _run_schedule(*_pools(dtype="bfloat16"), dict(atol=3e-2, rtol=3e-2))


def test_fused_pool_matches_jax_fused_pool_bfloat16():
    """The same on the fused full-resolution path (``fullres_impl="fused"``,
    the JAX package's default): each pool makes its fused kernels once, in
    bfloat16."""
    _run_schedule(*_pools(dtype="bfloat16", fullres_impl="fused"), dict(atol=3e-2, rtol=3e-2))


def test_pool_fetch_false_returns_device_views():
    _, pool = _pools(capacity=2)
    sid = pool.attach()
    out = pool.step({sid: torch.from_numpy(_vox(1))}, fetch=False)[sid]
    assert isinstance(out, torch.Tensor) and tuple(out.shape) == (H, W)
    # a new stream's slot reset leaves the handed-out image alone
    before = out.clone()
    pool.detach(sid)
    pool.attach()
    torch.testing.assert_close(out, before, rtol=0, atol=0)


def test_pool_refuses_what_is_not_ported_and_overflow():
    cfg = CistaConfig(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB)
    with pytest.raises(ValueError, match="divisible"):
        StreamPool(cfg, {}, capacity=6, mesh=make_mesh(4, devices=["cpu"] * 4))
    _, pool = _pools(capacity=1)
    with pytest.raises(ValueError, match="requires cfg.quant == 'int8'"):
        pool.calibrate(None)
    pool.attach()
    with pytest.raises(RuntimeError, match="pool full"):
        pool.attach()
