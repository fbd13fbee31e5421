"""The port's multi-device ``StreamPool`` (``mesh=make_mesh(4, devices=["cpu"]
* 4)``, one slot a device) against the JAX pool on ``make_mesh(4, 1)`` over
the suite's virtual CPU devices (tests/test_serving.py's sharded pool), at
16x20, C = 8, depth 2, float32: the outputs within 1e-5 over three steps,
then detach and attach; the port's unsharded pool gives the same numbers;
a capacity of 6 raises "divisible"; an int8 pool over two devices
calibrates and steps as the unsharded one does (within 1e-5); ``fetch=False`` hands out
views on each slot's device."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import no_new_jax_cache_entries, one_torch_thread  # noqa: F401
from v2e2v_tpu.models.cista import CistaConfig as JCfg, init_cista_lstc as jinit
from v2e2v_tpu.parallel.mesh import make_mesh as jmake_mesh
from v2e2v_tpu.serving import StreamPool as JPool
from v2e2v_tpu_torch.models.cista import CistaConfig
from v2e2v_tpu_torch.parallel.mesh import Mesh, make_mesh
from v2e2v_tpu_torch.serving import StreamPool
from v2e2v_tpu_torch.utils.checkpoint import params_from_jax

H, W, NB, C, DEPTH = 16, 20, 5, 8, 2


def _weights():
    jcfg = JCfg(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB)
    params = jinit(jax.random.PRNGKey(0), jcfg)
    return jcfg, params, params_from_jax(jax.tree_util.tree_map(np.asarray, params), DEPTH)


def _vox(seed):
    return np.random.default_rng(seed).normal(size=(H, W, NB)).astype(np.float32)


def test_mesh_pool_matches_jax_mesh_pool():
    jcfg, params, sd = _weights()
    cfg = CistaConfig(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB)
    jpool = JPool(jcfg, params, capacity=4, dtype=jnp.float32,
                  mesh=jmake_mesh(4, 1, devices=jax.devices("cpu")[:4]))
    pool = StreamPool(cfg, sd, capacity=4, dtype=torch.float32,
                      mesh=make_mesh(4, devices=["cpu"] * 4))
    one = StreamPool(cfg, sd, capacity=4, dtype=torch.float32, device="cpu")
    pools = (jpool, pool, one)
    sids = [[p.attach() for _ in range(4)] for p in pools]
    worst = 0.0
    for i in range(3):
        outs = [p.step({s: _vox(10 * i + j) for j, s in enumerate(ps)})
                for p, ps in zip(pools, sids)]
        for j in range(4):
            want = outs[0][sids[0][j]]
            worst = max(worst, float(np.abs(outs[1][sids[1][j]] - want).max()))
            np.testing.assert_allclose(outs[1][sids[1][j]], want, atol=1e-5)
            np.testing.assert_allclose(outs[1][sids[1][j]], outs[2][sids[2][j]], atol=1e-5)
    print(f"largest difference from the JAX mesh pool: {worst:.3g}")
    # detach and attach on the sharded state: the freed slot starts from zero
    for p, ps in zip(pools, sids):
        p.detach(ps[2])
        ps[2] = p.attach()
    outs = [p.step({ps[2]: _vox(99), ps[3]: _vox(98)}) for p, ps in zip(pools, sids)]
    for k in (2, 3):
        np.testing.assert_allclose(outs[1][sids[1][k]], outs[0][sids[0][k]], atol=1e-5)
    assert pool._states.z.shape[0] == 4 and pool._prev.shape == (4, H, W, 1)


def test_mesh_pool_capacity_must_divide_and_mesh_must_be_one_process():
    _, _, sd = _weights()
    cfg = CistaConfig(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB)
    with pytest.raises(ValueError, match="divisible"):
        StreamPool(cfg, sd, capacity=6, mesh=make_mesh(4, devices=["cpu"] * 4))
    group_mesh = Mesh((torch.device("cpu"),) * 2, group=object(), rank=0)
    with pytest.raises(ValueError, match="one process"):
        StreamPool(cfg, sd, capacity=4, mesh=group_mesh)


def test_int8_mesh_pool_calibrates_and_steps_as_one_device():
    _, _, sd = _weights()
    cfg = CistaConfig(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB,
                      quant="int8")
    pools = [StreamPool(cfg, sd, capacity=2, dtype=torch.float32, device="cpu"),
             StreamPool(cfg, sd, capacity=2, dtype=torch.float32,
                        mesh=make_mesh(2, devices=["cpu"] * 2))]
    calib = np.stack([np.stack([_vox(50 + 2 * t), _vox(51 + 2 * t)]) for t in range(3)])
    assert [p.calibrate(calib, drift_budget=1.0) for p in pools] == [True, True]
    # every device group steps with the static scales
    def scales(qp):
        return [float(v["s_x"]) for v in qp.values() if isinstance(v, dict) and "s_x" in v]

    assert scales(pools[1]._params[1]["_quant"]) == scales(pools[0].params["_quant"]) != []
    sids = [[p.attach(), p.attach()] for p in pools]
    for i in range(2):
        outs = [p.step({s: _vox(60 + 2 * i + j) for j, s in enumerate(ps)})
                for p, ps in zip(pools, sids)]
        for j in range(2):
            np.testing.assert_allclose(outs[1][sids[1][j]], outs[0][sids[0][j]], atol=1e-5)


def test_mesh_pool_fetch_false_views():
    _, _, sd = _weights()
    cfg = CistaConfig(image_dim=(H, W), base_channels=C, depth=DEPTH, num_bins=NB)
    pool = StreamPool(cfg, sd, capacity=2, dtype=torch.float32,
                      mesh=make_mesh(2, devices=["cpu"] * 2))
    a, b = pool.attach(), pool.attach()
    views = pool.step({a: _vox(1), b: _vox(2)}, fetch=False)
    assert all(isinstance(v, torch.Tensor) and v.shape == (H, W) for v in views.values())
    fetched = pool.step({b: _vox(3)})
    assert torch.equal(pool._prev[0, ..., 0], views[a])  # a idled: its image kept
    assert not np.array_equal(fetched[b], views[b].numpy())
