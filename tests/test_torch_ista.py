"""Port's ISTA loop (kernel K1's plain version and CPU dispatch) against the
Pallas kernel in interpret mode, at the JAX test's own tolerance (atol 2e-5,
float32) and at the bfloat16 tolerance of tests/test_pallas_core.py (3e-2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import no_new_jax_cache_entries  # noqa: F401
from v2e2v_tpu.ops.pallas.ista import ista_loop_pallas
from v2e2v_tpu_torch.ops.cuda.ista import ista_loop, ista_loop_plain


def _setup(b=2, h=16, w=24, c=8, seed=0):
    rng = np.random.default_rng(seed)

    def n(scale, *shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return (n(0.5, b, h, w, c), n(0.5, b, h, w, 2 * c), n(0.05, 3, 3, 2 * c, c), n(0.05, c),
            n(0.05, 3, 3, c, 2 * c), n(0.05, 2 * c),
            (0.01 * rng.uniform(size=2 * c)).astype(np.float32))


def _pallas(args, depth, dtype=jnp.float32):
    x1, z, *rest = (jnp.asarray(a) for a in args)
    return np.asarray(ista_loop_pallas(x1.astype(dtype), z.astype(dtype), *rest, depth=depth,
                                       interpret=True).astype(jnp.float32))


def _torch(args, depth, fn=ista_loop_plain, dtype=torch.float32):
    x1, z, *rest = (torch.from_numpy(a) for a in args)
    return fn(x1.to(dtype), z.to(dtype), *rest, depth=depth).float().numpy()


@pytest.mark.parametrize("depth", [1, 3, 5])
def test_plain_ista_matches_pallas_interpret(depth):
    args = _setup()
    np.testing.assert_allclose(_torch(args, depth), _pallas(args, depth), atol=2e-5)


def test_plain_ista_nonsquare_and_batched():
    args = _setup(b=3, h=24, w=16, seed=1)
    np.testing.assert_allclose(_torch(args, 2), _pallas(args, 2), atol=2e-5)


def test_plain_ista_bf16_keeps_the_kernel_cast_points():
    args = _setup(seed=2)
    np.testing.assert_allclose(_torch(args, 3, dtype=torch.bfloat16),
                               _pallas(args, 3, dtype=jnp.bfloat16), atol=3e-2, rtol=3e-2)


def test_wrapper_takes_plain_path_on_cpu_and_counts_nothing():
    args = _setup(seed=3)
    before = ista_loop.launches
    got = _torch(args, 2, fn=ista_loop)
    assert ista_loop.launches == before
    np.testing.assert_array_equal(got, _torch(args, 2))


def _tensors(**over):
    args = dict(zip(["x1", "z", "d_weight", "d_bias", "p_weight", "p_bias", "lam"],
                    (torch.from_numpy(a) for a in _setup(b=1, h=6, w=5, c=8))))
    args.update(over)
    return args


@pytest.mark.parametrize("over,exc,match", [
    (dict(z=torch.zeros(1, 6, 5, 8)), ValueError, "z must have shape"),
    (dict(d_weight=torch.zeros(3, 3, 8, 8)), ValueError, "d_weight must have shape"),
    (dict(lam=torch.zeros(8)), ValueError, "lam must have shape"),
    (dict(x1=torch.zeros(6, 5, 8)), ValueError, r"x1 must be \[B, H, W, C\]"),
    (dict(x1=torch.zeros(1, 1, 5, 8), z=torch.zeros(1, 1, 5, 16)), ValueError, "H >= 2"),
    (dict(x1=torch.zeros(1, 6, 5, 8, dtype=torch.float64),
          z=torch.zeros(1, 6, 5, 16, dtype=torch.float64)), TypeError, "float32 or bfloat16"),
    (dict(z=torch.zeros(1, 6, 5, 16, dtype=torch.bfloat16)), TypeError, "one dtype"),
    (dict(x1=torch.zeros(1, 5, 6, 8).transpose(1, 2)), ValueError, "contiguous"),
])
def test_wrapper_rejects_bad_inputs(over, exc, match):
    with pytest.raises(exc, match=match):
        ista_loop(**_tensors(**over), depth=1)


def test_wrapper_rejects_other_devices():
    args = _tensors()
    args = {k: v.to("meta") for k, v in args.items()}
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        ista_loop(**args, depth=1)
