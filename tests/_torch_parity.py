"""Shared pieces of the port's parity tests (``tests/test_torch_*.py``)."""

import jax
import pytest


@pytest.fixture(scope="module", autouse=True)
def no_new_jax_cache_entries():
    """Keep this module's JAX compiles out of the persistent compile cache.

    Parity tests compile fresh small programs; with the suite's 1 s threshold
    (tests/conftest.py) each would add a file to ``.jax_cache/``. A threshold
    no compile reaches stops the writes; the old value comes back after the
    module.
    """
    old = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)
    yield
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old)


INIT_DRAWS = ("pos_large", "pos_small", "neg_large", "neg_small", "leak_rate")


class JaxKeyNoise:
    """A noise source for the port's emulator that replays the JAX emulator's
    own key chain, so that both see the same numbers.

    At initialisation JAX splits its key in six (``emulator.py:132``): the
    four threshold draws, the leak-rate draw and the key carried on. Per
    frame pair it splits once for the leak normal (``:444``) and once for the
    shot uniforms (``:487``). Use one instance per sequence, as JAX uses one
    key per sequence.
    """

    explicit_shot = True  # JAX's CPU path draws the shot uniforms

    def __init__(self, key):
        self.key = key
        self.init_keys = None

    def normal(self, what, shape, device):
        import jax.numpy as jnp

        if what in INIT_DRAWS:
            if self.init_keys is None:
                self.init_keys = jax.random.split(self.key, 6)
                self.key = self.init_keys[5]
            k = self.init_keys[INIT_DRAWS.index(what)]
        else:
            self.key, k = jax.random.split(self.key)
        return _to_torch(jax.random.normal(k, shape, jnp.float32), device)

    def uniform(self, what, shape, device):
        self.key, k = jax.random.split(self.key)
        return _to_torch(jax.random.uniform(k, shape), device)

    def seeds(self, what, n, device):
        raise AssertionError("the JAX emulator draws no seeds on the CPU")


def _to_torch(x, device):
    import numpy as np
    import torch

    return torch.from_numpy(np.array(x)).to(device)
