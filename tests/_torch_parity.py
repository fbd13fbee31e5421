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
