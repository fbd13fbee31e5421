"""Shared pieces of the port's parity tests (``tests/test_torch_*.py``)."""

import contextlib
import functools

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


@contextlib.contextmanager
def torch_threads(n: int):
    """torch's intra-op thread count set to ``n`` for the block."""
    import torch

    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run this module's torch CPU work on one intra-op thread, then restore
    the count.

    The suite runs in several worker processes at once; with torch's default
    of one thread per core in each, the many small ops of a training step at
    test size wait on descheduled threads (measured: the CLI training tests
    took 470 s beside five other workers against 17 s alone). One thread
    gives the same results within each test's tolerance.
    """
    import torch

    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


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


# Super-SloMo: the JAX package's random UNet weights, a checkpoint of them
# with the flow scaled, and the adaptive count's margin

@functools.lru_cache(maxsize=None)
def _jax_init():
    import numpy as np
    from v2e2v_tpu.models.superslomo import init_unet

    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    return (jax.tree_util.tree_map(np.asarray, init_unet(k1, 6, 4)),
            jax.tree_util.tree_map(np.asarray, init_unet(k2, 20, 5)))


def jax_unet_params(scale: float = 1.0):
    """The JAX Upsampler's random weights (``PRNGKey(0)``), numpy, with the
    flow net's output conv scaled by ``scale``. With its random weights the
    flow net's largest flow is below 0.1 pixel, so ``ceil(max |flow|) = 1``
    and the interpolation net never runs; the flow net ends in a leaky ReLU,
    so scaling its output conv by ``s`` scales every flow by ``s``."""
    import numpy as np

    flow, intrp = _jax_init()
    flow = dict(flow)
    flow["conv3"] = {k: (v * np.float32(scale)).astype(np.float32)
                     for k, v in flow["conv3"].items()}
    return flow, intrp


def write_ckpt(path, scale: float):
    """A ``SuperSloMo.ckpt`` of ``jax_unet_params(scale)``."""
    import torch

    from v2e2v_tpu_torch.utils.checkpoint import unet_state_dict_from_jax

    flow, intrp = jax_unet_params(scale)
    torch.save({"state_dictFC": unet_state_dict_from_jax(flow),
                "state_dictAT": unet_state_dict_from_jax(intrp)}, path)
    return path


def pair_magnitudes(up, frames) -> list[float]:
    """Each pair's ``max |flow|`` through the flow net of the port's
    ``Upsampler`` ``up``, on the CPU."""
    import torch

    from v2e2v_tpu_torch.models.superslomo import flow_pair

    net = [up.crop.pad(torch.from_numpy(up._to_net(f))[None]) for f in frames]
    mags = []
    with torch.no_grad():
        for a, b in zip(net[:-1], net[1:]):
            f01, f10 = flow_pair(up.flow_net, a, b)
            mags.append(max(float(f.square().sum(-1).sqrt().max()) for f in (f01, f10)))
    return mags


def assert_off_integers(mags, lo: int, hi: int):
    """Each count in [lo, hi], each magnitude 0.1 or more from an integer
    (where the two packages' float32 roundings cannot put their counts one
    apart). Returns the counts."""
    import numpy as np

    counts = [int(np.ceil(m)) for m in mags]
    assert all(lo <= c <= hi for c in counts), f"counts {counts} outside [{lo}, {hi}]"
    gaps = [abs(m - round(m)) for m in mags]
    assert min(gaps) >= 0.1, (
        f"a flow magnitude lies within 0.1 of an integer ({mags}): the two packages' "
        "counts could differ by one there; pick another flow scale")
    return counts


# Runs over a process group of one (the lifted refusals of the CLI tests)

def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_flags(case: str, trace_dir) -> tuple[list[str], dict[str, str]]:
    """``(argv, environment)`` of a run flag case: ``profile`` (a trace into
    ``trace_dir``), or a world of one over ``gloo`` from the ``--dist_*``
    flags (``dist-flags``), the ``V2E2V_*`` variables (``dist-env``) or
    torchrun's variables (``dist-auto``)."""
    port = str(free_port())
    return {
        "profile": (["--profile_dir", str(trace_dir)], {}),
        "dist-flags": (["--dist_coordinator", f"localhost:{port}", "--dist_num_processes", "1",
                        "--dist_process_id", "0"], {}),
        "dist-env": ([], {"V2E2V_COORDINATOR": f"localhost:{port}", "V2E2V_NUM_PROCESSES": "1",
                          "V2E2V_PROCESS_ID": "0"}),
        "dist-auto": ([], {"V2E2V_DIST_AUTO": "1", "MASTER_ADDR": "localhost",
                           "MASTER_PORT": port, "RANK": "0", "WORLD_SIZE": "1"}),
    }[case]
