"""Port's emulator numerics (``v2e2v_tpu_torch/ops/numerics.py``) against
``v2e2v_tpu/ops/numerics.py`` on the same numpy inputs.

Tolerances and why:
- ``lin_log``: at most 2 ulp above the linear threshold, where torch's and
  XLA's float32 ``log`` differ (about 1.6% of uniform values in [0, 255]);
  exact below it.
- the low-pass and the leak current: at most 2 ulp, because XLA contracts
  their multiply-adds into fused multiply-adds, which PyTorch's eager ops do
  not.
- everything else exact.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import no_new_jax_cache_entries  # noqa: F401
from v2e2v_tpu.models import emulator as jemu
from v2e2v_tpu.ops import numerics as jnum
from v2e2v_tpu_torch.models import emulator as temu
from v2e2v_tpu_torch.ops import numerics as tnum


def _t(x):
    return torch.from_numpy(np.array(x))


def test_lin_log_within_two_ulp_and_exact_below_threshold():
    x = np.random.default_rng(0).uniform(0, 255, 200_000).astype(np.float32)
    want = np.asarray(jnum.lin_log(jnp.asarray(x)))
    got = tnum.lin_log(_t(x)).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=2)
    low = x <= jnum.LIN_LOG_THRESHOLD
    np.testing.assert_array_equal(got[low], want[low])
    assert 0.005 < np.mean(got != want) < 0.05  # the libm gap, not a formula slip


def test_lin_log_np_is_the_jax_host_version():
    x = np.random.default_rng(1).uniform(0, 255, (7, 9)).astype(np.float32)
    np.testing.assert_array_equal(tnum.lin_log_np(x), jnum.lin_log_np(x))


def test_rescale_and_lattice_are_exact():
    x = np.random.default_rng(2).uniform(0, 255, (2, 5, 6)).astype(np.float32)
    np.testing.assert_array_equal(tnum.rescale_intensity_frame(_t(x)).numpy(),
                                  np.asarray(jnum.rescale_intensity_frame(jnp.asarray(x))))
    np.testing.assert_array_equal(tnum.diversity_lattice_mask(5, 6, "cpu").numpy(),
                                  np.asarray(jnum._diversity_lattice_mask((5, 6))))


def test_div_const_rounds_as_xla_does():
    """XLA divides by a constant as a product with its float32 reciprocal."""
    x = np.random.default_rng(3).uniform(0, 1e3, 100_000).astype(np.float32)
    for s in (0.6, 275.0, 1e8, 9.0, 10.0):
        want = np.asarray(jax.jit(lambda v, s=s: v / s)(x))
        np.testing.assert_array_equal(tnum.div_const(_t(x), s).numpy(), want)


@pytest.mark.parametrize("ql,qs", [(1.0, 0.0), (1.0, 1.0), (0.0, 2.0)])
def test_low_pass_filter_step(ql, qs):
    rng = np.random.default_rng(4)
    new, lp = (rng.uniform(0, 5.5, (2, 6, 8)).astype(np.float32) for _ in range(2))
    inten = rng.uniform(0.07, 1.0, (2, 6, 8)).astype(np.float32)
    dt = np.array([0.004, 0.0004], np.float32)[:, None, None]
    want = jnum.low_pass_filter_step(*map(jnp.asarray, (new, lp, inten, dt)), 200.0, ql=ql, qs=qs)
    got = tnum.low_pass_filter_step(*map(_t, (new, lp, inten, dt)), 200.0, ql=ql, qs=qs)
    np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want), maxulp=2)
    np.testing.assert_array_equal(
        tnum.low_pass_filter_step(_t(new), _t(lp), _t(inten), _t(dt), 0.0).numpy(), new)


class _Given:
    """A noise source that hands out given numbers."""

    def __init__(self, normal):
        self.normal_values = normal
        self.asked = []

    def normal(self, what, shape, device):
        self.asked.append((what, shape))
        return _t(self.normal_values).to(device)


def test_subtract_leak_current_with_the_same_normals():
    rng = np.random.default_rng(5)
    key = jax.random.PRNGKey(0)
    shape = (2, 6, 8)
    normals = np.asarray(jax.random.normal(key, shape, jnp.float32))
    base, pos, rate = (rng.uniform(0.1, 2.0, shape).astype(np.float32) for _ in range(3))
    dt = np.array([0.004, 0.01], np.float32)[:, None, None]
    want = jnum.subtract_leak_current(key, jnp.asarray(base), 0.1, jnp.asarray(dt),
                                      jnp.asarray(pos), 0.1, jnp.asarray(rate))
    noise = _Given(normals)
    got = tnum.subtract_leak_current(noise, _t(base), 0.1, _t(dt), _t(pos), 0.1, _t(rate))
    assert noise.asked == [("leak", shape)]
    np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want), maxulp=2)


@pytest.mark.parametrize("n", [2, 5, 10, 11])
def test_per_row_times_match_jnp_linspace(n):
    rng = np.random.default_rng(n)
    start = rng.uniform(0, 100, (16, 1)).astype(np.float32)
    t = np.concatenate([start, start + rng.uniform(1e-3, 0.5, (16, 1)).astype(np.float32)], 1)
    want = np.asarray(jemu._per_row_times(jnp.asarray(t), n))
    np.testing.assert_array_equal(temu._per_row_times(_t(t), n).numpy(), want)


def test_torch_linspace_is_not_jnp_linspace():
    """The trap the port's ``_per_row_times`` avoids."""
    want = np.asarray(jemu._per_row_times(jnp.asarray([[0.1, 0.136]], jnp.float32), 10))[0]
    assert np.sum(torch.linspace(0.1, 0.136, 10).numpy() != want) > 0


# One fresh process: the port imported (it makes torch's first MKL VML call
# itself), then the port's first call of a VML function: lin_log's log
# (argv[1] == "log") or the tanh of tests/test_torch_conv.py's [tanh-1] case
# ("tanh"). No JAX: the fault does not need it.
_FIRST_VML_CALL = r"""
import json, sys
import numpy as np
import torch
from v2e2v_tpu_torch.ops import conv as tconv, numerics as tnum

if sys.argv[1] == "log":
    x = np.random.default_rng(0).uniform(0, 255, 200_000).astype(np.float32)
    first, second = (tnum.lin_log(torch.from_numpy(x)).numpy() for _ in range(2))
    print(json.dumps({"max_abs_err": float(np.abs(first - second).max())}))
else:
    rng = np.random.default_rng(1)
    xc = rng.standard_normal((2, 16, 24, 6)).astype(np.float32)
    w = (0.2 * rng.standard_normal((3, 3, 6, 8))).astype(np.float32)
    b = (0.2 * rng.standard_normal(8)).astype(np.float32)
    params = {"weight": torch.from_numpy(tconv.hwio_to_torch_conv(w).copy()),
              "bias": torch.from_numpy(b)}
    got = tconv.conv_layer(torch.from_numpy(xc), params, padding=1, activation="tanh").numpy()
    xp = np.pad(xc.astype(np.float64), ((0, 0), (1, 1), (1, 1), (0, 0)), mode="reflect")
    want = sum(np.einsum("nhwc,co->nhwo", xp[:, dy:dy + 16, dx:dx + 24], w[dy, dx])
               for dy in range(3) for dx in range(3))
    print(json.dumps({"max_abs_err": float(np.abs(got - np.tanh(want + b)).max())}))
"""


def test_first_vml_call_in_a_fresh_process_is_exact():
    """Pins the repair of the flake of this file's lin_log test and of
    test_torch_conv.py's [tanh-1] case (ROADMAP section 3): torch's CPU
    ``log`` and ``tanh`` call MKL's VML on each intra-op thread, and the
    first VML call of a process came out inexact on one or more threads'
    shares in about 1 of 10 fresh processes (log up to 1549 ulp, tanh up to
    4e-5). The port makes that first call itself when it is imported
    (``_device.make_first_cpu_vml_call``). 64 fresh processes (the fault
    would pass all of them well under 1% of the time); lin_log's first call
    must equal its second, the tanh conv lie within the parity tests' 1e-5
    of the float64 oracle."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root),
                                                       os.environ.get("PYTHONPATH", "")]))
    cases = ["log", "tanh"] * 32
    for at in range(0, len(cases), 8):  # 8 processes at a time
        batch = cases[at:at + 8]
        procs = [subprocess.Popen([sys.executable, "-c", _FIRST_VML_CALL, case], env=env,
                                  cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for case in batch]
        for case, proc in zip(batch, procs):
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-2000:]
            got = json.loads(out.strip().splitlines()[-1])["max_abs_err"]
            assert got <= (0.0 if case == "log" else 1e-5), (case, got)
