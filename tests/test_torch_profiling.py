"""The port's tracing and NaN debugging (``v2e2v_tpu_torch/utils/profiling.py``
and the checks of ``training/steps.py``) on the CPU, at 32x40, C = 8,
depth 2, T = 3, B = 2.

``maybe_profile`` writes one ``rank0.*.pt.trace.json`` when its region exits,
on an exception too, and nothing without a directory. Under
``enable_nan_debugging`` a train step raises ``FloatingPointError`` at the
first NaN in its loss (before the backward), in a gradient (one made NaN by
a hook, after the backward) or in an updated weight (a NaN learning rate);
an infinity is not a NaN; with the mode off a NaN loss comes back as it is.
Both trainers' ``--profile_dir`` and ``--debug_nans`` are in
tests/test_torch_cli_train.py::test_lifted_flags_are_honoured.
"""

import json

import numpy as np
import pytest
import torch

from _torch_parity import no_new_jax_cache_entries, one_torch_thread  # noqa: F401
from test_torch_train_step import H, NB, T, W, _weights
from v2e2v_tpu_torch.training import steps
from v2e2v_tpu_torch.utils import profiling


def test_maybe_profile_writes_one_trace_per_region(tmp_path):
    with profiling.maybe_profile(None):
        torch.ones(4).sum()
    with profiling.maybe_profile(""):
        torch.ones(4).sum()
    assert not list(tmp_path.iterdir())
    with profiling.maybe_profile(str(tmp_path / "a")):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    (trace,) = (tmp_path / "a").glob("rank0.*.pt.trace.json")
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert "aten::matmul" in names
    with pytest.raises(ZeroDivisionError):
        with profiling.maybe_profile(str(tmp_path / "b")):
            torch.ones(4).sum()
            1 / 0
    assert len(list((tmp_path / "b").glob("rank0.*.pt.trace.json"))) == 1


@pytest.fixture
def nan_debugging():
    profiling.enable_nan_debugging()
    assert profiling.nan_debugging()
    yield
    profiling.enable_nan_debugging(False)
    assert not profiling.nan_debugging()


def _step(lr=1e-4):
    _, _, tcfg, sd = _weights("cista-lstc")
    rng = np.random.default_rng(4)
    seq = torch.from_numpy(rng.normal(size=(T, 2, H, W, NB)).astype(np.float32))
    gt = torch.from_numpy(rng.uniform(size=(2, H, W, 1)).astype(np.float32))
    opt = steps.make_adam(sd, tcfg, 1e-4)
    steps.set_lr(opt, lr)  # Adam refuses a NaN at construction
    return sd, steps.make_e2v_train_step(tcfg, opt), seq, gt


def test_a_nan_in_the_loss_raises_before_the_backward(nan_debugging):
    sd, step, seq, gt = _step()
    seq[-1, 1, 3, 4, 0] = float("nan")
    before = sd["We.conv2d.weight"].detach().clone()
    with pytest.raises(FloatingPointError, match="NaN in the loss"):
        step(sd, seq, gt)
    assert sd["We.conv2d.weight"].grad is None and torch.equal(sd["We.conv2d.weight"], before)


def test_a_nan_gradient_raises_before_the_update(nan_debugging):
    sd, step, seq, gt = _step()
    sd["final_conv.conv2d.bias"].register_hook(lambda g: g * float("nan"))
    before = sd["final_conv.conv2d.bias"].detach().clone()
    with pytest.raises(FloatingPointError, match="NaN in a gradient"):
        step(sd, seq, gt)
    assert torch.equal(sd["final_conv.conv2d.bias"], before)


def test_a_nan_weight_after_the_update_raises(nan_debugging):
    sd, step, seq, gt = _step(lr=float("nan"))
    with pytest.raises(FloatingPointError, match="NaN in an updated weight"):
        step(sd, seq, gt)


def test_infinities_pass_and_the_mode_off_checks_nothing(nan_debugging):
    steps._raise_on_nan("a test", [torch.tensor([float("inf"), -float("inf"), 1.0])])
    profiling.enable_nan_debugging(False)
    sd, step, seq, gt = _step()
    seq[-1, 1, 3, 4, 0] = float("nan")
    assert torch.isnan(step(sd, seq, gt))
