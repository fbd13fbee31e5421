"""Probe the CPU fault of ROADMAP section 3: torch's first MKL VML call in a
fresh process, with and without JAX, and after the port's own first call.

Each case runs in its own fresh process, ``--runs`` times, ``--jobs`` at a
time, and reports in how many processes the first call of a torch op
differed from its second call on the same input, which contiguous block of
the output (one intra-op thread's share) it was, and how far the first call
lay from the float64 value:

- ``xla``: XLA computes ``log`` on the CPU, then torch's ``log`` (MKL VML);
- ``xla_tanh``: the same with ``tanh`` (the activation of
  ``tests/test_torch_conv.py``'s [tanh-1] case);
- ``idle_jax``: JAX imported but not computing, then torch's ``log``;
- ``torch_only``: no JAX in the process, torch's ``log``;
- ``xla_nonvml_first``: after XLA, torch's ``+`` and ``*`` (not VML) on every
  thread first, then ``log``;
- ``xla_vml_first``: after XLA, torch's ``exp`` (VML) first, then ``log``;
- ``port``: no JAX; ``import v2e2v_tpu_torch`` (which makes the first VML
  call, ``_device.make_first_cpu_vml_call``), then torch's ``log``.

Run from the repo root: ``python scripts/probe_first_vml_call.py --runs 64``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CASES = ("xla", "xla_tanh", "idle_jax", "torch_only", "xla_nonvml_first", "xla_vml_first",
         "port")

_ONE = r"""
import json, os, sys
case = sys.argv[1]
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8 --xla_backend_optimization_level=0"
    + " --xla_llvm_disable_expensive_passes=true")
if case == "port":
    import v2e2v_tpu_torch  # noqa: F401
elif case != "torch_only":
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
import numpy as np
import torch

x = np.random.default_rng(0).uniform(0, 255, 200_000).astype(np.float32)
if case.startswith("xla"):
    np.asarray(jnp.log(jnp.asarray(x)))
xt = torch.from_numpy(x)
if case == "xla_nonvml_first":
    (xt + 1.0) * 0.5
if case == "xla_vml_first":
    torch.exp(xt * 0.01)
op, ref = (torch.tanh, np.tanh) if case == "xla_tanh" else (torch.log, np.log)
if case == "xla_tanh":
    xt = xt * 0.01 - 1.0
first, second = op(xt).numpy(), op(xt).numpy()
bad = np.flatnonzero(first != second)
exact = ref(xt.numpy().astype(np.float64))
ulp = np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
print(json.dumps({
    "bad": int(bad.size),
    "block": [int(bad.min()), int(bad.max())] if bad.size else None,
    "threads": torch.get_num_threads(),
    "first_ulp": float((np.abs(first - exact) / ulp).max()),
    "second_ulp": float((np.abs(second - exact) / ulp).max()),
    "first_abs": float(np.abs(first - exact).max()),
}))
"""


def run_one(case: str) -> dict:
    out = subprocess.run([sys.executable, "-c", _ONE, case], capture_output=True, text=True,
                         check=True, timeout=300, cwd=ROOT)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=64, help="fresh processes per case")
    ap.add_argument("--jobs", type=int, default=8, help="processes at a time")
    ap.add_argument("--cases", nargs="+", default=list(CASES), choices=CASES)
    args = ap.parse_args()
    jobs = [case for case in args.cases for _ in range(args.runs)]
    with ThreadPoolExecutor(args.jobs) as pool:
        results = list(pool.map(run_one, jobs))
    for case in args.cases:
        rs = [r for c, r in zip(jobs, results) if c == case]
        bad = [r for r in rs if r["bad"]]
        print(json.dumps({
            "case": case, "processes": len(rs), "first_call_differs": len(bad),
            "blocks": [r["block"] for r in bad],
            "max_first_ulp": max(r["first_ulp"] for r in rs),
            "max_first_abs": max(r["first_abs"] for r in rs),
            "max_second_ulp": max(r["second_ulp"] for r in rs),
            "threads": rs[0]["threads"],
        }))


if __name__ == "__main__":
    main()
