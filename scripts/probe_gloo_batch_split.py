#!/usr/bin/env python3
"""Where the gradients of two gloo ranks on one card part from one process's
whole-batch step: ``chip_smoke.py`` phase 18b's steps under two cuDNN modes.

    python3 scripts/probe_gloo_batch_split.py [--seed 0] [--out readings.json]

For each mode, cuDNN as the port runs it and cuDNN deterministic with
``benchmark`` off (TF32 off in both), runs ``chip_smoke.gloo_steps`` twice in
this process (a V2E2V step at 180x240, C = 64, depth 5, 10 packs, global
B = 8, and an E2V device-data step whose padding lies on rank 1), then in two
ranks over gloo on the card, and prints per step, each as the largest of
every gradient's max |diff| over its largest entry:

- ``spread``: one process against itself, the same call repeated, and a
  second call's whole-batch step and each of its 4-row shares;
- ``split``: this process's two 4-row steps combined (mean, or sum for the
  weighted loss) against its 8-row step, no process group anywhere;
- ``local``: each rank's gradient before the reduction against this
  process's step on the same 4 rows; ``reduce_exact``: the reduced gradient
  equal to the ranks' combination; ``reduced``: against this process's
  8-row step and against its combined 4-row steps;
- ``faults``: the planted faults of ``gloo_steps`` against the 8-row step;

and the events, losses and ms per step. Prints the card's name and power
limit first. Needs a CUDA card; the ranks run this script with ``--rank``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

MODES = ("as run", "deterministic")


def set_mode(mode: str) -> None:
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    deterministic = mode == "deterministic"
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic, False


def err(got: dict, want: dict) -> list:
    """The largest of each gradient's max |diff| / max |g|, and its tensor."""
    return list(max((float((got[k] - g).abs().max()) / float(g.abs().max()), k)
                    for k, g in want.items()))


def rank_main(args) -> None:
    from v2e2v_tpu_torch.parallel import distributed
    from v2e2v_tpu_torch.parallel.mesh import make_mesh

    set_mode(args.mode)
    distributed.initialize_from_flags(argparse.Namespace(
        dist_coordinator=f"localhost:{args.port}", dist_num_processes=2,
        dist_process_id=args.rank), backend="gloo")
    try:
        torch.save(cs.gloo_steps(args.seed, make_mesh(2)), args.dir / f"rank{args.rank}.pt")
    finally:
        distributed.shutdown()


def readings(name: str, single: dict, again: dict, ranks: list) -> dict:
    s, a = single[name], again[name]
    combine = (lambda x, y: (x + y) / 2) if name == "v2e2v" else (lambda x, y: x + y)
    halves = {k: combine(s["shares"][0][k], s["shares"][1][k]) for k in s["grads"]}
    local = [r[name]["local"] for r in ranks]
    mine = {k: combine(local[0][k], local[1][k]) for k in halves}
    return {
        "spread": {"repeated": err(s["grads_again"], s["grads"]),
                   "second call": err(a["grads"], s["grads"]),
                   "second call's shares": [err(a["shares"][i], s["shares"][i])
                                            for i in range(2)]},
        "split": err(halves, s["grads"]),
        "local": [err(local[i], s["shares"][i]) for i in range(2)],
        "reduce_exact": [all(torch.equal(r[name]["grads"][k], mine[k]) for k in mine)
                         for r in ranks],
        "reduced": {"against the 8-row step": [err(r[name]["grads"], s["grads"])
                                               for r in ranks],
                    "against the 4-row steps": [err(r[name]["grads"], halves) for r in ranks]},
        "faults": {f: err(g, s["grads"]) for f, g in s["faults"].items()},
        "events": [s["events"]] + [r[name]["events"] for r in ranks],
        "loss": [s["loss"]] + [r[name]["loss"] for r in ranks],
        "ms": [s["ms"]] + [r[name]["ms"] for r in ranks],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None, help="also write the readings here")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mode", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dir", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    if args.rank is not None:
        rank_main(args)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        for mode in MODES:
            t0 = time.perf_counter()
            set_mode(mode)
            single, again = cs.gloo_steps(args.seed, None), cs.gloo_steps(args.seed, None)
            set_mode(MODES[0])
            port = cs.free_port()
            procs = [subprocess.Popen([sys.executable, __file__, "--seed", str(args.seed),
                                       "--rank", str(r), "--port", str(port), "--mode", mode,
                                       "--dir", tmp], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True) for r in range(2)]
            outs = [p.communicate(timeout=600)[0] for p in procs]
            if any(p.returncode for p in procs):
                sys.exit("a rank failed:\n" + "\n".join(o[-4000:] for o in outs))
            ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(2)]
            for name in ("v2e2v", "device_data"):
                report[f"{mode}, {name}"] = readings(name, single, again, ranks)
                print(f"{mode}, {name}: {json.dumps(report[f'{mode}, {name}'])}", flush=True)
            print(f"{mode}: {time.perf_counter() - t0:.1f} s", flush=True)
    if args.out is not None:
        args.out.write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
