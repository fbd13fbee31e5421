"""One rank of the port's CPU runs over ``gloo`` for
tests/test_torch_distributed.py (started as a script, one process per rank;
it imports torch and the port only).

    python tests/_torch_dist_worker.py steps <rank> <world> <port> <dir>
    python tests/_torch_dist_worker.py train_e2v <rank> <world> <port> <dir> [CLI flags]
    python tests/_torch_dist_worker.py train <rank> <world> <port> <dir> [CLI flags]

``steps`` runs the port's train steps on a data axis of ``world`` ranks, on
the weights and global batches the test wrote to ``<dir>/inputs.pt``, each
rank handing the per-batch steps its rows (``Mesh.rows``), as the trainers
do, and writes each step's loss, gradients and stats to
``<dir>/out<rank>.pt``. ``train_e2v`` and ``train`` run ``cli.train_e2v`` or
``cli.train`` with the ``--dist_*`` flags.
"""

import argparse
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


class ReplayNoise:
    """Hands out recorded draws in order, checking each shape."""

    explicit_shot = True

    def __init__(self, draws):
        self.draws = list(draws)

    def _next(self, what, shape):
        name, value = self.draws.pop(0)
        if name != what or tuple(value.shape) != tuple(shape):
            raise AssertionError(f"asked for {what} {tuple(shape)}, recorded {name} "
                                 f"{tuple(value.shape)}")
        return value

    def normal(self, what, shape, device):
        return self._next(what, shape).to(device)

    def uniform(self, what, shape, device):
        return self._next(what, shape).to(device)

    def seeds(self, what, n, device):
        return self._next(what, (n,)).to(device)


def run_steps(mesh, workdir, rank):
    from v2e2v_tpu_torch.models.cista import tie_weights
    from v2e2v_tpu_torch.training import steps
    from v2e2v_tpu_torch.utils.checkpoint import STEP_KEYS

    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    cfg, vcfg = inp["cfg"], inp["v2e2v_cfg"]
    out = {}

    def fresh(c):
        sd = tie_weights({k: v.clone() for k, v in inp["weights"].items()}, c)
        return sd, steps.make_adam(sd, c, 1e-4)

    def grads(sd):
        return {k: sd[k].grad.clone() for k in STEP_KEYS[cfg.model_mode]}

    rows = mesh.rows
    sd, opt = fresh(cfg)
    loss = steps.make_e2v_train_step(cfg, opt, mesh=mesh)(sd, rows(inp["seq"], 1),
                                                          rows(inp["gt"], 0))
    out["e2v"] = {"loss": loss, "grads": grads(sd)}

    for name, noise_std in (("device_data", 0.0), ("device_data_noise", 0.1)):
        sd, opt = fresh(cfg)
        step = steps.make_e2v_train_step_device_data(cfg, opt, noise_std=noise_std, mesh=mesh)
        gen = torch.Generator().manual_seed(inp["noise_seed"])
        loss = step(sd, inp["data"], inp["gt_all"], inp["idx"], gen, inp["w"])
        out[name] = {"loss": loss, "grads": grads(sd)}

    sd, opt = fresh(vcfg.cista)
    loss, stats = steps.make_v2e2v_train_step(vcfg, opt, mesh=mesh)(
        sd, rows(inp["frames"], 1), rows(inp["ts"], 1), rows(inp["vgt"], 0),
        ReplayNoise(inp["draws"]))
    out["v2e2v"] = {"loss": loss, "grads": grads(sd),
                    "stats": {k: int(v) for k, v in stats.items()}}
    torch.save(out, os.path.join(workdir, f"out{rank}.pt"))


def main():
    torch.set_num_threads(1)
    job, rank, world, port, workdir = sys.argv[1:6]
    os.environ["V2E2V_PLATFORM"] = "cpu"
    flags = ["--dist_coordinator", f"localhost:{port}", "--dist_num_processes", world,
             "--dist_process_id", rank]
    if job in ("train_e2v", "train"):
        import importlib

        importlib.import_module(f"v2e2v_tpu_torch.cli.{job}").main(sys.argv[6:] + flags)
        return
    from v2e2v_tpu_torch.parallel import distributed
    from v2e2v_tpu_torch.parallel.mesh import make_mesh
    from v2e2v_tpu_torch.utils.configs import set_configs

    parser = argparse.ArgumentParser()
    set_configs(parser)
    distributed.initialize_from_flags(parser.parse_args(flags), backend="gloo")
    try:
        run_steps(make_mesh(int(world), devices=["cpu"]), workdir, int(rank))
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
