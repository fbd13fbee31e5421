"""One rank of the port's CPU runs over ``gloo`` for
tests/test_torch_distributed.py (started as a script, one process per rank;
it imports torch and the port only).

    python tests/_torch_dist_worker.py steps <rank> <world> <port> <dir>
    python tests/_torch_dist_worker.py spatial <rank> <world> <port> <dir> <n_data> <n_spatial>
    python tests/_torch_dist_worker.py train_e2v <rank> <world> <port> <dir> [CLI flags]
    python tests/_torch_dist_worker.py train <rank> <world> <port> <dir> [CLI flags]

``steps`` runs the port's train steps on a data axis of ``world`` ranks, on
the weights and global batches the test wrote to ``<dir>/inputs.pt``, each
rank handing the per-batch steps its rows (``Mesh.rows``), as the trainers
do, and writes each step's loss, gradients and stats to
``<dir>/out<rank>.pt``. ``spatial`` runs, on a ``(n_data, n_spatial)``
mesh, the E2V cases of ``<dir>/spatial_inputs.pt`` that name that layout
(tests/test_torch_spatial.py), each rank handing the per-batch step its rows
and columns (``Mesh.rows``, ``Mesh.cols``), and writes each case's loss,
gradients and this rank's block of the forward's last reconstruction to
``<dir>/spatial_<n_data>x<n_spatial>_<rank>.pt``; a case may name a fault to plant
(``FAULTS``). ``train_e2v`` and ``train`` run ``cli.train_e2v`` or
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


def _reflect_inner_cuts():
    """A planted fault: the halo exchange's forward pads every cut by
    reflection, as if each block were a whole image (its collective still
    runs, so the ranks stay in step)."""
    from v2e2v_tpu_torch.parallel import spatial

    forward = spatial._HaloPad.forward

    def reflect_forward(ctx, x, p, mode, dim, shard):
        forward(ctx, x, p, mode, dim, shard)
        return torch.cat([spatial._edge(x, p, mode, dim, True), x,
                          spatial._edge(x, p, mode, dim, False)], dim)

    spatial._HaloPad.forward = staticmethod(reflect_forward)
    return lambda: setattr(spatial._HaloPad, "forward", staticmethod(forward))


FAULTS = {"reflect_inner_cuts": _reflect_inner_cuts}


def run_spatial(mesh, workdir, rank):
    from v2e2v_tpu_torch.models.cista import cista_sequence, tie_weights
    from v2e2v_tpu_torch.training import steps
    from v2e2v_tpu_torch.utils.checkpoint import STEP_KEYS

    inp = torch.load(os.path.join(workdir, "spatial_inputs.pt"), weights_only=False)
    out = {}
    for case in inp:
        if tuple(case["layout"]) != (mesh.n_data, mesh.n_spatial):
            continue
        undo = FAULTS[case["fault"]]() if case.get("fault") else (lambda: None)
        try:
            cfg = case["cfg"]
            sd = tie_weights({k: v.clone() for k, v in case["weights"].items()}, cfg)
            opt = steps.make_adam(sd, cfg, 1e-4)
            if case["step"] == "e2v":
                seq = mesh.cols(mesh.rows(case["seq"], 1), 3)
                loss = steps.make_e2v_train_step(cfg, opt, mesh=mesh)(
                    sd, seq, mesh.cols(mesh.rows(case["gt"], 0), 2))
                with torch.no_grad():
                    recs, _ = cista_sequence(sd, cfg, seq, shard=mesh.shard)
                rec = recs[-1]
            else:
                step = steps.make_e2v_train_step_device_data(
                    cfg, opt, noise_std=case["noise_std"], mesh=mesh)
                loss = step(sd, case["data"], case["gt_all"], case["idx"],
                            torch.Generator().manual_seed(case["noise_seed"]), case["w"])
                rec = None
            out[case["name"]] = {"loss": loss, "rec": rec, "grads": {
                k: sd[k].grad.clone() for k in STEP_KEYS[cfg.model_mode]}}
        finally:
            undo()
    torch.save(out, os.path.join(workdir, f"spatial_{mesh.n_data}x{mesh.n_spatial}_{rank}.pt"))


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
        if job == "spatial":
            n_data, n_spatial = map(int, sys.argv[6:8])
            run_spatial(make_mesh(n_data, n_spatial, devices=["cpu"]), workdir, int(rank))
        else:
            run_steps(make_mesh(int(world), devices=["cpu"]), workdir, int(rank))
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
