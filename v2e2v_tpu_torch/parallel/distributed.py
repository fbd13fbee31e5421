"""Runs over several processes (port of ``v2e2v_tpu/parallel/distributed.py``).

One process per device: a process group of ``torch.distributed`` joins them,
``nccl`` on CUDA cards and ``gloo`` on the CPU (``V2E2V_PLATFORM=cpu``).
Every rank runs the same program on the same global batches and takes its
own rows of each (``parallel/mesh.py``); the train steps all-reduce the
gradients.

- :func:`initialize_from_flags`: the process group from flags or environment
  (nothing without them, so one process runs as before).
- :func:`is_main_process`: checkpoint gating.
- :func:`process_local_rows`: this rank's contiguous rows of a global batch.
- :func:`barrier`, :func:`shutdown`: a wait for every rank, and the teardown
  the CLIs run on exit.

JAX's ``global_batch`` and ``local_batch_to_global`` have no counterpart:
they lay a host batch out as one global array over every process's devices;
here a rank keeps its rows as a tensor on its own device.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

COORDINATOR_ENV = ("V2E2V_COORDINATOR", "V2E2V_NUM_PROCESSES", "V2E2V_PROCESS_ID")
DIST_FLAGS = ("dist_coordinator", "dist_num_processes", "dist_process_id")


def cpu_platform() -> bool:
    return os.environ.get("V2E2V_PLATFORM", "").strip().lower() == "cpu"


def _explicit_source(cfgs) -> tuple[str, int, int] | None:
    """``(coordinator, processes, process id)`` from the three ``--dist_*``
    flags, else from the three ``V2E2V_*`` variables; None when neither is
    set. Raises when a source is given in part, as JAX's initialize does."""
    flags = [getattr(cfgs, k, None) if cfgs is not None else None for k in DIST_FLAGS]
    source, names = flags, [f"--{k}" for k in DIST_FLAGS]
    if flags[0] is None and COORDINATOR_ENV[0] in os.environ:
        source, names = [os.environ.get(k) for k in COORDINATOR_ENV], list(COORDINATOR_ENV)
    if source[0] is None:
        return None
    absent = [n for n, v in zip(names, source) if v is None]
    if absent:
        raise ValueError(f"{names[0]} needs {' and '.join(absent)} too")
    return str(source[0]), int(source[1]), int(source[2])


def _set_rank_device(backend: str) -> None:
    """One card per process: ``cuda:$LOCAL_RANK``, else ``cuda:(rank %
    cards)``, made current before anything is allocated."""
    if cpu_platform() and backend == "gloo":
        return
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found for this rank; set V2E2V_PLATFORM=cpu to run "
                           "on the CPU over gloo")
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else dist.get_rank() % torch.cuda.device_count()
    torch.cuda.set_device(index)


def initialize_from_flags(cfgs=None, backend: str | None = None) -> bool:
    """Make the process group from flags or environment. Sources, in order:

    1. the flags ``--dist_coordinator host:port --dist_num_processes N
       --dist_process_id I`` (all three together);
    2. ``V2E2V_COORDINATOR`` / ``V2E2V_NUM_PROCESSES`` / ``V2E2V_PROCESS_ID``
       (the same contract);
    3. ``V2E2V_DIST_AUTO=1``: torchrun's ``RANK``, ``WORLD_SIZE``,
       ``MASTER_ADDR`` and ``MASTER_PORT`` (``init_method="env://"``), in
       place of JAX's cluster detection.

    ``backend`` defaults to ``nccl``, and to ``gloo`` under
    ``V2E2V_PLATFORM=cpu``; ``gloo`` on the card runs several ranks on one
    card, which NCCL refuses. Returns whether a group was made."""
    source = _explicit_source(cfgs)
    auto = source is None and os.environ.get("V2E2V_DIST_AUTO") == "1"
    if source is None and not auto:
        return False
    backend = backend or ("gloo" if cpu_platform() else "nccl")
    if auto:
        dist.init_process_group(backend, init_method="env://")
    else:
        coordinator, world, rank = source
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=world, rank=rank)
    _set_rank_device(backend)
    world = dist.get_world_size()
    print(f"distributed{'(auto)' if auto else ''}: process {dist.get_rank()}/{world}, "
          f"1 local / {world} global devices ({backend})")
    return True


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return rank() == 0


def process_local_rows(n_rows_global: int) -> slice:
    """The contiguous rows this rank owns of a global batch of
    ``n_rows_global`` rows, process-major."""
    per = n_rows_global // world_size()
    r = rank()
    return slice(r * per, (r + 1) * per)


def barrier() -> None:
    """Wait for every rank (nothing without a group)."""
    if dist.is_initialized():
        dist.barrier()


def shutdown() -> None:
    """Destroy the process group if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()
