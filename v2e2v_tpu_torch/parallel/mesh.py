"""The data axis of the JAX package's ``(data, spatial)`` mesh (port of
``v2e2v_tpu/parallel/mesh.py:29-52``).

Sequences are independent along the data axis: each index of the axis takes
a contiguous share of every global batch, process-major, as JAX's
``P("data")`` sharding lays it out. In a process group the axis is the group,
one device per rank, and the train steps (``training/steps.py``) all-reduce
the gradients over it. In one process it is a list of devices, over which
``StreamPool`` spreads its slots. The spatial axis (the width sharded across
devices, with halo exchanges) is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from .distributed import cpu_platform

SPATIAL_AXIS = ("the spatial mesh axis (width sharded across devices) is not ported yet "
                "(ROADMAP.md queue 1, item 9, the spatial axis)")


@dataclass(frozen=True)
class Mesh:
    """The data axis: its devices, and in a process group the group and this
    rank's index on the axis (``group`` None in one process)."""

    devices: tuple[torch.device, ...]
    group: object = None
    rank: int = 0

    @property
    def n_data(self) -> int:
        return len(self.devices)

    def row_slice(self, n_rows: int) -> slice:
        """This rank's rows of a global batch of ``n_rows`` rows."""
        if n_rows % self.n_data:
            raise ValueError(f"a batch of {n_rows} rows does not divide over the data axis "
                             f"({self.n_data})")
        per = n_rows // self.n_data
        return slice(self.rank * per, (self.rank + 1) * per)

    def rows(self, x, dim: int = 0):
        """This rank's contiguous rows of ``x`` (a tensor or numpy array)
        along ``dim``: a view."""
        s = self.row_slice(x.shape[dim])
        if isinstance(x, np.ndarray):
            return x[(slice(None),) * dim + (s,)]
        return x.narrow(dim, s.start, s.stop - s.start)


def _rank_device() -> torch.device:
    """This rank's device: the CPU under ``V2E2V_PLATFORM=cpu``, else its
    current card (``initialize_from_flags`` set it)."""
    if cpu_platform():
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def make_mesh(n_data: int | None = None, n_spatial: int = 1, devices=None) -> Mesh:
    """The data axis.

    In a process group the axis is the group: ``n_data`` (None: the world
    size) must equal the world size, and ``devices`` (None: this rank's
    device) names this rank's one device. In one process ``devices`` (None:
    the card) lists the axis's devices; ``n_data`` (None: their count) takes
    the first ``n_data``, and more than there are raises ``ValueError``, as
    JAX's mesh does. ``n_spatial > 1`` raises ``NotImplementedError``."""
    if n_spatial > 1:
        raise NotImplementedError(f"n_spatial={n_spatial}: {SPATIAL_AXIS}")
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        n = world if n_data is None else n_data
        if n != world:
            raise ValueError(f"the data axis has one device per process: n_data={n} needs "
                             f"{n} processes, the group has {world}")
        mine = torch.device(devices[0]) if devices is not None else _rank_device()
        gathered = [None] * world
        dist.all_gather_object(gathered, str(mine))
        return Mesh(tuple(torch.device(d) for d in gathered), dist.group.WORLD,
                    dist.get_rank())
    devices = [resolve_device(None)] if devices is None else [torch.device(d) for d in devices]
    n = len(devices) if n_data is None else n_data
    if not 1 <= n <= len(devices):
        raise ValueError(f"n_data={n} needs {n} devices, this process has {len(devices)} "
                         "(one device per process: start one process per device with the "
                         "--dist_* flags)")
    return Mesh(tuple(devices[:n]))


class RowsNoise:
    """This rank's rows of a noise source's draws for the global batch.

    The emulator asks its noise source (``models/emulator.Noise``) for
    ``[B, ...]`` planes, ``[max_iters, B, ...]`` shot uniforms and ``[B]``
    seeds of its local batch. This source draws the global batch's shape from
    ``noise`` and hands back this rank's rows, so each rank makes the numbers
    that one process makes for those rows."""

    BATCH_DIM = {"shot": 1}  # the draws whose batch axis is not the first

    def __init__(self, noise, rows: slice, batch: int):
        self.noise, self.rows, self.batch = noise, rows, batch
        self.explicit_shot = getattr(noise, "explicit_shot", False)

    def _take(self, what: str, shape, draw):
        dim = self.BATCH_DIM.get(what, 0)
        local = self.rows.stop - self.rows.start
        if shape[dim] != local:
            raise ValueError(f"{what}: a draw of {tuple(shape)} is not {local} rows")
        full = draw(tuple(shape[:dim]) + (self.batch,) + tuple(shape[dim + 1:]))
        return full.narrow(dim, self.rows.start, local).contiguous()

    def normal(self, what, shape, device):
        return self._take(what, shape, lambda s: self.noise.normal(what, s, device))

    def uniform(self, what, shape, device):
        return self._take(what, shape, lambda s: self.noise.uniform(what, s, device))

    def seeds(self, what, n, device):
        return self._take(what, (n,), lambda s: self.noise.seeds(what, s[0], device))
