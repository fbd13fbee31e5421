"""The JAX package's ``(data, spatial)`` mesh (port of
``v2e2v_tpu/parallel/mesh.py:29-52``).

Sequences are independent along the data axis: each index of the axis takes
a contiguous share of every global batch, process-major, as JAX's
``P("data")`` sharding lays it out. The spatial axis shards the image width:
each index takes a contiguous block of columns, and the ops that read across
a cut exchange halos (``parallel/spatial.py``). In a process group the mesh
is the group, one device per rank, rank ``r`` at data index ``r //
n_spatial`` and spatial index ``r % n_spatial`` (JAX's ``devices.reshape(
n_data, n_spatial)``); the train steps (``training/steps.py``) all-reduce the
gradients over the whole group. In one process the mesh is a data axis of
devices, over which ``StreamPool`` spreads its slots.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from .distributed import cpu_platform
from .spatial import Shard, block_width


@dataclass(frozen=True)
class Mesh:
    """Every rank's device, in rank order, and in a process group the group,
    this rank's index on the data axis (``rank``) and on the spatial axis
    (``spatial_rank``), and the spatial axis's group (``group`` None in one
    process, ``spatial_group`` None for one spatial index). The data axis
    needs no group of its own: the steps reduce over the whole group, where
    the spatial ranks' partial gradients are summed in the same
    all-reduce."""

    devices: tuple[torch.device, ...]
    group: object = None
    rank: int = 0
    n_spatial: int = 1
    spatial_rank: int = 0
    spatial_group: object = None

    @property
    def n_data(self) -> int:
        return len(self.devices) // self.n_spatial

    @property
    def shard(self) -> Shard | None:
        """This rank's block of columns (None without a spatial axis)."""
        if self.n_spatial == 1:
            return None
        return Shard(self.spatial_group, self.spatial_rank, self.n_spatial)

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
        return _narrow(x, dim, self.row_slice(x.shape[dim]))

    def col_slice(self, width: int) -> slice:
        """This rank's columns of an image ``width`` wide; ``ValueError``
        unless it divides into ``2 * n_spatial`` equal blocks
        (``spatial.block_width``)."""
        per = block_width(width, self.n_spatial)
        return slice(self.spatial_rank * per, (self.spatial_rank + 1) * per)

    def cols(self, x, dim: int):
        """This rank's contiguous columns of ``x`` (a tensor or numpy array)
        along ``dim``: a view (``x`` itself without a spatial axis)."""
        if self.n_spatial == 1:
            return x
        return _narrow(x, dim, self.col_slice(x.shape[dim]))


def _narrow(x, dim: int, s: slice):
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
    """The ``(data, spatial)`` mesh.

    In a process group the mesh is the group: ``n_data`` (None: the world
    size over ``n_spatial``) times ``n_spatial`` must equal the world size,
    and ``devices`` (None: this rank's device) names this rank's one device.
    Every rank makes every spatial group, in the same order
    (``dist.new_group`` is collective). In one process ``devices`` (None: the
    card) lists the data axis's devices; ``n_data`` (None: their count) takes
    the first ``n_data``, and more than there are raises ``ValueError``, as
    JAX's mesh does; ``n_spatial > 1`` needs a process group and raises
    ``ValueError`` without one."""
    if n_spatial < 1:
        raise ValueError(f"n_spatial must be >= 1, got {n_spatial}")
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        n = world // n_spatial if n_data is None else n_data
        if n * n_spatial != world:
            raise ValueError(f"the mesh has one device per process: n_data={n} x "
                             f"n_spatial={n_spatial} needs {n * n_spatial} processes, the "
                             f"group has {world}")
        mine = torch.device(devices[0]) if devices is not None else _rank_device()
        gathered = [None] * world
        dist.all_gather_object(gathered, str(mine))
        rank = dist.get_rank()
        spatial_group = None
        if n_spatial > 1:
            for d in range(n):  # every rank makes every group, in order
                group = dist.new_group(list(range(d * n_spatial, (d + 1) * n_spatial)))
                if d == rank // n_spatial:
                    spatial_group = group
        return Mesh(tuple(torch.device(d) for d in gathered), dist.group.WORLD,
                    rank // n_spatial, n_spatial, rank % n_spatial, spatial_group)
    if n_spatial > 1:
        raise ValueError(f"n_spatial={n_spatial} shards the width over processes: start "
                         f"n_data x {n_spatial} processes with the --dist_* flags (one device "
                         "per process)")
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
