"""Batched multi-stream E2V serving (port of ``v2e2v_tpu/serving.py``).

A fixed-capacity pool of slots on the device; each slot holds one stream's
recurrent state and previous reconstruction. A step runs every slot as one
batch and keeps the old state of slots that had no input (masked update);
``attach`` zeroes the claimed slot. The step is ``cfg.model_mode``'s
(CISTA-LSTC or CISTA-TC, ``get_step_fn``). int8 calibration and a
multi-device mesh are not ported.

    pool = StreamPool(cfg, params, capacity=8)
    sid = pool.attach()
    recs = pool.step({sid: voxel_grid})    # [H, W, num_bins] per stream
    pool.detach(sid)
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ._device import resolve_device
from .models.cista import CistaConfig, CistaState, cista_zero_state, get_step_fn, with_derived


def _pool_step(params, cfg, states, prev_images, voxels, active):
    """Step all slots; inactive slots keep their state and image."""
    recs, new_states = get_step_fn(cfg)(params, cfg, voxels, prev_images, states)

    def keep(new, old):
        return torch.where(active.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)

    recs = keep(recs, prev_images)
    new_states = CistaState(
        cell=keep(new_states.cell, states.cell),
        z=keep(new_states.z, states.z),
        dg=(keep(new_states.dg[0], states.dg[0]), keep(new_states.dg[1], states.dg[1])),
    )
    return recs, new_states


class StreamPool:
    """Fixed-capacity pool of independent reconstruction streams."""

    def __init__(
        self,
        cfg: CistaConfig,
        params: Mapping[str, torch.Tensor],
        capacity: int = 8,
        dtype: torch.dtype = torch.bfloat16,
        mesh=None,
        device: torch.device | str | None = None,
    ):
        if mesh is not None:
            raise NotImplementedError("a multi-device StreamPool is not ported")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.capacity = capacity
        self.dtype = dtype
        # the derived kernels (K2's taps, the fused full-resolution and
        # ConvLSTC kernels) once, in the pool's dtype, not in every step
        self.params = with_derived(
            {k: v.to(self.device, dtype) for k, v in params.items()}, cfg, dtype)
        h, w = cfg.image_dim
        self._states = cista_zero_state(cfg, capacity, dtype, self.device)
        self._prev = torch.zeros((capacity, h, w, 1), dtype=dtype, device=self.device)
        self._active = np.zeros(capacity, bool)
        self._next_id = 0
        self._slot_of: dict[int, int] = {}

    def calibrate(self, voxels, drift_budget: float = 0.01) -> bool:
        raise NotImplementedError("int8 serving is not ported")

    def attach(self) -> int:
        """Claim a free slot for a new stream (its state zeroed); returns the
        stream id."""
        free = np.flatnonzero(~self._active)
        if len(free) == 0:
            raise RuntimeError(f"stream pool full (capacity {self.capacity})")
        slot = int(free[0])
        for s in (self._states.cell, self._states.z, *self._states.dg):
            s[slot].zero_()
        # out of place: fetch=False handed out views of the old images
        self._prev = self._prev.index_fill(0, torch.tensor([slot], device=self.device), 0)
        self._active[slot] = True
        sid = self._next_id
        self._next_id += 1
        self._slot_of[sid] = slot
        return sid

    def detach(self, stream_id: int) -> None:
        slot = self._slot_of.pop(stream_id)
        self._active[slot] = False

    def step(self, voxels_by_stream: Mapping[int, object], fetch: bool = True) -> dict:
        """Step the given streams with their voxel grids ``[H, W, num_bins]``
        (numpy arrays or tensors on any device); returns reconstructions
        ``[H, W]`` per stream id, as float32 numpy arrays, or with
        ``fetch=False`` as views of the device tensor. Streams not in the dict
        idle (state preserved)."""
        h, w = self.cfg.image_dim
        voxels = torch.zeros(
            (self.capacity, h, w, self.cfg.num_bins), dtype=self.dtype, device=self.device
        )
        active = np.zeros(self.capacity, bool)
        for sid, vox in voxels_by_stream.items():
            slot = self._slot_of[sid]
            voxels[slot] = torch.as_tensor(vox).to(self.device, self.dtype)
            active[slot] = True
        active_dev = torch.from_numpy(active).to(self.device)
        recs, self._states = _pool_step(
            self.params, self.cfg, self._states, self._prev, voxels, active_dev
        )
        self._prev = recs
        if not fetch:
            return {sid: recs[self._slot_of[sid], ..., 0] for sid in voxels_by_stream}
        recs_np = recs.float().cpu().numpy()
        return {sid: recs_np[self._slot_of[sid], ..., 0] for sid in voxels_by_stream}
