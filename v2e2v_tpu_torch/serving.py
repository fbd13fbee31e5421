"""Batched multi-stream E2V serving (port of ``v2e2v_tpu/serving.py``).

A fixed-capacity pool of slots on the device; each slot holds one stream's
recurrent state and previous reconstruction. A step runs every slot as one
batch and keeps the old state of slots that had no input (masked update);
``attach`` zeroes the claimed slot. The step is ``cfg.model_mode``'s
(CISTA-LSTC or CISTA-TC, float or int8, ``get_step_fn``). An int8 pool
quantizes its weights once and can calibrate static activation scales
(``calibrate``).

    pool = StreamPool(cfg, params, capacity=8)
    sid = pool.attach()
    recs = pool.step({sid: voxel_grid})    # [H, W, num_bins] per stream
    pool.detach(sid)

Several devices: ``mesh=parallel.mesh.make_mesh(n, devices=[...])`` spreads
the slots over the mesh's data axis, as the JAX pool shards them: slot ``i``
lives on device ``i // (capacity / n)``, which holds its group's states,
previous images and a copy of the weights and steps the group as one batch;
the API stays single-process (a process group's mesh raises).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ._device import resolve_device
from .models.cista import (
    CistaConfig,
    CistaState,
    cista_zero_state,
    get_step_fn,
    int8_static_drift_check,
    with_derived,
)
from .ops.qconv import calibrate_step_scales, quantize_core


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


def _to(tree, device: torch.device):
    """A nest of dicts, lists and tuples of tensors, moved to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


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
        """``mesh``: a data axis of devices in this process
        (``parallel/mesh.make_mesh``), in place of ``device``; ``capacity``
        must be divisible by its size."""
        if mesh is None:
            devices = [resolve_device(device)]
        elif mesh.n_spatial > 1:
            raise ValueError(f"a StreamPool has no spatial axis (n_spatial={mesh.n_spatial}), "
                             "as the JAX pool has none: pass a data axis")
        elif mesh.group is not None:
            raise ValueError("a StreamPool runs in one process, as the JAX pool does: pass a "
                             "mesh of this process's devices, not a process group's")
        elif capacity % mesh.n_data:
            raise ValueError(f"capacity {capacity} must be divisible by the mesh data axis "
                             f"({mesh.n_data})")
        else:
            devices = list(mesh.devices)
        self.device = devices[0]
        self._devices = devices
        self._per = capacity // len(devices)
        self.cfg = cfg
        self.capacity = capacity
        self.dtype = dtype
        placed = {}
        for d in devices:
            if d not in placed:
                placed[d] = self._place(params, d)
        self._params = [placed[d] for d in devices]  # one copy per device
        h, w = cfg.image_dim
        self._group_states = [cista_zero_state(cfg, self._per, dtype, d) for d in devices]
        self._group_prev = [torch.zeros((self._per, h, w, 1), dtype=dtype, device=d)
                            for d in devices]
        self._active = np.zeros(capacity, bool)
        self._next_id = 0
        self._slot_of: dict[int, int] = {}

    def _place(self, params: Mapping[str, torch.Tensor], device: torch.device):
        cast = {k: v.to(device, self.dtype) for k, v in params.items()}
        if self.cfg.quant == "int8":
            # the int8 weights once, from the weights as given, not from
            # their cast to the pool's dtype
            cast["_quant"] = quantize_core(
                {k: v.to(device) for k, v in params.items()}, self.cfg.model_mode)
        # the derived kernels (K2's taps, the fused full-resolution and
        # ConvLSTC kernels) once, in the pool's dtype, not in every step
        return with_derived(cast, self.cfg, self.dtype)

    @property
    def params(self):
        """The weights as the first device holds them."""
        return self._params[0]

    @property
    def _states(self) -> CistaState:
        """Every slot's state, in slot order (on the first device when the
        pool spans several)."""
        if len(self._devices) == 1:
            return self._group_states[0]
        cat = lambda ts: torch.cat([t.to(self.device) for t in ts])  # noqa: E731
        gs = self._group_states
        return CistaState(cell=cat([g.cell for g in gs]), z=cat([g.z for g in gs]),
                          dg=(cat([g.dg[0] for g in gs]), cat([g.dg[1] for g in gs])))

    @property
    def _prev(self) -> torch.Tensor:
        """Every slot's previous reconstruction, in slot order."""
        if len(self._devices) == 1:
            return self._group_prev[0]
        return torch.cat([p.to(self.device) for p in self._group_prev])

    def calibrate(self, voxels, drift_budget: float = 0.01) -> bool:
        """Calibrate static int8 activation scales on sample voxel grids
        ``[steps, batch, H, W, num_bins]`` (each reconstruction fed back as the
        next ``prev_image``, as in the pool), with margin 1.25 over the
        largest scale seen; afterwards a pool step quantizes with them
        instead of taking each conv input's ``max|x|``. CISTA-LSTC then also
        runs the requant chain (``CistaConfig.requant_chain``).

        Drift gate: the first calibration step runs float and int8 with the
        static scales (``int8_static_drift_check``); if the SSIM delta
        exceeds ``drift_budget`` the pool keeps its dynamic scales, warns and
        returns False. Returns True when the static scales were adopted.
        Requires ``cfg.quant == 'int8'``."""
        if self.cfg.quant != "int8":
            raise ValueError("calibrate() requires cfg.quant == 'int8'")
        import dataclasses

        # calibrated on the first device, the scales then copied to the others
        voxels = torch.as_tensor(voxels).to(self.device)
        step_fn = get_step_fn(self.cfg)
        b = voxels.shape[1]
        state = cista_zero_state(self.cfg, b, self.dtype, self.device)
        prev = torch.zeros(tuple(voxels.shape[1:4]) + (1,), dtype=self.dtype, device=self.device)
        p = self.params

        def run_steps():
            s, pv = state, prev
            for t in range(voxels.shape[0]):
                out, s = step_fn(p, self.cfg, voxels[t].to(self.dtype), pv, s)
                pv = out.to(self.dtype)

        qp_static = calibrate_step_scales(run_steps, self.params["_quant"],
                                          model_mode=self.cfg.model_mode,
                                          depth=self.cfg.depth, margin=1.25)
        cfg_run = self.cfg
        if self.cfg.model_mode == "cista-lstc":
            # static scales let the ISTA code stay int8 between iterations;
            # the gate below runs the chained step
            cfg_run = dataclasses.replace(self.cfg, requant_chain=True)
        p_static = {**self.params, "_quant": qp_static}
        delta, ok = int8_static_drift_check(p_static, cfg_run, voxels[0].to(self.dtype), prev,
                                            state, budget=drift_budget)
        if not ok:
            print(f"[StreamPool] WARNING: float-vs-int8 SSIM delta {delta:.4f} exceeds the "
                  f"{drift_budget} budget — keeping dynamic int8 scales")
            return False
        self.cfg = cfg_run
        self._params = [p_static if d == self.device else {**pd, "_quant": _to(qp_static, d)}
                        for d, pd in zip(self._devices, self._params)]
        return True

    def attach(self) -> int:
        """Claim a free slot for a new stream (its state zeroed); returns the
        stream id."""
        free = np.flatnonzero(~self._active)
        if len(free) == 0:
            raise RuntimeError(f"stream pool full (capacity {self.capacity})")
        slot = int(free[0])
        g, row = divmod(slot, self._per)
        st = self._group_states[g]
        for s in (st.cell, st.z, *st.dg):
            s[row].zero_()
        # out of place: fetch=False handed out views of the old images
        prev = self._group_prev[g]
        self._group_prev[g] = prev.index_fill(0, torch.tensor([row], device=prev.device), 0)
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
        per = self._per
        voxels = [torch.zeros((per, h, w, self.cfg.num_bins), dtype=self.dtype, device=d)
                  for d in self._devices]
        active = np.zeros(self.capacity, bool)
        for sid, vox in voxels_by_stream.items():
            g, row = divmod(self._slot_of[sid], per)
            voxels[g][row] = torch.as_tensor(vox).to(self._devices[g], self.dtype)
            active[self._slot_of[sid]] = True
        # every group's step is issued before any result is read
        for g, d in enumerate(self._devices):
            active_dev = torch.from_numpy(active[g * per:(g + 1) * per]).to(d)
            self._group_prev[g], self._group_states[g] = _pool_step(
                self._params[g], self.cfg, self._group_states[g], self._group_prev[g],
                voxels[g], active_dev)
        recs = self._group_prev
        if not fetch:
            return {sid: recs[self._slot_of[sid] // per][self._slot_of[sid] % per, ..., 0]
                    for sid in voxels_by_stream}
        recs_np = np.concatenate([r.float().cpu().numpy() for r in recs])
        return {sid: recs_np[self._slot_of[sid], ..., 0] for sid in voxels_by_stream}
