"""The dynamic activation scale of int8 inference, one reduction kernel per
conv site (``csrc/qscale.cu``), beside kernel K4 (``ops/cuda/qconv.py``),
which reads the scale on the device.

    s_x = max(max |x_a|, max |x_b|) / 127    (1 where that is 0)

over one NHWC float32 or bfloat16 activation or the two parts of a channel
concat, a float32 scalar tensor on their device, with ``/ 127`` as compiled
XLA computes it in the JAX package's ``quantize_activation``: a product with
the float32 reciprocal (``numerics.div_const``). ``act_scale`` runs the
kernel for CUDA tensors (one launch, no host sync) and the plain version
``act_scale_plain`` (eager passes: abs and amax of each part, their maximum,
the product, the select) for CPU tensors.
"""

from __future__ import annotations

import torch

from ..numerics import div_const
from . import DTYPE_NAMES, refuse_grad

_work: dict = {}  # (device index, stream) -> the kernel's work buffer


def _check(parts) -> None:
    if not 1 <= len(parts) <= 2 or any(p.dtype not in DTYPE_NAMES or p.dtype != parts[0].dtype
                                       for p in parts):
        raise TypeError("act_scale takes one or two float32 or bfloat16 tensors of one dtype, got "
                        f"{[p.dtype for p in parts]}")
    if any(p.device != parts[0].device for p in parts):
        raise ValueError(f"the parts are on {[str(p.device) for p in parts]}")
    if parts[0].numel() == 0:
        raise ValueError("act_scale of an empty tensor")


def act_scale_plain(parts) -> torch.Tensor:
    """Plain PyTorch version: ``abs().amax()`` of each part, their maximum,
    ``div_const(., 127)`` in float32, 0 -> 1. A float32 scalar on the parts'
    device."""
    parts = tuple(parts)
    _check(parts)
    amax = parts[0].abs().amax()
    for p in parts[1:]:
        amax = torch.maximum(amax, p.abs().amax())
    s_x = div_const(amax.to(torch.float32), 127.0)
    return torch.where(s_x == 0, 1.0, s_x)


def _work_buffer(lib, device: torch.device) -> torch.Tensor:
    """The kernel's work buffer on the current stream of ``device``: made
    (zeroed) once; each call leaves it ready for the next on that stream."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _work.get(key)
    if buf is None:
        buf = torch.zeros(lib.lib.v2e_qscale_work_words(), dtype=torch.int32, device=device)
        _work[key] = buf
    return buf


def act_scale(parts) -> torch.Tensor:
    """The scale of ``parts`` (one tensor or the two parts of a channel
    concat, float32 or bfloat16, one dtype): the CUDA kernel for CUDA tensors
    (one launch on the current stream, counted in ``act_scale.launches`` and,
    by input dtype, in ``act_scale.launches_by_dtype``), the plain version for
    CPU tensors. On a CUDA tensor it raises for a part that is not contiguous
    or does not start on a 16-byte boundary; under autograd it raises when a
    part requires grad (``refuse_grad``)."""
    parts = tuple(parts)
    _check(parts)
    refuse_grad("act_scale", parts)
    dev = parts[0].device
    if dev.type == "cpu":
        return act_scale_plain(parts)
    if dev.type != "cuda":
        raise ValueError(f"act_scale runs on cuda or cpu, not {dev}")
    if not all(p.is_contiguous() for p in parts):
        raise ValueError("act_scale's inputs must be contiguous, got strides "
                         f"{[p.stride() for p in parts]}")
    from ._lib import check_aligned, load

    check_aligned("act_scale", **{f"part{i}": p for i, p in enumerate(parts)})
    lib = load()
    s_x = torch.empty((), dtype=torch.float32, device=dev)
    xb = parts[1] if len(parts) > 1 else None
    with torch.cuda.device(dev):
        err = lib.lib.v2e_qscale(
            parts[0].data_ptr(), parts[0].numel(), None if xb is None else xb.data_ptr(),
            0 if xb is None else xb.numel(), int(parts[0].dtype == torch.bfloat16),
            _work_buffer(lib, dev).data_ptr(), s_x.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    lib.check(err, "act_scale launch")
    act_scale.launches += 1
    act_scale.launches_by_dtype[DTYPE_NAMES[parts[0].dtype]] += 1
    return s_x


act_scale.launches = 0
act_scale.launches_by_dtype = dict.fromkeys(DTYPE_NAMES.values(), 0)
