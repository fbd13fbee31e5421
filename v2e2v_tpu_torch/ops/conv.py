"""Conv primitives and recurrent conv cells (port of ``v2e2v_tpu/ops/conv.py``).

Public functions keep the JAX package's NHWC activations; inside, each conv
runs as ``F.conv2d`` on an NCHW view of the same memory. Weights are in
PyTorch's OIHW layout, as in a reference state dict; ``params`` is a
``{"weight", "bias"}`` dict like the JAX package's, or a dict of such dicts
for a cell. Convs accumulate in float32 and return the input's dtype.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

Params = dict[str, Any]


def conv2d(
    x: torch.Tensor, params: Params, stride: int = 1, padding: int = 0
) -> torch.Tensor:
    """Conv2d with reflect padding, as torch ``nn.Conv2d(...,
    padding_mode='reflect')``: reflect-pad, then a VALID conv (any stride)."""
    xc = x.permute(0, 3, 1, 2)
    if padding > 0:
        xc = F.pad(xc, (padding, padding, padding, padding), mode="reflect")
    bias = params.get("bias")
    y = F.conv2d(
        xc,
        params["weight"].to(x.dtype),
        None if bias is None else bias.to(x.dtype),
        stride=stride,
    )
    return y.permute(0, 2, 3, 1)


_ACTIVATIONS = {
    None: lambda x: x,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
}


def conv_layer(
    x: torch.Tensor,
    params: Params,
    stride: int = 1,
    padding: int = 0,
    activation: str | None = None,
) -> torch.Tensor:
    """Reference ``ConvLayer``: reflect conv + optional activation."""
    return _ACTIVATIONS[activation](conv2d(x, params, stride=stride, padding=padding))


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of NHWC input.

    ``align_corners=False`` (half-pixel centres) is the counterpart of
    ``jax.image.resize(..., 'linear')`` and upsamples only: that function
    antialiases when it downsamples and ``F.interpolate`` does not.
    ``align_corners=True`` is the Super-SloMo decoder's convention, the JAX
    package's gather formula (sample points ``i * f32((in - 1) / (out - 1))``,
    rows then columns), in either direction."""
    _, h, w, _ = x.shape
    if not align_corners and (out_h < h or out_w < w):
        raise ValueError(f"bilinear_resize upsamples only: {(h, w)} -> {(out_h, out_w)}")
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(out_h, out_w), mode="bilinear",
                      align_corners=align_corners)
    return y.permute(0, 2, 3, 1)


def upsample_conv_layer(
    x: torch.Tensor,
    params: Params,
    kernel_size: int = 3,
    activation: str | None = None,
    out_hw: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Reference ``UpsampleConvLayer``: bilinear upsample (2x unless
    ``out_hw``) -> reflection pad (k-1)/2 -> VALID conv."""
    _, h, w, _ = x.shape
    out_h, out_w = (2 * h, 2 * w) if out_hw is None else out_hw
    x = bilinear_resize(x, out_h, out_w)
    return _ACTIVATIONS[activation](conv2d(x, params, padding=(kernel_size - 1) // 2))


def conv_lstm_step(
    params: Params,
    x: torch.Tensor,
    state: tuple[torch.Tensor, torch.Tensor],
    k: int = 3,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """ConvLSTM step; ``state = (hidden, cell)``; gate channel order is
    torch's (in, remember, out, cell)."""
    hidden, cell = state
    gates = conv2d(torch.cat([x, hidden], dim=-1), params["Gates"], padding=k // 2)
    in_g, rem_g, out_g, cell_g = torch.chunk(gates, 4, dim=-1)
    cell = torch.sigmoid(rem_g) * cell + torch.sigmoid(in_g) * torch.tanh(cell_g)
    hidden = torch.sigmoid(out_g) * torch.tanh(cell)
    return hidden, (hidden, cell)


def conv_lstc_step(
    params: Params,
    x: torch.Tensor,
    z: torch.Tensor,
    prev_cell: torch.Tensor,
    k: int = 3,
) -> tuple[torch.Tensor, torch.Tensor]:
    """ConvLSTC step for sparse codes: in/forget gates (in that order) from
    cat(x, z); candidate ``z0 = P0(x)``; out gate from cat(z0, z);
    ``cell = forget*prev_cell + in*z0``. Returns ``(out_gate*tanh(cell), cell)``."""
    pad = k // 2
    gates = conv2d(torch.cat([x, z], dim=-1), params["gates"], padding=pad)
    in_g, forget_g = torch.chunk(gates, 2, dim=-1)
    z0 = conv2d(x, params["P0"], padding=pad)
    out_g = torch.sigmoid(
        conv2d(torch.cat([z0, z], dim=-1), params["out_gates"], padding=pad)
    )
    cell = torch.sigmoid(forget_g) * prev_cell + torch.sigmoid(in_g) * z0
    return out_g * torch.tanh(cell), cell


def conv_lstc_fuse(params: Params) -> Params:
    """The two-conv rewrite of ``conv_lstc_step``'s three convs (exact; the
    JAX package's ``lstc_impl='fused'``): pass 1 is ONE conv over cat(x, z)
    emitting ``[gates | z0 | og_z]`` (P0's kernel zero-padded over the z
    channels, out_gates' z half zero-padded over the x channels); pass 2 is
    out_gates' z0 half over z0, added to the ``og_z`` partial. Weights stay
    the cell's (``gates``, ``P0``, ``out_gates``, OIHW): gradients flow back
    to them."""
    wg, wp, wo = (params[k]["weight"] for k in ("gates", "P0", "out_gates"))
    out, x_ch = wp.shape[0], wp.shape[1]
    z_ch = wg.shape[1] - x_ch
    p0_blk = F.pad(wp, (0, 0, 0, 0, 0, z_ch))          # [out, x + z, 3, 3]
    og_z_blk = F.pad(wo[:, out:], (0, 0, 0, 0, x_ch, 0))
    bias = params["P0"]["bias"]
    return {
        "W1": {"weight": torch.cat([wg, p0_blk, og_z_blk], dim=0),
               "bias": torch.cat([params["gates"]["bias"], bias, bias.new_zeros(out)])},
        "W2": {"weight": wo[:, :out], "bias": params["out_gates"]["bias"]},
    }


def conv_lstc_step_fused(
    fused: Params,
    x: torch.Tensor,
    z: torch.Tensor,
    prev_cell: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``conv_lstc_step`` through the kernels of ``conv_lstc_fuse``."""
    out = fused["W2"]["weight"].shape[0]
    y1 = conv2d(torch.cat([x, z], dim=-1), fused["W1"], padding=1)
    in_g = torch.sigmoid(y1[..., :out])
    forget_g = torch.sigmoid(y1[..., out:2 * out])
    z0 = y1[..., 2 * out:3 * out]
    out_g = torch.sigmoid(conv2d(z0, fused["W2"], padding=1) + y1[..., 3 * out:])
    cell = forget_g * prev_cell + in_g * z0
    return out_g * torch.tanh(cell), cell


def torch_conv_to_hwio(weight: np.ndarray) -> np.ndarray:
    """torch OIHW conv weight -> HWIO."""
    return np.transpose(weight, (2, 3, 1, 0))


def hwio_to_torch_conv(weight: np.ndarray) -> np.ndarray:
    """HWIO conv weight -> torch OIHW (inverse of ``torch_conv_to_hwio``)."""
    return np.transpose(weight, (3, 2, 0, 1))
