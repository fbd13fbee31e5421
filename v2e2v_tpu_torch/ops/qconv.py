"""Int8 inference for the CISTA core (port of ``v2e2v_tpu/ops/qconv.py``).

Symmetric post-training quantization, as the JAX package does it:

- weights:      ``s_w[o] = max|w[o]| / 127`` over ``(in, kh, kw)`` (a zero
                channel gets 1); ``w_q = clip(round(w / s_w), -127, 127)``,
                once per checkpoint (``quantize_conv_params``);
- activations:  ``s_x = max|x| / 127`` per tensor (a zero tensor gets 1),
                on the fly (one reduction kernel per site on the card,
                ``ops/cuda/qscale.py``), or a static scale after calibration
                (``calibrate_step_scales``); ``x_q = clip(round(x / s_x),
                -127, 127)``, rounding half to even;
- conv:         reflect padding on the int8 tensor and an exact int32 sum,
                then ``acc * (s_x * s_w) + bias`` in float32, cast to the
                activation dtype: kernel K4 (``ops/cuda/qconv.py``) for CUDA
                tensors, which takes the float input and quantizes it while
                it stages it, so ``x_q`` never reaches device memory; its
                plain version (``quantize_with``, then the integer conv) for
                CPU tensors or where a caller asks for it (``impl="plain"``).

Weights are OIHW under the reference's state-dict names, so ``w_q`` equals
the JAX package's HWIO ``w_q`` transposed. The divisions round as the JAX
package's compiled step rounds them: ``/ 127`` is a product with the float32
reciprocal (``numerics.div_const``), ``x / s_x`` and ``w / s_w`` are true
divisions by device tensors (PyTorch on the card turns a division by a
Python float into a reciprocal product). A scale stays a tensor on the
device: a step reads none on the host.

A channel concat (the ConvLSTC and ConvLSTM gates) is quantized with one
scale, the largest over its parts, and reaches K4 as its two parts: the
concat is never built. Inference only: K4 raises under autograd.
"""

from __future__ import annotations

import copy
from typing import Any, Callable

import torch

from .cuda.qconv import qconv3x3, qconv3x3_plain, quantize_with
from .cuda.qscale import act_scale, act_scale_plain
from .numerics import div_const

Params = dict[str, Any]

# Calibration hook: when a list, every dynamic scale a conv computes is
# appended to it (``calibrate_step_scales``).
_CALIB: list | None = None

_IMPLS = {"cuda": qconv3x3, "plain": qconv3x3_plain}
_SCALES = {"cuda": act_scale, "plain": act_scale_plain}


def quantize_conv_params(params: Params) -> Params:
    """Per-output-channel symmetric int8 quantization of a conv layer:
    ``{"weight": OIHW, "bias"?}`` -> ``{"w_q": int8 OIHW, "s_w": float32
    [out], "bias"?: float32}``."""
    w = params["weight"].to(torch.float32)
    s_w = div_const(w.abs().amax(dim=(1, 2, 3)), 127.0)
    s_w = torch.where(s_w == 0, 1.0, s_w)
    w_q = torch.clamp(torch.round(w / s_w[:, None, None, None]), -127, 127).to(torch.int8)
    out: Params = {"w_q": w_q, "s_w": s_w}
    if params.get("bias") is not None:
        out["bias"] = params["bias"].to(torch.float32)
    return out


def _dynamic_scale(parts, impl: str = "cuda") -> torch.Tensor:
    """``max|x| / 127`` over all of ``parts`` (0 -> 1), a float32 scalar on
    their device (the scale kernel on the card, ``impl="cuda"``); appended to
    ``_CALIB`` when calibrating."""
    s_x = _SCALES[impl](tuple(parts))
    if _CALIB is not None:
        _CALIB.append(s_x)
    return s_x


def quantize_activation(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-tensor symmetric int8: ``(x_q int8, s_x float32 scalar)``."""
    s_x = _dynamic_scale((x,))
    return quantize_with(x, s_x), s_x


def _parts(x) -> tuple:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _conv(parts, s_x, qp: Params, padding, stride, pad_mode, out_dtype, impl) -> torch.Tensor:
    return _IMPLS[impl](parts[0], s_x, qp["w_q"], qp["s_w"], qp.get("bias"),
                        parts[1] if len(parts) > 1 else None, out_dtype, padding, stride,
                        pad_mode)


def qconv2d_pre(
    x_q,
    s_x: torch.Tensor,
    qp: Params,
    padding: int = 1,
    stride: int = 1,
    pad_mode: str = "reflect",
    out_dtype: torch.dtype = torch.bfloat16,
    impl: str = "cuda",
) -> torch.Tensor:
    """``qconv2d`` on an already-quantized int8 input ``x_q`` NHWC (or the
    two parts of a channel concat) with scale ``s_x`` (the requant chain:
    the producer quantized once, with a static scale)."""
    return _conv(_parts(x_q), s_x, qp, padding, stride, pad_mode, out_dtype, impl)


def qconv2d(
    x,
    qp: Params,
    padding: int = 1,
    stride: int = 1,
    pad_mode: str = "reflect",
    out_dtype: torch.dtype | None = None,
    impl: str = "cuda",
) -> torch.Tensor:
    """Quantized conv of NHWC ``x`` (or a tuple of the parts of a channel
    concat, quantized with one scale), as ``ops.conv.conv2d`` up to rounding.
    With a calibrated static scale ``qp["s_x"]`` the input is quantized with
    it (saturating past its range); else with the dynamic ``max|x| / 127``.
    The float input goes to the conv as it is: K4 quantizes it while it
    stages it (on the card it must be contiguous NHWC), the plain version
    with ``quantize_with``. Returns ``out_dtype`` (default: the input's
    dtype)."""
    parts = _parts(x)
    s_x = qp.get("s_x")
    if s_x is None:
        s_x = _dynamic_scale(parts, impl)
    return _conv(parts, s_x, qp, padding, stride, pad_mode, out_dtype or parts[0].dtype, impl)


# ---------------------------------------------------------------------------
# quantized recurrent cells (ops/conv.py's, with the convs in int8)


def qconv_lstc_step(
    qp: Params, x: torch.Tensor, z: torch.Tensor, prev_cell: torch.Tensor, impl: str = "cuda"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Int8 ``conv_lstc_step``: gates, P0 and out_gates quantized, the cell
    math in float."""
    gates = qconv2d((x, z), qp["gates"], impl=impl)
    in_g, forget_g = torch.chunk(gates, 2, dim=-1)
    in_g = torch.sigmoid(in_g)
    forget_g = torch.sigmoid(forget_g)
    z0 = qconv2d(x, qp["P0"], impl=impl)
    out_g = torch.sigmoid(qconv2d((z0, z), qp["out_gates"], impl=impl))
    cell = forget_g * prev_cell + in_g * z0
    return out_g * torch.tanh(cell), cell


def qconv_lstm_step(
    qp: Params, x: torch.Tensor, state: tuple[torch.Tensor, torch.Tensor], impl: str = "cuda"
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Int8 ``conv_lstm_step``: the 4-gate conv quantized, the cell math in
    float."""
    hidden, cell = state
    gates = qconv2d((x, hidden), qp["Gates"], impl=impl)
    in_g, rem_g, out_g, cell_g = torch.chunk(gates, 4, dim=-1)
    cell = torch.sigmoid(rem_g) * cell + torch.sigmoid(in_g) * torch.tanh(cell_g)
    hidden = torch.sigmoid(out_g) * torch.tanh(cell)
    return hidden, (hidden, cell)


def _q(params: Params, name: str) -> Params:
    return quantize_conv_params(
        {"weight": params[name + ".weight"], "bias": params.get(name + ".bias")})


def quantize_cista_core(params: Params) -> Params:
    """int8 weights of the CISTA-LSTC half-resolution core from the flat
    state dict: ConvLSTC (gates, P0, out_gates), the weight-tied ISTA pair
    (D, P), the decoder conv and the ConvLSTM gates. The heads and the
    upsample and final convs stay float."""
    return {
        "lstc": {k: _q(params, f"P0.{k}") for k in ("gates", "P0", "out_gates")},
        "D": _q(params, "lista_blocks.0.D.conv2d"),
        "P": _q(params, "lista_blocks.0.P.conv2d"),
        "dg_conv": _q(params, "Dg.conv.conv2d"),
        "lstm": {"Gates": _q(params, "Dg.recurrent_block.Gates")},
    }


def quantize_cista_tc_core(params: Params) -> Params:
    """int8 weights of the CISTA-TC core: its plain-conv ``P0``, the ISTA
    pair, the decoder conv and the ConvLSTM gates; the one-channel attention
    projections and ``alpha`` stay float."""
    return {
        "P0": _q(params, "P0.conv2d"),
        "D": _q(params, "lista_blocks.0.D.conv2d"),
        "P": _q(params, "lista_blocks.0.P.conv2d"),
        "dg_conv": _q(params, "Dg.conv.conv2d"),
        "lstm": {"Gates": _q(params, "Dg.recurrent_block.Gates")},
    }


def quantize_core(params: Params, model_mode: str = "cista-lstc") -> Params:
    """int8 weights of ``model_mode``'s core."""
    if model_mode == "cista-lstc":
        return quantize_cista_core(params)
    if model_mode == "cista-tc":
        return quantize_cista_tc_core(params)
    raise ValueError(f"unknown model_mode {model_mode!r}")


# ---------------------------------------------------------------------------
# static activation scales
#
# The conv sites of an int8 step run in a fixed order (the ISTA depth loop is
# unrolled), so a site is known by its position.

_SITE_ORDERS = {
    "cista-lstc": lambda depth: (
        ["lstc.gates", "lstc.P0", "lstc.out_gates"] + ["D", "P"] * depth
        + ["dg_conv", "lstm.Gates"]
    ),
    "cista-tc": lambda depth: ["P0"] + ["D", "P"] * depth + ["dg_conv", "lstm.Gates"],
}


def calibrate_step_scales(
    run_steps: Callable[[], None],
    qp: Params,
    model_mode: str = "cista-lstc",
    depth: int = 5,
    margin: float = 1.0,
) -> Params:
    """Static activation scales from the dynamic ones.

    ``run_steps()`` runs the int8 step (``params["_quant"]`` = ``qp``, no
    static scales) over calibration inputs; every dynamic scale it computes
    is kept on the device and read once, at the end (one sync). Returns a
    copy of ``qp`` with ``s_x`` at each site: the largest scale the site saw
    over all calls (the weight-tied D and P share one across the depth
    loop), times ``margin``, at least 1e-12, taken in Python floats and then
    made a float32 scalar on the scales' device, as the JAX package does.
    ``qp`` is not changed."""
    global _CALIB
    _CALIB = []
    try:
        with torch.no_grad():
            run_steps()
        recorded = _CALIB
    finally:
        _CALIB = None
    sites = _SITE_ORDERS[model_mode](depth)
    n = len(sites)
    if not recorded or len(recorded) % n != 0:
        raise ValueError(
            f"calibration recorded {len(recorded)} scales, expected a multiple of {n} "
            f"({model_mode}, depth={depth}): run_steps must run the int8 step with "
            "dynamic scales")
    device = recorded[0].device
    scales = torch.stack(recorded).tolist()
    agg: dict[str, float] = {}
    for i, s in enumerate(scales):
        site = sites[i % n]
        agg[site] = max(agg.get(site, 0.0), s)
    out = copy.copy(qp)
    for site, s in agg.items():
        node = out
        *path, leaf = site.split(".")
        for p in path:
            node[p] = copy.copy(node[p])
            node = node[p]
        node[leaf] = {**node[leaf],
                      "s_x": torch.tensor(max(s * margin, 1e-12), dtype=torch.float32,
                                          device=device)}
    return out
