"""CISTA events-to-video reconstruction (port of ``v2e2v_tpu/models/cista.py``).

Reference network ``CistaLSTCNet`` (lsying009/V2E2V ``e2v/e2v_model.py``):
event/image heads -> stride-2 downsample -> ConvLSTC sparse-code init ->
``depth`` weight-tied ISTA iterations -> ConvLSTM decoder -> bilinear
upsample conv -> final conv -> sigmoid. The full-resolution convs run as the
reference shapes them (``fullres_impl='ref'``) or as the JAX package's exact
rewrites in the half-resolution parity domain (``'fused'``,
``ops/fused.py``), which never build a full-resolution 64-channel map. The
half-resolution core (ConvLSTC, ISTA, decoder conv and ConvLSTM) runs layer
by layer, with the ISTA loop as kernel K1 (``ops/cuda/ista.py``) or its plain
version, or as one call of kernel K2 (``ops/cuda/core.py``) or its plain
version (``core_impl``). ``io_layout='parity'`` keeps a whole sequence's
input and feedback image parity-packed (``cista_sequence``).

``CistaTCNet`` (``model_mode="cista-tc"``, the ICASSP'22 network) starts the
sparse code from one conv ``P0`` and adds, in every weight-tied ISTA
iteration, a temporal term: a sigmoid attention between one-channel
projections of the previous step's code and the current one gates
``alpha * (prev_z - tmp)``. Its decoder's upsample conv has no activation.
It runs layer by layer on ``F.conv2d``: K1 and K2 compute LSTC's core only.

With ``quant="int8"`` either network's half-resolution core runs its convs in
int8 (``ops/qconv.py``: kernel K4, ``ops/cuda/qconv.py``); the heads, the
CISTA-TC attention projections and the upsample and final convs stay float.

Weights are a flat state dict under the reference module names (see
``utils/checkpoint.py``); activations are NHWC, as in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.utils.checkpoint

from .._device import resolve_device
from ..ops.conv import (
    conv_layer,
    conv_lstc_fuse,
    conv_lstc_step,
    conv_lstc_step_fused,
    conv_lstm_step,
    upsample_conv_layer,
)
from ..ops.cuda.core import cista_core, cista_core_plain, core_taps
from ..ops.cuda.ista import ista_loop, ista_loop_plain
from ..ops.fused import (
    depth_to_space,
    final_conv_parity_edgek,
    heads_fused_edgek,
    heads_parity_edgek,
    precompute_fused_kernels,
    space_to_depth,
    upsample_conv_parity_edgek,
)
from ..ops.numerics import softshrink
from ..ops.qconv import (
    qconv2d,
    qconv2d_pre,
    qconv_lstc_step,
    qconv_lstm_step,
    quantize_core,
    quantize_with,
)

StateDict = dict[str, torch.Tensor]


@dataclass(frozen=True)
class CistaConfig:
    """The parts of the JAX ``CistaConfig`` that the float path uses.

    ``image_dim`` is (H, W) of the voxel grid (even). ``ista_impl``: 'cuda'
    (kernel K1 for CUDA tensors; its plain version for CPU tensors) or
    'plain' (the plain version on any device). ``core_impl``: 'layers' (the
    default: the core layer by layer, its ISTA loop as ``ista_impl`` says),
    'cuda' (kernel K2 for CUDA tensors, its plain version for CPU tensors) or
    'plain' (K2's plain version on any device); with K2, ``ista_impl`` and
    ``lstc_impl`` are not read. CISTA-TC (``model_mode="cista-tc"``) reads
    neither and takes ``core_impl="layers"`` only.

    ``fullres_impl``: 'ref' (the default: the heads, the upsample conv and
    the final conv as the reference shapes them) or 'fused' (their exact
    rewrites in the parity domain, ``ops/fused.py``; the JAX package's
    default), for both model modes. On the card the fused pool step is the
    faster at batch 8, but the fused E2V CLI step at batch 1 is the slower:
    its thin border convs and writes cost the host more launches than the
    full-resolution maps they remove cost the card (PERF.md section 6).
    ``lstc_impl``: 'ref' or 'fused' (the ConvLSTC's three convs as two,
    ``ops/conv.conv_lstc_fuse``). ``io_layout``: 'full' or 'parity'
    (``cista_sequence`` packs the input and the feedback image once and runs
    ``cista_lstc_step_parity``; CISTA-LSTC with ``fullres_impl='fused'``
    only, else the sequence runs 'full'). The same values and meaning as the
    JAX package's; an unknown value raises.

    ``quant``: 'none' or 'int8' (``cista_lstc_step_int8`` and
    ``cista_tc_step_int8``: the core's convs in int8, ``ops/qconv.py``; they
    read neither ``ista_impl``, ``core_impl`` nor ``lstc_impl``, as in the JAX
    package). ``requant_chain``: with int8 and a calibrated static scale at
    the D site, the ISTA code stays int8 between iterations, as in the JAX
    package. ``qconv_impl``: 'cuda' (kernel K4 for CUDA tensors, its plain
    version for CPU tensors) or 'plain' (the plain version on any device).
    """

    image_dim: tuple[int, int] = (180, 240)
    base_channels: int = 64
    depth: int = 5
    num_bins: int = 5
    model_mode: str = "cista-lstc"
    ista_impl: str = "cuda"
    core_impl: str = "layers"
    fullres_impl: str = "ref"
    lstc_impl: str = "ref"
    io_layout: str = "full"
    quant: str = "none"
    requant_chain: bool = False
    qconv_impl: str = "cuda"

    def __post_init__(self):
        if self.model_mode not in ("cista-lstc", "cista-tc"):
            raise ValueError(
                f"model_mode must be 'cista-lstc' or 'cista-tc', got {self.model_mode!r}")
        if self.ista_impl not in ("plain", "cuda"):
            raise ValueError(f"ista_impl must be 'plain' or 'cuda', got {self.ista_impl!r}")
        if self.core_impl not in ("layers", "cuda", "plain"):
            hint = (" ('xla' and 'pallas' are the JAX package's names: 'layers' and 'cuda' "
                    "here)" if self.core_impl in ("xla", "pallas") else "")
            raise ValueError(
                f"core_impl must be 'layers', 'cuda' or 'plain', got {self.core_impl!r}{hint}"
            )
        for name, allowed in (("fullres_impl", ("ref", "fused")), ("lstc_impl", ("ref", "fused")),
                              ("io_layout", ("full", "parity")), ("quant", ("none", "int8")),
                              ("qconv_impl", ("cuda", "plain"))):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got {getattr(self, name)!r}")
        if self.model_mode == "cista-tc" and self.core_impl != "layers":
            raise ValueError(
                f"core_impl={self.core_impl!r} computes CISTA-LSTC's core (kernel K2); "
                "cista-tc runs with core_impl='layers'"
            )


class CistaState(NamedTuple):
    """Recurrent state between reconstructions: ConvLSTC ``cell`` and sparse
    code ``z`` (2C at H/2), decoder ConvLSTM ``dg = (hidden, cell)`` (C at H/2)."""

    cell: torch.Tensor
    z: torch.Tensor
    dg: tuple[torch.Tensor, torch.Tensor]


def cista_zero_state(
    cfg: CistaConfig,
    batch: int,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> CistaState:
    device = resolve_device(device)
    h2, w2 = cfg.image_dim[0] // 2, cfg.image_dim[1] // 2
    c = cfg.base_channels

    def zeros(ch):
        return torch.zeros((batch, h2, w2, ch), dtype=dtype, device=device)

    return CistaState(cell=zeros(2 * c), z=zeros(2 * c), dg=(zeros(c), zeros(c)))


# the weight-tied tensors: the reference repeats ONE IstaBlock (and, in
# CISTA-TC, one alpha), so every index names the same tensors
_TIED = ("lista_blocks.{}.D.conv2d.weight", "lista_blocks.{}.D.conv2d.bias",
         "lista_blocks.{}.P.conv2d.weight", "lista_blocks.{}.P.conv2d.bias",
         "lista_blocks.{}.Lambda")


def _random_weights(generator, cfg, device, layers, tied=_TIED) -> StateDict:
    """Draw ``layers`` in order on the CPU: ``(name, cin, cout)`` is a 3x3
    conv with torch's default init (weights and biases U(-1/sqrt(fan_in),
    1/sqrt(fan_in))), ``(name,)`` a ``[1, 2C, 1, 1]`` vector ``0.001 * U[0,
    1)``; move them to ``device`` and alias index 0 of ``tied`` for every
    index below ``cfg.depth``."""
    device = resolve_device(device)
    sd: StateDict = {}
    for name, *io in layers:
        if not io:
            sd[name] = 0.001 * torch.rand(1, 2 * cfg.base_channels, 1, 1, generator=generator)
            continue
        cin, cout = io
        bound = 1.0 / math.sqrt(cin * 9)
        sd[name + ".weight"] = torch.empty(cout, cin, 3, 3).uniform_(
            -bound, bound, generator=generator
        )
        sd[name + ".bias"] = torch.empty(cout).uniform_(-bound, bound, generator=generator)
    sd = {k: v.to(device) for k, v in sd.items()}
    for i in range(1, cfg.depth):
        for leaf in tied:
            sd[leaf.format(i)] = sd[leaf.format(0)]
    return sd


def init_cista_lstc(
    generator: torch.Generator,
    cfg: CistaConfig,
    device: torch.device | str | None = None,
) -> StateDict:
    """Random CISTA-LSTC weights with torch's default conv init and
    ``Lambda ~ 0.001 * U[0, 1)``, drawn on the CPU from ``generator`` (so a
    seed gives the same weights on every device), then moved to ``device``."""
    c = cfg.base_channels
    return _random_weights(generator, cfg, device, [
        ("We.conv2d", cfg.num_bins, c // 2), ("Wi.conv2d", 1, c // 2), ("W0.conv2d", c, c),
        ("P0.gates", c + 2 * c, 4 * c), ("P0.out_gates", 4 * c, 2 * c), ("P0.P0", c, 2 * c),
        ("lista_blocks.0.D.conv2d", 2 * c, c), ("lista_blocks.0.P.conv2d", c, 2 * c),
        ("lista_blocks.0.Lambda",), ("Dg.conv.conv2d", 2 * c, c),
        ("Dg.recurrent_block.Gates", 2 * c, 4 * c), ("upsamp_conv.conv2d", c, c),
        ("final_conv.conv2d", c, 1),
    ])


def init_cista_tc(
    generator: torch.Generator,
    cfg: CistaConfig,
    device: torch.device | str | None = None,
) -> StateDict:
    """Random CISTA-TC weights under the reference names, drawn as
    ``init_cista_lstc`` draws them, with ``alpha ~ 0.001 * U[0, 1)`` of shape
    ``[1, 2C, 1, 1]`` (one tensor for every iteration, stored as
    ``alpha.{i}``, as the reference repeats one parameter)."""
    c = cfg.base_channels
    return _random_weights(generator, cfg, device, [
        ("one_conv_for_prev.conv2d", 2 * c, 1), ("one_conv_for_cur.conv2d", 2 * c, 1),
        ("alpha.0",), ("We.conv2d", cfg.num_bins, c // 2), ("Wi.conv2d", 1, c // 2),
        ("W0.conv2d", c, c), ("P0.conv2d", c, 2 * c), ("lista_blocks.0.D.conv2d", 2 * c, c),
        ("lista_blocks.0.P.conv2d", c, 2 * c), ("lista_blocks.0.Lambda",),
        ("Dg.conv.conv2d", 2 * c, c), ("Dg.recurrent_block.Gates", 2 * c, 4 * c),
        ("upsamp_conv.conv2d", c, c), ("final_conv.conv2d", c, 1),
    ], _TIED + ("alpha.{}",))


def _conv(params: StateDict, name: str) -> dict[str, torch.Tensor]:
    return {"weight": params[name + ".weight"], "bias": params[name + ".bias"]}


def _hwio(w_oihw: torch.Tensor) -> torch.Tensor:
    return w_oihw.permute(2, 3, 1, 0)


def _heads(params: StateDict, cfg: CistaConfig, events: torch.Tensor,
           prev_image: torch.Tensor) -> torch.Tensor:
    """Event/image heads + concat + stride-2 downsample; on the 'fused' path
    one composed 5x5 stride-2 conv and its border kernels."""
    if cfg.fullres_impl == "fused":
        return heads_fused_edgek(params, events, prev_image, kernels=params.get("_fullres_fused"))
    x_e = conv_layer(events, _conv(params, "We.conv2d"), padding=1)
    x_i = conv_layer(prev_image, _conv(params, "Wi.conv2d"), padding=1)
    return conv_layer(
        torch.cat([x_e, x_i], dim=-1), _conv(params, "W0.conv2d"), stride=2, padding=1
    )


def _upsample_final(
    params: StateDict, cfg: CistaConfig, rec: torch.Tensor, upsamp_activation: str | None
) -> torch.Tensor:
    """Bilinear-upsample conv -> final conv; on the 'fused' path both in the
    parity domain (the full-res 64-channel map is never built)."""
    if cfg.fullres_impl == "fused":
        kernels = params.get("_fullres_fused")
        rec = upsample_conv_parity_edgek(_conv(params, "upsamp_conv.conv2d"), rec,
                                         activation=upsamp_activation, kernels=kernels)
        return final_conv_parity_edgek(_conv(params, "final_conv.conv2d"), rec, kernels=kernels)
    rec = upsample_conv_layer(
        rec, _conv(params, "upsamp_conv.conv2d"), activation=upsamp_activation,
        out_hw=cfg.image_dim,
    )
    return conv_layer(rec, _conv(params, "final_conv.conv2d"), padding=1)


def _lstc_params(params: StateDict) -> dict:
    return {name: _conv(params, f"P0.{name}") for name in ("gates", "out_gates", "P0")}


def half_res_core(
    params: StateDict, cfg: CistaConfig, x1: torch.Tensor, state: CistaState
) -> tuple[torch.Tensor, CistaState]:
    """The half-resolution core on the heads' output ``x1 [B, H/2, W/2, C]``:
    ConvLSTC -> ISTA x depth -> conv + relu -> ConvLSTM, as ``cfg.core_impl``
    says. Returns ``(rec_h, new_state)``, ``rec_h`` the ConvLSTM hidden."""
    if cfg.core_impl != "layers":
        # "_core_taps" is injected once per sequence (cista_sequence) or pool
        taps = params.get("_core_taps")
        if taps is None:
            taps = core_taps(params, x1.dtype)
        core = cista_core if cfg.core_impl == "cuda" else cista_core_plain
        rec_h, z, cell, dg_h, dg_c = core(
            taps, x1, state.z, state.cell, state.dg[0], state.dg[1], depth=cfg.depth
        )
        return rec_h, CistaState(cell=cell, z=z, dg=(dg_h, dg_c))
    if cfg.lstc_impl == "fused":
        # "_lstc_fused" is injected once per sequence or pool (with_derived)
        fused = params.get("_lstc_fused")
        if fused is None:
            fused = conv_lstc_fuse(_lstc_params(params))
        z, cell = conv_lstc_step_fused(fused, x1, state.z, state.cell)
    else:
        z, cell = conv_lstc_step(_lstc_params(params), x1, state.z, state.cell)
    ista = ista_loop if cfg.ista_impl == "cuda" else ista_loop_plain
    z = ista(
        x1, z.contiguous(),
        _hwio(params["lista_blocks.0.D.conv2d.weight"]), params["lista_blocks.0.D.conv2d.bias"],
        _hwio(params["lista_blocks.0.P.conv2d.weight"]), params["lista_blocks.0.P.conv2d.bias"],
        params["lista_blocks.0.Lambda"].reshape(-1), depth=cfg.depth,
    )
    x = conv_layer(z, _conv(params, "Dg.conv.conv2d"), padding=1, activation="relu")
    rec_h, dg_state = conv_lstm_step(
        {"Gates": _conv(params, "Dg.recurrent_block.Gates")}, x, state.dg
    )
    return rec_h, CistaState(cell=cell, z=z, dg=dg_state)


def cista_lstc_step(
    params: StateDict,
    cfg: CistaConfig,
    events: torch.Tensor,
    prev_image: torch.Tensor,
    state: CistaState,
) -> tuple[torch.Tensor, CistaState]:
    """One CISTA-LSTC reconstruction: heads, the half-resolution core,
    upsample conv (relu), final conv, sigmoid.

    Args:
      events: ``[B, H, W, num_bins]`` voxel grid (NHWC).
      prev_image: ``[B, H, W, 1]`` previous reconstruction.
      state: ``CistaState`` from the previous step (zeros at sequence start).
    Returns ``(rec_image [B, H, W, 1], new_state)``.
    """
    x1 = _heads(params, cfg, events, prev_image).contiguous()
    rec_h, state = half_res_core(params, cfg, x1, state)
    rec = _upsample_final(params, cfg, rec_h, upsamp_activation="relu")
    return torch.sigmoid(rec), state


def cista_lstc_step_parity(
    params: StateDict,
    cfg: CistaConfig,
    ev_parity: torch.Tensor,
    prev_parity: torch.Tensor,
    state: CistaState,
) -> tuple[torch.Tensor, CistaState]:
    """``cista_lstc_step`` with parity-packed IO (``io_layout='parity'``):
    events ``[B, H/2, W/2, 4 num_bins]`` and previous image ``[B, H/2, W/2,
    4]`` in, reconstruction ``[B, H/2, W/2, 4]`` out (``ops/fused.py``'s
    ``space_to_depth`` order), so the image feeds back without ever being
    built at full resolution. The core runs as ``cfg`` says (the JAX
    package's parity step always runs its layers core)."""
    kernels = params.get("_fullres_fused")
    x1 = heads_parity_edgek(params, ev_parity, prev_parity, kernels=kernels).contiguous()
    rec_h, state = half_res_core(params, cfg, x1, state)
    rec = upsample_conv_parity_edgek(_conv(params, "upsamp_conv.conv2d"), rec_h,
                                     activation="relu", kernels=kernels)
    rec = final_conv_parity_edgek(_conv(params, "final_conv.conv2d"), rec, kernels=kernels,
                                  packed=True)
    return torch.sigmoid(rec), state


def cista_tc_step(
    params: StateDict,
    cfg: CistaConfig,
    events: torch.Tensor,
    prev_image: torch.Tensor,
    state: CistaState,
) -> tuple[torch.Tensor, CistaState]:
    """One CISTA-TC reconstruction (reference ``e2v_model.py:146-197``).

    Arguments and results as ``cista_lstc_step``; ``state.cell`` is carried
    unchanged (the network has no ConvLSTC). ``one_conv_for_prev`` runs once
    per step on the previous code, ``one_conv_for_cur`` once per ISTA
    iteration.
    """
    x1 = _heads(params, cfg, events, prev_image)
    z = conv_layer(x1, _conv(params, "P0.conv2d"), padding=1)
    tmp = z
    prev_z = state.z
    one_ch_prev = conv_layer(prev_z, _conv(params, "one_conv_for_prev.conv2d"), padding=1)
    cur = _conv(params, "one_conv_for_cur.conv2d")
    d = _conv(params, "lista_blocks.0.D.conv2d")
    p = _conv(params, "lista_blocks.0.P.conv2d")
    lam = params["lista_blocks.0.Lambda"].reshape(-1).to(x1.dtype)
    alpha = params["alpha.0"].reshape(-1).to(x1.dtype)
    for _ in range(cfg.depth):
        one_ch_cur = conv_layer(tmp, cur, padding=1)
        attention = torch.sigmoid(one_ch_prev * one_ch_cur)
        temporal_z = attention * ((prev_z - tmp) * alpha)
        tmp = conv_layer(tmp, d, padding=1)
        x = conv_layer(x1 - tmp, p, padding=1)
        z = softshrink(x + z + temporal_z, lam)
        tmp = z
    x = conv_layer(z, _conv(params, "Dg.conv.conv2d"), padding=1, activation="relu")
    rec_h, dg_state = conv_lstm_step(
        {"Gates": _conv(params, "Dg.recurrent_block.Gates")}, x, state.dg
    )
    rec = _upsample_final(params, cfg, rec_h, upsamp_activation=None)
    return torch.sigmoid(rec), CistaState(cell=state.cell, z=z, dg=dg_state)


def _quant_params(params: StateDict, cfg: CistaConfig) -> dict:
    """The int8 weights: ``params["_quant"]`` (made once per sequence or pool
    by ``with_derived``, or injected with static scales), else made here."""
    qp = params.get("_quant")
    return qp if qp is not None else quantize_core(params, cfg.model_mode)


def cista_lstc_step_int8(
    params: StateDict,
    cfg: CistaConfig,
    events: torch.Tensor,
    prev_image: torch.Tensor,
    state: CistaState,
) -> tuple[torch.Tensor, CistaState]:
    """``cista_lstc_step`` with the half-resolution core in int8
    (``cfg.quant``): ConvLSTC, the ISTA depth loop, the decoder conv and the
    ConvLSTM through ``ops/qconv.py``; the heads and upsample/final as
    ``cfg.fullres_impl`` says.

    With ``cfg.requant_chain`` and a static scale ``s_z`` at the D site, z
    stays int8 between ISTA iterations: the D conv reads ``z_q`` as it is and
    the residual ``x + z`` reads the dequantized ``z_q * s_z``."""
    impl = cfg.qconv_impl
    qp = _quant_params(params, cfg)
    # K4 stages its float input from contiguous NHWC: x1 (a permuted NCHW
    # view from the heads' conv) feeds gates, P0 and every x1 - tmp, so it
    # is made contiguous once per step
    x1 = _heads(params, cfg, events, prev_image).contiguous()
    z, cell = qconv_lstc_step(qp["lstc"], x1, state.z, state.cell, impl=impl)
    lam = params["lista_blocks.0.Lambda"].reshape(-1).to(x1.dtype)
    s_z = qp["D"].get("s_x") if cfg.requant_chain else None
    if s_z is not None:
        dt = x1.dtype
        z_q = quantize_with(z, s_z)
        for i in range(cfg.depth):
            tmp = qconv2d_pre(z_q, s_z, qp["D"], out_dtype=dt, impl=impl)
            x = qconv2d(x1 - tmp, qp["P"], impl=impl)
            z = softshrink(x + (z_q.to(torch.float32) * s_z).to(dt), lam)
            if i + 1 < cfg.depth:
                z_q = quantize_with(z, s_z)
    else:
        tmp = z
        for _ in range(cfg.depth):
            tmp = qconv2d(tmp, qp["D"], impl=impl)
            x = qconv2d(x1 - tmp, qp["P"], impl=impl)
            z = softshrink(x + z, lam)
            tmp = z
    x = torch.relu(qconv2d(z, qp["dg_conv"], impl=impl))
    rec_h, dg_state = qconv_lstm_step(qp["lstm"], x, state.dg, impl=impl)
    rec = _upsample_final(params, cfg, rec_h, upsamp_activation="relu")
    return torch.sigmoid(rec), CistaState(cell=cell, z=z, dg=dg_state)


def cista_tc_step_int8(
    params: StateDict,
    cfg: CistaConfig,
    events: torch.Tensor,
    prev_image: torch.Tensor,
    state: CistaState,
) -> tuple[torch.Tensor, CistaState]:
    """``cista_tc_step`` with the wide core convs in int8 (``cfg.quant``): the
    plain-conv ``P0``, the ISTA pair, the decoder conv and the ConvLSTM
    gates. The one-channel attention projections, ``alpha``, the heads and
    upsample/final stay float."""
    impl = cfg.qconv_impl
    qp = _quant_params(params, cfg)
    x1 = _heads(params, cfg, events, prev_image).contiguous()  # as in cista_lstc_step_int8
    z = qconv2d(x1, qp["P0"], impl=impl)
    tmp = z
    prev_z = state.z
    one_ch_prev = conv_layer(prev_z, _conv(params, "one_conv_for_prev.conv2d"), padding=1)
    cur = _conv(params, "one_conv_for_cur.conv2d")
    lam = params["lista_blocks.0.Lambda"].reshape(-1).to(x1.dtype)
    alpha = params["alpha.0"].reshape(-1).to(x1.dtype)
    for _ in range(cfg.depth):
        one_ch_cur = conv_layer(tmp, cur, padding=1)
        attention = torch.sigmoid(one_ch_prev * one_ch_cur)
        temporal_z = attention * ((prev_z - tmp) * alpha)
        tmp = qconv2d(tmp, qp["D"], impl=impl)
        x = qconv2d(x1 - tmp, qp["P"], impl=impl)
        z = softshrink(x + z + temporal_z, lam)
        tmp = z
    x = torch.relu(qconv2d(z, qp["dg_conv"], impl=impl))
    rec_h, dg_state = qconv_lstm_step(qp["lstm"], x, state.dg, impl=impl)
    rec = _upsample_final(params, cfg, rec_h, upsamp_activation=None)
    return torch.sigmoid(rec), CistaState(cell=state.cell, z=z, dg=dg_state)


def get_step_fn(cfg: CistaConfig):
    """The step of ``cfg.model_mode`` and ``cfg.quant`` (``CistaConfig``
    admits no other)."""
    if cfg.model_mode == "cista-tc":
        return cista_tc_step_int8 if cfg.quant == "int8" else cista_tc_step
    return cista_lstc_step_int8 if cfg.quant == "int8" else cista_lstc_step


def int8_static_drift_check(
    params: StateDict,
    cfg: CistaConfig,
    events: torch.Tensor,
    prev_image: torch.Tensor,
    state: CistaState,
    budget: float = 0.01,
) -> tuple[float, bool]:
    """Run ``events`` through the float step and the int8 step with whatever
    ``params["_quant"]`` carries (static scales after calibration) and
    compare the reconstructions: returns ``(delta, delta <= budget)``, where
    ``delta = 1 - mean over the batch of SSIM(float, int8)`` (float64 SSIM,
    ``utils/evaluate.ssim``). Saturated static scales show up as structural
    damage; callers then keep the dynamic scales."""
    import dataclasses

    import numpy as np

    from ..utils.evaluate import ssim

    cfg_f = dataclasses.replace(cfg, quant="none")
    with torch.no_grad():
        rec_f, _ = get_step_fn(cfg_f)(params, cfg_f, events, prev_image, state)
        rec_q, _ = get_step_fn(cfg)(params, cfg, events, prev_image, state)
    a = rec_f[..., 0].to(torch.float32).cpu().numpy()
    b = rec_q[..., 0].to(torch.float32).cpu().numpy()
    delta = 1.0 - float(np.mean([ssim(a[i], b[i]) for i in range(a.shape[0])]))
    return delta, delta <= budget


def remat_step(step, params: StateDict, cfg: CistaConfig, events: torch.Tensor,
               prev_image: torch.Tensor, state: CistaState) -> tuple[torch.Tensor, CistaState]:
    """``step(params, cfg, events, prev_image, state)`` rematerialised on the
    backward pass (the JAX package's ``jax.checkpoint``): autograd keeps the
    step's inputs, not its activations, and runs the step again to
    differentiate it. The step draws no random numbers, so the RNG state is
    not saved (``preserve_rng_state=False``); callers keep every draw outside."""
    return torch.utils.checkpoint.checkpoint(
        step, params, cfg, events, prev_image, state, use_reentrant=False,
        preserve_rng_state=False,
    )


def tie_weights(params: StateDict, cfg: CistaConfig) -> StateDict:
    """The state dict with every ``depth`` index of the weight-tied tensors
    (the ISTA block, and CISTA-TC's ``alpha``) naming index 0's tensor, as
    ``init_cista_lstc`` makes them: a loaded checkpoint holds one copy per
    index, and training must update the one tensor the steps read."""
    tied = _TIED + (("alpha.{}",) if cfg.model_mode == "cista-tc" else ())
    params = dict(params)
    for i in range(1, cfg.depth):
        for leaf in tied:
            params[leaf.format(i)] = params[leaf.format(0)]
    return params


# entries a step derives from the weights, made once per sequence or pool
# (never written to a checkpoint: utils/checkpoint.save_checkpoint)
DERIVED = ("_core_taps", "_fullres_fused", "_lstc_fused", "_quant")


def with_derived(params: StateDict, cfg: CistaConfig, dtype: torch.dtype) -> StateDict:
    """``params`` with the entries ``cfg``'s steps read instead of computing
    them per step, each made once from the weights for activations of
    ``dtype``: kernel K2's taps (``core_impl`` other than 'layers'), the
    fused full-resolution kernels (``fullres_impl='fused'``), the fused
    ConvLSTC kernels (CISTA-LSTC, ``lstc_impl='fused'``) and, with
    ``quant='int8'``, the int8 weights (``ops/qconv.quantize_core``, from the
    weights as given, in float32), unless the caller injected ``_quant`` (a
    pool's, or one with calibrated static scales), which is kept. The float
    entries are differentiable: a loss over the steps reaches the weights
    through them."""
    quant = params.get("_quant")
    params = {k: v for k, v in params.items() if k not in DERIVED}
    if cfg.quant == "int8":
        params["_quant"] = quant if quant is not None else quantize_core(params, cfg.model_mode)
    else:
        if cfg.model_mode == "cista-lstc" and cfg.lstc_impl == "fused":
            params["_lstc_fused"] = conv_lstc_fuse(_lstc_params(params))
        if cfg.core_impl != "layers":
            params["_core_taps"] = core_taps(params, dtype)
    if cfg.fullres_impl == "fused":
        params["_fullres_fused"] = precompute_fused_kernels(params, dtype)
    return params


def parity_io(cfg: CistaConfig) -> bool:
    """Whether ``cista_sequence`` runs ``cfg`` with parity-packed IO: the JAX
    package's conditions (CISTA-LSTC, float, ``fullres_impl='fused'``, even
    H and W; the int8 step has no parity form); ``io_layout='parity'``
    otherwise runs 'full'."""
    return (cfg.io_layout == "parity" and cfg.model_mode == "cista-lstc"
            and cfg.quant == "none" and cfg.fullres_impl == "fused"
            and cfg.image_dim[0] % 2 == 0 and cfg.image_dim[1] % 2 == 0)


def cista_sequence(
    params: StateDict,
    cfg: CistaConfig,
    voxel_seq: torch.Tensor,
    prev_image: torch.Tensor | None = None,
    state: CistaState | None = None,
    remat: bool = False,
    input_packed: bool = False,
) -> tuple[torch.Tensor, CistaState]:
    """Reconstruct ``voxel_seq [T, B, H, W, num_bins]`` step by step, feeding
    each output back as the next ``prev_image``. The derived kernels
    (``with_derived``) are made once, outside the steps. With ``remat`` each
    step is rematerialised on the backward pass (``remat_step``):
    backpropagation through time keeps the per-step carries, not every conv
    activation; the values and gradients are the same.

    With parity IO (``parity_io(cfg)``) the sequence and the feedback image
    are packed once (``space_to_depth``) and every step runs
    ``cista_lstc_step_parity``. ``input_packed`` (parity IO only, else a
    ``ValueError``) takes ``voxel_seq`` as the producer's parity layout
    ``[T, B, H/2, W/2, 4 num_bins]`` (``ops/voxel.events_to_voxel_grid(...,
    layout='parity')``) and ``prev_image``, if given, as ``[B, H/2, W/2, 4]``.
    Returns ``(recs [T, B, H, W, 1], final_state)`` on ``voxel_seq``'s
    device."""
    t, b = voxel_seq.shape[0], voxel_seq.shape[1]
    h, w = cfg.image_dim
    packed_io = parity_io(cfg)
    if input_packed and not packed_io:
        raise ValueError("input_packed requires io_layout='parity'")
    if state is None:
        state = cista_zero_state(cfg, b, voxel_seq.dtype, voxel_seq.device)
    if prev_image is None:
        prev_image = voxel_seq.new_zeros((b, h // 2, w // 2, 4) if input_packed else (b, h, w, 1))
    params = with_derived(params, cfg, voxel_seq.dtype)
    if packed_io:
        if not input_packed:
            # pack the whole sequence and the feedback image once
            voxel_seq = space_to_depth(voxel_seq.reshape(t * b, h, w, cfg.num_bins)).reshape(
                t, b, h // 2, w // 2, 4 * cfg.num_bins)
            prev_image = space_to_depth(prev_image)
        step = cista_lstc_step_parity
    else:
        step = get_step_fn(cfg)
    recs = []
    for events in voxel_seq:
        if remat:
            prev_image, state = remat_step(step, params, cfg, events, prev_image, state)
        else:
            prev_image, state = step(params, cfg, events, prev_image, state)
        recs.append(prev_image)
    recs = torch.stack(recs)
    if packed_io:
        recs = depth_to_space(recs.reshape(t * b, h // 2, w // 2, 4)).reshape(t, b, h, w, 1)
    return recs, state
