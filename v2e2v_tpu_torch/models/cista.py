"""CISTA-LSTC events-to-video reconstruction (port of ``v2e2v_tpu/models/cista.py``).

Reference network ``CistaLSTCNet`` (lsying009/V2E2V ``e2v/e2v_model.py``):
event/image heads -> stride-2 downsample -> ConvLSTC sparse-code init ->
``depth`` weight-tied ISTA iterations -> ConvLSTM decoder -> bilinear
upsample conv -> final conv -> sigmoid. The full-resolution convs follow the
JAX package's ``fullres_impl='ref'`` path; the ISTA loop is kernel K1
(``ops/cuda/ista.py``) or its plain version.

Weights are a flat state dict under the reference module names (see
``utils/checkpoint.py``); activations are NHWC, as in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from .._device import resolve_device
from ..ops.conv import conv_layer, conv_lstc_step, conv_lstm_step, upsample_conv_layer
from ..ops.cuda.ista import ista_loop, ista_loop_plain

StateDict = dict[str, torch.Tensor]


@dataclass(frozen=True)
class CistaConfig:
    """The parts of the JAX ``CistaConfig`` that CISTA-LSTC uses.

    ``image_dim`` is (H, W) of the voxel grid (even). ``ista_impl``: 'cuda'
    (kernel K1 for CUDA tensors; its plain version for CPU tensors) or
    'plain' (the plain version on any device).
    """

    image_dim: tuple[int, int] = (180, 240)
    base_channels: int = 64
    depth: int = 5
    num_bins: int = 5
    model_mode: str = "cista-lstc"
    ista_impl: str = "cuda"

    def __post_init__(self):
        if self.ista_impl not in ("plain", "cuda"):
            raise ValueError(f"ista_impl must be 'plain' or 'cuda', got {self.ista_impl!r}")


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


def init_cista_lstc(
    generator: torch.Generator,
    cfg: CistaConfig,
    device: torch.device | str | None = None,
) -> StateDict:
    """Random CISTA-LSTC weights with torch's default conv init
    (U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights and biases) and
    ``Lambda ~ 0.001 * U[0, 1)``, drawn on the CPU from ``generator`` (so a
    seed gives the same weights on every device), then moved to ``device``."""
    device = resolve_device(device)
    c = cfg.base_channels
    sd: StateDict = {}

    def conv(name, cin, cout, k=3):
        bound = 1.0 / math.sqrt(cin * k * k)
        sd[name + ".weight"] = torch.empty(cout, cin, k, k).uniform_(
            -bound, bound, generator=generator
        )
        sd[name + ".bias"] = torch.empty(cout).uniform_(-bound, bound, generator=generator)

    conv("We.conv2d", cfg.num_bins, c // 2)
    conv("Wi.conv2d", 1, c // 2)
    conv("W0.conv2d", c, c)
    conv("P0.gates", c + 2 * c, 4 * c)
    conv("P0.out_gates", 4 * c, 2 * c)
    conv("P0.P0", c, 2 * c)
    conv("lista_blocks.0.D.conv2d", 2 * c, c)
    conv("lista_blocks.0.P.conv2d", c, 2 * c)
    sd["lista_blocks.0.Lambda"] = 0.001 * torch.rand(1, 2 * c, 1, 1, generator=generator)
    conv("Dg.conv.conv2d", 2 * c, c)
    conv("Dg.recurrent_block.Gates", 2 * c, 4 * c)
    conv("upsamp_conv.conv2d", c, c)
    conv("final_conv.conv2d", c, 1)
    sd = {k: v.to(device) for k, v in sd.items()}
    # the reference repeats ONE IstaBlock: every index names the same tensors
    for i in range(1, cfg.depth):
        for leaf in ("D.conv2d.weight", "D.conv2d.bias", "P.conv2d.weight",
                     "P.conv2d.bias", "Lambda"):
            sd[f"lista_blocks.{i}.{leaf}"] = sd[f"lista_blocks.0.{leaf}"]
    return sd


def _conv(params: StateDict, name: str) -> dict[str, torch.Tensor]:
    return {"weight": params[name + ".weight"], "bias": params[name + ".bias"]}


def _hwio(w_oihw: torch.Tensor) -> torch.Tensor:
    return w_oihw.permute(2, 3, 1, 0)


def _heads(params: StateDict, events: torch.Tensor, prev_image: torch.Tensor) -> torch.Tensor:
    """Event/image heads + concat + stride-2 downsample."""
    x_e = conv_layer(events, _conv(params, "We.conv2d"), padding=1)
    x_i = conv_layer(prev_image, _conv(params, "Wi.conv2d"), padding=1)
    return conv_layer(
        torch.cat([x_e, x_i], dim=-1), _conv(params, "W0.conv2d"), stride=2, padding=1
    )


def _upsample_final(
    params: StateDict, cfg: CistaConfig, rec: torch.Tensor, upsamp_activation: str | None
) -> torch.Tensor:
    rec = upsample_conv_layer(
        rec, _conv(params, "upsamp_conv.conv2d"), activation=upsamp_activation,
        out_hw=cfg.image_dim,
    )
    return conv_layer(rec, _conv(params, "final_conv.conv2d"), padding=1)


def _decode(params: StateDict, cfg: CistaConfig, z: torch.Tensor, dg_state):
    """Decoder: conv+relu -> ConvLSTM -> upsample conv (relu) -> final conv
    -> sigmoid."""
    x = conv_layer(z, _conv(params, "Dg.conv.conv2d"), padding=1, activation="relu")
    rec, dg_state = conv_lstm_step(
        {"Gates": _conv(params, "Dg.recurrent_block.Gates")}, x, dg_state
    )
    rec = _upsample_final(params, cfg, rec, upsamp_activation="relu")
    return torch.sigmoid(rec), dg_state


def cista_lstc_step(
    params: StateDict,
    cfg: CistaConfig,
    events: torch.Tensor,
    prev_image: torch.Tensor,
    state: CistaState,
) -> tuple[torch.Tensor, CistaState]:
    """One CISTA-LSTC reconstruction.

    Args:
      events: ``[B, H, W, num_bins]`` voxel grid (NHWC).
      prev_image: ``[B, H, W, 1]`` previous reconstruction.
      state: ``CistaState`` from the previous step (zeros at sequence start).
    Returns ``(rec_image [B, H, W, 1], new_state)``.
    """
    x1 = _heads(params, events, prev_image).contiguous()
    z, cell = conv_lstc_step(
        {name: _conv(params, f"P0.{name}") for name in ("gates", "out_gates", "P0")},
        x1, state.z, state.cell,
    )
    ista = ista_loop if cfg.ista_impl == "cuda" else ista_loop_plain
    z = ista(
        x1, z.contiguous(),
        _hwio(params["lista_blocks.0.D.conv2d.weight"]), params["lista_blocks.0.D.conv2d.bias"],
        _hwio(params["lista_blocks.0.P.conv2d.weight"]), params["lista_blocks.0.P.conv2d.bias"],
        params["lista_blocks.0.Lambda"].reshape(-1), depth=cfg.depth,
    )
    rec, dg_state = _decode(params, cfg, z, state.dg)
    return rec, CistaState(cell=cell, z=z, dg=dg_state)


def get_step_fn(cfg: CistaConfig):
    if cfg.model_mode == "cista-lstc":
        return cista_lstc_step
    if cfg.model_mode == "cista-tc":
        raise NotImplementedError("cista-tc is not ported yet")
    raise ValueError(f"model_mode must be 'cista-lstc' or 'cista-tc', got {cfg.model_mode!r}")


def cista_sequence(
    params: StateDict,
    cfg: CistaConfig,
    voxel_seq: torch.Tensor,
    prev_image: torch.Tensor | None = None,
    state: CistaState | None = None,
) -> tuple[torch.Tensor, CistaState]:
    """Reconstruct ``voxel_seq [T, B, H, W, num_bins]`` step by step, feeding
    each output back as the next ``prev_image``. Returns
    ``(recs [T, B, H, W, 1], final_state)`` on ``voxel_seq``'s device."""
    b = voxel_seq.shape[1]
    if state is None:
        state = cista_zero_state(cfg, b, voxel_seq.dtype, voxel_seq.device)
    if prev_image is None:
        prev_image = voxel_seq.new_zeros((b, cfg.image_dim[0], cfg.image_dim[1], 1))
    step = get_step_fn(cfg)
    recs = []
    for events in voxel_seq:
        prev_image, state = step(params, cfg, events, prev_image, state)
        recs.append(prev_image)
    return torch.stack(recs), state
