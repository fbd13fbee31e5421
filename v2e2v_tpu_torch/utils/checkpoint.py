"""Weights between the JAX package's parameter tree and the port's state dict.

The port keeps CISTA-LSTC and CISTA-TC weights as a flat state dict under the
reference torch module names (OIHW convs, ``Lambda`` and ``alpha`` as
``[1, 2C, 1, 1]``), so a reference ``.pth.tar`` state dict and the port's
weights are one format. This module keeps the port's own copy of
``export_torch_state_dict`` from ``v2e2v_tpu/utils/checkpoint.py``, loads
reference checkpoints (``load_torch_checkpoint``) and writes them
(``save_checkpoint``): the port's trainers save the reference's ``.pth.tar``
where the JAX trainers save orbax directories, so one file serves the port's
CLIs, the JAX package's ``load_torch_checkpoint`` and a resumed run.
The Super-SloMo UNets keep the original checkpoint's names too
(``unet_state_dict_from_jax``, ``load_superslomo_checkpoint``).
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import numpy as np
import torch

from ..ops.conv import hwio_to_torch_conv


def export_torch_state_dict(params: Mapping[str, Any], depth: int = 5,
                            model_mode: str = "cista-lstc") -> dict[str, np.ndarray]:
    """JAX-layout parameter tree (numpy, HWIO) -> reference-named numpy
    state dict. The weight-tied ISTA block (and CISTA-TC's one ``alpha``)
    appears under every index ``i < depth``, as torch's ``state_dict`` lists
    it."""

    def conv_out(p, prefix, sd):
        sd[prefix + ".weight"] = hwio_to_torch_conv(np.asarray(p["weight"]))
        if "bias" in p:
            sd[prefix + ".bias"] = np.asarray(p["bias"])

    if model_mode not in ("cista-lstc", "cista-tc"):
        raise ValueError(f"unknown model_mode {model_mode!r}")
    sd: dict[str, np.ndarray] = {}
    conv_out(params["We"], "We.conv2d", sd)
    conv_out(params["Wi"], "Wi.conv2d", sd)
    conv_out(params["W0"], "W0.conv2d", sd)
    for i in range(depth):
        conv_out(params["lista"]["D"], f"lista_blocks.{i}.D.conv2d", sd)
        conv_out(params["lista"]["P"], f"lista_blocks.{i}.P.conv2d", sd)
        sd[f"lista_blocks.{i}.Lambda"] = np.asarray(params["lista"]["Lambda"]).reshape(
            1, -1, 1, 1
        )
    conv_out(params["Dg"]["conv"], "Dg.conv.conv2d", sd)
    conv_out(params["Dg"]["lstm"]["Gates"], "Dg.recurrent_block.Gates", sd)
    conv_out(params["upsamp_conv"], "upsamp_conv.conv2d", sd)
    conv_out(params["final_conv"], "final_conv.conv2d", sd)
    if model_mode == "cista-lstc":
        conv_out(params["P0"]["gates"], "P0.gates", sd)
        conv_out(params["P0"]["out_gates"], "P0.out_gates", sd)
        conv_out(params["P0"]["P0"], "P0.P0", sd)
    else:
        conv_out(params["P0"], "P0.conv2d", sd)
        conv_out(params["one_conv_for_prev"], "one_conv_for_prev.conv2d", sd)
        conv_out(params["one_conv_for_cur"], "one_conv_for_cur.conv2d", sd)
        for i in range(depth):
            sd[f"alpha.{i}"] = np.asarray(params["alpha"]).reshape(1, -1, 1, 1)
    return sd


def params_from_jax(params_np: Mapping[str, Any], depth: int = 5,
                    model_mode: str = "cista-lstc") -> dict[str, torch.Tensor]:
    """JAX parameter tree (as numpy) -> the port's state dict of float32 CPU
    tensors. Move it to a device with the model's entry points."""
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32))
        for k, v in export_torch_state_dict(params_np, depth, model_mode).items()
    }


_UNET_CONVS = ("conv1", "conv2", "conv3") + tuple(
    f"{block}.{conv}" for block in ("down1", "down2", "down3", "down4", "down5",
                                    "up1", "up2", "up3", "up4", "up5")
    for conv in ("conv1", "conv2"))


def unet_state_dict_from_jax(params_np: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A Super-SloMo UNet's JAX parameter tree (numpy, HWIO) -> the port's
    ``UNet`` state dict (OIHW, the original checkpoint's names) of float32
    CPU tensors; the inverse of the JAX package's ``_convert_unet_sd``."""
    sd = {}
    for name in _UNET_CONVS:
        p = params_np
        for part in name.split("."):
            p = p[part]
        sd[name + ".weight"] = torch.from_numpy(
            np.array(hwio_to_torch_conv(np.asarray(p["weight"])), dtype=np.float32))
        sd[name + ".bias"] = torch.from_numpy(np.array(p["bias"], dtype=np.float32))
    return sd


def load_superslomo_checkpoint(path: str) -> tuple[dict, dict]:
    """The flow net's and the interpolation net's state dicts (float32 CPU
    tensors) from the public ``SuperSloMo.ckpt`` (``{"state_dictFC": ...,
    "state_dictAT": ...}``), read as the JAX package reads it."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return tuple({k: torch.as_tensor(v).detach().to(torch.float32) for k, v in ckpt[key].items()}
                 for key in ("state_dictFC", "state_dictAT"))


def _step_keys(convs: tuple[str, ...], vectors: tuple[str, ...]) -> tuple[str, ...]:
    return tuple(f"{name}.{leaf}" for name in convs for leaf in ("weight", "bias")) + vectors


_SHARED = ("We.conv2d", "Wi.conv2d", "W0.conv2d", "lista_blocks.0.D.conv2d",
           "lista_blocks.0.P.conv2d", "Dg.conv.conv2d", "Dg.recurrent_block.Gates",
           "upsamp_conv.conv2d", "final_conv.conv2d")
# the tensors a step reads (the tied ISTA block and alpha under index 0)
STEP_KEYS = {
    "cista-lstc": _step_keys(_SHARED + ("P0.gates", "P0.out_gates", "P0.P0"),
                             ("lista_blocks.0.Lambda",)),
    "cista-tc": _step_keys(_SHARED + ("P0.conv2d", "one_conv_for_prev.conv2d",
                                      "one_conv_for_cur.conv2d"),
                           ("lista_blocks.0.Lambda", "alpha.0")),
}


def load_torch_checkpoint(path: str, model_mode: str = "cista-lstc"):
    """Load a reference ``.pth.tar`` checkpoint (``{epoch, state_dict,
    v2e_params}`` or a bare state dict) of ``model_mode`` ('cista-lstc' or
    'cista-tc') as ``(state_dict, epoch, v2e_params or None)``, the state
    dict float32 CPU tensors under the reference names. A V2E2V checkpoint's
    ``e2v_net.`` prefix is stripped, as the JAX package's loader strips it."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (a JAX/orbax checkpoint?): the port loads torch "
            "checkpoints only; export the parameters to a .pth.tar with "
            "v2e2v_tpu.utils.checkpoint.export_torch_state_dict and torch.save"
        )
    if model_mode not in STEP_KEYS:
        raise ValueError(f"model_mode must be 'cista-lstc' or 'cista-tc', got {model_mode!r}")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    if any(k.startswith("e2v_net.") for k in sd):
        sd = {k[len("e2v_net."):]: v for k, v in sd.items() if k.startswith("e2v_net.")}
    missing = [k for k in STEP_KEYS[model_mode] if k not in sd]
    if missing:
        raise KeyError(f"{path}: not a {model_mode} checkpoint, missing {missing}")
    sd = {k: torch.as_tensor(v).detach().to(torch.float32) for k, v in sd.items()}
    return sd, ckpt.get("epoch", 0), ckpt.get("v2e_params")


def checkpoint_name(cfgs) -> str:
    """E2V checkpoint naming convention (reference ``train_e2v.py:35-36``)."""
    return "{}_{}_b{}_d{}_c{}".format(
        cfgs.model_name, cfgs.model_mode, cfgs.num_bins, cfgs.depth, cfgs.base_channels
    )


def v2e2v_checkpoint_name(cfgs) -> str:
    """V2E2V naming convention encoding the emulator parameters (reference
    ``train.py:34-35``)."""
    return "{}_C{}_{}_{}_fc{}_{}_{}".format(
        cfgs.model_name, cfgs.C, cfgs.pl, cfgs.ps, cfgs.cutoff_hz, cfgs.ql, cfgs.qs
    )


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(path: str, state_dict: Mapping[str, torch.Tensor], epoch: int,
                    optimizer: torch.optim.Optimizer | None = None,
                    v2e_params: Mapping[str, float] | None = None, prefix: str = "") -> None:
    """Write a reference ``.pth.tar``: ``{epoch, state_dict, optimizer?,
    v2e_params?}``. The state dict is float32 CPU tensors under the reference
    names with ``prefix`` (``"e2v_net."`` for a V2E2V checkpoint, as the
    reference's composite names its net), every ``depth`` index of the tied
    weights included; ``optimizer`` is ``optimizer.state_dict()`` on the CPU
    (the Adam moments, for ``load_optimizer_state`` on resume). The entries a
    step derives from the weights (``_``-prefixed: K2's taps, the fused
    kernels; ``models/cista.with_derived``) are not written."""
    payload: dict[str, Any] = {
        "epoch": epoch,
        "state_dict": {prefix + k: v.detach().to("cpu", torch.float32)
                       for k, v in state_dict.items() if not k.startswith("_")},
    }
    if optimizer is not None:
        payload["optimizer"] = _to_cpu(optimizer.state_dict())
    if v2e_params is not None:
        payload["v2e_params"] = dict(v2e_params)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(payload, path)


def load_optimizer_state(path: str) -> dict | None:
    """The ``optimizer`` entry of a checkpoint ``save_checkpoint`` wrote (None
    when it has none, as the reference's checkpoints), for
    ``Optimizer.load_state_dict``, which moves it to the parameters' device."""
    return torch.load(path, map_location="cpu", weights_only=False).get("optimizer")
