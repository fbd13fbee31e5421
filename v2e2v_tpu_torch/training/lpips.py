"""LPIPS (Learned Perceptual Image Patch Similarity) with a VGG16 trunk, the
port of ``v2e2v_tpu/training/lpips_jax.py``.

The reference reports ``lpips.LPIPS(net='vgg')`` with ``normalize=True`` and
trains on it (``LPIPS + L1 + (1 - SSIM)``): an input in [-1, 1] is shifted
and scaled per channel, runs through VGG16's thirteen 3x3 convs (each with a
ReLU, 2x2 max pools between the five blocks), and is tapped at the end of
each block (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3). Each tap is
normalised to unit length over its channels, the two images' squared
difference is weighted per channel by a non-negative 1x1 head and averaged
over space, and the five layers are summed.

Weights are not in the repository. ``V2E2V_LPIPS_WEIGHTS`` names a torch file,
read as the JAX loader reads it: either ``{'vgg': the features' state dict,
'lin': the heads' state dict}`` (heads ``lin{i}.model.1.weight``), or a bare
torchvision ``vgg16`` checkpoint (``features.N.*``), whose heads are then
uniform, ``1 / C``. ``available()`` says whether that file is there; the CLIs
report NaN for LPIPS without it and train with ``L1 + (1 - SSIM)``.

The convs are cuDNN's (``F.conv2d``), as the JAX package computes them with
``lax.conv_general_dilated`` outside any Pallas kernel; they run in float32
with TF32 off (``_device.float32_math``). The public functions take NHWC
images, as the rest of the port; the trunk runs NCHW.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from .._device import float32_math

# VGG16's conv plan: (out_channels, convs) per block; a tap after each block
_VGG_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
TAPS = [c for c, _ in _VGG_BLOCKS]

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

_ENV_VAR = "V2E2V_LPIPS_WEIGHTS"

Params = dict  # {"convs": [{"weight": [O, I, 3, 3], "bias": [O]}] x 13, "lins": [[C]] x 5}


def available() -> bool:
    """Whether ``V2E2V_LPIPS_WEIGHTS`` names an existing file."""
    path = os.environ.get(_ENV_VAR)
    return bool(path) and os.path.exists(path)


def _numpy(v) -> np.ndarray:
    return v.numpy() if hasattr(v, "numpy") else np.asarray(v)


def _convs_from_features(sd: dict) -> list[dict]:
    """VGG16 ``features`` state dict (``N.weight``, ``N.bias``) -> the
    thirteen convs in the order of their layer index."""
    keys = sorted({int(k.split(".")[0]) for k in sd if k.endswith("weight")})
    return [{"weight": torch.from_numpy(np.array(_numpy(sd[f"{k}.weight"]), np.float32)),
             "bias": torch.from_numpy(np.array(_numpy(sd[f"{k}.bias"]), np.float32))}
            for k in keys]


def load_params(path: str | None = None, device: torch.device | str = "cpu") -> Params:
    """LPIPS weights from the torch file at ``path`` (default
    ``$V2E2V_LPIPS_WEIGHTS``), in either layout of the module's notes, as
    float32 tensors on ``device``. The file is read with
    ``weights_only=False``, as the JAX loader reads it (a state dict may hold
    numpy arrays, which the restricted unpickler refuses): load only files
    you trust."""
    path = path or os.environ.get(_ENV_VAR)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "vgg" in ckpt:
        vgg_sd, lin_sd = ckpt["vgg"], ckpt.get("lin")
    else:  # a bare torchvision vgg16 checkpoint
        vgg_sd = {k[len("features."):]: v for k, v in ckpt.items() if k.startswith("features.")}
        lin_sd = None
    convs = _convs_from_features(vgg_sd)
    if lin_sd is not None:
        lins = [torch.from_numpy(np.array(_numpy(lin_sd[f"lin{i}.model.1.weight"]),
                                          np.float32).reshape(-1)) for i in range(len(TAPS))]
    else:
        lins = [torch.full((c,), 1.0 / c, dtype=torch.float32) for c in TAPS]
    return to_device({"convs": convs, "lins": lins}, device)


def from_jax_params(jax_params: dict, device: torch.device | str = "cpu") -> Params:
    """``lpips_jax``'s parameters (``{"convs": [{"weight": HWIO, "bias"}],
    "lins": [[C]]}``, numpy or JAX arrays) -> the port's, on ``device``."""
    convs = [{"weight": torch.from_numpy(np.ascontiguousarray(
                  np.transpose(np.asarray(p["weight"], np.float32), (3, 2, 0, 1)))),
              "bias": torch.from_numpy(np.array(p["bias"], np.float32))}
             for p in jax_params["convs"]]
    lins = [torch.from_numpy(np.array(w, np.float32).reshape(-1)) for w in jax_params["lins"]]
    return to_device({"convs": convs, "lins": lins}, device)


def to_device(params: Params, device: torch.device | str) -> Params:
    return {"convs": [{k: v.to(device) for k, v in p.items()} for p in params["convs"]],
            "lins": [w.to(device) for w in params["lins"]]}


def vgg_features(params: Params, x: torch.Tensor) -> list[torch.Tensor]:
    """``x`` NCHW in [-1, 1] -> the five tapped feature maps (NCHW), as
    ``lpips_jax._vgg_features``: the 2x2 stride-2 pools floor odd sizes."""
    shift = torch.from_numpy(_SHIFT).to(x.device).view(1, 3, 1, 1)
    scale = torch.from_numpy(_SCALE).to(x.device).view(1, 3, 1, 1)
    x = (x - shift) / scale
    feats, ci = [], 0
    for block, (_, n_convs) in enumerate(_VGG_BLOCKS):
        for _ in range(n_convs):
            p = params["convs"][ci]
            ci += 1
            x = F.relu(F.conv2d(x, p["weight"], p["bias"], padding=1))
        feats.append(x)
        if block < len(_VGG_BLOCKS) - 1:
            x = F.max_pool2d(x, 2, 2)
    return feats


def _unit_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + 1e-10)


def lpips_per_sample(params: Params, pred: torch.Tensor, target: torch.Tensor,
                     normalize: bool = True) -> torch.Tensor:
    """Each sample's LPIPS distance ``[B]``; ``pred``, ``target`` ``[B, H, W,
    1 or 3]`` (gray tiled to three channels; ``normalize`` maps [0, 1] to
    [-1, 1]). Both images run through the trunk as one batch."""
    def nchw(img):
        img = img.permute(0, 3, 1, 2)
        if img.shape[1] == 1:
            img = img.expand(-1, 3, -1, -1)
        return 2 * img - 1 if normalize else img

    b = pred.shape[0]
    with float32_math():
        feats = vgg_features(params, torch.cat([nchw(pred), nchw(target)]))
        total = 0.0
        for f, lin in zip(feats, params["lins"]):
            d = (_unit_normalize(f[:b]) - _unit_normalize(f[b:])) ** 2
            layer = torch.sum(d * lin.view(1, -1, 1, 1), dim=1)  # the 1x1 head
            total = total + torch.mean(layer, dim=(1, 2))
    return total


def lpips_distance(params: Params, pred: torch.Tensor, target: torch.Tensor,
                   normalize: bool = True) -> torch.Tensor:
    """The batch's mean LPIPS distance (``lpips_jax.lpips_distance``)."""
    return torch.mean(lpips_per_sample(params, pred, target, normalize))


class Lpips:
    """``fn(pred, target) -> scalar``, the batch mean with ``normalize=True``;
    ``per_sample`` gives ``[B]``. The weights are frozen: no gradient is
    taken for them."""

    def __init__(self, params: Params):
        self.params = params

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return lpips_distance(self.params, pred, target)

    def per_sample(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return lpips_per_sample(self.params, pred, target)


def make_lpips_fn(path: str | None = None, device: torch.device | str | None = None):
    """An ``Lpips`` on ``device`` (None: the card) from ``path`` or
    ``$V2E2V_LPIPS_WEIGHTS``, or None when neither names weights
    (``lpips_jax.make_lpips_fn``)."""
    from .._device import resolve_device

    if path is None and not available():
        return None
    return Lpips(load_params(path, resolve_device(device)))
