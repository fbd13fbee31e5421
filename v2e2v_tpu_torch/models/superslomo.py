"""Super-SloMo frame interpolation, the adaptive upsampler (port of
``v2e2v_tpu/models/superslomo.py``).

- ``UNet(in, out)``: a 7x7/7x7 stem, five ``down`` blocks (2x2 average pool,
  then two convs: 5x5 in ``down1``, 3x3 after), five ``up`` blocks (bilinear
  2x with ``align_corners=True``, a conv, the skip concat, a conv) and
  ``conv3``; leaky ReLU 0.1 after every conv, the output conv's included.
  Submodule names are the original checkpoint's, so its ``state_dictFC``
  (the flow net, ``UNet(6, 4)``) and ``state_dictAT`` (the interpolation
  net, ``UNet(20, 5)``) load with ``load_state_dict``. Convs pad with zeros,
  and run on cuDNN in float32 with TF32 off (``Upsampler`` sees to it).
- ``backwarp``: bilinear warp of an image by a flow with zeros outside, the
  JAX package's arithmetic, grid quirk included (the reference normalises by
  W, not W - 1, so the sample point is ``(x + u) * (W - 1) / W``).
- ``flow_pair`` and ``interp_at_t``: the bidirectional flow of a frame pair,
  and one intermediate frame at time ``t`` (warp, refinement UNet,
  visibility-weighted blend).
- ``Upsampler.upsampling``: per adjacent frame pair, the flow, the adaptive
  count ``ceil(max |flow|)`` (one host read per pair), ``count - 1``
  intermediate frames, all as uint8 gray on the host with their times.

Public functions keep the JAX package's NHWC layout; inside, each UNet runs
on an NCHW view of the same memory (a channels-last tensor, which cuDNN
transposes around its float32 NCHW convs).
"""

from __future__ import annotations

import math
import os
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._device import float32_math, resolve_device
from ..ops.conv import bilinear_resize
from ..ops.image import CropParameters

MEAN = np.array([0.429, 0.431, 0.397], np.float32)  # reference const.py

CKPT_ENV_VAR = "V2E2V_SUPERSLOMO_CKPT"
DEFAULT_CKPT = os.path.join("upsampling", "checkpoint", "SuperSloMo.ckpt")


def _conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    # made on the meta device: UNet draws the weights from its own generator
    return nn.Conv2d(cin, cout, k, padding=(k - 1) // 2, device="meta")


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


class _Down(nn.Module):
    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.conv1 = _conv(cin, cout, k)
        self.conv2 = _conv(cout, cout, k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.avg_pool2d(x, 2)
        return _lrelu(self.conv2(_lrelu(self.conv1(x))))


class _Up(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = _conv(cin, cout, 3)
        self.conv2 = _conv(2 * cout, cout, 3)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        _, _, h, w = x.shape
        x = bilinear_resize(x.permute(0, 2, 3, 1), 2 * h, 2 * w,
                            align_corners=True).permute(0, 3, 1, 2)
        x = _lrelu(self.conv1(x))
        return _lrelu(self.conv2(torch.cat([x, skip], 1)))


class UNet(nn.Module):
    """The Super-SloMo UNet on NHWC input, on the CPU until moved. Weights
    are drawn as the JAX package's ``init_unet`` draws them, uniform in
    +-1/sqrt(fan_in), from ``generator`` (seed 0 when None); a checkpoint's
    state dict replaces them."""

    def __init__(self, in_ch: int, out_ch: int, generator: torch.Generator | None = None):
        super().__init__()
        self.conv1 = _conv(in_ch, 32, 7)
        self.conv2 = _conv(32, 32, 7)
        self.down1 = _Down(32, 64, 5)
        self.down2 = _Down(64, 128, 3)
        self.down3 = _Down(128, 256, 3)
        self.down4 = _Down(256, 512, 3)
        self.down5 = _Down(512, 512, 3)
        self.up1 = _Up(512, 512)
        self.up2 = _Up(512, 256)
        self.up3 = _Up(256, 128)
        self.up4 = _Up(128, 64)
        self.up5 = _Up(64, 32)
        self.conv3 = _conv(32, out_ch, 3)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.to_empty(device="cpu")
        with torch.no_grad():
            for conv in self.modules():
                if isinstance(conv, nn.Conv2d):
                    bound = 1.0 / math.sqrt(conv.weight[0].numel())
                    for p in (conv.weight, conv.bias):
                        p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                                              generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        x = _lrelu(self.conv1(x))
        skips = [_lrelu(self.conv2(x))]
        for down in (self.down1, self.down2, self.down3, self.down4, self.down5):
            skips.append(down(skips[-1]))
        x = skips.pop()
        for up in (self.up1, self.up2, self.up3, self.up4, self.up5):
            x = up(x, skips.pop())
        return _lrelu(self.conv3(x)).permute(0, 2, 3, 1)


def backwarp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear warp of NHWC ``img`` by NHWC 2-channel ``flow`` (u, v), zero
    outside the image: torch ``grid_sample(align_corners=True,
    padding_mode='zeros')`` fed the reference's grid ``2 * ((x + u) / W -
    0.5)``, computed as the JAX package computes it (sample points
    ``(x + u) * f32((W - 1) / W)``, four gathers, the same weighted sum);
    ``grid_sample`` itself unnormalises with other roundings."""
    n, h, w, c = img.shape
    xs = torch.arange(w, dtype=torch.float32, device=img.device)
    ys = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    gx = (xs + flow[..., 0]) * ((w - 1) / w)
    gy = (ys + flow[..., 1]) * ((h - 1) / h)
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = gx - x0
    wy = gy - y0
    flat = img.reshape(n, h * w, c)

    def gather(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        vals = torch.gather(flat, 1, idx.reshape(n, h * w, 1).expand(n, h * w, c))
        return vals.reshape(n, h, w, c) * inside[..., None]

    return (gather(y0, x0) * ((1 - wx) * (1 - wy))[..., None]
            + gather(y0, x0 + 1) * (wx * (1 - wy))[..., None]
            + gather(y0 + 1, x0) * ((1 - wx) * wy)[..., None]
            + gather(y0 + 1, x0 + 1) * (wx * wy)[..., None])


def flow_pair(flow_net: UNet, i0: torch.Tensor, i1: torch.Tensor):
    """The flows ``(F_0->1, F_1->0)`` of a frame pair, each NHWC 2-channel."""
    out = flow_net(torch.cat([i0, i1], -1))
    return out[..., :2], out[..., 2:]


def interp_at_t(intrp_net: UNet, i0, i1, f01, f10, t: float) -> torch.Tensor:
    """The intermediate frame at ``t`` in (0, 1). The scalars are float32
    as in the JAX package, where ``t`` is a traced float32."""
    t32, one = np.float32(t), np.float32(1)
    temp = float(-t32 * (one - t32))
    f_t0 = temp * f01 + float(t32 * t32) * f10
    f_t1 = float((one - t32) * (one - t32)) * f01 + temp * f10

    g0 = backwarp(i0, f_t0)
    g1 = backwarp(i1, f_t1)
    intrp = intrp_net(torch.cat([i0, i1, f01, f10, f_t1, f_t0, g1, g0], -1))
    f_t0_f = intrp[..., 0:2] + f_t0
    f_t1_f = intrp[..., 2:4] + f_t1
    v_t0 = torch.sigmoid(intrp[..., 4:5])
    v_t1 = 1 - v_t0

    g0f = backwarp(i0, f_t0_f)
    g1f = backwarp(i1, f_t1_f)
    w0, w1 = float(one - t32), float(t32)
    return (w0 * v_t0 * g0f + w1 * v_t1 * g1f) / (w0 * v_t0 + w1 * v_t1 + 1e-12)


class Upsampler:
    """The adaptive Super-SloMo upsampler (reference ``upsamp_sequence.py:24``).

    Loads the public SuperSloMo.ckpt (the path argument, then
    ``$V2E2V_SUPERSLOMO_CKPT``, then ``upsampling/checkpoint/SuperSloMo.ckpt``);
    without one it warns and draws random weights from a generator seeded 0
    (the whole pipeline runs, the frames mean nothing). ``device`` None means
    the card, raising without one; the CPU runs only when asked for.
    ``is_train`` is accepted for the reference's signature and not read.
    """

    def __init__(self, image_dim, is_train: bool = False, ckpt_path: str | None = None,
                 device: torch.device | str | None = None):
        from ..utils.checkpoint import load_superslomo_checkpoint

        self.device = resolve_device(device)
        self.crop = CropParameters(image_dim[1], image_dim[0], 5)
        path = ckpt_path or os.environ.get(CKPT_ENV_VAR) or DEFAULT_CKPT
        gen = torch.Generator().manual_seed(0)
        self.flow_net = UNet(6, 4, gen)
        self.intrp_net = UNet(20, 5, gen)
        if os.path.isfile(path):
            fc, at = load_superslomo_checkpoint(path)
            self.flow_net.load_state_dict(fc)
            self.intrp_net.load_state_dict(at)
            self.pretrained = True
        else:
            warnings.warn(
                f"SuperSloMo checkpoint not found at {path!r}; using RANDOM "
                "weights — interpolation quality will be meaningless."
            )
            self.pretrained = False
        for net in (self.flow_net, self.intrp_net):
            net.to(self.device).eval().requires_grad_(False)

    def _to_net(self, img_u8: np.ndarray) -> np.ndarray:
        """uint8 gray ``[H, W]`` -> normalised RGB ``[H, W, 3]`` float32."""
        rgb = np.repeat(img_u8[..., None].astype(np.float32) / 255.0, 3, axis=-1)
        rgb -= MEAN
        return rgb

    def _denorm_to_gray(self, x: np.ndarray) -> np.ndarray:
        """A padded net frame ``[1, Hp, Wp, 3]`` -> uint8 gray ``[H, W]``:
        clip, crop, the luma weights in float32, and a truncating cast."""
        rgb = np.clip(x[0] + MEAN, 0.0, 1.0)
        rgb = rgb[self.crop.iy0:self.crop.iy1, self.crop.ix0:self.crop.ix1]
        gray = 0.114 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.299 * rgb[..., 2]
        return np.uint8(255.0 * gray)

    @torch.no_grad()
    def upsampling(self, img_sequence, time_sequence):
        """Adaptively interpolate a list of gray uint8 frames.

        Returns ``(np.ndarray [M, H, W] uint8, np.ndarray [M] float64)`` as
        the reference does (:87-133): each pair's frames sorted by time, the
        pair's last frame dropped except in the final pair.
        """
        frames_host = [self.crop.pad(torch.from_numpy(self._to_net(f))[None]).numpy()
                       for f in img_sequence]
        frames_net = [torch.from_numpy(f).to(self.device) for f in frames_host]
        out_frames: list[np.ndarray] = []
        out_ts: list[float] = []
        n = len(img_sequence)
        with float32_math():
            for i in range(n - 1):
                i0, i1 = frames_net[i], frames_net[i + 1]
                t0, t1 = float(time_sequence[i]), float(time_sequence[i + 1])
                f01, f10 = flow_pair(self.flow_net, i0, i1)
                mag = torch.maximum(f01.square().sum(-1).sqrt().amax(),
                                    f10.square().sum(-1).sqrt().amax())
                count = math.ceil(mag.item())

                ts = [k / count for k in range(1, count)]
                mids = [interp_at_t(self.intrp_net, i0, i1, f01, f10, t) for t in ts]
                pair_frames = [(t0, self._denorm_to_gray(frames_host[i]))]
                pair_frames += [(t0 + t * (t1 - t0), self._denorm_to_gray(m.cpu().numpy()))
                                for t, m in zip(ts, mids)]
                pair_frames.append((t1, self._denorm_to_gray(frames_host[i + 1])))
                pair_frames.sort(key=lambda p: p[0])

                if i != n - 2:  # the pair's last frame is the next pair's first
                    pair_frames = pair_frames[:-1]
                for t, fr in pair_frames:
                    out_ts.append(t)
                    out_frames.append(fr)

        return np.stack(out_frames, 0), np.asarray(out_ts)
