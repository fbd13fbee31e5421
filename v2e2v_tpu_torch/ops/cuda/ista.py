"""Kernel K1: the fused ISTA loop (port of ``v2e2v_tpu/ops/pallas/ista.py``).

``depth`` weight-tied ISTA iterations on NHWC activations::

    tmp = conv3x3_reflect(z, D)          # 2C -> C
    x   = conv3x3_reflect(x1 - tmp, P)   # C -> 2C
    z   = softshrink(x + z, Lambda)

``ista_loop`` runs the CUDA kernel of ``csrc/ista.cu`` for a CUDA tensor and
the plain PyTorch version ``ista_loop_plain`` for a CPU tensor. Both keep the
Pallas kernel's cast points: taps, biases and ``Lambda`` are cast to the
activation dtype first, sums are float32, ``x1 - tmp`` is cast to the dtype
before the P conv and ``z`` after the softshrink.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MODE_D, _MODE_P = 0, 1


def _check(x1, z, d_weight, d_bias, p_weight, p_bias, lam, depth) -> None:
    if x1.dtype not in _DTYPE_CODE or z.dtype != x1.dtype:
        raise TypeError(
            f"ista_loop takes float32 or bfloat16 activations of one dtype, got "
            f"x1 {x1.dtype}, z {z.dtype}"
        )
    if x1.dim() != 4:
        raise ValueError(f"x1 must be [B, H, W, C], got {tuple(x1.shape)}")
    b, h, w, c = x1.shape
    want = {
        "z": (z, (b, h, w, 2 * c)),
        "d_weight": (d_weight, (3, 3, 2 * c, c)),
        "d_bias": (d_bias, (c,)),
        "p_weight": (p_weight, (3, 3, c, 2 * c)),
        "p_bias": (p_bias, (2 * c,)),
        "lam": (lam, (2 * c,)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.device != x1.device:
            raise ValueError(f"{name} is on {t.device}, x1 on {x1.device}")
    if h < 2 or w < 2:
        raise ValueError(f"reflect padding needs H >= 2 and W >= 2, got {h}x{w}")
    if not (x1.is_contiguous() and z.is_contiguous()):
        raise ValueError("x1 and z must be contiguous NHWC tensors")
    if depth < 0:
        raise ValueError(f"depth must be >= 0, got {depth}")


def _conv3x3_reflect(x: torch.Tensor, w_oihw: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """float32 NCHW reflect-padded 3x3 conv."""
    return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), w_oihw, bias)


def ista_loop_plain(
    x1: torch.Tensor,
    z: torch.Tensor,
    d_weight: torch.Tensor,
    d_bias: torch.Tensor,
    p_weight: torch.Tensor,
    p_bias: torch.Tensor,
    lam: torch.Tensor,
    depth: int = 5,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with the same signature.

    Args:
      x1: ``[B, H, W, C]``; z: ``[B, H, W, 2C]``, float32 or bfloat16.
      d_weight/p_weight: HWIO ``[3, 3, Cin, Cout]``; biases ``[Cout]``;
      lam: ``[2C]`` soft-threshold.
    Returns the final sparse code ``[B, H, W, 2C]`` in ``x1.dtype``.
    """
    _check(x1, z, d_weight, d_bias, p_weight, p_bias, lam, depth)
    dtype = x1.dtype

    def f32(t):
        return t.to(dtype).float()

    dw = f32(d_weight).permute(3, 2, 0, 1)
    pw = f32(p_weight).permute(3, 2, 0, 1)
    db, pb = f32(d_bias), f32(p_bias)
    lam32 = f32(lam)[None, :, None, None]
    x1f = x1.float().permute(0, 3, 1, 2)
    zc = z.permute(0, 3, 1, 2)
    for _ in range(depth):
        zf = zc.float()
        xm = (x1f - _conv3x3_reflect(zf, dw, db)).to(dtype)
        y = _conv3x3_reflect(xm.float(), pw, pb) + zf
        zc = (torch.relu(y - lam32) - torch.relu(-y - lam32)).to(dtype)
    return zc.permute(0, 2, 3, 1).contiguous()


def _launch(lib, mode, x, taps, bias, other, lam, out, cin, cout, stream) -> None:
    b, h, w, _ = x.shape
    err = lib.lib.v2e_ista_conv3x3(
        _DTYPE_CODE[x.dtype], mode, x.data_ptr(), taps.data_ptr(), bias.data_ptr(),
        other.data_ptr(), None if lam is None else lam.data_ptr(), out.data_ptr(),
        b, h, w, cin, cout, stream,
    )
    lib.check(err, "ista_conv3x3 launch")
    ista_loop.launches += 1


def ista_loop(
    x1: torch.Tensor,
    z: torch.Tensor,
    d_weight: torch.Tensor,
    d_bias: torch.Tensor,
    p_weight: torch.Tensor,
    p_bias: torch.Tensor,
    lam: torch.Tensor,
    depth: int = 5,
) -> torch.Tensor:
    """The ISTA loop: the CUDA kernel for CUDA tensors (2 x depth launches
    on the current stream, counted in ``ista_loop.launches``), the plain
    version for CPU tensors. Arguments as ``ista_loop_plain``; the kernel
    needs ``C % 8 == 0`` and x1 and z starting on 16-byte boundaries (both
    convs copy 16-byte rows)."""
    _check(x1, z, d_weight, d_bias, p_weight, p_bias, lam, depth)
    if x1.device.type == "cpu":
        return ista_loop_plain(x1, z, d_weight, d_bias, p_weight, p_bias, lam, depth)
    if x1.device.type != "cuda":
        raise ValueError(f"ista_loop runs on cuda or cpu, not {x1.device}")
    b, h, w, c = x1.shape
    if c % 8:
        raise ValueError(f"the CUDA kernel needs C % 8 == 0, got C={c}")
    from ._lib import check_aligned, load
    from .conv_tc import cached_simt_taps, cached_wgmma_taps

    check_aligned("ista_loop", x1=x1, z=z)
    lib = load()
    dtype = x1.dtype
    # the taps in the order the conv stages them, laid out once per weights
    if dtype == torch.bfloat16:
        d_taps, p_taps = (cached_wgmma_taps(w, dtype) for w in (d_weight, p_weight))
    else:
        d_taps, p_taps = (cached_simt_taps(w) for w in (d_weight, p_weight))
    # cast to the activation dtype as the Pallas kernel does; the kernel
    # reads them as float32
    db, pb, lam_t = (t.to(dtype).float().contiguous() for t in (d_bias, p_bias, lam))
    xm = torch.empty_like(x1)
    bufs = (torch.empty_like(z), torch.empty_like(z))
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream().cuda_stream
        z_cur = z
        for i in range(depth):
            _launch(lib, _MODE_D, z_cur, d_taps, db, x1, None, xm, 2 * c, c, stream)
            z_next = bufs[i % 2]
            _launch(lib, _MODE_P, xm, p_taps, pb, z_cur, lam_t, z_next, c, 2 * c, stream)
            z_cur = z_next
    return z_cur


ista_loop.launches = 0
