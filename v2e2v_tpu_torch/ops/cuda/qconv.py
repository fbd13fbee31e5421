"""Kernel K4: the int8 3x3 conv of int8 inference, with the quantize of its
float input (the quantize, integer conv and dequant of
``v2e2v_tpu/ops/qconv.py``, which XLA runs there: no Pallas kernel).

On NHWC activations (one input, or the two parts of a channel concat) with
one scale ``s_x``, per-output-channel int8 OIHW weights with scales ``s_w``
and an optional float32 bias::

    x_q = x if x is int8 else clamp(round(x / s_x), -127, 127)
    acc = sum_{dy, dx, c} x_q[b, refl(y + dy - 1), refl(x + dx - 1), c] * w_q[o, c, dy, dx]
    out = cast(fma(float32(acc), s_x * s_w[o], bias[o]))

``qconv3x3`` runs the CUDA kernel of ``csrc/qconv3x3.cu`` for CUDA tensors and
the plain PyTorch version ``qconv3x3_plain`` for CPU tensors. A float32 or
bfloat16 input is quantized as ``quantize_with`` does it (a true division,
round half to even, saturation at +-127); the kernel does that while it
stages the input, so the codes never reach device memory. The int32 sum is
exact; ``float32(acc)`` rounds to nearest even (``|acc|`` passes 2^24);
``s_x * s_w`` is one float32 product and the dequant one fused multiply-add,
as the JAX package's compiled step computes it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import DTYPE_NAMES, refuse_grad

# the input types the kernel takes, as its in_type argument
IN_TYPES = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
IN_NAMES = {torch.int8: "int8", **DTYPE_NAMES}


def quantize_with(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """Quantize with a given scale (a float32 scalar tensor on ``x``'s
    device): ``clamp(round(x / s_x), -127, 127)``, a true division, rounding
    half to even; beyond-range values saturate at +-127. Contiguous int8."""
    return torch.clamp(torch.round(x.to(torch.float32) / s_x), -127, 127).to(
        torch.int8).contiguous()


def _check(xa, s_x, w_q, s_w, bias, xb, out_dtype) -> None:
    parts = (xa,) if xb is None else (xa, xb)
    if xa.dtype not in IN_TYPES or any(p.dtype != xa.dtype or p.dim() != 4 for p in parts):
        raise TypeError("qconv3x3 takes NHWC activations [B, H, W, C] of one dtype: int8 codes, "
                        "or float32 or bfloat16 to quantize with s_x; got "
                        f"{[(p.dtype, tuple(p.shape)) for p in parts]}")
    if xb is not None and xb.shape[:3] != xa.shape[:3]:
        raise ValueError(f"the two inputs differ in [B, H, W]: {tuple(xa.shape)}, "
                         f"{tuple(xb.shape)}")
    cin = sum(p.shape[3] for p in parts)
    if w_q.dtype != torch.int8 or w_q.dim() != 4 or tuple(w_q.shape[1:]) != (cin, 3, 3):
        raise ValueError(f"w_q must be int8 OIHW [cout, {cin}, 3, 3], got {w_q.dtype} "
                         f"{tuple(w_q.shape)}")
    cout = w_q.shape[0]
    if s_x.dim() != 0 or s_x.dtype != torch.float32:
        raise ValueError(f"s_x must be a float32 scalar tensor, got {s_x.dtype} "
                         f"{tuple(s_x.shape)}")
    for name, t in (("s_w", s_w), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != (cout,)):
            raise ValueError(f"{name} must be float32 [{cout}], got {t.dtype} {tuple(t.shape)}")
    for name, t in (("xb", xb), ("w_q", w_q), ("s_x", s_x), ("s_w", s_w), ("bias", bias)):
        if t is not None and t.device != xa.device:
            raise ValueError(f"{name} is on {t.device}, xa on {xa.device}")
    if out_dtype not in DTYPE_NAMES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")


def qconv3x3_plain(
    xa: torch.Tensor,
    s_x: torch.Tensor,
    w_q: torch.Tensor,
    s_w: torch.Tensor,
    bias: torch.Tensor | None = None,
    xb: torch.Tensor | None = None,
    out_dtype: torch.dtype = torch.float32,
    padding: int = 1,
    stride: int = 1,
    pad_mode: str = "reflect",
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with the same signature, on any
    device, and with any padding (``pad_mode`` 'reflect', or 'zeros' as the
    JAX package names a constant pad) and stride, as the JAX package's conv
    takes them.

    A float input is quantized first (``quantize_with``, each part with
    ``s_x``). The sum is taken in float64 on the int8 values, per tap as one
    matrix product of the shifted input plane: every product and partial sum
    is an integer below 2^53, so it is exact in any order (a float64 conv
    could be computed by a transform that is not). It is converted to int32,
    then to float32; the dequant ``acc * (s_x * s_w) + bias`` is taken in
    float64 from the float32 operands and rounded once to float32, as a fused
    multiply-add rounds it (a double rounding may rarely leave it 1 ulp from
    the fused result). Returns ``[B, H', W', cout]`` in ``out_dtype``.
    """
    _check(xa, s_x, w_q, s_w, bias, xb, out_dtype)
    if xa.dtype != torch.int8:
        xa = quantize_with(xa, s_x)
        xb = None if xb is None else quantize_with(xb, s_x)
    x = xa if xb is None else torch.cat([xa, xb], dim=-1)
    x = x.to(torch.float64)
    if padding > 0:
        mode = "constant" if pad_mode == "zeros" else pad_mode
        x = F.pad(x.permute(0, 3, 1, 2), (padding,) * 4, mode=mode).permute(0, 2, 3, 1)
    cout, _, kh, kw = w_q.shape
    b, hp, wp, _ = x.shape
    ho, wo = (hp - kh) // stride + 1, (wp - kw) // stride + 1
    w64 = w_q.to(torch.float64)
    acc = x.new_zeros((b, ho, wo, cout))
    for dy in range(kh):
        for dx in range(kw):
            plane = x[:, dy:dy + stride * (ho - 1) + 1:stride, dx:dx + stride * (wo - 1) + 1:stride]
            acc += plane @ w64[:, :, dy, dx].T
    acc = acc.to(torch.int32).to(torch.float32).to(torch.float64)
    y = acc * (s_x * s_w).to(torch.float64)
    if bias is not None:
        y = y + bias.to(torch.float64)
    return y.to(torch.float32).to(out_dtype)


def qconv3x3(
    xa: torch.Tensor,
    s_x: torch.Tensor,
    w_q: torch.Tensor,
    s_w: torch.Tensor,
    bias: torch.Tensor | None = None,
    xb: torch.Tensor | None = None,
    out_dtype: torch.dtype = torch.float32,
    padding: int = 1,
    stride: int = 1,
    pad_mode: str = "reflect",
) -> torch.Tensor:
    """The int8 conv: the CUDA kernel for CUDA tensors (one launch on the
    current stream, counted in ``qconv3x3.launches``, by ``out_dtype`` in
    ``qconv3x3.launches_by_dtype`` and by input dtype in
    ``qconv3x3.launches_by_input``), the plain version for CPU tensors.
    Arguments as ``qconv3x3_plain``: ``xa`` (and ``xb``, the second part of a
    channel concat, or None) NHWC, int8 codes or float32 / bfloat16 values
    that the kernel quantizes with ``s_x`` as it stages them, ``s_x`` a
    float32 scalar tensor on the same device, ``w_q`` int8 OIHW ``[cout,
    cin_a + cin_b, 3, 3]``, ``s_w`` and ``bias`` float32 ``[cout]``.

    On a CUDA tensor it raises for what the kernel does not take: padding
    other than 1, stride other than 1, a pad mode other than 'reflect',
    ``cin_a`` or ``cin_b`` not a multiple of 16, ``cout`` not a multiple of
    8, H or W below 2, an input that is not contiguous NHWC (it is never
    copied here: a caller makes a reused input contiguous once) or that does
    not start on a 16-byte boundary. Under autograd it raises when an
    argument requires grad, on every device (``refuse_grad``): the int8 path
    is inference only."""
    _check(xa, s_x, w_q, s_w, bias, xb, out_dtype)
    refuse_grad("qconv3x3", [t for t in (xa, xb, s_x, s_w, bias) if t is not None])
    if xa.device.type == "cpu":
        return qconv3x3_plain(xa, s_x, w_q, s_w, bias, xb, out_dtype, padding, stride, pad_mode)
    if xa.device.type != "cuda":
        raise ValueError(f"qconv3x3 runs on cuda or cpu, not {xa.device}")
    if (padding, stride, pad_mode) != (1, 1, "reflect"):
        raise ValueError("the CUDA kernel takes padding=1, stride=1, pad_mode='reflect', got "
                         f"padding={padding}, stride={stride}, pad_mode={pad_mode!r}")
    b, h, w, cin_a = xa.shape
    cin_b = 0 if xb is None else xb.shape[3]
    cout = w_q.shape[0]
    if cin_a % 16 or cin_b % 16 or cout % 8:
        raise ValueError(f"the CUDA kernel needs input channels % 16 == 0 and cout % 8 == 0, "
                         f"got cin {cin_a} + {cin_b}, cout {cout}")
    if h < 2 or w < 2:
        raise ValueError(f"reflect padding needs H >= 2 and W >= 2, got {h}x{w}")
    if not (xa.is_contiguous() and (xb is None or xb.is_contiguous())):
        raise ValueError(f"the {IN_NAMES[xa.dtype]} inputs must be contiguous NHWC tensors, got "
                         f"strides {[p.stride() for p in (xa, xb) if p is not None]}")
    from ._lib import check_aligned, load
    from .conv_tc import cached_s8_taps

    check_aligned("qconv3x3", xa=xa, **({} if xb is None else {"xb": xb}))
    lib = load()
    taps = cached_s8_taps(w_q, cin_a)
    s_x, s_w = s_x.contiguous(), s_w.contiguous()
    bias = None if bias is None else bias.contiguous()
    out = torch.empty((b, h, w, cout), dtype=out_dtype, device=xa.device)
    with torch.cuda.device(xa.device):
        err = lib.lib.v2e_qconv3x3(
            xa.data_ptr(), None if xb is None else xb.data_ptr(), cin_a, cin_b,
            IN_TYPES[xa.dtype], taps.data_ptr(), s_x.data_ptr(), s_w.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.bfloat16), b, h, w, cout,
            torch.cuda.current_stream().cuda_stream,
        )
    lib.check(err, "qconv3x3 launch")
    qconv3x3.launches += 1
    qconv3x3.launches_by_dtype[DTYPE_NAMES[out_dtype]] += 1
    qconv3x3.launches_by_input[IN_NAMES[xa.dtype]] += 1
    return out


qconv3x3.launches = 0
qconv3x3.launches_by_dtype = dict.fromkeys(DTYPE_NAMES.values(), 0)
qconv3x3.launches_by_input = dict.fromkeys(IN_NAMES.values(), 0)
