"""Kernel K2: the half-resolution core of a CISTA-LSTC step (port of
``v2e2v_tpu/ops/pallas/core.py``).

One step of the core on NHWC activations at (H/2, W/2)::

    ConvLSTC:  in, forget = sigmoid(conv(cat(x1, z), gates))
               z0 = conv(x1, P0);  cell = forget * cell + in * z0
               z = sigmoid(conv(cat(z0, z), out_gates)) * tanh(cell)
    ISTA x depth (weight-tied):  z = softshrink(conv(x1 - conv(z, D), P) + z)
    decoder:   xg = relu(conv(z, Dg));  ConvLSTM(xg, (dg_h, dg_c))

``cista_core`` runs the CUDA kernels of ``csrc/core.cu`` for CUDA tensors
and the plain PyTorch version ``cista_core_plain`` for CPU tensors. Both keep
the Pallas kernel's cast points: taps in the activation dtype, biases and
``Lambda`` in float32, float32 sums and gate algebra, the float32 cell into
the out gate, ``z0`` cast to the dtype only where it feeds the out-gate conv,
and the ISTA loop's casts as in kernel K1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import DTYPE_NAMES, refuse_grad, refuse_shard

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# v2e::Epilogue of csrc/conv3x3.cuh
_EPI_D, _EPI_P, _EPI_PRE, _EPI_RELU, _EPI_OUT_GATE = range(5)

TAP_KEYS = ("wg_x", "wg_z", "w_p0", "wog_z0", "wog_z", "w_d", "w_p", "w_dg", "wl_x", "wl_h")
BIAS_KEYS = ("b_g", "b_p0", "b_og", "b_d", "b_p", "lam", "b_dg", "b_l")
# bfloat16 taps as the tensor-core conv reads them (``conv_tc.wgmma_taps``)
TC_KEYS = tuple(f"{k}_tc" for k in TAP_KEYS)


def core_taps(params: dict, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The kernel's taps and biases from the flat state dict, as JAX's
    ``core_taps`` builds them from its parameter tree.

    Concat-input convs are split per input along dim 1 of the OIHW weight
    (gates on x ``[:C]`` and z ``[C:]``, out gates on z0 ``[:2C]`` and z
    ``[2C:]``, ConvLSTM gates on xg ``[:C]`` and h ``[C:]``). Weights become
    taps ``[9, Cin, Cout]`` in ``dtype``; biases and ``Lambda`` become float32
    ``[1, Cout]``. In bfloat16 the taps are also laid out for the tensor-core
    conv, under ``TC_KEYS``, so that a pool or a sequence does it once.
    """
    c = params["W0.conv2d.weight"].shape[0]  # base channels

    def taps(w):
        return w.permute(2, 3, 1, 0).reshape(9, w.shape[1], w.shape[0]).to(dtype).contiguous()

    def b(name):
        return params[name].reshape(1, -1).to(torch.float32).contiguous()

    wg = params["P0.gates.weight"]  # [4C, C + 2C, 3, 3] (in | forget)
    wog = params["P0.out_gates.weight"]  # [2C, 2C + 2C, 3, 3]
    wl = params["Dg.recurrent_block.Gates.weight"]  # [4C, C + C, 3, 3]
    ista = "lista_blocks.0."
    out = {
        "wg_x": taps(wg[:, :c]),
        "wg_z": taps(wg[:, c:]),
        "b_g": b("P0.gates.bias"),
        "w_p0": taps(params["P0.P0.weight"]),
        "b_p0": b("P0.P0.bias"),
        "wog_z0": taps(wog[:, : 2 * c]),
        "wog_z": taps(wog[:, 2 * c:]),
        "b_og": b("P0.out_gates.bias"),
        "w_d": taps(params[ista + "D.conv2d.weight"]),
        "b_d": b(ista + "D.conv2d.bias"),
        "w_p": taps(params[ista + "P.conv2d.weight"]),
        "b_p": b(ista + "P.conv2d.bias"),
        "lam": b(ista + "Lambda"),
        "w_dg": taps(params["Dg.conv.conv2d.weight"]),
        "b_dg": b("Dg.conv.conv2d.bias"),
        "wl_x": taps(wl[:, :c]),
        "wl_h": taps(wl[:, c:]),
        "b_l": b("Dg.recurrent_block.Gates.bias"),
    }
    if dtype == torch.bfloat16:
        from .conv_tc import wgmma_taps

        out |= {tk: wgmma_taps(out[k]) for k, tk in zip(TAP_KEYS, TC_KEYS)}
    return out


def _check(taps, x1, z, cell, dg_h, dg_c, depth) -> None:
    if x1.dtype not in _DTYPE_CODE or any(t.dtype != x1.dtype for t in (z, cell, dg_h, dg_c)):
        raise TypeError(
            "cista_core takes float32 or bfloat16 activations of one dtype, got "
            f"{[t.dtype for t in (x1, z, cell, dg_h, dg_c)]}"
        )
    if x1.dim() != 4:
        raise ValueError(f"x1 must be [B, H, W, C], got {tuple(x1.shape)}")
    b, h, w, c = x1.shape
    want = {"z": (z, 2 * c), "cell": (cell, 2 * c), "dg_h": (dg_h, c), "dg_c": (dg_c, c)}
    for name, (t, ch) in want.items():
        if tuple(t.shape) != (b, h, w, ch):
            raise ValueError(f"{name} must have shape {(b, h, w, ch)}, got {tuple(t.shape)}")
    # (cin, cout) of each conv's taps in units of C; biases are [1, cout]
    units = {"wg_x": (1, 4), "wg_z": (2, 4), "w_p0": (1, 2), "wog_z0": (2, 2), "wog_z": (2, 2),
             "w_d": (2, 1), "w_p": (1, 2), "w_dg": (2, 1), "wl_x": (1, 4), "wl_h": (1, 4),
             "b_g": 4, "b_p0": 2, "b_og": 2, "b_d": 1, "b_p": 2, "lam": 2, "b_dg": 1, "b_l": 4}
    for name, u in units.items():
        shape = (9, u[0] * c, u[1] * c) if name in TAP_KEYS else (1, u * c)
        if name not in taps or tuple(taps[name].shape) != shape:
            got = tuple(taps[name].shape) if name in taps else "missing"
            raise ValueError(f"taps[{name!r}] must have shape {shape}, got {got}")
    for t in (z, cell, dg_h, dg_c, *taps.values()):
        if t.device != x1.device:
            raise ValueError(f"cista_core's inputs lie on {t.device} and {x1.device}")
    if h < 2 or w < 2:
        raise ValueError(f"reflect padding needs H >= 2 and W >= 2, got {h}x{w}")
    if not all(t.is_contiguous() for t in (x1, z, cell, dg_h, dg_c)):
        raise ValueError("x1, z, cell, dg_h and dg_c must be contiguous NHWC tensors")
    if depth < 0:
        raise ValueError(f"depth must be >= 0, got {depth}")


def cista_core_plain(
    taps: dict,
    x1: torch.Tensor,
    z: torch.Tensor,
    cell: torch.Tensor,
    dg_h: torch.Tensor,
    dg_c: torch.Tensor,
    depth: int = 5,
):
    """Plain PyTorch version of the kernel, with the same signature.

    Args:
      taps: ``core_taps(params, dtype)``.
      x1: heads output ``[B, H, W, C]``; z / cell: ConvLSTC state
        ``[B, H, W, 2C]``; dg_h / dg_c: decoder ConvLSTM state ``[B, H, W, C]``;
        all float32 or bfloat16, NHWC.
    Returns ``(rec_h, z, cell, dg_h, dg_c)`` in ``x1.dtype``; ``rec_h`` is
    ``dg_h``, the new ConvLSTM hidden.
    """
    _check(taps, x1, z, cell, dg_h, dg_c, depth)
    dtype = x1.dtype
    b, h, w, c = x1.shape

    def conv(x, name, bias=None):
        """Reflect 3x3 conv of float32 NHWC ``x`` as one product of its 9
        shifted planes with the taps (the Pallas kernel's 9 tap products)."""
        t = taps[name].to(dtype).float()
        xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect").permute(0, 2, 3, 1)
        cols = torch.cat([xp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)], -1)
        y = (cols.reshape(-1, cols.shape[-1]) @ t.reshape(-1, t.shape[2])).reshape(b, h, w, -1)
        return y if bias is None else y + taps[bias].float().reshape(-1)

    x1f, zf = x1.float(), z.float()
    gates = conv(x1f, "wg_x", "b_g") + conv(zf, "wg_z")
    in_g, forget_g = torch.sigmoid(gates[..., : 2 * c]), torch.sigmoid(gates[..., 2 * c:])
    z0 = conv(x1f, "w_p0", "b_p0")
    out_g = torch.sigmoid(conv(z0.to(dtype).float(), "wog_z0", "b_og") + conv(zf, "wog_z"))
    cell_new = forget_g * cell.float() + in_g * z0
    zc = (out_g * torch.tanh(cell_new)).to(dtype)

    lam = taps["lam"].float().reshape(-1)
    for _ in range(depth):
        zi = zc.float()
        xm = (x1f - conv(zi, "w_d", "b_d")).to(dtype)
        y = conv(xm.float(), "w_p", "b_p") + zi
        zc = (torch.relu(y - lam) - torch.relu(-y - lam)).to(dtype)

    xg = torch.relu(conv(zc.float(), "w_dg", "b_dg")).to(dtype)
    lg = conv(xg.float(), "wl_x", "b_l") + conv(dg_h.float(), "wl_h")
    in_l, rem_l, out_l = (torch.sigmoid(lg[..., k * c:(k + 1) * c]) for k in range(3))
    hc = rem_l * dg_c.float() + in_l * torch.tanh(lg[..., 3 * c:])
    hidden = (out_l * torch.tanh(hc)).to(dtype).contiguous()
    return hidden, zc.contiguous(), cell_new.to(dtype).contiguous(), hidden, hc.to(dtype).contiguous()


def cista_core(
    taps: dict,
    x1: torch.Tensor,
    z: torch.Tensor,
    cell: torch.Tensor,
    dg_h: torch.Tensor,
    dg_c: torch.Tensor,
    depth: int = 5,
    *,
    shard=None,
):
    """The core: the CUDA kernels for CUDA tensors (7 + 2 x depth launches on
    the current stream, counted in ``cista_core.launches`` and, by dtype, in
    ``cista_core.launches_by_dtype``), the plain version
    for CPU tensors. Arguments and result as ``cista_core_plain``; the kernels
    need ``C % 8 == 0`` and inputs starting on 16-byte boundaries (the convs
    copy 16-byte rows); bfloat16 taps from ``core_taps(params,
    torch.bfloat16)`` carry their layout, float32 taps are laid out once per
    tensor (``conv_tc.cached_simt_taps``), others on every call. New
    tensors hold every output: the inputs stay as they were. Under autograd
    it raises when an input or a value of ``taps`` requires grad, on every
    device (``refuse_grad``), and on a sharded call (``refuse_shard``)."""
    _check(taps, x1, z, cell, dg_h, dg_c, depth)
    refuse_grad("cista_core", (x1, z, cell, dg_h, dg_c, *taps.values()))
    refuse_shard("cista_core", shard)
    if x1.device.type == "cpu":
        return cista_core_plain(taps, x1, z, cell, dg_h, dg_c, depth)
    if x1.device.type != "cuda":
        raise ValueError(f"cista_core runs on cuda or cpu, not {x1.device}")
    b, h, w, c = x1.shape
    if c % 8:
        raise ValueError(f"the CUDA kernel needs C % 8 == 0, got C={c}")
    from ._lib import check_aligned, load
    from .conv_tc import cached_simt_taps, wgmma_taps

    dtype = x1.dtype
    t = {k: taps[k].to(dtype).contiguous() for k in TAP_KEYS}
    t |= {k: taps[k].float().contiguous() for k in BIAS_KEYS}
    cout = {k: t[k].shape[2] for k in TAP_KEYS}
    # the taps in the order the conv stages them
    if dtype == torch.bfloat16:  # the tensor-core conv's layout, from core_taps
        laid = {k: taps.get(tk) for k, tk in zip(TAP_KEYS, TC_KEYS)}
        t |= {k: v if v is not None and v.dtype == dtype else wgmma_taps(t[k])
              for k, v in laid.items()}
    else:
        t |= {k: cached_simt_taps(t[k]) for k in TAP_KEYS}
    check_aligned("cista_core", x1=x1, z=z, cell=cell, dg_h=dg_h, dg_c=dg_c)
    lib = load()
    code = _DTYPE_CODE[dtype]
    f32 = dict(dtype=torch.float32, device=x1.device)
    pre = torch.empty((b, h, w, 4 * c), **f32)  # gate pre-activations, LSTC then LSTM
    z0 = torch.empty((b, h, w, 2 * c), **f32)
    cell32 = torch.empty((b, h, w, 2 * c), **f32)
    cell_out, z0_t, z_a, z_b = (torch.empty_like(z) for _ in range(4))
    xm, xg, hidden, hc = (torch.empty_like(x1) for _ in range(4))
    pixels = b * h * w

    def counted():
        cista_core.launches += 1
        cista_core.launches_by_dtype[DTYPE_NAMES[dtype]] += 1

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream().cuda_stream

        def conv(epi, xa, wa, out, xb=None, wb=None, bias=None, other=None, lam=None):
            err = lib.lib.v2e_core_conv3x3(
                code, epi, xa.data_ptr(), t[wa].data_ptr(), xa.shape[3], ptr(xb),
                None if wb is None else t[wb].data_ptr(), 0 if xb is None else xb.shape[3],
                t[bias].data_ptr(), ptr(other), None if lam is None else t[lam].data_ptr(),
                out.data_ptr(), b, h, w, cout[wa], stream,
            )
            lib.check(err, "core_conv3x3 launch")
            counted()

        conv(_EPI_PRE, x1, "wg_x", pre, z, "wg_z", bias="b_g")
        conv(_EPI_PRE, x1, "w_p0", z0, bias="b_p0")
        err = lib.lib.v2e_core_lstc_cell(code, pre.data_ptr(), z0.data_ptr(), cell.data_ptr(),
                                         cell32.data_ptr(), cell_out.data_ptr(),
                                         z0_t.data_ptr(), pixels, 2 * c, stream)
        lib.check(err, "core_lstc_cell launch")
        counted()
        conv(_EPI_OUT_GATE, z0_t, "wog_z0", z_a, z, "wog_z", bias="b_og", other=cell32)
        z_cur, z_next = z_a, z_b
        for _ in range(depth):
            conv(_EPI_D, z_cur, "w_d", xm, bias="b_d", other=x1)
            conv(_EPI_P, xm, "w_p", z_next, bias="b_p", other=z_cur, lam="lam")
            z_cur, z_next = z_next, z_cur
        conv(_EPI_RELU, z_cur, "w_dg", xg, bias="b_dg")
        conv(_EPI_PRE, xg, "wl_x", pre, dg_h, "wl_h", bias="b_l")
        err = lib.lib.v2e_core_lstm_cell(code, pre.data_ptr(), dg_c.data_ptr(),
                                         hidden.data_ptr(), hc.data_ptr(), pixels, c, stream)
        lib.check(err, "core_lstm_cell launch")
        counted()
    return hidden, z_cur, cell_out, hidden, hc


cista_core.launches = 0
cista_core.launches_by_dtype = dict.fromkeys(DTYPE_NAMES.values(), 0)


def launches_per_call(depth: int) -> int:
    """Launches of one ``cista_core`` call on CUDA tensors."""
    return 7 + 2 * depth
