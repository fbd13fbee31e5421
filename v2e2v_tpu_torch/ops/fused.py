"""Exact rewrites of the CISTA nets' full-resolution convs in the
half-resolution (parity) domain (port of ``v2e2v_tpu/ops/fused.py``).

The three full-resolution stages are linear up to their activation, so each
has an exact rewrite that never builds a full-resolution 64-channel map:

- **heads**: ``W0(R(cat(We(R(ev)), Wi(R(img)))))`` (R = reflect pad 1) is one
  composed 5x5 stride-2 conv in the interior; the outermost half-res rows and
  columns, where R of the intermediate differs from any input padding, get
  folded border kernels (one thin conv per edge, one matrix per corner);
- **bilinear 2x + reflect conv 3x3**: each output parity class (p, q) is a
  3x3 conv over the half-res input with the bilinear taps folded in, emitted
  parity-packed ``[B, H/2, W/2, 4C]`` (``space_to_depth`` order); the edges
  (bilinear clamp, reflect pad of the never-built full-res map) again by
  folded kernels;
- **final conv (C -> Cout)**: a 3x3 block conv ``4C -> 4 Cout`` on the packed
  map; the full-res reflect pad becomes additive edge and corner terms.

The strip versions (``heads_fused``, ``upsample_conv_parity``,
``final_conv_parity``) recompute the borders with the reference ops on thin
slices; the ``*_edgek`` versions are the ones the model runs.

Every kernel is a fold of the stored weights: one ``einsum`` of a weight (or
of the product of two) with a constant table of 0/1 or bilinear
coefficients, built in numpy from the JAX package's index arithmetic.
``precompute_fused_kernels`` makes them once per sequence or pool, and
gradients flow through it to the stored convs. Activations are NHWC and
kernels HWIO, as in the JAX package; weights come from the port's state dict
(reference names, OIHW). A conv kernel made by ``precompute_fused_kernels``
is stored as torch's channels_last OIHW seen through an HWIO view, so
``F.conv2d`` reads it without a copy.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from .conv import _ACTIVATIONS, conv_layer, upsample_conv_layer

Params = dict[str, Any]
StateDict = dict[str, torch.Tensor]

# bilinear 2x taps (align_corners=False, interior):
#   out[2k]   = 0.25*in[k-1] + 0.75*in[k]
#   out[2k+1] = 0.75*in[k]   + 0.25*in[k+1]
_BILINEAR_TAPS = {0: ((-1, 0.25), (0, 0.75)), 1: ((0, 0.75), (1, 0.25))}

# the reflect-padded upsampled map's border rows in terms of the two edge
# rows of the half-res input. Key: full-res row R (top, h rows {0, 1}) or
# R - (2n - 3) (bottom, h rows {n-2, n-1} as {0, 1})
_UP_EDGE0_TAPS = {
    -1: ((0, 0.75), (1, 0.25)),  # reflect: full row -1 == full row 1
    0: ((0, 1.0),),              # bilinear edge clamp: U[0] = h[0]
    1: ((0, 0.75), (1, 0.25)),
    2: ((0, 0.25), (1, 0.75)),
}
_UP_EDGE1_TAPS = {
    0: ((0, 0.75), (1, 0.25)),   # R = 2n-3
    1: ((0, 0.25), (1, 0.75)),   # R = 2n-2
    2: ((1, 1.0),),              # R = 2n-1: U = h[n-1] (edge clamp)
    3: ((0, 0.25), (1, 0.75)),   # R = 2n: reflect == R = 2n-2
}


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """[B, 2K, 2L, C] -> [B, K, L, 4C]; channel order (p, q, c), c fastest."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """Inverse of ``space_to_depth``."""
    b, k, l, c4 = x.shape
    x = x.reshape(b, k, l, 2, 2, c4 // 4).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, 2 * k, 2 * l, c4 // 4)


def _conv(x: torch.Tensor, w: torch.Tensor, stride=1, padding=0, groups=1) -> torch.Tensor:
    """Conv of NHWC ``x`` with HWIO ``w`` cast to x's dtype, zero ``padding``
    per axis, no bias: the JAX package's ``_conv`` (cuDNN and oneDNN sum in
    float32 and round once to x's dtype, as ``preferred_element_type=float32``
    then ``astype`` does). With ``groups=2`` the two halves of x's channels
    go through the two halves of w's output channels: two edge strips, one
    launch."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1), stride=stride,
                 padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1)


def _corners(patches, k: torch.Tensor) -> torch.Tensor:
    """The four corner values ``[4, B, Cout]`` of ``patches`` (tl, tr, bl,
    br; ``[B, ...]`` each) times ``k`` (``[4, K, Cout]``, ``_merge_borders``)
    in one batched product: ``k`` cast to the patches' dtype, the sums in
    float32, rounded to the patches' dtype (JAX's ``_corner_apply``)."""
    p = torch.stack(patches)
    return torch.bmm(p.reshape(4, p.shape[1], -1).float(), k.to(p.dtype).float()).to(p.dtype)


@functools.lru_cache(maxsize=64)
def _border_index(h: int, w: int, device: torch.device) -> torch.Tensor:
    """Flat positions in an ``h x w`` map of the values ``_set_borders``
    writes, in its order: row 0 and row h-1 without their end columns, column
    0 and column w-1 without their end rows, then the corners tl, tr, bl,
    br."""
    r, c = np.arange(1, w - 1), np.arange(1, h - 1)
    idx = np.concatenate([r, (h - 1) * w + r, c * w, c * w + w - 1,
                          [0, w - 1, (h - 1) * w, h * w - 1]])
    return torch.from_numpy(idx).to(device)


def _set_borders(y: torch.Tensor, tb: torch.Tensor, lr: torch.Tensor,
                 corners: torch.Tensor) -> torch.Tensor:
    """``y`` (``[B, H, W, C]``) with its outermost rows from ``tb`` (``[B, 1,
    W, 2C]``: top | bottom), its outermost columns from ``lr`` (``[B, H, 1,
    2C]``: left | right) and its corners from ``corners`` (``[4, B, C]``):
    the JAX package's select order (the columns win over the rows, the
    corners over both), as one ``index_copy_`` into ``y``."""
    y = y.contiguous()
    b, h, w, c = y.shape
    vals = torch.cat([tb[:, 0, 1:-1, :c], tb[:, 0, 1:-1, c:], lr[:, 1:-1, 0, :c],
                      lr[:, 1:-1, 0, c:], corners.transpose(0, 1)], dim=1)
    return y.view(b, h * w, c).index_copy_(1, _border_index(h, w, y.device), vals).view(
        b, h, w, c)


def _merge_borders(d: dict[str, torch.Tensor], kind: str) -> dict[str, torch.Tensor]:
    """The port's launch-saving forms of a border-kernel dict (whose eight
    leaves are the JAX package's): ``tb`` / ``lr``, the top and bottom (left
    and right) edge kernels side by side on the output axis for one
    two-group conv, and ``corners``, the four corner kernels stacked for one
    batched product. The heads' top and left kernels read 3 rows (columns)
    and their bottom and right ones 4: the short ones get a zero fourth, and
    the corners are 4x4, so every strip and patch has one size (zero taps
    add exact zeros). The final conv's corner kernels read one parity group
    of the corner block: zero rows for the others."""
    top, bot, left, right = d["top"], d["bot"], d["left"], d["right"]
    corners = [d["tl"], d["tr"], d["bl"], d["br"]]
    if kind == "heads":
        top, left = F.pad(top, (0, 0, 0, 0, 0, 0, 0, 1)), F.pad(left, (0, 0, 0, 0, 0, 1))
        corners = [F.pad(k, (0, 0, 0, 0, 0, 4 - k.shape[1], 0, 4 - k.shape[0]))
                   for k in corners]
    elif kind == "final":
        c = corners[0].shape[0]
        corners = [F.pad(k, (0, 0, g * c, (3 - g) * c)) for k, g in zip(corners, (3, 2, 1, 0))]
    stacked = torch.stack(corners)
    return {"tb": torch.cat([top, bot], dim=3), "lr": torch.cat([left, right], dim=3),
            "corners": stacked.reshape(4, -1, stacked.shape[-1])}


def _borders(kernels, key: str, make) -> dict[str, torch.Tensor]:
    """The border kernels ``kernels[key]`` (``precompute_fused_kernels``),
    or ``make()``'s merged, for one call."""
    got = (kernels or {}).get(key)
    return got if got is not None else {**(d := make()), **_merge_borders(d, key.split("_")[0])}


def _table(coeffs: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(coeffs).to(like.device, torch.float32)


def _hwio(params: Params) -> torch.Tensor:
    """A ``{"weight": OIHW, "bias"}`` conv's weight as float32 HWIO."""
    return params["weight"].float().permute(2, 3, 1, 0)


def _conv_params(sd: StateDict, name: str) -> Params:
    return {"weight": sd[name + ".weight"], "bias": sd[name + ".bias"]}


# ---------------------------------------------------------------------------
# heads: We|Wi + stride-2 W0 -> composed 5x5/s2 conv + border kernels
# ---------------------------------------------------------------------------

def _merged_head_kernel(params: StateDict) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-diagonal merge of We (events) and Wi (prev image), HWIO: one 3x3
    conv over cat(events, image), exact since reflect padding is
    per-channel."""
    we = _hwio(_conv_params(params, "We.conv2d"))
    wi = _hwio(_conv_params(params, "Wi.conv2d"))
    half = we.shape[3]
    a = torch.cat([F.pad(we, (0, half)), F.pad(wi, (half, 0))], dim=2)
    b = torch.cat([params["We.conv2d.bias"], params["Wi.conv2d.bias"]]).float()
    return a, b


def _heads_row_top(s: int, t: int) -> int:
    """Input row (of x[0:3]) read by composed tap (W0 tap s, merged tap t) at
    the TOP half-res output row: reflect pad 1 of the merged map (row -1 ->
    1), then reflect pad 1 of the input."""
    m = 1 if s - 1 == -1 else s - 1      # merged row
    r = m - 1 + t                        # x row, in -1..2
    return 1 if r == -1 else r


def _heads_row_bot(s: int, t: int) -> int:
    """Input row (of x[-4:]) at the BOTTOM output row: the merged map needs no
    pad there (it reads merged rows H-3..H-1) but merged row H-1 reads x[H],
    which reflects to x[H-2]; base row H-4, relative row s + t."""
    r = s + t                            # relative x row in 0..4
    return 2 if r == 4 else r            # row H reflects to H-2 (relative 2)


def _heads_taps(row_map, n: int) -> np.ndarray:
    """``M[x, t, s]``: 1 where merged tap t under W0 tap s reads input row
    (or column) x of an ``n``-row window."""
    m = np.zeros((n, 3, 3))
    for s in range(3):
        for t in range(3):
            m[row_map(s, t), t, s] = 1.0
    return m


_HEADS_INTERIOR = _heads_taps(lambda s, t: s + t, 5)
_HEADS_TOP = _heads_taps(_heads_row_top, 3)
_HEADS_BOT = _heads_taps(_heads_row_bot, 4)


def _heads_pairs(params: StateDict) -> torch.Tensor:
    """``Q[t1, t2, s1, s2] = a[t1, t2] @ w0[s1, s2]`` (``[3,3,3,3,Cin,Cout]``):
    the merged head's taps composed with W0's."""
    a, _ = _merged_head_kernel(params)
    w0 = _hwio(_conv_params(params, "W0.conv2d"))
    return torch.einsum("abim,rsmo->abrsio", a, w0)


def _heads_fold(rows: np.ndarray, cols: np.ndarray, pairs: torch.Tensor) -> torch.Tensor:
    """A composed heads kernel ``[rows, cols, Cin, Cout]`` from the row and
    column tap tables (``_heads_taps``)."""
    return torch.einsum("xts,yTS,tTsSio->xyio", _table(rows, pairs), _table(cols, pairs), pairs)


def _composed_heads_kernel(params: StateDict) -> tuple[torch.Tensor, torch.Tensor]:
    """5x5 stride-2 kernel and bias of ``W0 o (We|Wi)`` (interior-exact)."""
    k5 = _heads_fold(_HEADS_INTERIOR, _HEADS_INTERIOR, _heads_pairs(params))
    _, b_a = _merged_head_kernel(params)
    w0 = _hwio(_conv_params(params, "W0.conv2d"))
    b5 = torch.einsum("abmo,m->o", w0, b_a) + params["W0.conv2d.bias"].float()
    return k5, b5


def _heads_border_kernels(params: StateDict) -> dict[str, torch.Tensor]:
    """Edge kernels ``[rows, 5, Cin, Cout]`` / ``[5, cols, Cin, Cout]``
    (stride 2 along the edge) and corner tensors of the composed heads conv."""
    q = _heads_pairs(params)
    i, t, b = _HEADS_INTERIOR, _HEADS_TOP, _HEADS_BOT
    return {
        "top": _heads_fold(t, i, q), "bot": _heads_fold(b, i, q),
        "left": _heads_fold(i, t, q), "right": _heads_fold(i, b, q),
        "tl": _heads_fold(t, t, q), "tr": _heads_fold(t, b, q),
        "bl": _heads_fold(b, t, q), "br": _heads_fold(b, b, q),
    }


def _parity_select() -> np.ndarray:
    """``G[A, p, u]``: 1 where tap u (0..4) of a stride-2 5x5 conv reads
    parity block A - 1 at parity p (``u - 2 = 2 (A - 1) + p``)."""
    g = np.zeros((3, 2, 5))
    for u in range(5):
        a, p = divmod(u - 2, 2)
        g[a + 1, p, u] = 1.0
    return g


_PARITY_SELECT = _parity_select()


def _heads_parity_kernel(params: StateDict, composed=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``[3, 3, 4 nb + 4, Cout]`` kernel equal to the composed 5x5 stride-2
    heads conv on PARITY-PACKED input (``space_to_depth`` events, then the
    packed prev image): a pure reindex of the 5x5 kernel."""
    k5, b5 = composed if composed is not None else _composed_heads_kernel(params)
    nb, cout = k5.shape[2] - 1, k5.shape[3]
    g = _table(_PARITY_SELECT, k5)
    ev = torch.einsum("Apu,Bqv,uvco->ABpqco", g, g, k5[:, :, :nb])
    img = torch.einsum("Apu,Bqv,uvo->ABpqo", g, g, k5[:, :, nb])
    return torch.cat([ev.reshape(3, 3, 4 * nb, cout), img.reshape(3, 3, 4, cout)], dim=2), b5


def _heads_two_stage(params: StateDict, x: torch.Tensor) -> torch.Tensor:
    """The reference-shaped two-stage heads on a strip of input, for the
    border rows and columns where the composed conv is inexact."""
    a, b = _merged_head_kernel(params)
    u = conv_layer(x, {"weight": a.permute(3, 2, 0, 1), "bias": b}, padding=1)
    return conv_layer(u, _conv_params(params, "W0.conv2d"), stride=2, padding=1)


def heads_fused(params: StateDict, events: torch.Tensor, prev_image: torch.Tensor,
                kernels=None) -> torch.Tensor:
    """The heads (``e2v_model.py:62-66``): the composed 5x5 stride-2 conv in
    the interior, the two-stage heads on 6-row/column strips for the border
    rows and columns of the half-res output."""
    x = torch.cat([events, prev_image], dim=-1)
    k5, b5 = kernels["heads"] if kernels else _composed_heads_kernel(params)
    y = _conv(x, k5, stride=2, padding=2) + b5.to(x.dtype)
    b = x.shape[0]
    tb = _heads_two_stage(params, torch.cat([x[:, :6], x[:, -6:]], dim=0))
    lr = _heads_two_stage(params, torch.cat([x[:, :, :6], x[:, :, -6:]], dim=0))
    y[:, :1] = tb[:b, :1]
    y[:, -1:] = tb[b:, -1:]
    y[:, :, :1] = lr[:b, :, :1]
    y[:, :, -1:] = lr[b:, :, -1:]
    return y


def heads_fused_edgek(params: StateDict, events: torch.Tensor, prev_image: torch.Tensor,
                      kernels=None) -> torch.Tensor:
    """The heads by the composed 5x5 stride-2 conv and the folded border
    kernels: ``[B, H, W, nb]``, ``[B, H, W, 1]`` -> ``[B, H/2, W/2, C]``."""
    x = torch.cat([events, prev_image], dim=-1)
    k5, b5 = kernels["heads"] if kernels else _composed_heads_kernel(params)
    hb = _borders(kernels, "heads_borders", lambda: _heads_border_kernels(params))
    y = _set_borders(
        _conv(x, k5, stride=2, padding=2),
        _conv(torch.cat([x[:, :4], x[:, -4:]], dim=-1), hb["tb"], stride=(1, 2), padding=(0, 2),
              groups=2),
        _conv(torch.cat([x[:, :, :4], x[:, :, -4:]], dim=-1), hb["lr"], stride=(2, 1),
              padding=(2, 0), groups=2),
        _corners([x[:, :4, :4], x[:, :4, -4:], x[:, -4:, :4], x[:, -4:, -4:]], hb["corners"]),
    )
    # every value gets the one bias add, after its cast, as JAX's ``+ b5t``
    return y + b5.to(x.dtype)


def heads_parity_edgek(params: StateDict, ev_parity: torch.Tensor, img_parity: torch.Tensor,
                       kernels=None) -> torch.Tensor:
    """The heads on PARITY-PACKED inputs (``[B, H/2, W/2, 4 nb]`` events,
    ``[B, H/2, W/2, 4]`` image): one 3x3 conv over their concat, and the
    border kernels on thin full-res strips rebuilt from the edge blocks."""
    kp, b5 = kernels["heads_parity"] if kernels else _heads_parity_kernel(params)
    hb = _borders(kernels, "heads_borders", lambda: _heads_border_kernels(params))

    def strip(ev_sl, img_sl):
        return torch.cat([depth_to_space(ev_sl), depth_to_space(img_sl)], dim=-1)

    xt = strip(ev_parity[:, :2], img_parity[:, :2])        # full rows 0..3
    xb = strip(ev_parity[:, -2:], img_parity[:, -2:])      # rows H-4..H-1
    xl = strip(ev_parity[:, :, :2], img_parity[:, :, :2])  # full cols 0..3
    xr = strip(ev_parity[:, :, -2:], img_parity[:, :, -2:])
    y = _set_borders(
        _conv(torch.cat([ev_parity, img_parity], dim=-1), kp, padding=1),
        _conv(torch.cat([xt, xb], dim=-1), hb["tb"], stride=(1, 2), padding=(0, 2), groups=2),
        _conv(torch.cat([xl, xr], dim=-1), hb["lr"], stride=(2, 1), padding=(2, 0), groups=2),
        _corners([xt[:, :, :4], xt[:, :, -4:], xb[:, :, :4], xb[:, :, -4:]], hb["corners"]),
    )
    return y + b5.to(ev_parity.dtype)


# ---------------------------------------------------------------------------
# bilinear 2x + reflect conv3x3 -> parity-packed half-res conv
# ---------------------------------------------------------------------------

def _interior_taps() -> np.ndarray:
    """``U[a, p, r]``: the coefficient of conv tap r (0..2) of the full-res
    reflect conv over the bilinear 2x map, at half-res tap a (0..2), for
    output parity p (interior)."""
    u = np.zeros((3, 2, 3))
    for p in (0, 1):
        for r in (-1, 0, 1):
            m, pr = divmod(p + r, 2)
            for d, c in _BILINEAR_TAPS[pr]:
                u[m + d + 1, p, r + 1] += c
    return u


def _edge_taps(taps: dict, key_off: int) -> np.ndarray:
    """``E[s, p, d]``: the coefficient of conv tap d at edge row s (0, 1) of
    the half-res input, for output parity p, at a top (``_UP_EDGE0_TAPS``,
    0) or bottom (``_UP_EDGE1_TAPS``, 1) edge."""
    e = np.zeros((2, 2, 3))
    for p in (0, 1):
        for d in range(3):
            for s, c in taps[p + d - 1 + key_off]:
                e[s, p, d] += c
    return e


_UP_INTERIOR = _interior_taps()
_UP_EDGE0 = _edge_taps(_UP_EDGE0_TAPS, 0)
_UP_EDGE1 = _edge_taps(_UP_EDGE1_TAPS, 1)


def _up_fold(rows: np.ndarray, cols: np.ndarray, w: torch.Tensor) -> torch.Tensor:
    """``[rows, cols, Cin, 4 Cout]`` parity-packed kernel from the row and
    column tap tables and the HWIO conv weight; output channels (p, q, o)."""
    k = torch.einsum("xpr,yqs,rsio->xyipqo", _table(rows, w), _table(cols, w), w)
    return k.reshape(rows.shape[0], cols.shape[0], w.shape[2], 4 * w.shape[3])


def _upsample_parity_kernel(params: Params) -> tuple[torch.Tensor, torch.Tensor]:
    """``[3, 3, C, 4C]`` kernel computing all four parity classes of
    ``conv3x3(reflect_pad(bilinear2x(h)))`` in one half-res conv (interior)."""
    w = _hwio(params)
    return _up_fold(_UP_INTERIOR, _UP_INTERIOR, w), params["bias"].float().repeat(4)


def _up_border_kernels(params: Params) -> dict[str, torch.Tensor]:
    w = _hwio(params)
    i, e0, e1 = _UP_INTERIOR, _UP_EDGE0, _UP_EDGE1
    return {
        "top": _up_fold(e0, i, w), "bot": _up_fold(e1, i, w),
        "left": _up_fold(i, e0, w), "right": _up_fold(i, e1, w),
        "tl": _up_fold(e0, e0, w), "tr": _up_fold(e0, e1, w),
        "bl": _up_fold(e1, e0, w), "br": _up_fold(e1, e1, w),
    }


def upsample_conv_parity(params: Params, h: torch.Tensor, activation: str | None = None,
                         kernels=None) -> torch.Tensor:
    """``upsample_conv_layer`` emitting parity-packed output ``[B, H/2, W/2,
    4C]``, the border blocks recomputed by the reference op on 4-row/column
    slices."""
    kk, bb = kernels["upsamp"] if kernels else _upsample_parity_kernel(params)
    y = _conv(h, kk, padding=1) + bb.to(h.dtype)
    b, hh, wh = h.shape[0], h.shape[1], h.shape[2]
    tb = upsample_conv_layer(torch.cat([h[:, :4], h[:, -4:]], dim=0), params,
                             out_hw=(8, 2 * wh))
    lr = upsample_conv_layer(torch.cat([h[:, :, :4], h[:, :, -4:]], dim=0), params,
                             out_hw=(2 * hh, 8))
    # corners belong to the left/right strips (they are written last)
    y[:, :1] = space_to_depth(tb[:b, :2])
    y[:, -1:] = space_to_depth(tb[b:, -2:])
    y[:, :, :1] = space_to_depth(lr[:b, :, :2])
    y[:, :, -1:] = space_to_depth(lr[b:, :, -2:])
    return _ACTIVATIONS[activation](y)


def upsample_conv_parity_edgek(params: Params, h: torch.Tensor, activation: str | None = None,
                               kernels=None) -> torch.Tensor:
    """``upsample_conv_layer`` in the parity domain: one 3x3 conv, four thin
    edge convs and four corner products; ``[B, H/2, W/2, C]`` ->
    ``[B, H/2, W/2, 4C]``."""
    kk, bb = kernels["upsamp"] if kernels else _upsample_parity_kernel(params)
    bk = _borders(kernels, "upsamp_borders", lambda: _up_border_kernels(params))
    y = _set_borders(
        _conv(h, kk, padding=1),
        _conv(torch.cat([h[:, :2], h[:, -2:]], dim=-1), bk["tb"], padding=(0, 1), groups=2),
        _conv(torch.cat([h[:, :, :2], h[:, :, -2:]], dim=-1), bk["lr"], padding=(1, 0),
              groups=2),
        _corners([h[:, :2, :2], h[:, :2, -2:], h[:, -2:, :2], h[:, -2:, -2:]], bk["corners"]),
    )
    return _ACTIVATIONS[activation](y + bb.to(h.dtype))


# ---------------------------------------------------------------------------
# final reflect conv3x3 (C -> Cout) in the parity domain
# ---------------------------------------------------------------------------

def _final_taps() -> np.ndarray:
    """``S[A, t, p, r]``: 1 where tap r (0..2) of a full-res conv at output
    parity p reads half-res block A - 1 at parity t."""
    s = np.zeros((3, 2, 2, 3))
    for p in (0, 1):
        for r in (-1, 0, 1):
            m, pr = divmod(p + r, 2)
            s[m + 1, pr, p, r + 1] = 1.0
    return s


_FINAL_TAPS = _final_taps()


def _final_parity_kernel(params: Params) -> tuple[torch.Tensor, torch.Tensor]:
    """``[3, 3, 4C, 4 Cout]`` block kernel equal to a full-res 3x3 conv."""
    w = _hwio(params)
    c, cout = w.shape[2], w.shape[3]
    s = _table(_FINAL_TAPS, w)
    kk = torch.einsum("Aapr,Bbqs,rsio->ABabipqo", s, s, w).reshape(3, 3, 4 * c, 4 * cout)
    return kk, params["bias"].float().repeat(4)


def _keep_groups(x: torch.Tensor, groups: tuple[int, ...]) -> torch.Tensor:
    """``x`` with every parity group of its last axis but ``groups`` zeroed."""
    c = x.shape[-1] // 4
    keep = torch.zeros(4, 1, dtype=torch.bool, device=x.device)
    keep[list(groups)] = True
    return torch.where(keep.expand(4, c).reshape(4 * c), x, torch.zeros((), dtype=x.dtype,
                                                                         device=x.device))


def _reflect_pad_parity(y: torch.Tensor) -> torch.Tensor:
    """The parity-domain equivalent of reflect-padding the FULL-RES map by 1:
    full-res row -1 == row 1 == parity 1 of block 0 (and likewise at the other
    edges), so each pad block carries the mirrored parity channels and zeros
    in the channels the block kernel never reads."""
    yv = torch.cat([_keep_groups(y[:, :1], (2, 3)), y, _keep_groups(y[:, -1:], (0, 1))], dim=1)
    return torch.cat([_keep_groups(yv[:, :, :1], (1, 3)), yv,
                      _keep_groups(yv[:, :, -1:], (0, 2))], dim=2)


def final_conv_parity(params: Params, y_parity: torch.Tensor, kernels=None) -> torch.Tensor:
    """The full-res reflect conv3x3 on a parity-packed input, through a padded
    copy (``_reflect_pad_parity``); returns the FULL-RES result."""
    kk, bb = kernels["final"] if kernels else _final_parity_kernel(params)
    out = _conv(_reflect_pad_parity(y_parity), kk) + bb.to(y_parity.dtype)
    return depth_to_space(out)


def _final_border_kernels(params: Params, parity=None) -> dict[str, torch.Tensor]:
    """Additive border corrections for the parity-domain final conv: the
    zero-padded block conv misses, per edge, the block kernel's outer tap on
    the masked edge row/column and, per corner, one tap on one parity group
    of the corner block."""
    kk, _ = parity if parity is not None else _final_parity_kernel(params)
    c = kk.shape[2] // 4

    def keep(k, groups):  # zero the input channels outside ``groups``
        return _keep_groups(k.transpose(2, 3), groups).transpose(2, 3)

    return {
        # full row -1 == parity p = 1 of block row 0 -> keep pc in {2, 3}
        "top": keep(kk[0:1], (2, 3)), "bot": keep(kk[2:3], (0, 1)),
        "left": keep(kk[:, 0:1], (1, 3)), "right": keep(kk[:, 2:3], (0, 2)),
        # corner pads select one parity group of the corner block
        "tl": kk[0, 0, 3 * c:], "tr": kk[0, 2, 2 * c:3 * c],
        "bl": kk[2, 0, c:2 * c], "br": kk[2, 2, :c],
    }


def final_conv_parity_edgek(params: Params, y_parity: torch.Tensor, kernels=None,
                            packed: bool = False) -> torch.Tensor:
    """The full-res reflect conv3x3 on a parity-packed input without the
    padded copy: one 3x3 block conv plus additive edge and corner terms.
    Returns the FULL-RES result, or with ``packed`` the parity-packed ``[B,
    H/2, W/2, 4 Cout]`` one (the parity-IO recurrence feeds it straight back
    into ``heads_parity_edgek``)."""
    kk, bb = kernels["final"] if kernels else _final_parity_kernel(params)
    fb = _borders(kernels, "final_borders",
                  lambda: _final_border_kernels(params, parity=(kk, bb)))
    y = y_parity
    out = (_conv(y, kk, padding=1) + bb.to(y.dtype)).contiguous()
    b, h, w, n = out.shape
    tb = _conv(torch.cat([y[:, :1], y[:, -1:]], dim=-1), fb["tb"], padding=(0, 1), groups=2)
    lr = _conv(torch.cat([y[:, :, :1], y[:, :, -1:]], dim=-1), fb["lr"], padding=(1, 0),
               groups=2)
    # the corrections in the JAX package's order of adds: the top and bottom
    # rows, then the left and right columns (one strided add each; H, W >= 2)
    out[:, ::h - 1].add_(tb.reshape(b, w, 2, n).transpose(1, 2))
    out[:, :, ::w - 1].add_(lr.reshape(b, h, 2, n))
    corners = _corners([y[:, 0, 0], y[:, 0, -1], y[:, -1, 0], y[:, -1, -1]], fb["corners"])
    out.view(b, h * w, n).index_add_(1, _border_index(h, w, y.device)[-4:],
                                     corners.transpose(0, 1))
    return out if packed else depth_to_space(out)


# ---------------------------------------------------------------------------
# all kernels of one model-apply call
# ---------------------------------------------------------------------------

_CONV_LEAVES = ("top", "bot", "left", "right", "tb", "lr")


def _conv_layout(k: torch.Tensor, dtype) -> torch.Tensor:
    """HWIO ``k`` in ``dtype``, stored as channels_last OIHW (memory order
    O, H, W, I): ``k.permute(3, 2, 0, 1)`` is then what cuDNN reads."""
    return k.to(dtype).permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)


def precompute_fused_kernels(params: StateDict, dtype: torch.dtype | None = None) -> Params:
    """All composed and parity kernels of one model-apply call, from the state
    dict (``upsamp_conv.conv2d`` and ``final_conv.conv2d`` and the heads),
    made once ahead of the steps, as the JAX package hoists them out of its
    scan. ``dtype`` (default float32) is the activations' dtype: each leaf is
    cast once here, as every use would cast it. Each border dict holds the
    JAX package's eight leaves and the port's merged forms of them
    (``_merge_borders``), which the steps read. Differentiable: gradients
    flow to the stored convs."""
    dtype = dtype or torch.float32
    up = _conv_params(params, "upsamp_conv.conv2d")
    fin = _conv_params(params, "final_conv.conv2d")
    heads = _composed_heads_kernel(params)
    final = _final_parity_kernel(fin)

    def pair(kb):
        return _conv_layout(kb[0], dtype), kb[1].to(dtype)

    def borders(d, kind):
        return {k: _conv_layout(v, dtype) if k in _CONV_LEAVES else v.to(dtype)
                for k, v in {**d, **_merge_borders(d, kind)}.items()}

    return {
        "heads": pair(heads),
        "heads_parity": pair(_heads_parity_kernel(params, heads)),
        "heads_borders": borders(_heads_border_kernels(params), "heads"),
        "upsamp": pair(_upsample_parity_kernel(up)),
        "upsamp_borders": borders(_up_border_kernels(up), "upsamp"),
        "final": pair(final),
        "final_borders": borders(_final_border_kernels(fin, parity=final), "final"),
    }
