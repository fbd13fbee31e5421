"""The taps of the hand-written convs of kernels K1 and K2 in the order the
kernels stage them in shared memory.

The bfloat16 tensor-core conv (``csrc/conv3x3_tc.cuh``) streams one tap's
slice of one 64-channel K chunk at a time into a ring of shared-memory
buffers, each slice with a single bulk copy, so the slices are laid out once,
here, in the exact byte order that ``wgmma`` reads: for every block of ``NB``
output channels, every 64-channel chunk of the input channels and every tap,
a contiguous ``[8, NB / 8, 8, 8]`` block (input-channel group, output-channel
group, 8 input channels, 8 output channels), each 16-byte row 8 neighbouring
output channels of one input channel: N-major core matrices, read with
wgmma's B-transpose bit (``wgmma_taps``). The float32 conv
(``csrc/conv3x3.cuh``) stages all 9 taps of one 16-channel chunk for a block
of 64 output channels with one bulk copy: for every block of 64 output
channels and every chunk of 16 input channels, a contiguous ``[9, 16, 64]``
block (``simt_taps``). The int8 conv of kernel K4 (``csrc/qconv3x3.cu``)
copies the 9 taps of one 32-channel K chunk for a block of ``NB`` output
channels with one bulk copy; 8-bit ``wgmma`` has no transpose bit, so its B
operand is K-major: per tap a ``[2, NB / 8, 8, 16]`` block (input-channel
group, output-channel group, 8 output channels, 16 input channels), each
16-byte row 16 neighbouring input channels of one output channel
(``s8_taps``). Input
channels past ``cin`` and output channels past ``cout`` are zeros.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F

KCH = 64  # input channels per K chunk (conv3x3_tc.cuh KCH)
SIMT_KC, SIMT_CO = 16, 64  # input channels per chunk, output channels per block (conv3x3.cuh)
S8_KCH, S8_KG = 32, 16  # int8 conv: input channels per K chunk and per core-matrix row
_CACHE_SIZE = 32
_cache: OrderedDict = OrderedDict()  # key -> (source weight, laid-out taps)


def n_block(cout: int) -> int:
    """Output channels per block (``conv3x3_tc.cuh`` ``n_block``)."""
    return 128 if cout > 64 else 64


def wgmma_taps(taps: torch.Tensor) -> torch.Tensor:
    """Taps ``[9, cin, cout]`` or HWIO ``[3, 3, cin, cout]`` -> ``[ceil(cout /
    NB), ceil(cin / 64), 9, 8, NB / 8, 8, 8]`` in ``taps.dtype``, ``NB =
    n_block(cout)``."""
    cin, cout = taps.shape[-2:]
    taps = taps.reshape(9, cin, cout)
    nb = n_block(cout)
    kc, nc = -(-cin // KCH), -(-cout // nb)
    t = F.pad(taps, (0, nc * nb - cout, 0, kc * KCH - cin))
    t = t.reshape(9, kc, 8, 8, nc, nb // 8, 8)  # tap, chunk, group, ci, block, co group, co
    return t.permute(4, 1, 0, 2, 5, 3, 6).contiguous()


def simt_taps(taps: torch.Tensor) -> torch.Tensor:
    """Taps ``[9, cin, cout]`` or HWIO ``[3, 3, cin, cout]`` -> ``[ceil(cout /
    64), ceil(cin / 16), 9, 16, 64]`` in ``taps.dtype``."""
    cin, cout = taps.shape[-2:]
    taps = taps.reshape(9, cin, cout)
    kc, nc = -(-cin // SIMT_KC), -(-cout // SIMT_CO)
    t = F.pad(taps, (0, nc * SIMT_CO - cout, 0, kc * SIMT_KC - cin))
    t = t.reshape(9, kc, SIMT_KC, nc, SIMT_CO)  # tap, chunk, ci, block, co
    return t.permute(3, 1, 0, 2, 4).contiguous()


def s8_taps(w_q: torch.Tensor, cin_a: int) -> torch.Tensor:
    """int8 OIHW weights ``[cout, cin_a + cin_b, 3, 3]`` of a conv on the
    concat of two inputs (``cin_b`` may be 0) -> ``[ceil(cout / NB), chunks,
    9, 2, NB / 8, 8, 16]`` int8, ``NB = n_block(cout)``: each input's
    channels in chunks of 32 (the first input's chunks, then the second's),
    and per chunk and tap the K-major B operand of ``wgmma`` m64nNk32 s8: for
    16-channel group ``kg`` and output channel ``8 ng + r`` of the block, the
    16 bytes of input channels ``16 kg .. 16 kg + 15`` of the chunk."""
    cout = w_q.shape[0]
    nb = n_block(cout)
    nc = -(-cout // nb)
    parts = []
    for w in (w_q[:, :cin_a], w_q[:, cin_a:]):
        if w.shape[1] == 0:
            continue
        kc = -(-w.shape[1] // S8_KCH)
        t = F.pad(w, (0, 0, 0, 0, 0, kc * S8_KCH - w.shape[1], 0, nc * nb - cout))
        # block, co group, co, chunk, ci group, ci, dy, dx
        t = t.reshape(nc, nb // 8, 8, kc, S8_KCH // S8_KG, S8_KG, 3, 3)
        parts.append(t.permute(0, 3, 6, 7, 4, 1, 2, 5).reshape(
            nc, kc, 9, S8_KCH // S8_KG, nb // 8, 8, S8_KG))
    return torch.cat(parts, dim=1).contiguous()


def _cached(layout, weight: torch.Tensor, dtype: torch.dtype, *args) -> torch.Tensor:
    """``layout(weight.to(dtype), *args)``, laid out once for the same weight:
    the key is the storage, offset, strides, shape, dtype and version counter
    of ``weight`` (an in-place update bumps the version), ``dtype``, the
    layout and ``args``; an entry holds ``weight``, so its memory is not
    reused while cached."""
    key = (weight.untyped_storage().data_ptr(), weight.storage_offset(), weight.stride(),
           tuple(weight.shape), weight.dtype, weight.device, weight._version, dtype, layout,
           args)
    hit = _cache.get(key)
    if hit is not None:
        _cache.move_to_end(key)
        return hit[1]
    laid = layout(weight.to(dtype), *args)
    _cache[key] = (weight, laid)
    if len(_cache) > _CACHE_SIZE:
        _cache.popitem(last=False)
    return laid


def cached_wgmma_taps(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``wgmma_taps(weight.to(dtype))``, laid out once for the same weight:
    kernel K1 takes its weights as tensors on every call (a pool passes the
    same ones every step), so its wrapper keeps their layout here. Kernel
    K2's bfloat16 taps are laid out once by ``core_taps`` instead."""
    return _cached(wgmma_taps, weight, dtype)


def cached_simt_taps(weight: torch.Tensor) -> torch.Tensor:
    """``simt_taps(weight.float())``, laid out once for the same weight: the
    float32 taps of K1 (per call) and of K2 (``core_taps``' float32 taps)."""
    return _cached(simt_taps, weight, torch.float32)


def cached_s8_taps(w_q: torch.Tensor, cin_a: int) -> torch.Tensor:
    """``s8_taps(w_q, cin_a)``, laid out once for the same int8 weights:
    kernel K4 takes them as tensors on every call (a pool quantizes them once
    and passes the same ones every step)."""
    return _cached(s8_taps, w_q, torch.int8, cin_a)
