"""The taps of the bfloat16 tensor-core conv (``csrc/conv3x3_tc.cuh``) in the
order the kernel stages them in shared memory.

The kernel streams one tap's slice of one 64-channel K chunk at a time into a
ring of shared-memory buffers, each slice with a single bulk copy, so the
slices are laid out once, here, in the exact byte order that ``wgmma`` reads:
for every block of ``NB`` output channels, every 64-channel chunk of the
input channels and every tap, a contiguous ``[8, NB / 8, 8, 8]`` block
(input-channel group, output-channel group, 8 input channels, 8 output
channels), each 16-byte row 8 neighbouring output channels of one input
channel: N-major core matrices, read with wgmma's B-transpose bit. Input
channels past ``cin`` and output channels past ``cout`` are zeros.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F

KCH = 64  # input channels per K chunk (conv3x3_tc.cuh KCH)
_CACHE_SIZE = 8
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


def cached_wgmma_taps(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``wgmma_taps(weight.to(dtype))``, laid out once for the same weight:
    kernel K1 takes its weights as tensors on every call (a pool passes the
    same ones every step), so its wrapper keeps their layout here. The key is
    the storage, offset, strides, shape, dtype and version counter of
    ``weight`` (an in-place update bumps the version) and ``dtype``; an entry
    holds ``weight``, so its memory is not reused while cached. Kernel K2's
    taps are laid out once by ``core_taps`` instead."""
    key = (weight.untyped_storage().data_ptr(), weight.storage_offset(), weight.stride(),
           tuple(weight.shape), weight.dtype, weight.device, weight._version, dtype)
    hit = _cache.get(key)
    if hit is not None:
        _cache.move_to_end(key)
        return hit[1]
    laid = wgmma_taps(weight.to(dtype))
    _cache[key] = (weight, laid)
    if len(_cache) > _CACHE_SIZE:
        _cache.popitem(last=False)
    return laid
