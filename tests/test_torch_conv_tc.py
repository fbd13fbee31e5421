"""The bfloat16 tensor-core conv of kernels K1 and K2 (``csrc/conv3x3_tc.cuh``)
on the CPU.

The kernel runs only on the card (``tests/test_torch_cuda.py``). Here, a
pure-torch model of its tiling, taken from the header's own constants, is
held against the plain conv: each block's haloed input tile gathered with the
kernel's reflect/clamp index arithmetic, K in chunks of 64 channels with the
tail zero-filled, the 9 taps as shifted views of one staged tile, the taps in
the order the kernel stages them in shared memory (``wgmma_taps``), and the
ragged edge masked.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_parity import no_new_jax_cache_entries  # noqa: F401
from v2e2v_tpu_torch.ops.cuda import conv_tc

ROOT = Path(__file__).resolve().parents[1]
HEADER = (ROOT / "v2e2v_tpu_torch" / "csrc" / "conv3x3_tc.cuh").read_text()
# the kernel's own tile constants
K = {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", HEADER)}
TILE_H, TILE_W, KCH = K["TILE_H"], K["TILE_W"], K["KCH"]
IN_H, IN_W = TILE_H + 2, TILE_W + 2
# descriptor strides in bf16 elements (the header's are in bytes)
A_SBO, A_LBO = IN_W * 8, IN_H * IN_W * 8


def unlay(laid, cin, cout):
    """Inverse of ``wgmma_taps``: ``[9, cin, cout]`` and the padding."""
    nc, kc, _, _, nb8, _, _ = laid.shape
    full = laid.permute(2, 1, 3, 5, 0, 4, 6).reshape(9, kc * KCH, nc * nb8 * 8)
    return full[:, :cin, :cout], full


@pytest.mark.parametrize("cin,cout", [(128, 64), (64, 128), (192, 256), (8, 16), (24, 24),
                                      (72, 136)])
def test_wgmma_taps_is_a_permutation_and_inverts(cin, cout):
    """The laid-out taps hold every tap once and zeros elsewhere, each slice
    of one (output block, K chunk, tap) contiguous, in the header's K chunk
    and output block sizes."""
    assert KCH == conv_tc.KCH
    assert "inline int n_block(int cout) { return cout > 64 ? 128 : 64; }" in HEADER
    nb = conv_tc.n_block(cout)
    taps = torch.arange(1, 9 * cin * cout + 1, dtype=torch.float64).reshape(9, cin, cout)
    laid = conv_tc.wgmma_taps(taps)
    kc, nc = -(-cin // KCH), -(-cout // nb)
    assert laid.shape == (nc, kc, 9, 8, nb // 8, 8, 8) and laid.is_contiguous()
    back, full = unlay(laid, cin, cout)
    assert torch.equal(back, taps)
    assert int((full != 0).sum()) == taps.numel()  # the padding is zeros
    values = laid[laid != 0].sort().values
    assert torch.equal(values, taps.flatten())  # each tap exactly once
    # one slice: 16-byte rows of 8 neighbouring output channels of one input channel
    sl = laid[nc - 1, kc - 1, 4].reshape(-1, 8)
    ci0, co0 = (kc - 1) * KCH, (nc - 1) * nb
    for row in (0, 1, 9, sl.shape[0] - 1):
        g, rest = divmod(row, nb)  # [group][co group][ci][co]
        cog, ci = divmod(rest, 8)
        ci, co = ci0 + 8 * g + ci, co0 + 8 * cog
        want = F.pad(taps, (0, nc * nb - cout, 0, kc * KCH - cin))[4, ci, co:co + 8]
        assert torch.equal(sl[row], want)
    # HWIO weights lay out as their taps
    hwio = taps.reshape(3, 3, cin, cout)
    assert torch.equal(conv_tc.wgmma_taps(hwio.permute(0, 1, 2, 3)), laid)


def test_cached_wgmma_taps_follows_the_storage_and_in_place_updates():
    w = torch.randn(8, 16, 3, 3)  # OIHW float32, as in a state dict
    hwio = w.permute(2, 3, 1, 0)
    first = conv_tc.cached_wgmma_taps(hwio, torch.bfloat16)
    # another view of the same float32 weight hits, though the cast is new
    assert conv_tc.cached_wgmma_taps(w.permute(2, 3, 1, 0), torch.bfloat16) is first
    assert first.dtype == torch.bfloat16
    assert torch.equal(first, conv_tc.wgmma_taps(hwio.to(torch.bfloat16)))
    assert conv_tc.cached_wgmma_taps(hwio, torch.float32).dtype == torch.float32
    w.mul_(2)  # an in-place update bumps the version
    again = conv_tc.cached_wgmma_taps(w.permute(2, 3, 1, 0), torch.bfloat16)
    assert again is not first and torch.equal(again, 2 * first)


def reflect(i, n):
    """conv3x3.cuh reflect(): torch's reflect for the 1-pixel halo, clamped
    past it (rows and columns of a ragged tile's masked outputs)."""
    i = np.where(i < 0, -i, i)
    i = np.where(i >= n, 2 * (n - 1) - i, i)
    return np.clip(i, 0, n - 1)


def tiled_conv(xs, laids, cout):
    """What the kernel computes, block by block, in float64: per block the
    haloed input tile of each 64-channel chunk staged as [ci / 8][IN_H][IN_W]
    [8] (source rows reflected, then clamped; channels past cin zeros), the
    tap slice as the bulk copy stages it, A and B read through the wgmma
    descriptors' address formulas (A K-major: core matrices A_SBO apart
    along M, A_LBO along K; B N-major: NB * 8 elements apart along K, 64
    along N), 4 K steps of 16 per (chunk, tap), and the ragged edge masked."""
    b_, h, w, _ = xs[0].shape
    nb = conv_tc.n_block(cout)
    out = torch.zeros(b_, h, w, -(-cout // nb) * nb, dtype=torch.float64)
    m = np.arange(64)[:, None]  # rows of one warpgroup's A: 8x8 pixels
    k = np.arange(16)[None, :]
    a_off = (m // 8) * A_SBO + (m % 8) * 8 + (k // 8) * A_LBO + k % 8
    kk, nn = np.arange(16)[:, None], np.arange(nb)[None, :]
    b_off = (kk // 8) * nb * 8 + (nn // 8) * 64 + (kk % 8) * 8 + nn % 8
    for bi in range(b_):
        for h0 in range(0, h, TILE_H):
            for w0 in range(0, w, TILE_W):
                gy = reflect(h0 - 1 + np.arange(IN_H), h)
                gx = reflect(w0 - 1 + np.arange(IN_W), w)
                for nci in range(out.shape[-1] // nb):
                    acc = torch.zeros(2, 64, nb, dtype=torch.float64)
                    for x, laid in zip(xs, laids):
                        cin = x.shape[-1]
                        for kc in range(-(-cin // KCH)):
                            tile = torch.zeros(IN_H, IN_W, KCH, dtype=torch.float64)
                            chans = x[bi][gy][:, gx][..., kc * KCH:(kc + 1) * KCH]
                            tile[..., :chans.shape[-1]] = chans
                            smem_a = tile.reshape(IN_H, IN_W, 8, 8).permute(2, 0, 1, 3).flatten()
                            for t in range(9):
                                smem_b = laid[nci, kc, t].flatten()
                                for wg in range(2):
                                    start = ((8 * wg + t // 3) * IN_W + t % 3) * 8
                                    for q in range(KCH // 16):
                                        a_mat = smem_a[start + 2 * q * A_LBO + a_off]
                                        b_mat = smem_b[2 * q * nb * 8 + b_off]
                                        acc[wg] += a_mat @ b_mat
                    for wg in range(2):
                        for mi in range(64):
                            oy, ox = h0 + 8 * wg + mi // 8, w0 + mi % 8
                            if oy < h and ox < w:
                                out[bi, oy, ox, nci * nb:(nci + 1) * nb] = acc[wg, mi]
    return out[..., :cout]


@pytest.mark.parametrize("b,h,w,cins,cout", [
    (1, 17, 13, (8,), 24),       # C = 8: K chunk mostly zeros, cout below the block, ragged
    (1, 9, 21, (72,), 136),      # two K chunks with a tail, two output blocks of 128
    (2, 2, 2, (16,), 8),         # the 2x2 minimum: reflect then clamp
    (1, 16, 8, (8, 16), 64),     # one whole tile, two inputs (a concat conv)
])
def test_tiled_model_of_the_kernel_is_the_reflect_conv(b, h, w, cins, cout):
    g = torch.Generator().manual_seed(b * h * w + cout)
    xs = [torch.randn(b, h, w, c, generator=g, dtype=torch.float64) for c in cins]
    taps = [torch.randn(9, c, cout, generator=g, dtype=torch.float64) for c in cins]
    got = tiled_conv(xs, [conv_tc.wgmma_taps(t) for t in taps], cout)
    want = sum(F.conv2d(F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect"),
                        t.reshape(3, 3, *t.shape[1:]).permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
               for x, t in zip(xs, taps))
    torch.testing.assert_close(got, want, atol=1e-10, rtol=1e-10)
