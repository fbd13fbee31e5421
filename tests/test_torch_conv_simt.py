"""The float32 conv of kernels K1 and K2 (``csrc/conv3x3.cuh``) on the CPU.

The kernel runs only on the card (``tests/test_torch_cuda.py``). Here, a
numpy model of what each of its threads does, taken from the header's own
constants and index formulas, is held against the plain reflect conv: per
block and 16-channel chunk, every thread's 16-byte copies of the haloed input
tile (its fixed pixels, reflected then clamped, channels past cin zero-filled)
into ``[ci / 4][TH + 2][8 GX + 2][4]`` planes, the tap slice as the bulk copy
stages it from ``simt_taps``, every thread's 8 pixels x 8 channels read from
those planes and slices, and the ragged edge masked, for each tile width.
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
HEADER = (ROOT / "v2e2v_tpu_torch" / "csrc" / "conv3x3.cuh").read_text()
# the kernel's own constants
K = {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", HEADER)}
TH, PX, CO, CO_BLOCK, KC, STAGES = (K[k] for k in ("TH", "PX", "CO", "CO_BLOCK", "KC", "STAGES"))
SMEM_LIMIT, SM_SMEM = 232448, 233472  # a block's and an SM's shared memory on an H100


class Tile:
    """``Tile<GX>`` of the header, its formulas restated."""

    def __init__(self, gx):
        self.tw = PX * gx
        self.ih, self.iw = TH + 2, self.tw + 2
        self.threads = TH * gx * (CO_BLOCK // CO)
        ihw = self.ih * self.iw
        self.plane = ihw + (10 - ihw % 8) % 8
        self.stage_bytes = 9 * KC * CO_BLOCK * 4 + KC // 4 * self.plane * 16
        self.copies = -(-(KC // 4 * ihw) // self.threads)
        self.smem = STAGES * self.stage_bytes + 8 * STAGES


def test_header_constants_and_shared_memory():
    assert "static constexpr int PLANE = IH * IW + (10 - IH * IW % 8) % 8;" in HEADER
    assert (conv_tc.SIMT_KC, conv_tc.SIMT_CO) == (KC, CO_BLOCK)
    for gx in (1, 2, 4):
        t = Tile(gx)
        assert t.plane % 8 == 2  # a quad's 4 planes of one pixel lie in 4 bank groups
        assert (t.iw * 16) % 128 == 32  # a warp's 4 rows lie in 4 bank groups
        assert t.smem <= SMEM_LIMIT
        if gx < 4:  # two blocks of the narrow tiles fit on an SM (1 KB reserved each)
            assert 2 * (t.smem + 1024) <= SM_SMEM
    assert STAGES == 2 and Tile(4).smem == 118032 and Tile(4).threads == 256


def unlay(laid, cin, cout):
    """Inverse of ``simt_taps``: ``[9, cin, cout]`` and the padding."""
    nc, kc = laid.shape[:2]
    full = laid.permute(2, 1, 3, 0, 4).reshape(9, kc * KC, nc * CO_BLOCK)
    return full[:, :cin, :cout], full


@pytest.mark.parametrize("cin,cout", [(128, 64), (64, 128), (192, 256), (8, 16), (24, 24),
                                      (72, 136)])
def test_simt_taps_is_a_permutation_and_inverts(cin, cout):
    """Every tap once and zeros elsewhere; one (output block, chunk) slice is
    9 x 16 rows of 64 output channels, contiguous."""
    taps = torch.arange(1, 9 * cin * cout + 1, dtype=torch.float64).reshape(9, cin, cout)
    laid = conv_tc.simt_taps(taps)
    kc, nc = -(-cin // KC), -(-cout // CO_BLOCK)
    assert laid.shape == (nc, kc, 9, KC, CO_BLOCK) and laid.is_contiguous()
    back, full = unlay(laid, cin, cout)
    assert torch.equal(back, taps)
    assert int((full != 0).sum()) == taps.numel()
    assert torch.equal(laid[laid != 0].sort().values, taps.flatten())
    assert torch.equal(laid[0, 0, 4, 1], taps[4, 1, :CO_BLOCK] if cout >= CO_BLOCK else
                       F.pad(taps[4, 1], (0, CO_BLOCK - cout)))
    hwio = taps.reshape(3, 3, cin, cout)
    assert torch.equal(conv_tc.simt_taps(hwio), laid)


def test_cached_simt_taps_follows_the_storage_and_in_place_updates():
    w = torch.randn(3, 3, 16, 8, generator=torch.Generator().manual_seed(0))
    first = conv_tc.cached_simt_taps(w)
    assert conv_tc.cached_simt_taps(w) is first
    assert torch.equal(first, conv_tc.simt_taps(w))
    assert conv_tc.cached_wgmma_taps(w, torch.float32) is not first  # another layout
    w.mul_(2)  # bumps the version
    again = conv_tc.cached_simt_taps(w)
    assert again is not first and torch.equal(again, conv_tc.simt_taps(w))
    bf = conv_tc.cached_simt_taps(w.to(torch.bfloat16))
    assert bf.dtype == torch.float32


def reflect(i, n):
    """conv3x3.cuh reflect(): torch's reflect for the 1-pixel halo, clamped
    past it (rows and columns of a ragged tile's masked outputs)."""
    i = np.where(i < 0, -i, i)
    i = np.where(i >= n, 2 * (n - 1) - i, i)
    return np.clip(i, 0, n - 1)


def tiled_conv(xs, laids, cout, gx):
    """What the kernel computes with ``Tile<gx>``, thread by thread, in
    float64 (the ``acc`` of every thread, its pixel and channel indices, and
    every shared-memory index as the header writes them)."""
    t = Tile(gx)
    b_, h, w, _ = xs[0].shape
    tiles_w, tiles_h = -(-w // t.tw), -(-h // TH)
    nz = -(-cout // CO_BLOCK)
    out = np.full((b_, h, w, nz * CO_BLOCK), np.nan)
    tid = np.arange(t.threads)
    warp, lane = tid // 32, tid % 32
    cg, r, c0 = lane % 8, (warp % 2) * 4 + lane // 8, (warp // 2) * PX
    g = tid % (KC // 4)
    xs = [x.numpy() for x in xs]
    laids = [laid.numpy().reshape(laid.shape[0], laid.shape[1], -1) for laid in laids]
    for bi in range(b_):
        for bx in range(tiles_w * tiles_h):
            h0, w0 = (bx // tiles_w) * TH, (bx % tiles_w) * t.tw
            ps = [tid // (KC // 4) + k * (t.threads // (KC // 4)) for k in range(t.copies)]
            pix = [reflect(h0 - 1 + p // t.iw, h) * w + reflect(w0 - 1 + p % t.iw, w)
                   for p in ps]
            for z in range(nz):
                acc = np.zeros((t.threads, PX, CO))
                for x, laid in zip(xs, laids):
                    cin = x.shape[-1]
                    flat = x[bi].reshape(h * w, cin)
                    for kc in range(-(-cin // KC)):
                        in4 = np.full((KC // 4 * t.plane, 4), np.nan)  # unwritten: NaN
                        ci = kc * KC + 4 * g
                        ok = ci < cin
                        for k, p in enumerate(ps):
                            live = (p < t.ih * t.iw) if k == t.copies - 1 else np.ones_like(p, bool)
                            dst = g * t.plane + p
                            val = np.zeros((t.threads, 4))
                            src = np.minimum(ci, cin - 4)
                            val[ok] = flat[pix[k][ok][:, None], src[ok][:, None] + np.arange(4)]
                            in4[dst[live]] = val[live]
                        w4 = laid[z, kc].reshape(-1, 4)  # the bulk copy of the slice
                        for dy in range(3):
                            for q in range(KC // 4):
                                row = q * t.plane + (r + dy) * t.iw + c0
                                v = in4[row[:, None] + np.arange(PX + 2)]  # [T, 10, 4]
                                wrow = (dy * 3 * KC + 4 * q) * (CO_BLOCK // 4) + cg
                                for e in range(4):
                                    for dx in range(3):
                                        i4 = wrow + (dx * KC + e) * (CO_BLOCK // 4)
                                        wv = np.concatenate([w4[i4], w4[i4 + 8]], axis=1)
                                        xv = v[:, dx:dx + PX, e]
                                        acc += xv[:, :, None] * wv[:, None, :]
                ch0 = z * CO_BLOCK + 4 * cg
                for j in range(PX):
                    oy, ox = h0 + r, w0 + c0 + j
                    keep = (oy < h) & (ox < w)
                    for hh in range(2):
                        for e in range(4):
                            out[bi, oy[keep], ox[keep], ch0[keep] + 32 * hh + e] = \
                                acc[keep, j, 4 * hh + e]
    return torch.from_numpy(out[..., :cout])


@pytest.mark.parametrize("gx", [1, 2, 4])
@pytest.mark.parametrize("b,h,w,cins,cout", [
    (1, 9, 21, (24,), 24),       # ragged tiles, a partial chunk, cout below the block
    (1, 17, 13, (8, 16), 72),    # two inputs, cin = 8, two output blocks, the second 8 wide
    (2, 2, 2, (16,), 8),         # the 2x2 minimum: reflect then clamp
])
def test_tiled_model_of_the_kernel_is_the_reflect_conv(gx, b, h, w, cins, cout):
    g = torch.Generator().manual_seed(b * h * w + cout)
    xs = [torch.randn(b, h, w, c, generator=g, dtype=torch.float64) for c in cins]
    taps = [torch.randn(9, c, cout, generator=g, dtype=torch.float64) for c in cins]
    got = tiled_conv(xs, [conv_tc.simt_taps(t) for t in taps], cout, gx)
    want = sum(F.conv2d(F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect"),
                        t.reshape(3, 3, *t.shape[1:]).permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
               for x, t in zip(xs, taps))
    torch.testing.assert_close(got, want, atol=1e-10, rtol=1e-10)
