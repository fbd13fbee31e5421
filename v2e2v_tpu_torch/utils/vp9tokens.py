"""VP9 coefficient tokens (``vp9block.c::decode_coeffs_b_generic``) in plain
Python: one transform block's tokens, dequantised, in raster order.

The context of the first token is the number of the above and left
neighbours (by 4x4 columns and rows, any of the block's width or height)
that had coefficients; each later token's is ``(1 + e[a] + e[b]) >> 1``
over the energy classes of the two neighbours the scan names. The band is
the position's (``vp9_coefband_trans``); the first three node
probabilities are the context's and the other eight the Pareto tail of the
third (``vp9_pareto8_full``). A value is dequantised with the DC quantiser
at scan position 0 and the AC one after, halved towards zero in 32x32
blocks, and kept as FFmpeg keeps it, wrapped to 16 bits.

Every bit goes through the boolean decoder's ``bit``
(``utils/vp8.py::_Bool``), the sign's at probability 128.
"""

from __future__ import annotations

from . import vp9tables as T

CAT_PROBS = (T.CAT3_PROBS.tolist(), T.CAT4_PROBS.tolist(), T.CAT5_PROBS.tolist(),
             T.CAT6_PROBS.tolist())
CAT_BASE = (11, 19, 35, 67)
PARETO = [(0,) * 8] + [tuple(r) for r in T.PARETO8.tolist()]  # 0: band 0's unused contexts


def model_to_full(probs3: list) -> list:
    """A context's three probabilities and the Pareto tail of the third."""
    return list(probs3) + list(PARETO[probs3[2]])


def read_coeffs(br, probs, ctx: int, scan, nb, bands, n: int, dq_dc: int, dq_ac: int,
                half: bool, cnt, eobc, out: list, cache: list) -> int:
    """Tokens of one block into ``out`` (raster, dequantised, 16-bit); returns
    the number of scan positions read (0: none coded). ``probs[band][ctx]``
    holds the 11 node probabilities; ``cnt``/``eobc`` the frame's counts for
    this transform size, plane and reference."""
    bit = br.bit
    c = 0
    while c < n:
        band = bands[c]
        p = probs[band][ctx]
        b = bit(p[0])  # more tokens?
        eobc[band][ctx][b] += 1
        if not b:
            break
        while not bit(p[1]):  # zero tokens
            cnt[band][ctx][0] += 1
            cache[scan[c]] = 0
            c += 1
            if c == n:
                return c
            ctx = (1 + cache[nb[c][0]] + cache[nb[c][1]]) >> 1
            band = bands[c]
            p = probs[band][ctx]
        if not bit(p[2]):
            cnt[band][ctx][1] += 1
            val = energy = 1
        else:
            cnt[band][ctx][2] += 1
            if not bit(p[3]):
                if not bit(p[4]):
                    val = energy = 2
                else:
                    val, energy = 3 + bit(p[5]), 3
            elif not bit(p[6]):
                energy = 4
                if not bit(p[7]):
                    val = 5 + bit(159)
                else:
                    val = 7 + 2 * bit(165)
                    val += bit(145)
            else:
                energy = 5
                if not bit(p[8]):
                    cat = bit(p[9])
                else:
                    cat = 2 + bit(p[10])
                v = 0
                for prob in CAT_PROBS[cat]:
                    v = (v << 1) | bit(prob)
                val = CAT_BASE[cat] + v
        if bit(128):  # sign
            val = -val
        v = val * (dq_ac if c else dq_dc)
        if half:
            v = -((-v) >> 1) if v < 0 else v >> 1
        rc = scan[c]
        out[rc] = ((v + 32768) & 0xFFFF) - 32768
        cache[rc] = energy
        c += 1
        if c < n:
            ctx = (1 + cache[nb[c][0]] + cache[nb[c][1]]) >> 1
    return c
