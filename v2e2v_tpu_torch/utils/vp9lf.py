"""VP9's loop filter as FFmpeg's ``vp9`` decoder runs it (``vp9lpf.c``,
``vp9dsp_template.c::loop_filter``).

Each block with a level above 0 marks its edges in its 64x64 superblock's
masks (``mask_edges``): 16-, 8- or 4-wide, by its transform size,
its size, whether it is a skipped inter block, and the 4:2:0 rules for
chroma. ``segments`` turns a superblock's masks into filtered 8-pixel
segments as ``filter_plane_cols`` and ``filter_plane_rows`` walk them (the
frame's first column and row are not filtered; chroma takes the level of
the top-left 8x8 block of each 16x16; a 16-wide filter of two segments runs
at the first one's level; the inner 4x4 edges of luma). ``filter_lines``
is ``loop_filter`` on many lines at once: the filter mask from the level's
limits (``E = 2 (L + 2) + I``, ``I`` from the sharpness, ``H = L >> 4``),
the flat tests of the 8- and 16-wide filters and the 4-wide filter with its
high-edge-variance branch.

FFmpeg filters superblock after superblock in raster order, in each the
luma, Cb and Cr planes, first the edges between columns (left to right)
and then those between rows (top to bottom). A superblock's filter reads
and writes 8 pixels on either side of its edges, so superblock (r, c)
depends on (r, c - 1) and (r - 1, c + 1) but not on (r - 1, c + 2):
``loop_filter`` runs the superblocks of each anti-diagonal ``c + 2 r``
together (``order="wavefront"``), which gives raster order's result
(``order="raster"`` runs one superblock at a time, as FFmpeg does).
"""

from __future__ import annotations

import numpy as np

TX_4X4, TX_8X8 = 0, 1  # transform sizes


def limits(sharpness: int):
    """``filter_lut``: (mblim, lim) by level 0..63."""
    lim = np.zeros(64, np.int64)
    mblim = np.zeros(64, np.int64)
    for i in range(1, 64):
        limit = i
        if sharpness > 0:
            limit >>= (sharpness + 3) >> 2
            limit = min(limit, 9 - sharpness)
        limit = max(limit, 1)
        lim[i], mblim[i] = limit, 2 * (i + 2) + limit
    return mblim, lim


def mask_edges(mask, ss_h: int, ss_v: int, row_and_7: int, col_and_7: int, w: int, h: int,
               col_end: int, row_end: int, tx: int, skip_inter: bool) -> None:
    """``vp9block.c::mask_edges``: one block's edges into a superblock's
    ``mask[dir][row][kind]`` (dir 0: edges between columns, 1: between
    rows; kind 0: 16-wide, 1: 8-wide, 2: 4-wide, 3: 4-wide at the inner 4x4
    edge), bits by 8x8 column."""
    if tx == TX_4X4 and (ss_v or ss_h):
        if h == ss_v:
            if row_and_7 & 1:
                return
            if not row_end:
                h += 1
        if w == ss_h:
            if col_and_7 & 1:
                return
            if not col_end:
                w += 1
    t = 1 << col_and_7
    m_col = (t << w) - t
    if tx == TX_4X4 and not skip_inter:
        m_row_8 = m_col & (0x01 if ss_h else 0x11)
        m_row_4 = m_col - m_row_8
        for y in range(row_and_7, h + row_and_7):
            col_mask_id = 2 - (not (y & (0x07 if ss_v else 0x03)))
            mask[0][y][1] |= m_row_8
            mask[0][y][2] |= m_row_4
            if ss_h and ss_v and (col_end & 1) and (y & 1):
                mask[1][y][col_mask_id] |= (t << (w - 1)) - t
            else:
                mask[1][y][col_mask_id] |= m_col
            if not ss_h:
                mask[0][y][3] |= m_col
            if not ss_v:
                if ss_h and (col_end & 1):
                    mask[1][y][3] |= (t << (w - 1)) - t
                else:
                    mask[1][y][3] |= m_col
        return
    if not skip_inter:
        mask_id = int(tx == TX_8X8)
        l2 = tx + ss_h - 1
        m_row = m_col & (0xFF, 0x55, 0x11, 0x01)[l2]
        if ss_h and tx > TX_8X8 and (w ^ (w - 1)) == 1:
            m_row_16 = ((t << (w - 1)) - t) & (0xFF, 0x55, 0x11, 0x01)[l2]
            m_row_8 = m_row - m_row_16
            for y in range(row_and_7, h + row_and_7):
                mask[0][y][0] |= m_row_16
                mask[0][y][1] |= m_row_8
        else:
            for y in range(row_and_7, h + row_and_7):
                mask[0][y][mask_id] |= m_row
        l2 = tx + ss_v - 1
        step1d = 1 << l2
        if ss_v and tx > TX_8X8 and (h ^ (h - 1)) == 1:
            y = row_and_7
            while y < h + row_and_7 - 1:
                mask[1][y][0] |= m_col
                y += step1d
            if y - row_and_7 == h - 1:
                mask[1][y][1] |= m_col
        else:
            for y in range(row_and_7, h + row_and_7, step1d):
                mask[1][y][mask_id] |= m_col
    elif tx != TX_4X4:
        mask_id = int(tx == TX_8X8 or h == ss_v)
        mask[1][row_and_7][mask_id] |= m_col
        mask_id = int(tx == TX_8X8 or w == ss_h)
        for y in range(row_and_7, h + row_and_7):
            mask[0][y][mask_id] |= t
    else:
        t8 = t & (0x01 if ss_h else 0x11)
        t4 = t - t8
        for y in range(row_and_7, h + row_and_7):
            mask[0][y][2] |= t4
            mask[0][y][1] |= t8
        mask[1][row_and_7][2 - (not (row_and_7 & (0x07 if ss_v else 0x03)))] |= m_col


def segments(masks, lvl, sr: int, sc: int, out: dict, wave: int) -> None:
    """One superblock's filtered segments into ``out[(wave, plane, pass,
    step)]`` as lists of (y, x, width, level): vertical-edge segments are 8
    rows from (y, x), the edge left of x; horizontal ones 8 columns, the
    edge above y."""
    for plane in range(3):
        ss = plane > 0
        m = masks[int(ss)]
        y0, x0 = (32 * sr, 32 * sc) if ss else (64 * sr, 64 * sc)
        # edges between columns
        cols = m[0]
        for y in ((0, 4) if ss else (0, 2, 4, 6)):
            h1, h2 = cols[y], cols[y + 1 + ss]
            hm1, hm13 = h1[0] | h1[1] | h1[2], h1[3]
            hm2, hm23 = h2[1] | h2[2], h2[3]
            hm = hm1 | hm2 | hm13 | hm23
            py = y0 + (16 * (y // 4) if ss else 8 * y)
            for xi in range(8):
                x = 1 << xi
                if not hm & ~(x - 1):
                    break
                px = x0 + (4 * xi if ss else 8 * xi)
                lc = xi & ~1 if ss else xi
                l1, l2 = lvl[y][lc], lvl[y + 1 + ss][lc]
                key = (wave, plane, 0, 2 * xi)
                segs = out.setdefault(key, [])
                if sc or xi:
                    if hm1 & x:
                        if h1[0] & x:
                            segs.append((py, px, 16, l1))
                            if h2[0] & x:
                                segs.append((py + 8, px, 16, l1))
                        elif hm2 & x:
                            segs.append((py, px, 8 if h1[1] & x else 4, l1))
                            segs.append((py + 8, px, 8 if h2[1] & x else 4, l2))
                        else:
                            segs.append((py, px, 8 if h1[1] & x else 4, l1))
                    elif hm2 & x:
                        segs.append((py + 8, px, 8 if h2[1] & x else 4, l2))
                if not ss:
                    inner = out.setdefault((wave, plane, 0, 2 * xi + 1), [])
                    if hm13 & x:
                        inner.append((py, px + 4, 4, l1))
                        if hm23 & x:
                            inner.append((py + 8, px + 4, 4, l2))
                    elif hm23 & x:
                        inner.append((py + 8, px + 4, 4, l2))
        # edges between rows
        rows = m[1]
        for y in range(8):
            v = rows[y]
            vm, vm3 = v[0] | v[1] | v[2], v[3]
            py = y0 + (4 * y if ss else 8 * y)
            lr = y & ~1 if ss else y
            step = 2 if not ss else 4
            for xi in range(0, 8, step):
                x = 1 << xi
                if not vm & ~(x - 1):
                    break
                x2 = x << (step // 2 if not ss else 2)
                xi2 = xi + (1 if not ss else 2)
                px = x0 + (8 * xi if not ss else 4 * xi)
                px2 = px + 8
                l1, l2 = lvl[lr][xi], lvl[lr][xi2]
                segs = out.setdefault((wave, plane, 1, 2 * y), [])
                if sr or y:
                    if vm & x:
                        if v[0] & x:
                            segs.append((py, px, 16, l1))
                            if v[0] & x2:
                                segs.append((py, px2, 16, l1))
                        elif vm & x2:
                            segs.append((py, px, 8 if v[1] & x else 4, l1))
                            segs.append((py, px2, 8 if v[1] & x2 else 4, l2))
                        else:
                            segs.append((py, px, 8 if v[1] & x else 4, l1))
                    elif vm & x2:
                        segs.append((py, px2, 8 if v[1] & x2 else 4, l2))
                if not ss:
                    inner = out.setdefault((wave, plane, 1, 2 * y + 1), [])
                    if vm3 & x:
                        inner.append((py + 4, px, 4, l1))
                        if vm3 & x2:
                            inner.append((py + 4, px2, 4, l2))
                    elif vm3 & x2:
                        inner.append((py + 4, px2, 4, l2))


def filter_lines(parts, vertical: bool, wd: np.ndarray, E: np.ndarray, I: np.ndarray,
                 H: np.ndarray) -> None:
    """``loop_filter`` on lines across edges, in place: ``parts`` lists
    (plane, y, x) with the edge at (``y``, ``x``) of each line (a pixel row
    for a vertical edge, a column for a horizontal one); ``wd``, ``E``,
    ``I``, ``H`` run over the parts' lines in order."""
    k = np.arange(-8, 8)
    where = []
    for plane, y, x in parts:
        if vertical:
            ys = np.broadcast_to(y[:, None], (len(y), 16))
            xs = np.maximum(x[:, None] + k, 0)
        else:
            ys = np.maximum(y[:, None] + k, 0)
            xs = np.broadcast_to(x[:, None], (len(x), 16))
        where.append((plane, ys, xs))
    P = np.concatenate([plane[ys, xs] for plane, ys, xs in where]).astype(np.int64)
    p = [P[:, 7 - i] for i in range(8)]  # p0..p7
    q = [P[:, 8 + i] for i in range(8)]  # q0..q7
    ab = np.abs
    fm = ((ab(p[3] - p[2]) <= I) & (ab(p[2] - p[1]) <= I) & (ab(p[1] - p[0]) <= I)
          & (ab(q[1] - q[0]) <= I) & (ab(q[2] - q[1]) <= I) & (ab(q[3] - q[2]) <= I)
          & (ab(p[0] - q[0]) * 2 + (ab(p[1] - q[1]) >> 1) <= E))
    flat8in = ((ab(p[3] - p[0]) <= 1) & (ab(p[2] - p[0]) <= 1) & (ab(p[1] - p[0]) <= 1)
               & (ab(q[1] - q[0]) <= 1) & (ab(q[2] - q[0]) <= 1) & (ab(q[3] - q[0]) <= 1))
    flat8out = np.ones(len(P), bool)
    for i in range(4, 8):
        flat8out &= (ab(p[i] - p[0]) <= 1) & (ab(q[i] - q[0]) <= 1)
    c16 = fm & (wd >= 16) & flat8in & flat8out
    c8 = fm & (wd >= 8) & flat8in & ~c16
    c4 = fm & ~c16 & ~c8
    new = P.copy()
    if c16.any():
        e = P[c16]
        pad = np.concatenate([np.repeat(e[:, :1], 7, 1), e, np.repeat(e[:, -1:], 7, 1)], 1)
        cs = np.cumsum(np.concatenate([np.zeros((len(e), 1), np.int64), pad], 1), 1)
        for pos in range(1, 15):  # p6 .. q6
            win = cs[:, pos + 15] - cs[:, pos]  # the 15 taps around pos, edges repeated
            new[c16, pos] = (win + e[:, pos] + 8) >> 4
    if c8.any():
        e = P[c8]
        pad = np.concatenate([np.repeat(e[:, 4:5], 3, 1), e[:, 4:12], np.repeat(e[:, 11:12], 3, 1)],
                             1)
        for pos in range(5, 11):  # p2 .. q2
            j = pos - 4 + 3
            new[c8, pos] = (pad[:, j - 3:j + 4].sum(1) + e[:, pos] + 4) >> 3
    if c4.any():
        p1, p0, q0, q1 = P[c4, 6], P[c4, 7], P[c4, 8], P[c4, 9]
        hev = (ab(p1 - p0) > H[c4]) | (ab(q1 - q0) > H[c4])
        f = np.where(hev, np.clip(p1 - q1, -128, 127), 0)
        f = np.clip(3 * (q0 - p0) + f, -128, 127)
        f1 = np.minimum(f + 4, 127) >> 3
        f2 = np.minimum(f + 3, 127) >> 3
        new[c4, 7] = np.clip(p0 + f2, 0, 255)
        new[c4, 8] = np.clip(q0 - f1, 0, 255)
        g = (f1 + 1) >> 1
        new[c4, 6] = np.where(hev, p1, np.clip(p1 + g, 0, 255))
        new[c4, 9] = np.where(hev, q1, np.clip(q1 - g, 0, 255))
    sel, at = slice(1, 15), 0
    for plane, ys, xs in where:
        plane[ys[:, sel], xs[:, sel]] = new[at:at + len(ys), sel]
        at += len(ys)


def loop_filter(planes, masks, levels, sharpness: int, order: str = "wavefront") -> None:
    """Filter ``planes`` (Y, Cb, Cr int32 arrays with 16 pixels of margin
    past the 64-aligned frame) in place from every superblock's masks
    ``[sb_rows, sb_cols, 2, 2, 8, 4]`` and levels ``[sb_rows, sb_cols, 8, 8]``."""
    mblim, lim = limits(sharpness)
    sb_rows, sb_cols = levels.shape[:2]
    work: dict = {}
    for sr in range(sb_rows):
        for sc in range(sb_cols):
            if not masks[sr, sc].any():
                continue
            wave = sc + 2 * sr if order == "wavefront" else sr * sb_cols + sc
            segments(masks[sr, sc].tolist(), levels[sr, sc].tolist(), sr, sc, work, wave)
    # the three planes are independent: one call filters a step of each
    steps: dict = {}
    for (wave, plane, pas, step), segs in work.items():
        if segs:
            steps.setdefault((wave, pas, step), []).append((plane, segs))
    for (_, pas, _), groups in sorted(steps.items()):
        parts, wds, levels_ = [], [], []
        for plane, segs in sorted(groups):
            s = np.array(segs, np.int64)
            n = np.tile(np.arange(8), len(s))
            y = np.repeat(s[:, 0], 8)
            x = np.repeat(s[:, 1], 8)
            if pas == 0:
                y = y + n
            else:
                x = x + n
            parts.append((planes[plane], y, x))
            wds.append(np.repeat(s[:, 2], 8))
            levels_.append(np.repeat(s[:, 3], 8))
        L = np.concatenate(levels_)
        filter_lines(parts, pas == 0, np.concatenate(wds), mblim[L], lim[L], L >> 4)
