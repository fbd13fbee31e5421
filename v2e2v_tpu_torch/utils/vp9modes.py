"""VP9 per-block syntax (``vp9block.c::decode_mode``, ``vp9mvs.c``,
``vp9.c::decode_sb``) in plain Python, as FFmpeg's ``vp9`` decoder reads
it: the partition tree from 64x64 down to 8x8, each block's segment, skip
flag, transform size, intra modes (by the above and left modes on key
frames, by block size on inter frames, per 4x4 or 4x8 / 8x4 sub-block
under 8x8), and on inter frames the reference (single or compound, with
libvpx's contexts), interpolation filter, inter modes and motion vectors:
``find_ref_mvs`` over the candidate positions of the block size, the
previous frame's vectors (when FFmpeg's ``use_last_frame_mvs`` holds),
candidates of other references with the sign bias applied, clamping, the
precision lowered by the best vector's size, and the sub-8x8 candidates of
``append_sub8x8_mvs_for_idx``; then the coefficient tokens of every
transform block (``utils/vp9tokens.py``).

``TileDecoder.block`` records what reconstruction needs: for each intra
block its transform blocks in decoding order (each predicted from the
frame decoded so far), for each inter block its prediction, and the
dequantised coefficients of every transform block that has any. It also
sets the loop filter's masks and levels per 64x64 superblock
(``vp9lf.mask_edges``, ported from ``vp9block.c``).

Modes, references and block sizes are numbered as libvpx numbers them
(``utils/vp9tables.py``); a motion vector is ``(row, col)`` in 1/8 pixel.
"""

from __future__ import annotations

import numpy as np

from . import vp9tables as T
from .vp9 import (ALTREF_FRAME, COMPOUND_REFERENCE, GOLDEN_FRAME, LAST_FRAME,
                  REFERENCE_MODE_SELECT, SWITCHABLE, TX_MODE_SELECT, refused)
from .vp9lf import mask_edges
from .vp9tokens import model_to_full, read_coeffs

BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8 = 0, 1, 2, 3
PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT = range(4)
DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D117_PRED, D153_PRED, D207_PRED, D63_PRED, \
    TM_PRED = range(10)
NEARESTMV, NEARMV, ZEROMV, NEWMV = 10, 11, 12, 13
TX_4X4, TX_8X8, TX_16X16, TX_32X32 = range(4)
DCT_DCT = 0
WHT = 4  # the lossless 4x4 Walsh-Hadamard transform, as a transform "type"
TX_MODE_TO_BIGGEST = (0, 1, 2, 3, 3)

W8 = T.NUM_8X8_WIDE.tolist()
H8 = T.NUM_8X8_HIGH.tolist()
MAX_TX = T.MAX_TXSIZE.tolist()
SIZE_GROUP = T.SIZE_GROUP.tolist()
SUBSIZE = T.SUBSIZE.tolist()
PART_CTX = T.PARTITION_CONTEXT.tolist()
MV_REF = T.MV_REF_BLOCKS.tolist()
C2C = T.COUNTER_TO_CONTEXT.tolist()
M2C = T.MODE_2_COUNTER.tolist()
TX_TYPE = T.INTRA_MODE_TO_TX_TYPE.tolist()
KF_Y = T.KF_Y_MODE_PROBS.tolist()
KF_UV = T.KF_UV_MODE_PROBS.tolist()
KF_PART = T.KF_PARTITION_PROBS.tolist()
TREES = {name: getattr(T, name).tolist() for name in (
    "INTRA_MODE_TREE", "INTER_MODE_TREE", "PARTITION_TREE", "SWITCHABLE_INTERP_TREE",
    "SEGMENT_TREE", "MV_JOINT_TREE", "MV_CLASS_TREE", "MV_FP_TREE")}
SCANS = {}
for _n, _t in ((4, 0), (8, 1), (16, 2), (32, 3)):
    for _kind, _types in (("DEFAULT", (0, 3)), ("ROW", (1,)), ("COL", (2,))):
        if _n == 32 and _kind != "DEFAULT":
            continue
        _scan = getattr(T, f"{_kind}_SCAN_{_n}X{_n}").tolist()
        _nb = [tuple(p) for p in getattr(T, f"{_kind}_SCAN_{_n}X{_n}_NEIGHBORS").tolist()]
        for _type in _types:
            SCANS[_t, _type] = (_scan, _nb)
for _type in (1, 2, 3):
    SCANS[3, _type] = SCANS[3, 0]
SCANS[0, WHT] = SCANS[0, 0]
BANDS = (T.COEFBAND_4X4.tolist(), T.COEFBAND_8X8PLUS.tolist())
ZERO_MV = (0, 0)


def tree(br, t: list, probs) -> int:
    """``vpx_read_tree``: leaves are stored negated (0 is a leaf)."""
    i = 0
    while True:
        i = t[i + br.bit(probs[i >> 1])]
        if i <= 0:
            return -i


class Block:
    """One block's modes (``VP9Block`` / libvpx's ``MODE_INFO``)."""

    __slots__ = ("bs", "row", "col", "seg", "seg_pred", "skip", "tx", "uvtx", "is_inter",
                 "ref", "mode", "bmodes", "uv_mode", "mv", "filter")

    def __init__(self, bs, row, col):
        self.bs, self.row, self.col = bs, row, col
        self.seg_pred = 0
        self.is_inter = False
        self.ref = (0, -1)
        self.filter = 3
        self.uv_mode = DC_PRED


class Frame:
    """A decoded frame as a reference: planes and the motion vectors and
    segment map FFmpeg keeps with it."""

    __slots__ = ("planes", "size", "mvs", "seg_map", "full_range")


class TileDecoder:
    """The block syntax of one frame (every tile), into records for
    reconstruction (see the module's notes)."""

    def __init__(self, dec, hdr, fc, counts, path: str):
        self.dec, self.hdr, self.fc, self.counts, self.path = dec, hdr, fc, counts, path
        self.rows, self.cols = (hdr.height + 7) >> 3, (hdr.width + 7) >> 3
        self.sb_rows, self.sb_cols = (self.rows + 7) >> 3, (self.cols + 7) >> 3
        self.intra_frame = hdr.key or hdr.intra_only
        self.grid = [[None] * self.cols for _ in range(self.rows)]
        self.above_part = [0] * (self.sb_cols * 8)
        self.above_nz = [[0] * (self.sb_cols * 16), [0] * (self.sb_cols * 8),
                         [0] * (self.sb_cols * 8)]
        self.above_segpred = [0] * (self.sb_cols * 8)
        self.cache = [0] * 1024
        # the frame's maps, FFmpeg's layout (8 per superblock)
        stride = self.sb_cols * 8
        self.seg_map = np.zeros((self.sb_rows * 8, stride), np.uint8)
        self.mv_ref = np.full((self.sb_rows * 8, stride, 2), -1, np.int8)
        self.mv_ref[:, :, 0] = 0  # FFmpeg's zeroed pairs where no block wrote
        self.mv_val = np.zeros((self.sb_rows * 8, stride, 2, 2), np.int32)
        self.intra_blocks = []  # (block, [(plane, y, x, tx, mode, residual key)], tile start)
        self.inter_blocks = []  # (block, [(plane, y, x, tx, residual key)])
        self.coefs = {}  # (tx, type) -> list of coefficient lists
        self.lf_masks = np.zeros((self.sb_rows, self.sb_cols, 2, 2, 8, 4), np.int64)
        self.lf_level = np.zeros((self.sb_rows, self.sb_cols, 8, 8), np.int64)
        self.segments_used = set()
        self._frame_probs()

    def _frame_probs(self) -> None:
        hdr, fc, dec = self.hdr, self.fc, self.dec
        self.full_coef = [[[[[model_to_full(ctx) for ctx in band] for band in ref]
                            for ref in plane] for plane in tx] for tx in fc.coef]
        self.qmul, self.lf_lvl = [], []
        sh = hdr.lf_level >= 32
        for seg in range(8 if hdr.seg_enabled else 1):
            q, lf, _, _ = dec.seg_features[seg] if hdr.seg_enabled else (None, None, None, 0)
            qy = hdr.base_q
            if q is not None:
                qy = q if dec.seg_abs else hdr.base_q + q
                qy = min(max(qy, 0), 255)
            qs = [min(max(qy + d, 0), 255) for d in (hdr.dq_y_dc, hdr.dq_uv_dc, hdr.dq_uv_ac)]
            self.qmul.append(((int(T.DC_QLOOKUP[qs[0]]), int(T.AC_QLOOKUP[qy])),
                              (int(T.DC_QLOOKUP[qs[1]]), int(T.AC_QLOOKUP[qs[2]]))))
            lvl = hdr.lf_level
            if lf is not None:
                lvl = min(max(lf if dec.seg_abs else hdr.lf_level + lf, 0), 63)
            if hdr.lf_deltas_enabled:
                rd, md = dec.lf_ref_deltas, dec.lf_mode_deltas
                table = [[min(max(lvl + (rd[0] << sh), 0), 63)] * 2]
                for ref in (1, 2, 3):
                    table.append([min(max(lvl + ((rd[ref] + md[m]) << sh), 0), 63)
                                  for m in (0, 1)])
            else:
                table = [[lvl, lvl]] * 4
            self.lf_lvl.append(table)

    # ------------------------------------------------------------ tiles

    def decode_tiles(self, data: bytes, start: int, end: int, make_bool) -> None:
        hdr = self.hdr
        tile_cols, tile_rows = 1 << hdr.tile_cols_log2, 1 << hdr.tile_rows_log2
        at = start
        for tr in range(tile_rows):
            readers = []
            for tc in range(tile_cols):
                last = tr == tile_rows - 1 and tc == tile_cols - 1
                if last:
                    size = end - at
                else:
                    if at + 4 > end:
                        raise refused(self.path, "a truncated tile size")
                    size = int.from_bytes(data[at:at + 4], "big")
                    at += 4
                if size > end - at:
                    raise refused(self.path, "a tile past the frame's end")
                readers.append(make_bool(data, at, size))
                at += size
            r0 = self._offset(tr, hdr.tile_rows_log2, self.sb_rows, self.rows)
            r1 = self._offset(tr + 1, hdr.tile_rows_log2, self.sb_rows, self.rows)
            for row in range(r0, r1, 8):
                for tc in range(tile_cols):
                    c0 = self._offset(tc, hdr.tile_cols_log2, self.sb_cols, self.cols)
                    c1 = self._offset(tc + 1, hdr.tile_cols_log2, self.sb_cols, self.cols)
                    self.tile_start = c0
                    self.left_part = [0] * 8
                    self.left_nz = [[0] * 16, [0] * 8, [0] * 8]
                    self.left_segpred = [0] * 8
                    br = readers[tc]
                    for col in range(c0, c1, 8):
                        self.partition(br, row, col, 3)

    @staticmethod
    def _offset(i: int, log2: int, sbs: int, mis: int) -> int:
        return min(((i * sbs) >> log2) << 3, mis)

    def partition(self, br, row: int, col: int, bsl: int) -> None:
        if row >= self.rows or col >= self.cols:
            return
        n8 = 1 << bsl
        hbs = n8 >> 1
        bsize = 3 * bsl + BLOCK_8X8
        above = (self.above_part[col] >> bsl) & 1
        left = (self.left_part[row & 7] >> bsl) & 1
        ctx = left * 2 + above + bsl * 4
        probs = KF_PART[ctx] if self.intra_frame else self.fc.partition[ctx]
        has_rows, has_cols = (row + hbs) < self.rows, (col + hbs) < self.cols
        if bsl == 0 or (has_rows and has_cols):
            p = tree(br, TREES["PARTITION_TREE"], probs)
        elif has_cols:
            p = PARTITION_SPLIT if br.bit(probs[1]) else PARTITION_HORZ
        elif has_rows:
            p = PARTITION_SPLIT if br.bit(probs[2]) else PARTITION_VERT
        else:
            p = PARTITION_SPLIT
        self.counts.partition[ctx][p] += 1
        subsize = SUBSIZE[p][bsize]
        if bsl == 0:
            self.block(br, row, col, subsize)
        elif p == PARTITION_NONE:
            self.block(br, row, col, subsize)
        elif p == PARTITION_HORZ:
            self.block(br, row, col, subsize)
            if has_rows:
                self.block(br, row + hbs, col, subsize)
        elif p == PARTITION_VERT:
            self.block(br, row, col, subsize)
            if has_cols:
                self.block(br, row, col + hbs, subsize)
        else:
            for dr, dc in ((0, 0), (0, hbs), (hbs, 0), (hbs, hbs)):
                self.partition(br, row + dr, col + dc, bsl - 1)
        if bsl == 0 or p != PARTITION_SPLIT:
            a, lft = PART_CTX[subsize]
            for i in range(n8):
                self.above_part[col + i] = a
                if (row & 7) + i < 8:
                    self.left_part[(row & 7) + i] = lft

    # ------------------------------------------------------------ blocks

    def block(self, br, row: int, col: int, bs: int) -> None:
        hdr, fc, counts, dec = self.hdr, self.fc, self.counts, self.dec
        b = Block(bs, row, col)
        w8, h8 = W8[bs], H8[bs]
        x_mis, y_mis = min(w8, self.cols - col), min(h8, self.rows - row)
        for y in range(y_mis):
            line = self.grid[row + y]
            for x in range(x_mis):
                line[col + x] = b
        above = self.grid[row - 1][col] if row > 0 else None
        left = self.grid[row][col - 1] if col > self.tile_start else None
        # segment
        seg = 0
        if hdr.seg_enabled:
            if self.intra_frame:
                seg = tree(br, TREES["SEGMENT_TREE"], hdr.seg_tree_probs) \
                    if hdr.seg_update_map else 0
            else:
                pred = not hdr.seg_update_map
                if not pred and hdr.seg_temporal:
                    ctx = self.above_segpred[col] + self.left_segpred[row & 7]
                    pred = br.bit(hdr.seg_pred_probs[ctx])
                if pred:
                    ref_map = dec.segmap_ref
                    if not hdr.error_res and ref_map is not None:
                        seg = int(ref_map[row:row + y_mis, col:col + x_mis].min())
                    for x in range(x_mis):
                        self.above_segpred[col + x] = 1
                    for y in range(min(y_mis, 8 - (row & 7))):
                        self.left_segpred[(row & 7) + y] = 1
                    b.seg_pred = 1
                else:
                    seg = tree(br, TREES["SEGMENT_TREE"], hdr.seg_tree_probs)
                    for x in range(x_mis):
                        self.above_segpred[col + x] = 0
                    for y in range(min(y_mis, 8 - (row & 7))):
                        self.left_segpred[(row & 7) + y] = 0
            if hdr.seg_update_map or self.intra_frame:
                self.seg_map[row:row + h8, col:col + w8] = seg
        b.seg = seg
        self.segments_used.add(seg)
        feat = dec.seg_features[seg] if hdr.seg_enabled else (None, None, None, False)
        # skip
        if feat[3]:
            b.skip = 1
        else:
            ctx = (above.skip if above else 0) + (left.skip if left else 0)
            b.skip = br.bit(fc.skip[ctx])
            counts.skip[ctx][b.skip] += 1
        # intra / inter
        if not self.intra_frame:
            if feat[2] is not None:
                b.is_inter = feat[2] != 0
            else:
                if above and left:
                    ai, li = not above.is_inter, not left.is_inter
                    ctx = 3 if (ai and li) else int(ai or li)
                elif above or left:
                    ctx = 2 * (not (above or left).is_inter)
                else:
                    ctx = 0
                b.is_inter = bool(br.bit(fc.intra_inter[ctx]))
                counts.intra_inter[ctx][b.is_inter] += 1
        b.tx = self.read_tx(br, b, above, left, not b.skip or not b.is_inter)
        if b.is_inter:
            self.inter_modes(br, b, above, left, feat)
        elif self.intra_frame:
            self.kf_intra_modes(br, b, above, left)
        else:
            self.intra_modes(br, b)
        # the chroma transform: the luma one, or one size down where it
        # would not fit the 4:2:0 block
        b.uvtx = b.tx - (w8 * 2 == (1 << b.tx) or h8 * 2 == (1 << b.tx)) if b.tx else 0
        if hdr.lossless:
            b.tx = b.uvtx = 0
        self.record_mvs(b, x_mis, y_mis)
        # tokens
        if b.skip:
            n4w, n4h = 2 * w8, 2 * h8
            self._zero_ctx(0, col * 2, (row & 7) * 2, n4w, n4h)
            for plane in (1, 2):
                self._zero_ctx(plane, col, row & 7, w8, h8)
            recs = self.tx_blocks(b, x_mis, y_mis, tokens=None)
        else:
            recs = self.tx_blocks(b, x_mis, y_mis, tokens=br)
            if b.is_inter and bs >= BLOCK_8X8 and not any(r[-1] is not None for r in recs):
                b.skip = 1
        if b.is_inter:
            self.inter_blocks.append((b, [r for r in recs if r[-1] is not None]))
        else:
            self.intra_blocks.append((b, recs, self.tile_start))
        self.loop_filter_masks(b, x_mis, y_mis)

    def _zero_ctx(self, plane, ax, ly, n4w, n4h):
        a, lft = self.above_nz[plane], self.left_nz[plane]
        for i in range(n4w):
            a[ax + i] = 0
        for i in range(min(n4h, len(lft) - ly)):
            lft[ly + i] = 0

    def read_tx(self, br, b, above, left, allow_select: bool) -> int:
        hdr = self.hdr
        max_tx = MAX_TX[b.bs]
        if allow_select and hdr.tx_mode == TX_MODE_SELECT and b.bs >= BLOCK_8X8:
            a = above.tx if (above and not above.skip) else max_tx
            lf = left.tx if (left and not left.skip) else max_tx
            if not left:
                lf = a
            if not above:
                a = lf
            ctx = int(a + lf > max_tx)
            probs = (None, self.fc.tx8, self.fc.tx16, self.fc.tx32)[max_tx][ctx]
            tx = br.bit(probs[0])
            if tx and max_tx >= TX_16X16:
                tx += br.bit(probs[1])
                if tx != TX_8X8 and max_tx >= TX_32X32:
                    tx += br.bit(probs[2])
            (None, self.counts.tx8, self.counts.tx16, self.counts.tx32)[max_tx][ctx][tx] += 1
            return tx
        return min(max_tx, TX_MODE_TO_BIGGEST[hdr.tx_mode])

    def kf_intra_modes(self, br, b, above, left) -> None:
        """``read_intra_frame_mode_info``'s modes: each by the above and
        left (sub-)block modes."""
        bs = b.bs
        t = TREES["INTRA_MODE_TREE"]

        def above_mode(i):
            if i < 2:
                if above is None or above.is_inter:
                    return DC_PRED
                return above.bmodes[i + 2]
            return m[i - 2]

        def left_mode(i):
            if not i & 1:
                if left is None or left.is_inter:
                    return DC_PRED
                return left.bmodes[i + 1]
            return m[i - 1]

        m = [0, 0, 0, 0]
        if bs == BLOCK_4X4:
            for i in range(4):
                m[i] = tree(br, t, KF_Y[above_mode(i)][left_mode(i)])
        elif bs == BLOCK_4X8:
            m[0] = m[2] = tree(br, t, KF_Y[above_mode(0)][left_mode(0)])
            m[1] = m[3] = tree(br, t, KF_Y[above_mode(1)][left_mode(1)])
        elif bs == BLOCK_8X4:
            m[0] = m[1] = tree(br, t, KF_Y[above_mode(0)][left_mode(0)])
            m[2] = m[3] = tree(br, t, KF_Y[above_mode(2)][left_mode(2)])
        else:
            m = [tree(br, t, KF_Y[above_mode(0)][left_mode(0)])] * 4
        b.bmodes, b.mode = m, m[3]
        b.uv_mode = tree(br, t, KF_UV[b.mode])

    def intra_modes(self, br, b) -> None:
        """``read_intra_block_mode_info``: an intra block of an inter frame."""
        fc, counts, bs = self.fc, self.counts, b.bs
        t = TREES["INTRA_MODE_TREE"]

        def y(group):
            mode = tree(br, t, fc.y_mode[group])
            counts.y_mode[group][mode] += 1
            return mode

        if bs == BLOCK_4X4:
            m = [y(0) for _ in range(4)]
        elif bs == BLOCK_4X8:
            m = [y(0), y(0)]
            m = [m[0], m[1], m[0], m[1]]
        elif bs == BLOCK_8X4:
            m = [y(0), y(0)]
            m = [m[0], m[0], m[1], m[1]]
        else:
            m = [y(SIZE_GROUP[bs])] * 4
        b.bmodes, b.mode = m, m[3]
        b.uv_mode = tree(br, t, fc.uv_mode[b.mode])
        counts.uv_mode[b.mode][b.uv_mode] += 1

    # ------------------------------------------------------- inter modes

    def inter_modes(self, br, b, above, left, feat) -> None:
        """``read_inter_block_mode_info``."""
        hdr, fc, counts = self.hdr, self.fc, self.counts
        row, col, bs = b.row, b.col, b.bs
        # references
        if feat[2] is not None:
            b.ref = (feat[2], -1)
        else:
            comp = hdr.reference_mode == COMPOUND_REFERENCE
            if hdr.reference_mode == REFERENCE_MODE_SELECT:
                ctx = self.comp_inter_ctx(above, left)
                comp = br.bit(fc.comp_inter[ctx])
                counts.comp_inter[ctx][comp] += 1
            if comp:
                idx = hdr.sign_bias[hdr.comp_fixed_ref]
                ctx = self.comp_ref_ctx(above, left)
                bit = br.bit(fc.comp_ref[ctx])
                counts.comp_ref[ctx][bit] += 1
                refs = [0, 0]
                refs[idx] = hdr.comp_fixed_ref
                refs[1 - idx] = hdr.comp_var_ref[bit]
                b.ref = tuple(refs)
            else:
                ctx = self.single_ref_p1_ctx(above, left)
                bit = br.bit(fc.single_ref[ctx][0])
                counts.single_ref[ctx][0][bit] += 1
                if bit:
                    ctx = self.single_ref_p2_ctx(above, left)
                    bit = br.bit(fc.single_ref[ctx][1])
                    counts.single_ref[ctx][1][bit] += 1
                    b.ref = (ALTREF_FRAME if bit else GOLDEN_FRAME, -1)
                else:
                    b.ref = (LAST_FRAME, -1)
        comp = b.ref[1] > 0
        # the mode context: the first two candidate positions' modes
        counter = 0
        for dr, dc in MV_REF[bs][:2]:
            r, c = row + dr, col + dc
            if r >= 0 and self.tile_start <= c < self.cols and r < self.rows:
                counter += M2C[self.grid[r][c].mode]
        mode_ctx = C2C[counter]
        t = TREES["INTER_MODE_TREE"]
        if bs >= BLOCK_8X8:
            if feat[3]:
                mode = ZEROMV
            else:
                leaf = tree(br, t, fc.inter_mode[mode_ctx])
                counts.inter_mode[mode_ctx][leaf] += 1
                mode = NEARESTMV + leaf
        # (under 8x8 the sub-blocks' modes are read whatever the segment's
        # skip feature says, as FFmpeg reads them; libvpx refuses such blocks)
        # interpolation filter
        if hdr.filter == SWITCHABLE:
            lt = left.filter if (left and left.is_inter) else 3
            at = above.filter if (above and above.is_inter) else 3
            if lt == at:
                ctx = lt
            elif lt == 3:
                ctx = at
            elif at == 3:
                ctx = lt
            else:
                ctx = 3
            b.filter = tree(br, TREES["SWITCHABLE_INTERP_TREE"], fc.filter[ctx])
            counts.filter[ctx][b.filter] += 1
        else:
            b.filter = hdr.filter
        b.mv = [None] * 4
        b.bmodes = [0] * 4
        if bs >= BLOCK_8X8:
            b.bmodes = [mode] * 4
            mv = self.fill_mv(br, b, mode, -1, comp)
            b.mv = [mv] * 4
        else:
            for sb in (0, 1, 2, 3):
                if (sb == 1 and bs == BLOCK_8X4) or (sb == 2 and bs == BLOCK_4X8):
                    b.bmodes[sb], b.mv[sb] = b.bmodes[sb - 1 if sb == 1 else 0], \
                        b.mv[sb - 1 if sb == 1 else 0]
                    continue
                if sb == 3 and bs != BLOCK_4X4:
                    src = 2 if bs == BLOCK_8X4 else 1
                    b.bmodes[3], b.mv[3] = b.bmodes[src], b.mv[src]
                    continue
                leaf = tree(br, t, fc.inter_mode[mode_ctx])
                counts.inter_mode[mode_ctx][leaf] += 1
                b.bmodes[sb] = NEARESTMV + leaf
                b.mv[sb] = self.fill_mv(br, b, b.bmodes[sb], sb, comp)
        b.mode = b.bmodes[3]

    def fill_mv(self, br, b, mode: int, sb: int, comp: bool) -> tuple:
        """``ff_vp9_fill_mv``: the vector pair of a block (``sb`` -1) or
        sub-block."""
        if mode == ZEROMV:
            return (ZERO_MV, ZERO_MV)
        out = []
        for z in range(1 + comp):
            mv = self.find_ref_mv(b, b.ref[z], z, mode == NEARMV, -1 if mode == NEWMV else sb)
            hp = True
            if mode == NEWMV or sb == -1:
                hp = self.hdr.allow_hp and abs(mv[0]) < 64 and abs(mv[1]) < 64
                if not hp:
                    mv = tuple(v - (1 if v > 0 else -1) if v & 1 else v for v in mv)
            if mode == NEWMV:
                j = tree(br, TREES["MV_JOINT_TREE"], self.fc.mv_joint)
                self.counts.mv_joint[j] += 1
                dy = self.mv_component(br, 0, hp) if j >= 2 else 0
                dx = self.mv_component(br, 1, hp) if j & 1 else 0
                mv = (mv[0] + dy, mv[1] + dx)
            out.append(mv)
        if not comp:
            out.append(ZERO_MV)
        return tuple(out)

    def mv_component(self, br, i: int, hp: bool) -> int:
        fc, counts = self.fc, self.counts
        sign = br.bit(fc.mv_sign[i])
        cls = tree(br, TREES["MV_CLASS_TREE"], fc.mv_classes[i])
        counts.mv_sign[i][sign] += 1
        counts.mv_classes[i][cls] += 1
        if cls:
            n = 0
            for m in range(cls):
                bit = br.bit(fc.mv_bits[i][m])
                n |= bit << m
                counts.mv_bits[i][m][bit] += 1
            n <<= 3
            fp = tree(br, TREES["MV_FP_TREE"], fc.mv_fp[i])
            n |= fp << 1
            counts.mv_fp[i][fp] += 1
            if hp:
                bit = br.bit(fc.mv_hp[i])
                counts.mv_hp[i][bit] += 1
                n |= bit
            else:
                n |= 1
                counts.mv_hp[i][1] += 1
            n += 8 << cls  # mv_class_base: CLASS0_SIZE << (class + 2)
        else:
            d = br.bit(fc.mv_class0[i])
            counts.mv_class0[i][d] += 1
            fp = tree(br, TREES["MV_FP_TREE"], fc.mv_class0_fp[i][d])
            counts.mv_class0_fp[i][d][fp] += 1
            n = (d << 3) | (fp << 1)
            if hp:
                bit = br.bit(fc.mv_class0_hp[i])
                counts.mv_class0_hp[i][bit] += 1
                n |= bit
            else:
                n |= 1
                counts.mv_class0_hp[i][1] += 1
        return -(n + 1) if sign else n + 1

    def find_ref_mv(self, b, ref: int, z: int, idx: bool, sb: int) -> tuple:
        """``vp9mvs.c::find_ref_mvs``: the nearest (``idx`` false) or near
        vector of reference ``ref``."""
        row, col, w8, h8 = b.row, b.col, W8[b.bs], H8[b.bs]
        lo = (-(128 + row * 64), -(128 + col * 64))
        hi = (128 + (self.rows - row - h8) * 64, 128 + (self.cols - col - w8) * 64)

        def clamp(mv):
            return (min(max(mv[0], lo[0]), hi[0]), min(max(mv[1], lo[1]), hi[1]))

        mem = mem_sub = None
        for kind, mv in self._candidates(b, ref, z, sb):
            if kind == 0:  # RETURN_DIRECT_MV
                if not idx:
                    return mv
                if mem is None:
                    mem = mv
                elif mv != mem:
                    return mv
            elif sb > 0:
                if mem_sub is None:
                    t = clamp(mv)
                    if t != mem:
                        return t
                    mem_sub = mv
                elif mem_sub != mv:
                    t = clamp(mv)
                    return t if t != mem else ZERO_MV
            else:
                if not idx:
                    return clamp(mv)
                if mem is None:
                    mem = mv
                elif mv != mem:
                    return clamp(mv)
        return clamp(ZERO_MV)

    def _candidates(self, b, ref, z, sb):
        row, col, grid = b.row, b.col, self.grid
        bias = self.hdr.sign_bias
        start = 0
        if sb >= 0:
            if sb in (1, 2):
                yield 0, b.mv[0][z]
            elif sb == 3:
                yield 0, b.mv[2][z]
                yield 0, b.mv[1][z]
                yield 0, b.mv[0][z]
            if row > 0:
                a = grid[row - 1][col]
                if a.ref[0] == ref:
                    yield 1, a.mv[2 + (sb & 1)][0]
                elif a.ref[1] == ref:
                    yield 1, a.mv[2 + (sb & 1)][1]
            if col > self.tile_start:
                lft = grid[row][col - 1]
                if lft.ref[0] == ref:
                    yield 1, lft.mv[1 + 2 * (sb >> 1)][0]
                elif lft.ref[1] == ref:
                    yield 1, lft.mv[1 + 2 * (sb >> 1)][1]
            start = 2
        cands = []
        for dr, dc in MV_REF[b.bs]:
            r, c = row + dr, col + dc
            cands.append(grid[r][c] if (self.tile_start <= c < self.cols and 0 <= r < self.rows)
                         else None)
        for cand in cands[start:]:
            if cand is not None:
                if cand.ref[0] == ref:
                    yield 1, cand.mv[3][0]
                elif cand.ref[1] == ref:
                    yield 1, cand.mv[3][1]
        prev = self.dec.prev_mvs
        if prev is not None:
            pref, pmv = prev[0][row, col], prev[1][row, col]
            if pref[0] == ref:
                yield 1, (int(pmv[0][0]), int(pmv[0][1]))
            elif pref[1] == ref:
                yield 1, (int(pmv[1][0]), int(pmv[1][1]))
        for cand in cands:
            if cand is not None and cand.is_inter:
                r0, r1 = cand.ref
                m0, m1 = cand.mv[3]
                if r0 != ref and r0 > 0:
                    yield 1, (m0 if bias[r0] == bias[ref] else (-m0[0], -m0[1]))
                if r1 != ref and r1 > 0 and m0 != m1:
                    yield 1, (m1 if bias[r1] == bias[ref] else (-m1[0], -m1[1]))
        if prev is not None:
            pref, pmv = prev[0][row, col], prev[1][row, col]
            m0 = (int(pmv[0][0]), int(pmv[0][1]))
            m1 = (int(pmv[1][0]), int(pmv[1][1]))
            r0, r1 = int(pref[0]), int(pref[1])
            if r0 != ref and r0 > 0:
                yield 1, (m0 if bias[r0] == bias[ref] else (-m0[0], -m0[1]))
            if r1 != ref and r1 > 0 and m0 != m1:
                yield 1, (m1 if bias[r1] == bias[ref] else (-m1[0], -m1[1]))

    def record_mvs(self, b, x_mis, y_mis) -> None:
        """The frame's vector pairs (FFmpeg's ``VP9mvrefPair``) over the
        block's visible part: the references (-1 for none, 0 intra as 0)
        and the last sub-block's vectors."""
        r, c = b.row, b.col
        if b.is_inter:
            self.mv_ref[r:r + y_mis, c:c + x_mis] = b.ref
            self.mv_val[r:r + y_mis, c:c + x_mis] = b.mv[3] if b.ref[1] > 0 else \
                (b.mv[3][0], (0, 0))
        else:
            self.mv_ref[r:r + y_mis, c:c + x_mis] = (-1, -1)

    # ------------------------------------------------------ contexts

    def comp_inter_ctx(self, above, left) -> int:
        hdr = self.hdr
        fix = hdr.comp_fixed_ref
        if above and left:
            a2, l2 = above.ref[1] > 0, left.ref[1] > 0
            if not a2 and not l2:
                return (above.ref[0] == fix) ^ (left.ref[0] == fix)
            if not a2:
                return 2 + (above.ref[0] == fix or not above.is_inter)
            if not l2:
                return 2 + (left.ref[0] == fix or not left.is_inter)
            return 4
        if above or left:
            e = above or left
            return int(e.ref[0] == fix) if e.ref[1] <= 0 else 3
        return 1

    def comp_ref_ctx(self, above, left) -> int:
        hdr = self.hdr
        fix_idx = hdr.sign_bias[hdr.comp_fixed_ref]
        var_idx = 1 - fix_idx
        var0, var1 = hdr.comp_var_ref
        if above and left:
            ai, li = not above.is_inter, not left.is_inter
            if ai and li:
                return 2
            if ai or li:
                e = left if ai else above
                if e.ref[1] <= 0:
                    return 1 + 2 * (e.ref[0] != var1)
                return 1 + 2 * (e.ref[var_idx] != var1)
            l_sg, a_sg = left.ref[1] <= 0, above.ref[1] <= 0
            vrfa = above.ref[0] if a_sg else above.ref[var_idx]
            vrfl = left.ref[0] if l_sg else left.ref[var_idx]
            if vrfa == vrfl and var1 == vrfa:
                return 0
            if l_sg and a_sg:
                if (vrfa == hdr.comp_fixed_ref and vrfl == var0) or \
                        (vrfl == hdr.comp_fixed_ref and vrfa == var0):
                    return 4
                return 3 if vrfa == vrfl else 1
            if l_sg or a_sg:
                vrfc = vrfa if l_sg else vrfl
                rfs = vrfa if a_sg else vrfl
                if vrfc == var1 and rfs != var1:
                    return 1
                if rfs == var1 and vrfc != var1:
                    return 2
                return 4
            return 4 if vrfa == vrfl else 2
        if above or left:
            e = above or left
            if not e.is_inter:
                return 2
            if e.ref[1] > 0:
                return 4 * (e.ref[var_idx] != var1)
            return 3 * (e.ref[0] != var1)
        return 2

    @staticmethod
    def single_ref_p1_ctx(above, left) -> int:
        if above and left:
            ai, li = not above.is_inter, not left.is_inter
            if ai and li:
                return 2
            if ai or li:
                e = left if ai else above
                if e.ref[1] <= 0:
                    return 4 * (e.ref[0] == LAST_FRAME)
                return 1 + (e.ref[0] == LAST_FRAME or e.ref[1] == LAST_FRAME)
            a2, l2 = above.ref[1] > 0, left.ref[1] > 0
            a0, a1, l0, l1 = above.ref[0], above.ref[1], left.ref[0], left.ref[1]
            if a2 and l2:
                return 1 + (LAST_FRAME in (a0, a1, l0, l1))
            if a2 or l2:
                rfs = a0 if not a2 else l0
                crf1, crf2 = (a0, a1) if a2 else (l0, l1)
                if rfs == LAST_FRAME:
                    return 3 + (crf1 == LAST_FRAME or crf2 == LAST_FRAME)
                return int(crf1 == LAST_FRAME or crf2 == LAST_FRAME)
            return 2 * (a0 == LAST_FRAME) + 2 * (l0 == LAST_FRAME)
        if above or left:
            e = above or left
            if not e.is_inter:
                return 2
            if e.ref[1] <= 0:
                return 4 * (e.ref[0] == LAST_FRAME)
            return 1 + (e.ref[0] == LAST_FRAME or e.ref[1] == LAST_FRAME)
        return 2

    @staticmethod
    def single_ref_p2_ctx(above, left) -> int:
        G, L, A = GOLDEN_FRAME, LAST_FRAME, ALTREF_FRAME
        if above and left:
            ai, li = not above.is_inter, not left.is_inter
            if ai and li:
                return 2
            if ai or li:
                e = left if ai else above
                if e.ref[1] <= 0:
                    if e.ref[0] == L:
                        return 3
                    return 4 * (e.ref[0] == G)
                return 1 + 2 * (e.ref[0] == G or e.ref[1] == G)
            a2, l2 = above.ref[1] > 0, left.ref[1] > 0
            a0, a1, l0, l1 = above.ref[0], above.ref[1], left.ref[0], left.ref[1]
            if a2 and l2:
                if a0 == l0 and a1 == l1:
                    return 3 * (G in (a0, a1, l0, l1))
                return 2
            if a2 or l2:
                rfs = a0 if not a2 else l0
                crf1, crf2 = (a0, a1) if a2 else (l0, l1)
                if rfs == G:
                    return 3 + (crf1 == G or crf2 == G)
                if rfs == A:
                    return int(crf1 == G or crf2 == G)
                return 1 + 2 * (crf1 == G or crf2 == G)
            if a0 == L and l0 == L:
                return 3
            if a0 == L or l0 == L:
                edge0 = l0 if a0 == L else a0
                return 4 * (edge0 == G)
            return 2 * (a0 == G) + 2 * (l0 == G)
        if above or left:
            e = above or left
            if not e.is_inter or (e.ref[0] == L and e.ref[1] <= 0):
                return 2
            if e.ref[1] <= 0:
                return 4 * (e.ref[0] == G)
            return 3 * (e.ref[0] == G or e.ref[1] == G)
        return 2

    # --------------------------------------------------- coefficients

    def tx_blocks(self, b, x_mis: int, y_mis: int, tokens) -> list:
        """Each visible transform block of each plane, in decoding order:
        (plane, y, x, tx, mode, residual key or None); tokens read from
        ``tokens`` unless the block is skipped."""
        hdr = self.hdr
        lossless = hdr.lossless
        w8, h8 = W8[b.bs], H8[b.bs]
        out = []
        qmul = self.qmul[b.seg]
        for plane in range(3):
            ss = plane > 0
            txs = b.uvtx if ss else b.tx
            step = 1 << txs
            n4w, n4h = (w8, h8) if ss else (2 * w8, 2 * h8)
            vis_w, vis_h = (x_mis, y_mis) if ss else (2 * x_mis, 2 * y_mis)
            vis_w, vis_h = min(vis_w, n4w), min(vis_h, n4h)
            ax = b.col if ss else 2 * b.col
            ly = (b.row & 7) if ss else 2 * (b.row & 7)
            a, lft = self.above_nz[plane], self.left_nz[plane]
            py, px = (b.row * 4, b.col * 4) if ss else (b.row * 8, b.col * 8)
            dq_dc, dq_ac = qmul[1 if ss else 0]
            if tokens is not None:
                probs = self.full_coef[txs][int(ss)][int(b.is_inter)]
                cnt = self.counts.coef[txs][int(ss)][int(b.is_inter)]
                eobc = self.counts.eob[txs][int(ss)][int(b.is_inter)]
            for y in range(0, vis_h, step):
                for x in range(0, vis_w, step):
                    if ss:
                        mode = b.uv_mode
                    elif b.bs < BLOCK_8X8 and txs == TX_4X4:
                        mode = b.bmodes[y * 2 + x]
                    else:
                        mode = b.mode
                    if lossless:
                        ttype = WHT
                    elif ss or b.is_inter or txs == TX_32X32:
                        ttype = DCT_DCT
                    else:
                        ttype = TX_TYPE[mode]
                    key = None
                    if tokens is not None:
                        ctx = (int(any(a[ax + x:ax + x + step]))
                               + int(any(lft[ly + y:ly + y + step])))
                        scan, nb = SCANS[txs, ttype]
                        n = 16 << (2 * txs)
                        buf = [0] * n
                        eob = read_coeffs(tokens, probs, ctx, scan, nb, BANDS[txs > 0], n, dq_dc,
                                          dq_ac, txs == TX_32X32, cnt, eobc, buf, self.cache)
                        nz = int(eob > 0)
                        for i in range(step):
                            if ax + x + i < len(a):
                                a[ax + x + i] = nz if x + i < vis_w else 0
                            if ly + y + i < len(lft):
                                lft[ly + y + i] = nz if y + i < vis_h else 0
                        if eob:
                            group = self.coefs.setdefault((txs, ttype), [])
                            key = (txs, ttype, len(group))
                            group.append(buf)
                    out.append((plane, py + 4 * y, px + 4 * x, txs, mode, key))
        return out

    # ------------------------------------------------------ loop filter

    def loop_filter_masks(self, b, x_mis: int, y_mis: int) -> None:
        hdr = self.hdr
        if not hdr.lf_level:
            return
        ref = b.ref[0] if b.is_inter else 0
        lvl = self.lf_lvl[b.seg][ref][int(b.mode != ZEROMV)]
        if lvl <= 0:
            return
        sr, sc = b.row >> 3, b.col >> 3
        row7, col7 = b.row & 7, b.col & 7
        w8, h8 = W8[b.bs], H8[b.bs]
        self.lf_level[sr, sc, row7:row7 + h8, col7:col7 + w8] = lvl
        skip_inter = b.is_inter and b.skip
        masks = self.lf_masks[sr, sc]
        m0 = masks[0].tolist()
        mask_edges(m0, 0, 0, row7, col7, x_mis, y_mis, 0, 0, b.tx, skip_inter)
        m1 = masks[1].tolist()
        col_end = self.cols & 7 if (self.cols & 1 and b.col + w8 >= self.cols) else 0
        row_end = self.rows & 7 if (self.rows & 1 and b.row + h8 >= self.rows) else 0
        mask_edges(m1, 1, 1, row7, col7, x_mis, y_mis, col_end, row_end, b.uvtx, skip_inter)
        masks[0] = m0
        masks[1] = m1
