"""VP9 frame-level syntax, as FFmpeg's ``vp9`` decoder (``libavcodec/vp9.c``,
``vp9prob.c``) reads it: the superframe index, the uncompressed header, the
compressed header and the four saved probability contexts with their
backward adaptation. ``utils/vp9dec.py`` runs the frame loop over these.

The boolean decoder is ``utils/vp8.py::_Bool`` (VP9's arithmetic is VP8's;
FFmpeg decodes both with ``vpx_rac``), handed the bytes FFmpeg's reader
sees: it takes three bytes at ``ff_vpx_init_range_decoder`` and two at a
time after, so it reads up to one byte past a partition whose size is even
(a tile's, into the next tile's size field; the last's, into the packet's
zero padding); ``bool_decoder`` gives ``_Bool`` exactly those bytes. Each
partition opens with VP9's marker bit, which must be 0.

Probabilities are nested lists (``ProbContext``), in libvpx's layout (see
``utils/vp9tables.py``). ``adapt`` is ``vp9prob.c::ff_vp9_adapt_probs``:
the saved context's probabilities merged with the frame's counts (count
saturation 24 and update factor 112, or 128 on the frame after a key
frame, for coefficients; 20 and 128 for the rest), only coefficients,
skip and transform-size probabilities after an intra frame.

Refused, each with a ValueError naming ROADMAP.md queue 1, item 4:
profiles 1-3, ``intra_only`` frames, an RGB colour space, a bad frame
marker, sync code or marker bit, an empty partition, a compressed header
or tile past the packet, a superframe index whose sizes run past its
packet (an index whose first and last bytes differ is no index, as for the
bitstream filter), and truncated headers. FFmpeg checks no padding bits,
so neither does the port.
"""

from __future__ import annotations

import copy

from . import vp9tables as T
from .imgcodecs import ROADMAP
from .vp8 import _Bool

SYNC_CODE = 0x498342
# the interpolation filter a frame header's two bits name (libvpx's
# literal_to_filter): smooth, regular, sharp, bilinear in libvpx's order
# (0 regular, 1 smooth, 2 sharp, 3 bilinear)
LITERAL_TO_FILTER = (1, 0, 2, 3)
SWITCHABLE = 4
ONLY_4X4, ALLOW_8X8, ALLOW_16X16, ALLOW_32X32, TX_MODE_SELECT = range(5)
SINGLE_REFERENCE, COMPOUND_REFERENCE, REFERENCE_MODE_SELECT = range(3)
INTRA_FRAME, LAST_FRAME, GOLDEN_FRAME, ALTREF_FRAME = range(4)


def refused(path: str, what: str) -> ValueError:
    return ValueError(f"{path}: VP9 video: {what} is not supported by the port's VP9 decoder "
                      f"({ROADMAP})")


def superframe_split(data: bytes, path: str = "<packet>") -> list[tuple[int, int]]:
    """``vp9_superframe_split_bsf.c``: (start, end) of each frame of a
    packet; a packet without a superframe index is one frame."""
    if not data:
        raise refused(path, "an empty packet")
    marker = data[-1]
    if marker & 0xE0 == 0xC0:
        nbytes = 1 + ((marker >> 3) & 3)
        nframes = 1 + (marker & 7)
        idx = nbytes * nframes + 2
        if len(data) >= idx and data[-idx] == marker:
            sizes, at = [], len(data) - idx + 1
            for _ in range(nframes):
                sizes.append(int.from_bytes(data[at:at + nbytes], "little"))
                at += nbytes
            out, start = [], 0
            for size in sizes:
                if start + size > len(data) - idx:
                    raise refused(path, "a superframe index past its packet")
                out.append((start, start + size))
                start += size
            return out
    return [(0, len(data))]


def bool_decoder(buf: bytes, start: int, size: int, path: str) -> _Bool:
    """The boolean decoder over ``buf[start:start + size]`` as FFmpeg reads
    it (see the module's notes), its marker bit read and checked."""
    if size < 1:
        raise refused(path, "an empty partition")
    seen = 3 if size <= 3 else 3 + 2 * ((size - 2) // 2)
    data = buf[start:start + seen]
    br = _Bool(data + bytes(seen - len(data)), path)
    if br.bit(128):
        raise refused(path, "a set marker bit")
    return br


class BitReader:
    """MSB-first bits of the uncompressed header."""

    def __init__(self, data: bytes, path: str):
        self.data, self.pos, self.path = data, 0, path

    def f(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.pos >> 3
            if byte >= len(self.data):
                raise refused(self.path, "a truncated frame header")
            v = (v << 1) | ((self.data[byte] >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def s(self, n: int) -> int:
        """``get_sbits_inv``: magnitude then sign."""
        v = self.f(n)
        return -v if self.f(1) else v


class ProbContext:
    """One probability context (``ProbContext`` + coefficient probabilities)."""

    def __init__(self):
        self.coef = T.COEF_PROBS.tolist()  # [tx][plane][ref][band][ctx][3]
        self.y_mode = T.Y_MODE_PROBS.tolist()
        self.uv_mode = T.UV_MODE_PROBS.tolist()
        self.filter = T.SWITCHABLE_INTERP_PROBS.tolist()
        self.inter_mode = T.INTER_MODE_PROBS.tolist()
        self.intra_inter = T.INTRA_INTER_PROBS.tolist()
        self.comp_inter = T.COMP_INTER_PROBS.tolist()
        self.single_ref = T.SINGLE_REF_PROBS.tolist()
        self.comp_ref = T.COMP_REF_PROBS.tolist()
        self.tx32 = T.TX_PROBS_32.tolist()
        self.tx16 = T.TX_PROBS_16.tolist()
        self.tx8 = T.TX_PROBS_8.tolist()
        self.skip = T.SKIP_PROBS.tolist()
        self.partition = T.PARTITION_PROBS.tolist()
        self.mv_joint = T.MV_JOINT_PROBS.tolist()
        self.mv_sign = [p[0] for p in T.MV_SIGN_PROBS.tolist()]
        self.mv_classes = T.MV_CLASS_PROBS.tolist()
        self.mv_class0 = [p[0] for p in T.MV_CLASS0_PROBS.tolist()]
        self.mv_bits = T.MV_BITS_PROBS.tolist()
        self.mv_class0_fp = T.MV_CLASS0_FP_PROBS.tolist()
        self.mv_fp = T.MV_FP_PROBS.tolist()
        self.mv_class0_hp = [p[0] for p in T.MV_CLASS0_HP_PROBS.tolist()]
        self.mv_hp = [p[0] for p in T.MV_HP_PROBS.tolist()]

    def copy(self) -> "ProbContext":
        return copy.deepcopy(self)


class Counts:
    """The symbol counts of one frame (``VP9TileData.counts``)."""

    def __init__(self):
        z = lambda *shape: _zeros(shape)  # noqa: E731
        self.coef = z(4, 2, 2, 6, 6, 3)
        self.eob = z(4, 2, 2, 6, 6, 2)
        self.y_mode = z(4, 10)
        self.uv_mode = z(10, 10)
        self.filter = z(4, 3)
        self.inter_mode = z(7, 4)  # ZEROMV, NEARESTMV, NEARMV, NEWMV as the tree's leaves
        self.intra_inter = z(4, 2)
        self.comp_inter = z(5, 2)
        self.single_ref = z(5, 2, 2)
        self.comp_ref = z(5, 2)
        self.tx32 = z(2, 4)
        self.tx16 = z(2, 3)
        self.tx8 = z(2, 2)
        self.skip = z(3, 2)
        self.partition = z(16, 4)
        self.mv_joint = z(4)
        self.mv_sign = z(2, 2)
        self.mv_classes = z(2, 11)
        self.mv_class0 = z(2, 2)
        self.mv_bits = z(2, 10, 2)
        self.mv_class0_fp = z(2, 2, 4)
        self.mv_fp = z(2, 4)
        self.mv_class0_hp = z(2, 2)
        self.mv_hp = z(2, 2)


def _zeros(shape):
    if len(shape) == 1:
        return [0] * shape[0]
    return [_zeros(shape[1:]) for _ in range(shape[0])]


class Header:
    """A frame's uncompressed and compressed headers (attributes as named
    in the module's notes)."""


def read_color_config(br: BitReader, hdr: Header, path: str) -> None:
    hdr.color_space = br.f(3)
    if hdr.color_space == 7:
        raise refused(path, "an RGB colour space in profile 0")
    hdr.color_range = br.f(1)


def read_uncompressed(data: bytes, dec, path: str) -> Header:
    """The uncompressed header (``decode_frame_header``'s first part);
    ``dec`` is the decoder, whose references, loop-filter deltas and
    segmentation persist from frame to frame and are updated here."""
    br = BitReader(data, path)
    hdr = Header()
    if br.f(2) != 2:
        raise refused(path, "a bad frame marker")
    profile = br.f(1) | (br.f(1) << 1)
    if profile == 3:
        profile += br.f(1)
    if profile:
        raise refused(path, f"profile {profile} (bit depth above 8 or 4:2:2 / 4:4:0 / 4:4:4)")
    hdr.show_existing = br.f(1)
    if hdr.show_existing:
        hdr.existing_idx = br.f(3)
        return hdr
    hdr.key = not br.f(1)
    hdr.show = br.f(1)
    hdr.error_res = br.f(1)
    hdr.intra_only = 0
    if hdr.key:
        if br.f(24) != SYNC_CODE:
            raise refused(path, "a bad sync code")
        read_color_config(br, hdr, path)
        hdr.refresh = 0xFF
        hdr.width, hdr.height = br.f(16) + 1, br.f(16) + 1
        if br.f(1):
            br.f(32)  # render size
        hdr.ref_idx, hdr.sign_bias = [0, 0, 0], [0, 0, 0, 0]
    else:
        hdr.intra_only = br.f(1) if not hdr.show else 0
        hdr.reset_context = 0 if hdr.error_res else br.f(2)
        if hdr.intra_only:
            raise refused(path, "an intra-only frame")
        hdr.refresh = br.f(8)
        hdr.ref_idx, hdr.sign_bias = [], [0]
        for _ in range(3):
            hdr.ref_idx.append(br.f(3))
            hdr.sign_bias.append(br.f(1) and not hdr.error_res)
        for i in hdr.ref_idx:
            if dec.refs[i] is None:
                raise refused(path, "an inter frame before any key frame")
        for i in hdr.ref_idx:
            if br.f(1):
                hdr.height, hdr.width = dec.refs[i].size
                break
        else:
            hdr.width, hdr.height = br.f(16) + 1, br.f(16) + 1
        if br.f(1):
            br.f(32)  # render size
        hdr.allow_hp = br.f(1)
        hdr.filter = SWITCHABLE if br.f(1) else LITERAL_TO_FILTER[br.f(2)]
    if hdr.error_res:
        hdr.refresh_context, hdr.parallel = 0, 1
    else:
        hdr.refresh_context, hdr.parallel = br.f(1), br.f(1)
    hdr.context_idx = br.f(2)
    if hdr.key or hdr.intra_only:
        hdr.context_idx = 0
    if hdr.key or hdr.error_res:
        dec.lf_ref_deltas, dec.lf_mode_deltas = [1, 0, -1, -1], [0, 0]
        dec.seg_features = [[None, None, None, False] for _ in range(8)]
    # loop filter
    hdr.lf_level, hdr.sharpness = br.f(6), br.f(3)
    hdr.lf_deltas_enabled = br.f(1)
    hdr.lf_deltas_update = 0
    if hdr.lf_deltas_enabled:
        hdr.lf_deltas_update = br.f(1)
        if hdr.lf_deltas_update:
            for i in range(4):
                if br.f(1):
                    dec.lf_ref_deltas[i] = br.s(6)
            for i in range(2):
                if br.f(1):
                    dec.lf_mode_deltas[i] = br.s(6)
    # quantisers
    hdr.base_q = br.f(8)
    hdr.dq_y_dc, hdr.dq_uv_dc, hdr.dq_uv_ac = (br.s(4) if br.f(1) else 0 for _ in range(3))
    hdr.lossless = not (hdr.base_q or hdr.dq_y_dc or hdr.dq_uv_dc or hdr.dq_uv_ac)
    # segmentation
    hdr.seg_enabled = br.f(1)
    hdr.seg_update_map = hdr.seg_temporal = hdr.seg_update_data = 0
    if hdr.seg_enabled:
        hdr.seg_update_map = br.f(1)
        if hdr.seg_update_map:
            hdr.seg_tree_probs = [br.f(8) if br.f(1) else 255 for _ in range(7)]
            hdr.seg_temporal = br.f(1)
            if hdr.seg_temporal:
                hdr.seg_pred_probs = [br.f(8) if br.f(1) else 255 for _ in range(3)]
        hdr.seg_update_data = br.f(1)
        if hdr.seg_update_data:
            dec.seg_abs = br.f(1)
            for i in range(8):
                q = br.s(8) if br.f(1) else None
                lf = br.s(6) if br.f(1) else None
                ref = br.f(2) if br.f(1) else None
                dec.seg_features[i] = [q, lf, ref, bool(br.f(1))]
    # tiles
    sb_cols = (hdr.width + 63) >> 6
    min_log2 = 0
    while (64 << min_log2) < sb_cols:
        min_log2 += 1
    max_log2 = 0
    while (sb_cols >> max_log2) >= 4:
        max_log2 += 1
    max_log2 = max(0, max_log2 - 1)
    hdr.tile_cols_log2 = min_log2
    while hdr.tile_cols_log2 < max_log2 and br.f(1):
        hdr.tile_cols_log2 += 1
    hdr.tile_rows_log2 = br.f(1)
    if hdr.tile_rows_log2:
        hdr.tile_rows_log2 += br.f(1)
    hdr.compressed_size = br.f(16)
    hdr.header_bytes = (br.pos + 7) >> 3
    if not hdr.compressed_size:
        raise refused(path, "a compressed header of size 0")
    if hdr.header_bytes + hdr.compressed_size > len(data):
        raise refused(path, "a compressed header past the frame's end")
    return hdr


def diff_update_prob(br: _Bool, p: int) -> int:
    """``update_prob`` behind its 252 flag: the sub-exponential code and
    ``inv_remap_prob``."""
    if not br.bit(252):
        return p
    if not br.bit(128):
        d = br.literal(4)
    elif not br.bit(128):
        d = br.literal(4) + 16
    elif not br.bit(128):
        d = br.literal(5) + 32
    else:
        d = br.literal(7)
        if d >= 65:
            d = (d << 1) - 65 + br.bit(128)
        d += 64
    v = int(T.INV_MAP_TABLE[d])
    if p <= 128:
        m = p - 1
        return 1 + (v if v > 2 * m else (m - ((v + 1) >> 1) if v & 1 else m + (v >> 1)))
    m = 255 - p
    return 255 - (v if v > 2 * m else (m - ((v + 1) >> 1) if v & 1 else m + (v >> 1)))


def _update_list(br: _Bool, probs: list) -> None:
    for i, p in enumerate(probs):
        probs[i] = diff_update_prob(br, p)


def _update_mv(br: _Bool, probs: list) -> None:
    for i, p in enumerate(probs):
        if br.bit(252):
            probs[i] = (br.literal(7) << 1) | 1


def read_compressed(br: _Bool, hdr: Header, fc: ProbContext) -> None:
    """The compressed header (``decode_frame_header``'s second part): the
    transform mode and reference mode, and the forward updates of ``fc``
    (the frame's copy of its saved context)."""
    if hdr.lossless:
        hdr.tx_mode = ONLY_4X4
    else:
        hdr.tx_mode = br.literal(2)
        if hdr.tx_mode == ALLOW_32X32:
            hdr.tx_mode += br.bit(128)
        if hdr.tx_mode == TX_MODE_SELECT:
            for probs in (fc.tx8, fc.tx16, fc.tx32):
                for row in probs:
                    _update_list(br, row)
    for tx in range(min(hdr.tx_mode, ALLOW_32X32) + 1):
        if br.bit(128):
            for plane in fc.coef[tx]:
                for ref in plane:
                    for band, ctxs in enumerate(ref):
                        for ctx in ctxs[:3 if band == 0 else 6]:
                            _update_list(br, ctx)
    _update_list(br, fc.skip)
    hdr.reference_mode = SINGLE_REFERENCE
    if hdr.key or hdr.intra_only:
        return
    for row in fc.inter_mode:
        _update_list(br, row)
    if hdr.filter == SWITCHABLE:
        for row in fc.filter:
            _update_list(br, row)
    _update_list(br, fc.intra_inter)
    bias = hdr.sign_bias
    hdr.comp_allowed = bias[1] != bias[2] or bias[1] != bias[3]
    if hdr.comp_allowed:
        if bias[LAST_FRAME] == bias[GOLDEN_FRAME]:
            hdr.comp_fixed_ref, hdr.comp_var_ref = ALTREF_FRAME, (LAST_FRAME, GOLDEN_FRAME)
        elif bias[LAST_FRAME] == bias[ALTREF_FRAME]:
            hdr.comp_fixed_ref, hdr.comp_var_ref = GOLDEN_FRAME, (LAST_FRAME, ALTREF_FRAME)
        else:
            hdr.comp_fixed_ref, hdr.comp_var_ref = LAST_FRAME, (GOLDEN_FRAME, ALTREF_FRAME)
        if br.bit(128):
            hdr.reference_mode = REFERENCE_MODE_SELECT if br.bit(128) else COMPOUND_REFERENCE
        if hdr.reference_mode == REFERENCE_MODE_SELECT:
            _update_list(br, fc.comp_inter)
    if hdr.reference_mode != COMPOUND_REFERENCE:
        for row in fc.single_ref:
            _update_list(br, row)
    if hdr.reference_mode != SINGLE_REFERENCE:
        _update_list(br, fc.comp_ref)
    for row in fc.y_mode:
        _update_list(br, row)
    for row in fc.partition:
        _update_list(br, row)
    read_mv_probs(br, hdr, fc)


def read_mv_probs(br: _Bool, hdr: Header, fc: ProbContext) -> None:
    """``read_mv_probs``: joints; per component sign, classes, class0, bits;
    per component class0_fp and fp; with high precision, class0_hp and hp."""
    _update_mv(br, fc.mv_joint)
    for i in range(2):
        one = [fc.mv_sign[i]]
        _update_mv(br, one)
        fc.mv_sign[i] = one[0]
        _update_mv(br, fc.mv_classes[i])
        one = [fc.mv_class0[i]]
        _update_mv(br, one)
        fc.mv_class0[i] = one[0]
        _update_mv(br, fc.mv_bits[i])
    for i in range(2):
        for row in fc.mv_class0_fp[i]:
            _update_mv(br, row)
        _update_mv(br, fc.mv_fp[i])
    if hdr.allow_hp:
        for i in range(2):
            for probs in (fc.mv_class0_hp, fc.mv_hp):
                one = [probs[i]]
                _update_mv(br, one)
                probs[i] = one[0]


def _merge(p: int, c0: int, c1: int, sat: int, factor: int) -> int:
    """``adapt_prob``: ``p`` moved towards the counts' probability."""
    ct = c0 + c1
    if not ct:
        return p
    uf = factor * min(ct, sat) // sat
    p2 = min(max(((c0 << 8) + (ct >> 1)) // ct, 1), 255)
    return p + (((p2 - p) * uf + 128) >> 8)


def _tree_merge(probs: list, tree: list, counts: list, sat: int = 20, factor: int = 128) -> None:
    """Each node of ``tree`` (libvpx's, leaves negated) merged with the
    counts of the leaves under its two branches."""
    def total(i):
        return counts[-i] if i <= 0 else total(tree[i]) + total(tree[i + 1])

    for node in range(0, len(tree), 2):
        probs[node >> 1] = _merge(probs[node >> 1], total(tree[node]), total(tree[node + 1]), sat,
                                  factor)


def adapt(pre: ProbContext, fc: ProbContext, counts: Counts, hdr: Header, last_key: bool) -> None:
    """``ff_vp9_adapt_probs``: the saved context ``pre`` adapted to the
    frame's counts (``fc`` holds the frame's forward-updated probabilities,
    which an intra frame's skip and transform probabilities take)."""
    uf = 112 if (hdr.key or hdr.intra_only or not last_key) else 128
    for t in range(4):
        for i in range(2):
            for j in range(2):
                for band in range(6):
                    for ctx in range(3 if band == 0 else 6):
                        p = pre.coef[t][i][j][band][ctx]
                        e = counts.eob[t][i][j][band][ctx]
                        c = counts.coef[t][i][j][band][ctx]
                        p[0] = _merge(p[0], e[0], e[1], 24, uf)
                        p[1] = _merge(p[1], c[0], c[1] + c[2], 24, uf)
                        p[2] = _merge(p[2], c[1], c[2], 24, uf)
    if hdr.key or hdr.intra_only:
        pre.skip, pre.tx32, pre.tx16, pre.tx8 = (copy.deepcopy(x) for x in (fc.skip, fc.tx32,
                                                                           fc.tx16, fc.tx8))
        return
    for i in range(3):
        pre.skip[i] = _merge(pre.skip[i], *counts.skip[i], 20, 128)
    for i in range(4):
        pre.intra_inter[i] = _merge(pre.intra_inter[i], *counts.intra_inter[i], 20, 128)
    if hdr.reference_mode == REFERENCE_MODE_SELECT:
        for i in range(5):
            pre.comp_inter[i] = _merge(pre.comp_inter[i], *counts.comp_inter[i], 20, 128)
    if hdr.reference_mode != SINGLE_REFERENCE:
        for i in range(5):
            pre.comp_ref[i] = _merge(pre.comp_ref[i], *counts.comp_ref[i], 20, 128)
    if hdr.reference_mode != COMPOUND_REFERENCE:
        for i in range(5):
            for k in range(2):
                pre.single_ref[i][k] = _merge(pre.single_ref[i][k], *counts.single_ref[i][k], 20,
                                              128)
    for i in range(16):
        _tree_merge(pre.partition[i], T.PARTITION_TREE.tolist(), counts.partition[i])
    if hdr.tx_mode == TX_MODE_SELECT:
        for i in range(2):
            c8, c16, c32 = counts.tx8[i], counts.tx16[i], counts.tx32[i]
            pre.tx8[i][0] = _merge(pre.tx8[i][0], c8[0], c8[1], 20, 128)
            pre.tx16[i][0] = _merge(pre.tx16[i][0], c16[0], c16[1] + c16[2], 20, 128)
            pre.tx16[i][1] = _merge(pre.tx16[i][1], c16[1], c16[2], 20, 128)
            pre.tx32[i][0] = _merge(pre.tx32[i][0], c32[0], c32[1] + c32[2] + c32[3], 20, 128)
            pre.tx32[i][1] = _merge(pre.tx32[i][1], c32[1], c32[2] + c32[3], 20, 128)
            pre.tx32[i][2] = _merge(pre.tx32[i][2], c32[2], c32[3], 20, 128)
    if hdr.filter == SWITCHABLE:
        for i in range(4):
            _tree_merge(pre.filter[i], T.SWITCHABLE_INTERP_TREE.tolist(), counts.filter[i])
    for i in range(7):
        _tree_merge(pre.inter_mode[i], T.INTER_MODE_TREE.tolist(), counts.inter_mode[i])
    _tree_merge(pre.mv_joint, T.MV_JOINT_TREE.tolist(), counts.mv_joint)
    for i in range(2):
        pre.mv_sign[i] = _merge(pre.mv_sign[i], *counts.mv_sign[i], 20, 128)
        _tree_merge(pre.mv_classes[i], T.MV_CLASS_TREE.tolist(), counts.mv_classes[i])
        pre.mv_class0[i] = _merge(pre.mv_class0[i], *counts.mv_class0[i], 20, 128)
        for j in range(10):
            pre.mv_bits[i][j] = _merge(pre.mv_bits[i][j], *counts.mv_bits[i][j], 20, 128)
        for j in range(2):
            _tree_merge(pre.mv_class0_fp[i][j], T.MV_FP_TREE.tolist(), counts.mv_class0_fp[i][j])
        _tree_merge(pre.mv_fp[i], T.MV_FP_TREE.tolist(), counts.mv_fp[i])
        if hdr.allow_hp:
            pre.mv_class0_hp[i] = _merge(pre.mv_class0_hp[i], *counts.mv_class0_hp[i], 20, 128)
            pre.mv_hp[i] = _merge(pre.mv_hp[i], *counts.mv_hp[i], 20, 128)
    for i in range(4):
        _tree_merge(pre.y_mode[i], T.INTRA_MODE_TREE.tolist(), counts.y_mode[i])
    for i in range(10):
        _tree_merge(pre.uv_mode[i], T.INTRA_MODE_TREE.tolist(), counts.uv_mode[i])
