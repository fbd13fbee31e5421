"""VP9 video, profile 0 (8-bit 4:2:0), with numpy and plain Python, as
FFmpeg's native ``vp9`` decoder (``libavcodec/vp9*.c``) gives it to OpenCV:
``Vp9Decoder(path).decode(packet)`` yields each shown frame's ``(Y, Cb,
Cr)`` uint8 planes at the frame size (chroma ``ceil(H / 2) x ceil(W / 2)``).

The layers: ``utils/vp9.py`` (superframes, the uncompressed and compressed
headers, the probability contexts and their adaptation),
``utils/vp9modes.py`` (partitions, modes, references, motion vectors),
``utils/vp9tokens.py`` (coefficients), ``utils/vp9itx.py`` (inverse
transforms), ``utils/vp9pred.py`` (intra and inter prediction),
``utils/vp9lf.py`` (the loop filter) and ``utils/vp9tables.py`` (the default
tables, generated from opencv-python's FFmpeg and libvpx). This module runs the
frame loop: a packet's frames (a superframe holds several), the tiles in
order, reconstruction (every inter block at once, then the intra blocks in
decoding order from the frame built so far), the loop filter, the eight
reference slots refreshed by ``refresh_frame_flags``, the four probability
contexts saved or adapted, and the state FFmpeg keeps for the next frame:
the previous frame's motion vectors (used when it was shown, of the same
size, and the new frame is not error resilient) and the segment map
(FFmpeg's ``REF_FRAME_SEGMAP``: the previous frame's, kept while frames do
not update it).

A frame with ``show_frame`` 0 yields nothing; ``show_existing_frame``
yields the slot's frame as it was decoded. ``full_range`` is the range of
the frame last yielded: the key frame's ``color_range`` bit, which FFmpeg
hands swscale.

Probed with cv2 5.0.0 (FFmpeg avcodec 62.28, swscale 9.5, x86), with
clips written by cv2's ``VP90`` and headers rewritten by
``scripts/make_vp9_fixtures.py``: swscale converts FFmpeg's VP9 frames
as it converts VP8's (chroma centred, ``yuv.VP8_H_POS``), at full range
when ``color_range`` is 1; every ``color_space`` value but RGB (which
profile 0 cannot carry) converts as unknown (``tests/test_torch_vp9.py``
holds each against cv2); cv2's frame threads give the same frames as one
thread on every fixture and rewritten stream of the tests.

Refused, each with a ValueError naming ROADMAP.md queue 1, item 4 (besides
``utils/vp9.py``'s): a size change, a reference of another size (scaled
motion compensation), an inter frame before any key frame, the segment
skip feature on blocks under 8x8, coefficients whose inverse transform
leaves 16 bits (``utils/vp9itx.py``), a tile or partition past the packet,
and an empty partition.
"""

from __future__ import annotations

import time

import numpy as np

from . import vp9
from .vp9 import Counts, ProbContext, bool_decoder, read_compressed, read_uncompressed, refused
from .vp9itx import inverse
from .vp9lf import loop_filter
from .vp9modes import BLOCK_4X8, BLOCK_8X4, BLOCK_8X8, H8, W8, Frame, TileDecoder
from .vp9pred import edges, motion, predict

MARGIN = 16  # pixels past the 64-aligned frame, so the loop filter never clips
# the colour spaces swscale converts as it converts an unknown one (BT.601):
# unknown, BT.601 and SMPTE 170M; BT.709 (2), SMPTE 240M (4) and BT.2020 (5)
# take other matrices, reserved (6) is not converted
SPACES_AS_UNKNOWN = (0, 1, 3)


def _rdiv(a: int, b: int) -> int:
    """``ROUNDED_DIV``: half away from zero, truncated."""
    return (a + (b >> 1)) // b if a >= 0 else -((-a + (b >> 1)) // b)


class Vp9Decoder:
    """A VP9 stream's state from frame to frame (see the module's notes)."""

    def __init__(self, path: str = "<stream>"):
        self.path = path
        self.refs: list = [None] * 8
        self.contexts = [ProbContext() for _ in range(4)]
        self.lf_ref_deltas, self.lf_mode_deltas = [1, 0, -1, -1], [0, 0]
        self.seg_features = [[None, None, None, False] for _ in range(8)]
        self.seg_abs = 0
        self.size = None
        self.color_range = 0  # the last key frame's
        self.last = None  # the frame decoded last (shown or not)
        self.last_shown = True
        self.last_key = False
        self.prev_seg = (0, 0)  # the last header's segmentation enabled / update_map
        self.segmap_ref = None
        self.prev_mvs = None
        self.full_range = False
        self.log = None  # a list to collect (header, TileDecoder) of each frame in, for tests

    def decode(self, packet: bytes, stats: dict | None = None):
        """One packet -> the planes of each frame it shows (a generator).
        ``stats`` adds seconds by stage and a frame, each under ``key`` or
        ``inter``."""
        for start, end in vp9.superframe_split(packet, self.path):
            yield from self._frame(packet, start, end, stats)

    # ------------------------------------------------------------ frames

    def _frame(self, data: bytes, start: int, end: int, stats):
        t0 = time.perf_counter()
        retain = self.segmap_ref is not None and not (self.prev_seg[0] and self.prev_seg[1])
        hdr = read_uncompressed(data[start:end], self, self.path)
        if hdr.show_existing:
            frame = self.refs[hdr.existing_idx]
            if frame is None:
                raise refused(self.path, "show_existing_frame of an empty slot")
            self.full_range = frame.full_range
            yield self._crop(frame)
            return
        self.prev_seg = (hdr.seg_enabled, hdr.seg_update_map)
        size = (hdr.height, hdr.width)
        if hdr.key:
            if self.size is not None and self.size != size:
                raise refused(self.path, f"a size change from {self.size} to {size}")
            self.size = size
            if hdr.color_space not in SPACES_AS_UNKNOWN:
                raise refused(self.path, f"colour space {hdr.color_space} (swscale converts it "
                              "with another matrix or not at all)")
            self.color_range = hdr.color_range
        else:
            if size != self.size:
                raise refused(self.path, f"an inter frame of size {size} on references of "
                              f"{self.size} (scaled motion compensation)")
            for i in hdr.ref_idx:
                if self.refs[i].size != size:
                    raise refused(self.path, "a reference of another size (scaled motion "
                                  "compensation)")
        if hdr.key or hdr.error_res:
            self.contexts = [ProbContext() for _ in range(4)]
        fc = self.contexts[hdr.context_idx].copy()
        at = start + hdr.header_bytes
        br = bool_decoder(data, at, hdr.compressed_size, self.path)
        read_compressed(br, hdr, fc)
        counts = Counts()
        src = self.last if not (hdr.key or hdr.error_res) else None
        if not retain or hdr.key:
            self.segmap_ref = src.seg_map if src is not None else None
        use_prev = (not hdr.error_res and self.last_shown and self.last is not None
                    and self.last.size == size and not hdr.key)
        self.prev_mvs = self.last.mvs if use_prev else None
        td = TileDecoder(self, hdr, fc, counts, self.path)
        td.decode_tiles(data, at + hdr.compressed_size, end,
                        lambda buf, s, n: bool_decoder(buf, s, n, self.path))
        t1 = time.perf_counter()
        planes = self.reconstruct(td, hdr)
        t2 = time.perf_counter()
        if hdr.lf_level:
            loop_filter(planes, td.lf_masks, td.lf_level, hdr.sharpness)
        t3 = time.perf_counter()
        if hdr.refresh_context:
            if hdr.parallel:
                self.contexts[hdr.context_idx] = fc
            else:
                vp9.adapt(self.contexts[hdr.context_idx], fc, counts, hdr, self.last_key)
        frame = Frame()
        frame.planes, frame.size = planes, size
        frame.mvs = (td.mv_ref, td.mv_val)
        frame.seg_map = td.seg_map
        frame.full_range = bool(self.color_range)
        for i in range(8):
            if hdr.refresh >> i & 1:
                self.refs[i] = frame
        self.last, self.last_shown, self.last_key = frame, bool(hdr.show), hdr.key
        if self.log is not None:
            self.log.append((hdr, td))
        if stats is not None:
            kind = "key" if hdr.key else "inter"
            for name, secs in (("tokens", t1 - t0), ("predict", t2 - t1), ("filter", t3 - t2)):
                stats[f"{name}_{kind}"] = stats.get(f"{name}_{kind}", 0.0) + secs
            stats[f"frames_{kind}"] = stats.get(f"frames_{kind}", 0) + 1
        if hdr.show:
            self.full_range = frame.full_range
            yield self._crop(frame)

    @staticmethod
    def _crop(frame):
        h, w = frame.size
        ch, cw = (h + 1) // 2, (w + 1) // 2
        return tuple(np.ascontiguousarray(p[:hh, :ww], dtype=np.uint8)
                     for p, hh, ww in zip(frame.planes, (h, ch, ch), (w, cw, cw)))

    # ---------------------------------------------------- reconstruction

    def reconstruct(self, td: TileDecoder, hdr) -> list:
        """Prediction plus residuals of every block, unfiltered."""
        H, W = td.sb_rows * 64, td.sb_cols * 64
        planes = [np.zeros((H + MARGIN, W + MARGIN), np.int32),
                  np.zeros((H // 2 + MARGIN, W // 2 + MARGIN), np.int32),
                  np.zeros((H // 2 + MARGIN, W // 2 + MARGIN), np.int32)]
        res = {key: inverse(np.array(group, np.int64), key[0], key[1], self.path)
               for key, group in td.coefs.items()}
        if td.inter_blocks:
            self._inter(td, hdr, planes, res)
        aligned = ((td.cols * 8, td.rows * 8), (td.cols * 4, td.rows * 4))
        for b, recs, tile_start in td.intra_blocks:
            w4 = 2 * W8[b.bs]
            for plane, y, x, txs, mode, key in recs:
                ss = plane > 0
                n = 4 << txs
                pl = planes[plane]
                aw, ah = aligned[ss]
                bx = (x - (b.col * 4 if ss else b.col * 8)) >> 2  # 4x4 column in the block
                mode2, top, left, tl = edges(pl, mode, y, x, n, y > 0,
                                             x > (tile_start * 4 if ss else tile_start * 8),
                                             bx < (w4 >> ss) - 1, aw - x, ah - y)
                pred = predict(mode2, n, top, left, tl)
                if key is not None:
                    pred = np.clip(pred + res[key[:2]][key[2]], 0, 255)
                pl[y:y + n, x:x + n] = pred
        return planes

    def _inter(self, td, hdr, planes, res) -> None:
        """Every inter block's prediction (grouped by reference, plane and
        size), compound averages, then the residuals."""
        units = {}  # (comp, slot, plane, h, w) -> [(y, x, mvy, mvx, filter)]
        for b, _ in td.inter_blocks:
            comp = b.ref[1] > 0
            for z in range(1 + comp):
                slot = hdr.ref_idx[b.ref[z] - 1]
                ly, lx = b.row * 8, b.col * 8
                if b.bs >= BLOCK_8X8:
                    mv = b.mv[0][z]
                    units.setdefault((z, slot, 0, H8[b.bs] * 8, W8[b.bs] * 8), []).append(
                        (ly, lx, mv[0], mv[1], b.filter))
                    units.setdefault((z, slot, 1, H8[b.bs] * 4, W8[b.bs] * 4), []).append(
                        (ly // 2, lx // 2, mv[0], mv[1], b.filter))
                    continue
                if b.bs == BLOCK_8X4:
                    parts = [(0, 0, 4, 8, 0), (4, 0, 4, 8, 2)]
                    cm = [b.mv[0][z], b.mv[2][z]]
                elif b.bs == BLOCK_4X8:
                    parts = [(0, 0, 8, 4, 0), (0, 4, 8, 4, 1)]
                    cm = [b.mv[0][z], b.mv[1][z]]
                else:
                    parts = [(0, 0, 4, 4, 0), (0, 4, 4, 4, 1), (4, 0, 4, 4, 2), (4, 4, 4, 4, 3)]
                    cm = [b.mv[k][z] for k in range(4)]
                for dy, dx, h, w, k in parts:
                    mv = b.mv[k][z]
                    units.setdefault((z, slot, 0, h, w), []).append(
                        (ly + dy, lx + dx, mv[0], mv[1], b.filter))
                cmv = (_rdiv(sum(m[0] for m in cm), len(cm)), _rdiv(sum(m[1] for m in cm), len(cm)))
                units.setdefault((z, slot, 1, 4, 4), []).append(
                    (ly // 2, lx // 2, cmv[0], cmv[1], b.filter))
        # first predictions written, second ones averaged in
        for z in (0, 1):
            for (zz, slot, kind, h, w), lst in units.items():
                if zz != z:
                    continue
                ref = self.refs[slot]
                a = np.array(lst, np.int64)
                y, x, mvy, mvx, filt = a.T
                if kind == 0:
                    targets = [(0, ref.planes[0], ref.size)]
                    y0, x0, fy, fx = y + (mvy >> 3), x + (mvx >> 3), (mvy & 7) << 1, (mvx & 7) << 1
                else:
                    ch, cw = (ref.size[0] + 1) // 2, (ref.size[1] + 1) // 2
                    targets = [(1, ref.planes[1], (ch, cw)), (2, ref.planes[2], (ch, cw))]
                    y0, x0, fy, fx = y + (mvy >> 4), x + (mvx >> 4), mvy & 15, mvx & 15
                rows = y[:, None] + np.arange(h)
                cols = x[:, None] + np.arange(w)
                for plane, src, size in targets:
                    pred = motion(src, size, y0, x0, fy, fx, filt, h, w)
                    dst = planes[plane]
                    if z:
                        pred = (dst[rows[:, :, None], cols[:, None, :]] + pred + 1) >> 1
                    dst[rows[:, :, None], cols[:, None, :]] = pred
        # residuals
        groups = {}
        for b, recs in td.inter_blocks:
            for plane, y, x, txs, mode, key in recs:
                groups.setdefault((plane, key[0], key[1]), []).append((y, x, key[2]))
        for (plane, txs, ttype), lst in groups.items():
            n = 4 << txs
            a = np.array(lst, np.int64)
            rows = a[:, 0, None] + np.arange(n)
            cols = a[:, 1, None] + np.arange(n)
            dst = planes[plane]
            cur = dst[rows[:, :, None], cols[:, None, :]]
            dst[rows[:, :, None], cols[:, None, :]] = np.clip(cur + res[txs, ttype][a[:, 2]], 0,
                                                              255)
