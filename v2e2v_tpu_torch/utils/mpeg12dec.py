"""An MPEG-1 / MPEG-2 video decoder in numpy and plain Python, bit for bit
what FFmpeg's ``mpeg1video`` and ``mpeg2video`` decoders (``mpeg12dec.c``,
``mpegvideo``) give for progressive frame pictures of 4:2:0: I-, P- and
B-pictures, as ``cv2.VideoWriter`` writes them (FFmpeg's ``mpeg1video`` and
``mpeg2video`` encoders) and as their headers may be rewritten.

``Mpeg12Decoder(where)``'s ``decode(data)`` takes elementary-stream bytes
(a packet of any split: the pictures are cut at their start codes) and
returns the planes of every picture FFmpeg outputs by then, in its order;
``flush()`` returns the last reference picture. Each is ``(Y, Cb, Cr)``
uint8, cropped to ``horizontal_size`` x ``vertical_size`` (FFmpeg's
``yuv420p``; limited range). The layers: ``mpeg12.py`` the headers,
``mpeg12mb.py`` the macroblocks and their coefficients, this module the
pictures:

- reconstruction vectorised over a picture's macroblocks:
  ``jpeg.idct_simple`` for intra blocks and ``jpeg.idct_simple_add`` for
  coded residuals (``ff_simple_idct_put`` / ``_add``, shared with
  ``mpeg4.py``), after the half-pel prediction: ``put_pixels`` with
  rounding ((a + b + 1) >> 1, (a + b + c + d + 2) >> 2) from the forward
  or the backward reference, a bidirectional macroblock averaging the
  backward prediction into the forward one as ``avg_pixels`` does
  ((p + q + 1) >> 1, x86's ``pavgb``, exact); chroma vectors as
  ``mpeg_motion_internal`` derives them for 4:2:0 (the luma vector halved
  towards zero, its own half-pel bit);
- a vector whose luma block reaches past the reference's macroblock grid
  is refused: FFmpeg's MPEG-1/2 path leaves such a macroblock unpredicted
  (whatever its frame buffer held), it does not emulate the edge (probed:
  reads clamped to the edge give other pixels than cv2 on exactly those
  macroblocks of an MPEG-1 stream whose ``full_pel`` flags were set);
- the picture loop: the forward and backward references (FFmpeg's
  ``last_pic`` and ``next_pic``); a B-picture is output at once, an I- or
  P-picture when the next one arrives (at once where the sequence
  extension says ``low_delay``), the last at ``flush``. A B-picture before
  the stream's second reference picture is dropped unless the GOP header
  in force says ``closed_gop`` (FFmpeg then predicts it from a grey dummy
  picture, of which a closed GOP uses nothing); ``broken_link`` changes
  nothing, as in FFmpeg.

Probed on this host's cv2 5.0.0 (FFmpeg avcodec 62.28), on cv2's own
streams and rewritten ones (``scripts/make_mpeg12_fixtures.py``):

- the frame count cv2 reports for program and transport streams is
  FFmpeg's estimate (``mpegps.py::pts_frame_count``): the largest PES
  time stamp of the file's tail plus one packet's duration at
  ``r_frame_rate`` (``mpegps.packet_rate``), less the first, times the
  rate, rounded; pinned by the counts 1 (8x8, 12 frames), 6 (128x96, 12),
  10 (MPEG-1 noise at 48x32, 12), 36 (64x96, 40) and by a 30-case sweep
  (``tests/test_torch_mpeg12_video.py``);
- swscale converts MPEG-1's 4:2:0 with centred chroma (``yuv.VP8_H_POS``)
  and MPEG-2's with left-sited chroma (``yuv.MPEG4_H_POS``), both at
  limited range, as ``mpeg12dec.c`` tags them: the two differ only on the
  general scaler's route (an odd height), probed on rewritten sizes
  (75x61 MPEG-1, 125x91 and 128x91 MPEG-2); a colour description of
  BT.601 (5, 6) converts as an unspecified one (2), BT.709, FCC, SMPTE
  240M and the rest do not (refused);
- pictures with ``progressive_frame`` 0 convert as the others;
- ``avg_pixels`` and ``put_pixels`` at the xy half-pel position are exact
  (cv2's B-pictures average every half-pel kind; the fixtures hold them);
- FFmpeg drops the leading B-pictures of an open GOP at the stream's
  start (a stream cut at its second GOP loses them) and decodes those after
  a ``broken_link`` from the references it holds;
- cv2's frame threads give the same frames as one thread on every fixture.

Refused, each with a ValueError naming ROADMAP.md queue 1, item 4: field
pictures, field or dual-prime motion and field DCT, 4:2:2 and 4:4:4, the
scalable extensions, MPEG-1 D-pictures, a size change inside a stream, a
P- or B-picture before any I-picture, vectors past the reference's edge,
colour descriptions that swscale converts otherwise, and corrupt or
truncated data (a macroblock no slice codes, an invalid code), where
FFmpeg would conceal.
"""

from __future__ import annotations

import time

import numpy as np

from .jpeg import idct_simple, idct_simple_add
from .mpeg12 import (B_TYPE, D_TYPE, EXTENSION, GOP, I_TYPE, PICTURE, PICTURE_NAMES,
                     SEQUENCE, SEQUENCE_END, SLICE_MAX, SLICE_MIN, USER_DATA, StreamHeaders,
                     corrupt, refuse, start_codes)
from .mpeg12mb import PictureSyntax
from .mpeg4 import Bits


class Frame:
    """A decoded picture at the macroblock grid's size."""

    def __init__(self, y: np.ndarray, cb: np.ndarray, cr: np.ndarray, kind: int):
        self.y, self.cb, self.cr, self.kind = y, cb, cr, kind


class Mpeg12Decoder:
    """FFmpeg's ``mpeg1video`` / ``mpeg2video`` for the streams the module's
    notes list."""

    def __init__(self, where: str = "<stream>"):
        self.where = where
        self.h = StreamHeaders(where)
        self.last: Frame | None = None  # the forward reference (FFmpeg's last_pic)
        self.next: Frame | None = None  # the backward reference (next_pic)
        self.size: tuple[int, int] | None = None
        self.mpeg2: bool | None = None
        self.pending = b""  # bytes of a picture whose end is not yet seen
        self.pictures = 0
        self.syntax_log: list | None = None  # when a list, each picture's PictureSyntax
        self.stats: dict | None = None  # when a dict, seconds by stage and picture type
        self.shown: list[str] = []  # the picture type ("I", "P", "B") of each frame output

    # --------------------------------------------------------------- input

    def decode(self, data: bytes) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Elementary-stream bytes -> the planes FFmpeg outputs by their end.
        A picture is decoded when its last slice is followed by another
        start code or ``flush``."""
        buf = self.pending + bytes(data)
        codes = start_codes(buf)
        # a picture ends where the next picture, sequence, GOP or end code starts
        out = []
        start = None
        for code, pos in codes:
            if code in (PICTURE, SEQUENCE, GOP, SEQUENCE_END):
                if start is not None:
                    out += self._unit(buf[start:pos - 4])
                start = pos - 4
        self.pending = buf[start:] if start is not None else buf
        return out

    def flush(self) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """The rest of the stream: its last picture, then the held reference."""
        out = self._unit(self.pending) if self.pending else []
        self.pending = b""
        if self.next is not None and not (self.mpeg2 and self.h.seq.low_delay):
            out.append(self._crop(self.next))
        self.next = None
        return out

    def _unit(self, data: bytes) -> list:
        """One header or picture (its start code, its extensions, its slices)."""
        codes = start_codes(data)
        if not codes:
            return []
        code, pos = codes[0]
        # the headers' bytes: up to the first slice (each slice gets its own reader)
        first = next((p for c, p in codes if SLICE_MIN <= c <= SLICE_MAX), len(data))
        bits = Bits(data[:first])
        h = self.h
        if code == SEQUENCE:
            bits.pos = 8 * pos
            h.sequence(bits)
            self._extensions(bits, data, codes[1:], SEQUENCE)
            self._check_sequence()
            return []
        if code == GOP:
            bits.pos = 8 * pos
            h.gop(bits)
            self._extensions(bits, data, codes[1:], GOP)
            return []
        if code != PICTURE:
            return []
        if h.seq is None:
            raise corrupt(self.where, "a picture before any sequence header")
        bits.pos = 8 * pos
        pic = h.picture(bits)
        slices = self._extensions(bits, data, codes[1:], PICTURE)
        if self.mpeg2 and not pic.extension:
            raise corrupt(self.where, "an MPEG-2 picture with no picture coding extension")
        return self._picture(pic, data, slices)

    def _extensions(self, bits: Bits, data: bytes, codes, after: int) -> list:
        """Read the extensions after a header; return the slices' start codes."""
        slices = []
        for code, pos in codes:
            if code == EXTENSION:
                bits.pos = 8 * pos
                self.h.extension(bits, after)
            elif SLICE_MIN <= code <= SLICE_MAX:
                if after != PICTURE:
                    raise corrupt(self.where, "a slice outside a picture")
                slices.append((code, pos))
            elif code != USER_DATA:
                raise corrupt(self.where, f"start code 0x{code:02X} inside a picture's data")
        return slices

    def _check_sequence(self) -> None:
        s = self.h.seq
        size = (s.width, s.height)
        if self.size is not None and (size != self.size or s.mpeg2 != self.mpeg2):
            raise refuse(self.where, f"a sequence of {s.width}x{s.height} "
                         f"{'MPEG-2' if s.mpeg2 else 'MPEG-1'} after "
                         f"{self.size[0]}x{self.size[1]} (a change inside the stream)")
        self.size, self.mpeg2 = size, s.mpeg2

    # ------------------------------------------------------------ pictures

    def _grid(self) -> tuple[int, int]:
        s = self.h.seq
        mbw = (s.width + 15) >> 4
        if self.mpeg2 and not s.progressive_sequence:
            return mbw, 2 * ((s.height + 31) >> 5)
        return mbw, (s.height + 15) >> 4

    def _picture(self, pic, data: bytes, slices) -> list:
        kind = pic.kind
        name = PICTURE_NAMES[kind]
        if kind == D_TYPE:
            raise refuse(self.where, "an MPEG-1 D-picture")
        if kind != I_TYPE and self.next is None:
            raise refuse(self.where, f"a {name}-picture before any I-picture")
        if kind == B_TYPE and self.last is None and not self.h.closed_gop:
            return []  # FFmpeg skips it: no forward reference in an open GOP
        where = f"{self.where} picture {self.pictures}"
        self.pictures += 1
        mbw, mbh = self._grid()
        t0 = time.perf_counter()
        syn = PictureSyntax(self.h, pic, mbw, mbh, self.mpeg2, where)
        if self.syntax_log is not None:
            syn.marks = []
        if pic.alternate_scan:
            syn.used.add("alternate_scan")
        if pic.intra_dc_precision:
            syn.used.add("intra_dc_precision")
        for i, (code, pos) in enumerate(slices):
            end = slices[i + 1][1] - 4 if i + 1 < len(slices) else len(data)
            bits = Bits(data[pos:end])
            bits.pos = 0
            syn.slice(bits, code)
        if 0 in syn.kind:
            missing = syn.kind.index(0)
            raise corrupt(where, f"macroblock {missing} coded by no slice (FFmpeg conceals it)")
        t1 = time.perf_counter()
        if self.syntax_log is not None:
            self.syntax_log.append(syn)
        frame = self._reconstruct(syn, kind, mbw, mbh, where)
        if self.stats is not None:
            st = self.stats.setdefault(name, {"syntax": 0.0, "reconstruct": 0.0, "frames": 0})
            st["syntax"] += t1 - t0
            st["reconstruct"] += time.perf_counter() - t1
            st["frames"] += 1
        if kind == B_TYPE:
            return [self._crop(frame)]
        out = []
        if self.mpeg2 and self.h.seq.low_delay:
            out.append(self._crop(frame))
        elif self.next is not None:
            out.append(self._crop(self.next))
        self.last, self.next = self.next, frame
        return out

    def _crop(self, f: Frame):
        self.shown.append(PICTURE_NAMES[f.kind])
        w, h = self.size
        ch, cw = (h + 1) >> 1, (w + 1) >> 1
        return f.y[:h, :w].copy(), f.cb[:ch, :cw].copy(), f.cr[:ch, :cw].copy()

    # ------------------------------------------------------ reconstruction

    def _reconstruct(self, syn: PictureSyntax, kind: int, mbw: int, mbh: int,
                     where: str) -> Frame:
        y = np.zeros((mbh * 16, mbw * 16), np.uint8)
        cb = np.zeros((mbh * 8, mbw * 8), np.uint8)
        cr = np.zeros((mbh * 8, mbw * 8), np.uint8)
        planes = (y, cb, cr)
        if kind != I_TYPE:
            self._predict(syn, planes, mbw, mbh, where)
        mismatch = bool(self.mpeg2)
        if syn.inter.ids:
            where_ = _block_places(syn.inter.ids, mbw)
            pred = np.concatenate([planes[k][r, c] for k, (r, c) in where_]).reshape(-1, 64)
            order = np.concatenate([sel for sel in _by_plane(syn.inter.ids)])
            coef = syn.inter.dense(mismatch)[order]
            px = idct_simple_add(coef, pred, where).reshape(-1, 8, 8)
            _place(planes, where_, px)
        if syn.intra.ids:
            where_ = _block_places(syn.intra.ids, mbw)
            order = np.concatenate([sel for sel in _by_plane(syn.intra.ids)])
            px = idct_simple(syn.intra.dense(mismatch)[order], where).reshape(-1, 8, 8)
            _place(planes, where_, px)
        return Frame(y, cb, cr, kind)

    def _predict(self, syn: PictureSyntax, planes, mbw: int, mbh: int, where: str) -> None:
        """Half-pel prediction of every predicted macroblock: forward, backward
        or both averaged (``ff_mpv_motion`` with ``put_pixels``, then
        ``avg_pixels``)."""
        sel = [mb for mb, k in enumerate(syn.kind) if k == 1]
        if not sel:
            return
        mb = np.array(sel)
        mby, mbx = np.divmod(mb, mbw)
        vec = np.array([syn.vectors[m] for m in sel], np.int64).reshape(-1, 4)
        dirs = np.array([syn.direction[m] for m in sel])
        if syn.pic.kind == B_TYPE:  # FFmpeg's last_pic and next_pic
            refs = (_grey(mbw, mbh) if self.last is None else self.last, self.next)
        else:  # a P-picture: the newest reference, which becomes last_pic
            refs = (self.next, None)
        out = [np.zeros((len(sel), 16, 16), np.int32), np.zeros((len(sel), 8, 8), np.int32),
               np.zeros((len(sel), 8, 8), np.int32)]
        for d in (0, 1):
            use = (dirs >> d & 1).astype(bool)
            if not use.any():
                continue
            mx, my = vec[use, 2 * d], vec[use, 2 * d + 1]
            px, py = mbx[use], mby[use]
            preds = _motion(refs[d], px, py, mx, my, mbw, mbh, where)
            for k in range(3):
                if d == 0:
                    out[k][use] = preds[k]
                else:  # avg_pixels onto a forward prediction where there is one
                    both = (dirs[use] & 1).astype(bool)
                    prev = out[k][use]
                    out[k][use] = np.where(both[:, None, None], (prev + preds[k] + 1) >> 1,
                                           preds[k])
        y, cb, cr = planes
        y.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3)[mby, mbx] = out[0]
        cb.reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3)[mby, mbx] = out[1]
        cr.reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3)[mby, mbx] = out[2]


def _grey(mbw: int, mbh: int) -> Frame:
    """FFmpeg's dummy forward reference of a closed GOP's leading B-pictures."""
    return Frame(np.full((mbh * 16, mbw * 16), 128, np.uint8),
                 np.full((mbh * 8, mbw * 8), 128, np.uint8),
                 np.full((mbh * 8, mbw * 8), 128, np.uint8), I_TYPE)


def _by_plane(ids) -> list[np.ndarray]:
    """The indices of the blocks ``ids`` (macroblock, block) in Y, Cb, Cr."""
    n = np.array([b for _, b in ids])
    return [np.flatnonzero(n < 4), np.flatnonzero(n == 4), np.flatnonzero(n == 5)]


def _block_places(ids, mbw: int) -> list:
    """Per plane, (its index, (rows, columns)): each block's 8x8 sample
    indices in that plane, in ``_by_plane``'s order."""
    mb = np.array([m for m, _ in ids])
    n = np.array([b for _, b in ids])
    mby, mbx = np.divmod(mb, mbw)
    k = np.arange(8)
    out = []
    for plane, sel in enumerate(_by_plane(ids)):
        if plane == 0:
            top = 16 * mby[sel] + 8 * (n[sel] >> 1)
            left = 16 * mbx[sel] + 8 * (n[sel] & 1)
        else:
            top, left = 8 * mby[sel], 8 * mbx[sel]
        out.append((plane, ((top[:, None] + k)[:, :, None], (left[:, None] + k)[:, None, :])))
    return out


def _place(planes, places, px: np.ndarray) -> None:
    """Write ``px`` (blocks in ``_by_plane``'s order) to their places."""
    at = 0
    for plane, (rows, cols) in places:
        n = len(rows)
        planes[plane][rows, cols] = px[at:at + n]
        at += n


def _motion(ref: Frame, mbx, mby, mx, my, mbw: int, mbh: int, where: str):
    """``mpeg_motion_internal`` for 16x16 frame prediction: luma and chroma
    predictions of the macroblocks at (mbx, mby) by half-pel vectors (mx, my)."""
    src_x = 16 * mbx + (mx >> 1)
    src_y = 16 * mby + (my >> 1)
    h_edge, v_edge = 16 * mbw, 16 * mbh
    bad = ((src_x < 0) | (src_x > h_edge - (mx & 1) - 16)
           | (src_y < 0) | (src_y > v_edge - (my & 1) - 16))
    if bad.any():
        k = int(np.argmax(bad))
        raise refuse(where, f"a motion vector ({int(mx[k])}, {int(my[k])}) past the reference's "
                     f"edge at macroblock ({int(mbx[k])}, {int(mby[k])}), which FFmpeg leaves "
                     "unpredicted")
    luma = _halfpel(ref.y, src_x, src_y, mx & 1, my & 1, 16, where)
    cmx = np.where(mx < 0, -(-mx // 2), mx // 2)  # C division: towards zero
    cmy = np.where(my < 0, -(-my // 2), my // 2)
    cx = 8 * mbx + (cmx >> 1)
    cy = 8 * mby + (cmy >> 1)
    cb = _halfpel(ref.cb, cx, cy, cmx & 1, cmy & 1, 8, where)
    cr = _halfpel(ref.cr, cx, cy, cmx & 1, cmy & 1, 8, where)
    return luma, cb, cr


def _halfpel(plane: np.ndarray, sx, sy, hx, hy, size: int, where: str) -> np.ndarray:
    """``put_pixels`` of ``size`` x ``size`` blocks at (sx, sy) + (hx, hy) / 2."""
    ph, pw = plane.shape
    if (sx < 0).any() or (sy < 0).any() or (sx + size + hx > pw).any() or (
            sy + size + hy > ph).any():
        raise refuse(where, "a chroma prediction past the reference's edge")
    k = np.arange(size + 1)
    rows = np.minimum(sy[:, None] + k, ph - 1) * pw
    cols = np.minimum(sx[:, None] + k, pw - 1)
    p = np.take(plane, rows[:, :, None] + cols[:, None, :]).astype(np.int16)  # [N, s+1, s+1]
    out = np.empty((len(sx), size, size), np.int16)
    kind = hx + 2 * hy
    for dxy in range(4):  # each half-pel position's rounding, on its blocks alone
        sel = np.flatnonzero(kind == dxy)
        if not len(sel):
            continue
        q = p[sel]
        a = q[:, :size, :size]
        if dxy == 0:
            out[sel] = a
        elif dxy == 1:
            out[sel] = (a + q[:, :size, 1:] + 1) >> 1
        elif dxy == 2:
            out[sel] = (a + q[:, 1:, :size] + 1) >> 1
        else:
            out[sel] = (a + q[:, :size, 1:] + q[:, 1:, :size] + q[:, 1:, 1:] + 2) >> 2
    return out
