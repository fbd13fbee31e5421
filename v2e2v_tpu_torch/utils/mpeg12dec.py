"""An MPEG-1 / MPEG-2 video decoder in numpy and plain Python, bit for bit
what FFmpeg's ``mpeg1video`` and ``mpeg2video`` decoders (``mpeg12dec.c``,
``mpegvideo``) give for 4:2:0: progressive and interlaced frame pictures,
pairs of field pictures, I-, P- and B-pictures, as ``cv2.VideoWriter``
writes them (FFmpeg's ``mpeg1video`` and ``mpeg2video`` encoders), as their
headers may be rewritten, and as ``scripts/make_mpeg2i_fixtures.py`` codes
interlaced streams.

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
  ``mpeg4.py``), a field-DCT macroblock's luma blocks on its fields' rows
  (0-1 the top field's, 2-3 the bottom's; chroma frame-coded), after the
  half-pel prediction: ``put_pixels`` with rounding ((a + b + 1) >> 1,
  (a + b + c + d + 2) >> 2), then ``avg_pixels`` ((p + q + 1) >> 1, x86's
  ``pavgb``, exact) for a B-macroblock's backward parts where it has
  forward ones and for dual prime's other parity; chroma vectors as
  ``mpeg_motion_internal`` derives them for 4:2:0 (the luma vector halved
  towards zero, its own half-pel bit);
- ``ff_mpv_motion``'s parts: a frame picture's 16x16 frame prediction, or
  per field 16x8 from the selected field at twice the line stride (field
  motion; dual prime: each field from its own parity, averaged with the
  other parity's by the derived vectors); a field picture's 16x16 or two
  16x8 predictions from the selected field of the forward reference, or,
  for the second field of an I/P or P frame, its first field (the current
  frame) where the other parity is selected; dual prime from both parities
  of the forward reference (the second field: the other parity from its
  own frame); zero-vector and skipped macroblocks from their own parity;
- a vector whose luma block reaches past the reference's macroblock grid
  (in field lines for field predictions: 8 x the frame's macroblock rows)
  is refused: FFmpeg's MPEG-1/2 path leaves such a macroblock unpredicted
  (whatever its frame buffer held), it does not emulate the edge (probed:
  reads clamped to the edge give other pixels than cv2 on exactly those
  macroblocks of an MPEG-1 stream whose ``full_pel`` flags were set);
- the picture loop: the forward and backward references (FFmpeg's
  ``last_pic`` and ``next_pic``), moved on when an I- or P-frame starts
  (its first field); a B-frame is output when complete, an I- or P-frame
  when the next one is (at once where the sequence extension says
  ``low_delay``), the last at ``flush``; two field pictures, of opposite
  parity and both B or neither, make one frame, output after its second. A
  B-picture before the stream's second reference picture is dropped (both
  of its fields) unless the GOP header in force says ``closed_gop``
  (FFmpeg then predicts it from a grey dummy picture, of which a closed GOP
  uses nothing); ``broken_link`` changes nothing, as in FFmpeg.

Probed on this host's cv2 5.0.0 (FFmpeg avcodec 62.28), on cv2's own
streams, rewritten ones (``scripts/make_mpeg12_fixtures.py``) and coded
ones (``scripts/make_mpeg2i_fixtures.py``), the latter against FFmpeg's
decoded planes (its ``mpeg2video`` through the libavcodec cv2 bundles):

- the frame count and rate cv2 reports for program and transport streams
  are FFmpeg's estimates (``mpegrate.py``, ``mpegps.py::pts_frame_count``),
  pinned by sweeps against cv2 (``tests/test_torch_mpeg12_video.py``,
  ``tests/test_torch_mpeg2i.py``);
- swscale converts MPEG-1's 4:2:0 with centred chroma (``yuv.VP8_H_POS``)
  and MPEG-2's with left-sited chroma (``yuv.MPEG4_H_POS``), both at
  limited range, as ``mpeg12dec.c`` tags them: the two differ only on the
  general scaler's route (an odd height), probed on rewritten sizes
  (75x61 MPEG-1, 125x91 and 128x91 MPEG-2); a colour description of
  BT.601 (5, 6) converts as an unspecified one (2), BT.709, FCC, SMPTE
  240M and the rest do not (refused);
- cv2 does not convert a frame FFmpeg flags interlaced (field pictures, and
  frame pictures with ``progressive_frame`` 0 in an interlaced sequence):
  swscale 9.5 refuses "interlaced to progressive", and cv2 returns an
  unconverted buffer that differs from run to run, so the JAX readers' frames
  of such a file are undefined. The port converts them as cv2 converts every
  other MPEG-2 frame, which is what cv2 gives for the same frame flagged
  progressive and for an I420 AVI of FFmpeg's decoded planes; pictures with
  ``progressive_frame`` 0 in a progressive sequence convert as the others;
- ``avg_pixels`` and ``put_pixels`` at the xy half-pel position are exact
  (cv2's B-pictures average every half-pel kind; the fixtures hold them);
- FFmpeg drops the leading B-pictures of an open GOP at the stream's
  start (a stream cut at its second GOP loses them) and decodes those after
  a ``broken_link`` from the references it holds;
- cv2's frame threads give the same frames as one thread on every fixture
  cv2 converts.

Refused, each with a ValueError naming ROADMAP.md queue 1, item 4: 4:2:2
and 4:4:4, the scalable extensions, MPEG-1 D-pictures, a size change inside
a stream, a P- or B-picture before any I-picture, vectors past the
reference's edge, a P-field predicting from its own parity with no earlier
reference (the second field of the stream's first frame: FFmpeg reads the
field being decoded), colour descriptions that swscale converts otherwise,
and corrupt or truncated data (a macroblock or macroblock row no slice
codes, an invalid code, a field picture without its pair or paired with
one of its own parity, field pictures in a progressive sequence), where
FFmpeg would conceal.
"""

from __future__ import annotations

import time

import numpy as np

from .jpeg import idct_simple, idct_simple_add
from .mpeg12 import (B_TYPE, D_TYPE, EXTENSION, FRAME_PICTURE, GOP, I_TYPE, PICTURE,
                     PICTURE_NAMES, SEQUENCE, SEQUENCE_END, SLICE_MAX, SLICE_MIN, USER_DATA,
                     StreamHeaders, corrupt, refuse, start_codes)
from .mpeg12mb import PictureSyntax
from .mpeg4 import Bits


class Frame:
    """A decoded picture at the macroblock grid's size: its planes, its
    (first field's) picture type and its first picture's structure."""

    def __init__(self, y, cb, cr, kind: int, structure: int = FRAME_PICTURE):
        self.y, self.cb, self.cr, self.kind, self.structure = y, cb, cr, kind, structure

    def planes(self) -> tuple:
        return self.y, self.cb, self.cr


class Mpeg12Decoder:
    """FFmpeg's ``mpeg1video`` / ``mpeg2video`` for the streams the module's
    notes list."""

    def __init__(self, where: str = "<stream>"):
        self.where = where
        self.h = StreamHeaders(where)
        self.last: Frame | None = None  # the forward reference (FFmpeg's last_pic)
        self.next: Frame | None = None  # the backward reference (next_pic)
        self.current: Frame | None = None  # a frame whose second field is to come
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
        if self.current is not None and self.current.y is not None:
            raise corrupt(self.where, "a field picture without its second field at the end")
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
        field_pic = pic.picture_structure != FRAME_PICTURE
        cur = self.current  # the frame whose first field came last, if any
        if cur is not None and not field_pic:
            raise corrupt(self.where, "a frame picture after a lone field picture")
        if cur is not None and pic.picture_structure == cur.structure:
            raise corrupt(self.where, "two field pictures of one parity in a frame")
        if cur is not None and (kind == B_TYPE) != (cur.kind == B_TYPE):
            raise corrupt(self.where, "a B-field paired with an I- or P-field")
        if cur is None:
            if kind != I_TYPE and self.next is None:
                raise refuse(self.where, f"a {name}-picture before any I-picture")
            if kind == B_TYPE and self.last is None and not self.h.closed_gop:
                # FFmpeg skips it: no forward reference in an open GOP (both fields)
                if field_pic:
                    self.current = Frame(None, None, None, kind, pic.picture_structure)
                return []
        elif cur.y is None:  # the second field of a skipped B-frame
            self.current = None
            return []
        where = f"{self.where} picture {self.pictures}"
        self.pictures += 1
        mbw, mbh = self._grid()
        t0 = time.perf_counter()
        syn = PictureSyntax(self.h, pic, mbw, mbh >> field_pic, self.mpeg2, where)
        if self.syntax_log is not None:
            syn.marks = []
        if pic.alternate_scan:
            syn.used.add("alternate_scan")
        if pic.intra_dc_precision:
            syn.used.add("intra_dc_precision")
        if field_pic:
            syn.used.add("field_picture")
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
        if cur is None:  # a frame starts: I and P frames rotate the references
            cur = Frame(np.zeros((mbh * 16, mbw * 16), np.uint8),
                        np.zeros((mbh * 8, mbw * 8), np.uint8),
                        np.zeros((mbh * 8, mbw * 8), np.uint8), kind, pic.picture_structure)
            if kind != B_TYPE:
                self.last, self.next = self.next, cur
        self._reconstruct(syn, cur, mbw, mbh, where)
        if self.stats is not None:  # by the frame's (its first field's) type
            st = self.stats.setdefault(PICTURE_NAMES[cur.kind],
                                       {"syntax": 0.0, "reconstruct": 0.0, "frames": 0})
            st["syntax"] += t1 - t0
            st["reconstruct"] += time.perf_counter() - t1
            st["frames"] += not (field_pic and self.current is None)
        if field_pic and self.current is None:  # the first field: the frame waits
            self.current = cur
            return []
        self.current = None
        if cur.kind == B_TYPE or (self.mpeg2 and self.h.seq.low_delay):
            return [self._crop(cur)]
        return [self._crop(self.last)] if self.last is not None else []

    def _crop(self, f: Frame):
        self.shown.append(PICTURE_NAMES[f.kind])
        w, h = self.size
        ch, cw = (h + 1) >> 1, (w + 1) >> 1
        return f.y[:h, :w].copy(), f.cb[:ch, :cw].copy(), f.cr[:ch, :cw].copy()

    # ------------------------------------------------------ reconstruction

    def _reconstruct(self, syn: PictureSyntax, frame: Frame, mbw: int, mbh: int,
                     where: str) -> None:
        """A picture's predictions and blocks into ``frame``: all of it, or
        the rows of a field picture's parity."""
        structure = syn.pic.picture_structure
        planes = frame.planes()
        if structure != FRAME_PICTURE:
            planes = tuple(a[structure - 1::2] for a in planes)
        if syn.pic.kind != I_TYPE:
            self._predict(syn, frame, planes, mbw, mbh, where)
        mismatch = bool(self.mpeg2)
        for blocks, put in ((syn.inter, False), (syn.intra, True)):
            if not blocks.ids:
                continue
            places = _block_places(blocks.ids, mbw, syn.dct)
            order = np.concatenate(_by_plane(blocks.ids))
            coef = blocks.dense(mismatch)[order]
            if put:
                px = idct_simple(coef, where)
            else:
                pred = np.concatenate([planes[k][r, c] for k, (r, c) in places]).reshape(-1, 64)
                px = idct_simple_add(coef, pred, where)
            _place(planes, places, px.reshape(-1, 8, 8))

    def _predict(self, syn: PictureSyntax, frame: Frame, planes, mbw: int, mbh: int,
                 where: str) -> None:
        """Half-pel prediction of every predicted macroblock (``ff_mpv_motion``):
        each part put from its reference (``put_pixels``), then the parts that
        average onto it (``avg_pixels``: a B-macroblock's backward parts
        where it has forward ones, dual prime's opposite parity)."""
        pic = syn.pic
        structure = pic.picture_structure
        field_pic = structure != FRAME_PICTURE
        parity = structure - 1
        second = field_pic and frame is self.current
        if pic.kind == B_TYPE:  # FFmpeg's last_pic (a grey dummy in a closed GOP) and next_pic
            refs = (_grey(mbw, mbh) if self.last is None else self.last, self.next)
        else:
            refs = (self.last, None)
        # (avg, reference, field select, height) -> (reference, [[mbx, src row, x, y, dest
        # row] arrays], [the same of one macroblock part])
        jobs: dict = {}

        def entry(avg, ref, sel, h):
            if ref is None:
                raise refuse(where, "a P-field predicting from its own parity with no earlier "
                             "reference picture (FFmpeg reads the field being decoded)")
            return jobs.setdefault((avg, id(ref), sel, h), (ref, [], []))

        def add(avg, ref, sel, h, mbx, src, x, y, dest):
            entry(avg, ref, sel, h)[2].append((mbx, src, x, y, dest))

        def field_ref(d, sel):  # FFmpeg's choice for a P-field's other parity
            if d == 0 and pic.kind != B_TYPE and second and sel != parity:
                return frame
            return refs[d]

        # 16x16 frame predictions, the macroblocks of a progressive stream, at once
        whole = np.array([mb for mb, k in enumerate(syn.kind) if k == 1 and syn.parts[mb] is None],
                         np.int64)
        if len(whole):
            mby, mbx = np.divmod(whole, mbw)
            vec = np.array([syn.vectors[m] for m in whole], np.int64).reshape(-1, 4)
            dirs = np.array([syn.direction[m] for m in whole])
            for d in (0, 1):
                for avg in (False, True):
                    use = (dirs >> d & 1).astype(bool) & ((d == 1) & (dirs == 3) == avg)
                    if use.any():
                        entry(avg, refs[d], -1, 16)[1].append(np.stack(
                            [mbx[use], 16 * mby[use], vec[use, 2 * d], vec[use, 2 * d + 1],
                             16 * mby[use]], 1))
        for mb, k in enumerate(syn.kind):
            parts = syn.parts[mb]
            if k != 1 or parts is None:
                continue
            mby, mbx = divmod(mb, mbw)
            dirs = syn.direction[mb]
            for d in (0, 1):
                if not dirs >> d & 1:
                    continue
                avg = d == 1 and dirs == 3
                name, own = parts[0], parts[1 + d]
                if name == "dmv" and field_pic:
                    (x, y), (x2, y2) = own
                    add(False, refs[0], parity, 16, mbx, 16 * mby, x, y, 16 * mby)
                    add(True, field_ref(0, 1 - parity), 1 - parity, 16, mbx, 16 * mby, x2, y2,
                        16 * mby)
                elif name == "dmv":  # each field from its own parity, then the other
                    for j, (x, y) in enumerate(own):
                        add(j >= 2, refs[0], (j & 1) ^ (j >> 1), 8, mbx, 8 * mby, x, y,
                            16 * mby + (j & 1))
                elif field_pic and name == "field":
                    sel, x, y = own[0]
                    add(avg, field_ref(d, sel), sel, 16, mbx, 16 * mby, x, y, 16 * mby)
                elif field_pic:  # 16x8
                    for i, (sel, x, y) in enumerate(own):
                        add(avg, field_ref(d, sel), sel, 8, mbx, 16 * mby + 8 * i, x, y,
                            16 * mby + 8 * i)
                else:  # a frame picture's field prediction: field j from field sel
                    for j, (sel, x, y) in enumerate(own):
                        add(avg, refs[d], sel, 8, mbx, 8 * mby, x, y, 16 * mby + j)
        v_edge = 8 * mbh  # in field lines (a frame's: 16 * mbh)
        for avg_pass in (False, True):
            for (avg, _, sel, h), (ref, chunks, rows) in jobs.items():
                if avg != avg_pass:
                    continue
                if rows:
                    chunks = chunks + [np.array(rows, np.int64)]
                mbx, src, x, y, dest = np.concatenate(chunks).T
                if sel < 0:
                    luma, cb, cr = _motion(ref.planes(), mbx, src, x, y, 16 * mbw, 16 * mbh, 16,
                                           where)
                    step = 1
                else:
                    luma, cb, cr = _motion(tuple(a[sel::2] for a in ref.planes()), mbx, src, x,
                                           y, 16 * mbw, v_edge, h, where)
                    step = 1 if field_pic else 2
                cdest = dest // 2 if step == 1 else 8 * (dest // 16) + (dest & 1)
                for plane, block, row0 in ((planes[0], luma, dest), (planes[1], cb, cdest),
                                           (planes[2], cr, cdest)):
                    _write(plane, row0, block.shape[2] * mbx, step, block, avg)


def _write(plane: np.ndarray, row0, col0, step: int, block: np.ndarray, avg: bool) -> None:
    """``block`` [N, h, w] to the rows ``row0 + step * r`` and columns
    ``col0 + c`` of ``plane``: put, or averaged onto what is there
    (``avg_pixels``: (p + q + 1) >> 1)."""
    n, h, w = block.shape
    if step == 1 and h == w and plane.flags.c_contiguous and not (row0 % h).any():
        # whole macroblocks of a frame: through a view of the plane's blocks
        view = plane.reshape(plane.shape[0] // h, h, plane.shape[1] // w, w).transpose(0, 2, 1, 3)
        at = (row0 // h, col0 // w)
        if avg:
            block = (view[at].astype(np.int16) + block + 1) >> 1
        view[at] = block
        return
    rows = (row0[:, None] + step * np.arange(h))[:, :, None]
    cols = (col0[:, None] + np.arange(w))[:, None, :]
    if avg:
        block = (plane[rows, cols].astype(np.int16) + block + 1) >> 1
    plane[rows, cols] = block


def _grey(mbw: int, mbh: int) -> Frame:
    """FFmpeg's dummy forward reference of a closed GOP's leading B-pictures."""
    return Frame(np.full((mbh * 16, mbw * 16), 128, np.uint8),
                 np.full((mbh * 8, mbw * 8), 128, np.uint8),
                 np.full((mbh * 8, mbw * 8), 128, np.uint8), I_TYPE)


def _by_plane(ids) -> list[np.ndarray]:
    """The indices of the blocks ``ids`` (macroblock, block) in Y, Cb, Cr."""
    n = np.array([b for _, b in ids])
    return [np.flatnonzero(n < 4), np.flatnonzero(n == 4), np.flatnonzero(n == 5)]


def _block_places(ids, mbw: int, dct) -> list:
    """Per plane, (its index, (rows, columns)): each block's 8x8 sample
    indices in that plane, in ``_by_plane``'s order; a field-DCT
    macroblock's luma blocks 0-1 on its top field's rows, 2-3 on its
    bottom's (chroma stays frame-coded in 4:2:0)."""
    mb = np.array([m for m, _ in ids])
    n = np.array([b for _, b in ids])
    field = np.array(dct)[mb]
    mby, mbx = np.divmod(mb, mbw)
    k = np.arange(8)
    out = []
    for plane, sel in enumerate(_by_plane(ids)):
        if plane == 0:
            half = n[sel] >> 1
            top = 16 * mby[sel] + np.where(field[sel], half, 8 * half)
            step = 1 + field[sel]
            left = 16 * mbx[sel] + 8 * (n[sel] & 1)
        else:
            top, step, left = 8 * mby[sel], np.ones(len(sel), np.int64), 8 * mbx[sel]
        rows = (top[:, None] + step[:, None] * k)[:, :, None]
        out.append((plane, (rows, (left[:, None] + k)[:, None, :])))
    return out


def _place(planes, places, px: np.ndarray) -> None:
    """Write ``px`` (blocks in ``_by_plane``'s order) to their places."""
    at = 0
    for plane, (rows, cols) in places:
        n = len(rows)
        planes[plane][rows, cols] = px[at:at + n]
        at += n


def _motion(ref, mbx, top, mx, my, h_edge: int, v_edge: int, h: int, where: str):
    """``mpeg_motion_internal``: luma (16 x ``h``) and chroma (8 x ``h`` / 2)
    predictions of the macroblock columns ``mbx`` from the rows ``top`` (+
    the vectors' whole part) of ``ref``'s planes (a frame, or one field's
    rows) by half-pel vectors (mx, my); chroma vectors as FFmpeg derives them
    for 4:2:0 (the luma vector halved towards zero)."""
    src_x = 16 * mbx + (mx >> 1)
    src_y = top + (my >> 1)
    bad = ((src_x < 0) | (src_x > h_edge - (mx & 1) - 16)
           | (src_y < 0) | (src_y > v_edge - (my & 1) - h))
    if bad.any():
        k = int(np.argmax(bad))
        raise refuse(where, f"a motion vector ({int(mx[k])}, {int(my[k])}) past the reference's "
                     f"edge at macroblock column {int(mbx[k])}, row {int(top[k])}, which FFmpeg "
                     "leaves unpredicted")
    luma = _halfpel(ref[0], src_x, src_y, mx & 1, my & 1, 16, h, where)
    cmx = np.where(mx < 0, -(-mx // 2), mx // 2)  # C division: towards zero
    cmy = np.where(my < 0, -(-my // 2), my // 2)
    cx = 8 * mbx + (cmx >> 1)
    cy = top // 2 + (cmy >> 1)
    cb = _halfpel(ref[1], cx, cy, cmx & 1, cmy & 1, 8, h // 2, where)
    cr = _halfpel(ref[2], cx, cy, cmx & 1, cmy & 1, 8, h // 2, where)
    return luma, cb, cr


def _halfpel(plane: np.ndarray, sx, sy, hx, hy, w: int, h: int, where: str) -> np.ndarray:
    """``put_pixels`` of ``w`` x ``h`` blocks at (sx, sy) + (hx, hy) / 2."""
    ph, pw = plane.shape
    if (sx < 0).any() or (sy < 0).any() or (sx + w + hx > pw).any() or (
            sy + h + hy > ph).any():
        raise refuse(where, "a chroma prediction past the reference's edge")
    rows = np.minimum(sy[:, None] + np.arange(h + 1), ph - 1)
    cols = np.minimum(sx[:, None] + np.arange(w + 1), pw - 1)
    p = plane[rows[:, :, None], cols[:, None, :]].astype(np.int16)  # [N, h+1, w+1]
    out = np.empty((len(sx), h, w), np.int16)
    kind = hx + 2 * hy
    for dxy in range(4):  # each half-pel position's rounding, on its blocks alone
        sel = np.flatnonzero(kind == dxy)
        if not len(sel):
            continue
        q = p[sel]
        a = q[:, :h, :w]
        if dxy == 0:
            out[sel] = a
        elif dxy == 1:
            out[sel] = (a + q[:, :h, 1:] + 1) >> 1
        elif dxy == 2:
            out[sel] = (a + q[:, 1:, :w] + 1) >> 1
        else:
            out[sel] = (a + q[:, :h, 1:] + q[:, 1:, :w] + q[:, 1:, 1:] + 2) >> 2
    return out
