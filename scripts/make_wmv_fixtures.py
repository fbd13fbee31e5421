#!/usr/bin/env python3
"""Write the fixtures of the port's ASF and MS-MPEG-4 path
(``v2e2v_tpu_torch/utils/asf.py``, ``msmpeg4.py``, ``wmv2.py`` and the
family's tags in ``avi.py``, ``mkv.py`` and ``mp4.py``) and what the JAX
package's readers return for each.

    JAX_PLATFORMS=cpu python scripts/make_wmv_fixtures.py [--out tests/data/wmv] [--seed 0]

It needs cv2 built with FFmpeg and the JAX package, so it runs where the JAX
package's dependencies are installed, not on the card's machine; the card
checks the port against the records this writes. The clips:

- by ``cv2.VideoWriter`` (10 fps unless named otherwise): ``flagship.wmv``,
  12 frames of WMV2 at 960x720 panning 3 rows and -7 columns a frame;
  each codec in each container cv2 writes it into: ``.wmv`` (WMV1, WMV2,
  MP42, MP43, and FMP4, FLV1 and MJPG), AVI (MP42, DIV2, MP43, DIV3, MPG3,
  DIV4, DIV5, DVX3, COL1, AP41, WMV1, WMV2), Matroska (WMV1, WMV2, MP42,
  MP43) and MOV (WMV1, WMV2, MP42, DIV2, and MP43, which cv2 writes as
  ``3IVD``); 14-frame clips with a second I-picture at frame 12
  (``gop_*``); noise, flat and fading content (``fade_mp43.avi``: v3's
  run/level table 0), 8x8, a portrait clip and 4CIF; WMV1 at 96x64
  and 2 fps (``lowrate_wmv1.avi``: ``inter_intra_pred`` on) against 176x144
  (off); the rate and count sweep ``r*.wmv`` (cv2's ASF rate is FFmpeg's
  guess from millisecond stamps);
- rewritten here: ``odd_*``, cv2's 130x96 clips whose container says
  129x95 (the same macroblock grid), which send swscale to its general
  scaler; ``noflip_mp43.avi``, v3's ``flipflop_rounding`` cleared in every
  I-picture's extension header;
- re-coded here from cv2's streams by ``recode``, symbol by symbol, values
  kept (each decodes in FFmpeg without concealment): v3 and WMV1 under DC
  table 0 and motion vector table 0 and with per-macroblock run/level
  tables (``tables_*``); pictures cut into slices (``slices_*``: WMV1's
  of 2 macroblock rows, and v3's of 2 and v2's of 1 on smooth content,
  their DC differentials predicted again); WMV2 under every non-intra table
  (the quantiser rewritten past 10 and 20, the third escape's lengths
  re-coded), with per-macroblock run/level tables, the skip map's four
  types, a P-picture that skips every macroblock (no frame), the hybrid
  vector predictor's bit (``top_left_mv_flag``) and ``mspel`` with
  ``hshift`` bits (``wmv2_*``); ASF files written here with single and
  multiple payloads, every length type and padding (``asf_*``).

``timing/mp43_960x720.avi`` (6 frames of MS-MPEG-4 v3 at 960x720) is no
record: ``chip_smoke.py`` times its stages.

``manifest.json`` holds cv2's version and, for each clip, its codec, fps and
frame count as cv2 reports them, the sha256 of each cv2 BGR frame (one
decoding thread) and of its ``cvtColor`` gray, of each JAX ``VideoReader``
frame (``ds = (0.25, 0.25)``) and of each JAX ``VideoSequence`` frame;
``reader_frames.npz`` the JAX ``VideoReader``'s frames of each clip.

The writers (``write_asf``, ``recode`` and its cases, ``patch_size``) need
no cv2: the tests craft their streams with them.
"""

from __future__ import annotations

import argparse
import shutil
import struct
import sys
import uuid
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from make_h263_fixtures import BitWriter  # noqa: E402

from v2e2v_tpu_torch.utils import asf, msmpeg4, wmv2  # noqa: E402
from v2e2v_tpu_torch.utils import msmpeg4tables as T  # noqa: E402
from v2e2v_tpu_torch.utils.avi import AviFile  # noqa: E402
from v2e2v_tpu_torch.utils.mpeg4 import Bits  # noqa: E402

FLAGSHIP = (720, 960, 12, 10.0)  # height, width, frames, fps
SIZE = (64, 96)  # the small clips' height, width
WMV_TAGS = {"wmv1.wmv": "WMV1", "wmv2.wmv": "WMV2", "mp42.wmv": "MP42", "mp43.wmv": "MP43",
            "fmp4.wmv": "FMP4", "flv1.wmv": "FLV1", "mjpg.wmv": "MJPG"}
AVI_TAGS = ("MP42", "DIV2", "MP43", "DIV3", "MPG3", "DIV4", "DIV5", "DVX3", "COL1", "AP41", "WMV1",
            "WMV2")
MKV_TAGS = ("WMV1", "WMV2", "MP42", "MP43")
MOV_TAGS = ("WMV1", "WMV2", "MP42", "DIV2", "MP43")
# rate sweep: name -> (fps, frames); 30 -> 359/12 at 6 frames, 29.97 -> 30000/1001 at 17
RATES = {"r30_6.wmv": (30.0, 6), "r2997_17.wmv": (30000 / 1001, 17), "r25_9.wmv": (25.0, 9),
         "r24_5.wmv": (24.0, 5), "r15_5.wmv": (15.0, 5), "r60_17.wmv": (60.0, 17),
         "r12_5_3.wmv": (12.5, 3), "r7_5_3.wmv": (7.5, 3), "r1_2.wmv": (1.0, 2),
         "r100_45.wmv": (100.0, 45)}
CODECS = {"WMV1": "wmv1", "WMV2": "wmv2", "MP42": "msmpeg4v2", "DIV2": "msmpeg4v2",
          "FMP4": "mpeg4", "FLV1": "flv", "MJPG": "mjpeg"}


def codec_of_tag(tag: str) -> str:
    return CODECS.get(tag, "msmpeg4v3")


# ------------------------------------------------------------------- ASF

def _guid(s: str) -> bytes:
    return uuid.UUID(s).bytes_le


def _obj(guid: str, body: bytes) -> bytes:
    return _guid(guid) + struct.pack("<Q", 24 + len(body)) + body


def _two(kind: int, value: int) -> bytes:
    return b"" if not kind else value.to_bytes((0, 1, 2, 4)[kind], "little")


def write_asf(path: Path, packets: list[bytes], stamps: list[int], width: int, height: int,
              fourcc: bytes, extradata: bytes = b"", packet_size: int = 3200,
              multiple: bool = True, types: tuple[int, int, int] = (1, 3, 1),
              length_type: int = 0, pad_type: int = 2, preroll: int = 3100,
              per_packet: int = 6) -> None:
    """An ASF of one video stream: each of ``packets`` a media object of
    presentation time ``stamps[i] + preroll`` ms, cut into payloads that
    fill packets of ``packet_size`` bytes (``multiple``: up to
    ``per_packet`` payloads a packet, 16-bit payload lengths; else one
    payload a packet), ``types`` the length types of the media object
    number, offset and replicated data (1 byte, 2, 4), ``length_type`` and
    ``pad_type`` those of the packet length and the padding length (0: none,
    the packet then fills by its last payload's length); the File
    Properties' play duration the last stamp plus a frame."""
    t_num, t_off, t_rep = types
    flags = (multiple and 1) | (pad_type << 3) | (length_type << 5)
    prop = t_rep | (t_off << 2) | (t_num << 4) | (1 << 6)
    out_packets = []
    pieces = []  # (object number, offset, total, stamp, bytes)
    for k, (data, ts) in enumerate(zip(packets, stamps)):
        pieces.append([k, 0, len(data), ts + preroll, data])
    head = 3 + 2 + len(_two(length_type, 0)) + len(_two(pad_type, 0)) + 6 + (1 if multiple else 0)
    per = 1 + (0, 1, 2, 4)[t_num] + (0, 1, 2, 4)[t_off] + (0, 1, 2, 4)[t_rep] + 8 + \
        (2 if multiple else 0)
    while pieces:
        room, body, n = packet_size - head, b"", 0
        while pieces and room > per and n < (per_packet if multiple else 1):
            num, off, total, ts, data = pieces[0]
            take = min(len(data) - 0, room - per)
            chunk = data[:take]
            body += bytes([0x81 if num == 0 or off else 0x01]) + _two(t_num, num % 256) + \
                _two(t_off, off) + _two(t_rep, 8) + struct.pack("<II", total, ts)
            if multiple:
                body += struct.pack("<H", len(chunk))
            body += chunk
            room -= per + len(chunk)
            n += 1
            if take == len(data):
                pieces.pop(0)
            else:
                pieces[0] = [num, off + take, total, ts, data[take:]]
        pad = packet_size - head - len(body)
        if pad and not pad_type:
            raise ValueError("padding needs a padding length type")
        send = pieces[0][3] - preroll if pieces else 0
        hdr = b"\x82\x00\x00" + bytes([flags, prop]) + _two(length_type, packet_size) + \
            _two(pad_type, pad) + struct.pack("<IH", max(send, 0), 0)
        if multiple:
            hdr += bytes([0x80 | n])
        out_packets.append(hdr + body + bytes(pad))
    data_obj = (_guid(asf.DATA) + struct.pack("<Q", 50 + sum(map(len, out_packets)))
                + bytes(16) + struct.pack("<Q", len(out_packets)) + b"\x01\x01"
                + b"".join(out_packets))
    bih = struct.pack("<IiiHH4sIiiII", 40 + len(extradata), width, height, 1, 24, fourcc,
                      width * height * 3, 0, 0, 0, 0) + extradata
    specific = struct.pack("<IIBH", width, height, 2, len(bih)) + bih
    stream = _obj(asf.STREAM_PROPERTIES, _guid(asf.VIDEO_MEDIA) + _guid(asf.NO_ERROR_CORRECTION)
                  + struct.pack("<QIIHI", 0, len(specific), 0, 1, 0) + specific)
    frame_ms = stamps[1] - stamps[0] if len(stamps) > 1 else 100
    play = (stamps[-1] + frame_ms + preroll) * 10000
    ext = _obj(asf.HEADER_EXTENSION, bytes(16) + struct.pack("<HI", 6, 0))
    def header_rest(size: int) -> bytes:
        props = struct.pack("<QQQQQQIIII", size, 0, len(out_packets), play,
                            play - preroll * 10000, preroll, 2, packet_size, packet_size, 1000000)
        return _obj(asf.FILE_PROPERTIES, bytes(16) + props) + stream + ext

    body = header_rest(0)
    header_size = 30 + len(body)
    total = header_size + len(data_obj)
    body = header_rest(total)
    header = _guid(asf.HEADER) + struct.pack("<QIBB", header_size, 3, 1, 2) + body
    path.write_bytes(header + data_obj)


def patch_size(data: bytes, width: int, height: int) -> bytes:
    """An AVI's or ASF's stated size (``strf`` / ``avih``, or the Stream
    Properties' and its BITMAPINFOHEADER's) set to ``width`` x ``height``."""
    d = bytearray(data)
    if d[:4] == b"RIFF":
        k = d.find(b"strf")
        struct.pack_into("<ii", d, k + 12, width, height)
        k = d.find(b"avih")
        struct.pack_into("<II", d, k + 8 + 32, width, height)
    else:
        k = d.find(_guid(asf.STREAM_PROPERTIES)) + 24 + 54
        struct.pack_into("<II", d, k, width, height)
        struct.pack_into("<ii", d, k + 11 + 4, width, height)
    return bytes(d)


def _header_objects(data: bytes):
    """(position, size) of each object in an ASF's Header Object."""
    (end,) = struct.unpack("<Q", data[16:24])
    pos = 30
    while pos < end:
        (size,) = struct.unpack("<Q", data[pos + 16:pos + 24])
        yield pos, size
        pos += size


def add_header_object(data: bytes, obj: bytes) -> bytes:
    """An ASF with ``obj`` appended to its Header Object (its size, object
    count and the File Properties' file size kept true)."""
    size, count = struct.unpack("<QI", data[16:28])
    out = bytearray(data[:size] + obj + data[size:])
    struct.pack_into("<QI", out, 16, size + len(obj), count + 1)
    for pos, _ in _header_objects(bytes(out)):
        if out[pos:pos + 16] == _guid(asf.FILE_PROPERTIES):
            struct.pack_into("<Q", out, pos + 24 + 16, len(out))
    return bytes(out)


def second_video_stream(data: bytes) -> bytes:
    """An ASF whose video Stream Properties object is repeated as stream 2."""
    for pos, size in _header_objects(data):
        if data[pos:pos + 16] == _guid(asf.STREAM_PROPERTIES):
            obj = bytearray(data[pos:pos + size])
            struct.pack_into("<H", obj, 24 + 48, 2)
            return add_header_object(data, bytes(obj))
    raise ValueError("no Stream Properties object")


# ------------------------------------------------------------- re-coding

def _vlc_codes(pairs) -> dict:
    return {k: (int(c), int(n)) for k, (c, n) in enumerate(np.asarray(pairs).reshape(-1, 2))}


DC_CODES = [[_vlc_codes(T.DC[t][c]) for c in (0, 1)] for t in (0, 1)]
MB_NON_INTRA = [_vlc_codes(T.MB_NON_INTRA[t]) for t in range(4)]
MV_CODES = []
for lens, syms in ((T.MV0_LENS, T.MV0_SYMS), (T.MV1_LENS, T.MV1_SYMS)):
    codes = msmpeg4.from_lengths(lens)
    MV_CODES.append({int(s): c for s, c in zip(syms, codes)})


def put_dc(w: BitWriter, diff: int, table: int, chroma: int) -> None:
    """A v3 / WMV DC differential under DC table ``table``."""
    mag = abs(diff)
    codes = DC_CODES[table][chroma]
    if mag >= msmpeg4.DC_MAX:
        w.put(*codes[msmpeg4.DC_MAX])
        w.put(mag, 8)
        w.put(int(diff < 0), 1)
    else:
        w.put(*codes[mag])
        if mag:
            w.put(int(diff < 0), 1)


def put_mv(w: BitWriter, sx: int, sy: int, table: int) -> None:
    """A v3 / WMV vector symbol (offset by 32) under table ``table``, or its
    escape."""
    code = MV_CODES[table].get(sx << 8 | sy) if (sx, sy) != (0, 0) else None
    if code is None:
        w.put(*MV_CODES[table][0])
        w.put(sx, 6)
        w.put(sy, 6)
    else:
        w.put(*code)


def put012(w: BitWriter, v: int) -> None:
    w.put(*((0, 1), (2, 2), (3, 2))[v])


class Record:
    """A picture parsed with each syntax element's bit span kept: the
    header's end, then per macroblock (kind, start, end) and the spans
    and values of its type code, DC symbols, vector and third escapes."""

    def __init__(self):
        self.mbs: list[dict] = []
        self.escapes: list[tuple] = []


def parse_recorded(dec: msmpeg4.MsMpeg4Decoder, packet: bytes):
    """``dec`` parses and reconstructs ``packet`` while a ``Record`` keeps
    each element's span. Returns (record, planes or None)."""
    rec = Record()
    cls = type(dec.picture(Bits(b"\0"), msmpeg4.Header()))

    class Recorder(cls):
        def parse(self):
            rec.header_end = self.bits.pos
            rec.pic = self
            super().parse()
            rec.end = self.bits.pos

        def macroblock(self, mbx, mby, first_row):
            mb = {"start": self.bits.pos, "dc": [], "esc": [], "x": mbx, "y": mby}
            rec.mbs.append(mb)
            self._mb = mb
            super().macroblock(mbx, mby, first_row)
            mb["end"] = self.bits.pos
            k = mby * self.mbw + mbx
            mb["kind"], mb["mv"] = self.kinds[k], self.mv_list[k]

        def _motion(self, px, py):
            start = self.bits.pos
            mv = super()._motion(px, py)
            self._mb["mv_span"] = (start, self.bits.pos)
            self._mb["pred"] = (px, py)
            return mv

        def _dc(self, n, *a):
            start = self.bits.pos
            out = super()._dc(n, *a)
            self._mb["dc"].append((n, start, self.bits.pos, out[0]))
            self._mb["ac_pred"] = self.ac_pred
            return out

        def _predict_cbp(self, code, mbx, mby):
            cbp = super()._predict_cbp(code, mbx, mby)
            self._mb["cbp"] = cbp
            return cbp

        def _escape3(self):
            start = self.bits.pos
            header = not self.esc3_level_length
            last, run, level = super()._escape3()
            self._mb["esc"].append((start, self.bits.pos, header, last, run, level))
            return last, run, level

    orig = dec.picture
    dec.picture = lambda bits, hdr: Recorder(dec, bits, hdr)
    try:
        pic = dec.parse(packet)
        planes = None if pic is None else dec.reconstruct(pic)
    finally:
        dec.picture = orig
    return rec, planes


class Copier:
    """Bits of ``data`` copied into a ``BitWriter`` span by span."""

    def __init__(self, data: bytes):
        self.bits, self.w, self.pos = Bits(data), BitWriter(), 0

    def copy_to(self, end: int) -> None:
        while self.pos < end:
            n = min(16, end - self.pos)
            self.bits.pos = self.pos
            self.w.put(self.bits.read(n), n)
            self.pos += n

    def skip_to(self, end: int) -> None:
        self.pos = end


def _dc_diff(data: bytes, start: int, table: int, chroma: int) -> int:
    b = Bits(data, start)
    sym = msmpeg4.tables()["dc"][table][chroma].read(b, "", "DC")
    if sym == msmpeg4.DC_MAX:
        mag = b.read(8)
        return -mag if b.read(1) else mag
    return -sym if sym and b.read(1) else sym


def _mv_sym(data: bytes, start: int, table: int) -> tuple[int, int]:
    b = Bits(data, start)
    sym = msmpeg4.tables()["mv"][table].read(b, "", "vector")
    return (b.read(6), b.read(6)) if sym is None else sym


def recode_msmpeg4(packets: list[bytes], codec: str, width: int, height: int, dc_table=None,
                   mv_table=None, per_mb_rl: bool = False, slices: int | None = None) -> list:
    """v2, v3 or WMV1 pictures re-coded with values kept: every DC
    differential under ``dc_table`` (v3, WMV1), every vector under
    ``mv_table`` (v3, WMV1), ``per_mb_rl`` (WMV1 above 50 kbit/s: the
    run/level table index sent in every macroblock with coded blocks instead
    of the header), and ``slices``: the pictures cut into slices of that
    many macroblock rows, the vectors (and for v2 and v3, whose slices reset
    the DC and AC predictors above them, the DC differentials, by
    ``DcModel``) predicted again. An intra macroblock in a slice's first row
    with ``ac_pred`` would need its coefficients sent again: ValueError."""
    dec = msmpeg4.MsMpeg4Decoder(codec, width, height)
    version = dec.version
    out = []
    for packet in packets:
        rec, _ = parse_recorded(dec, packet)
        pic = rec.pic
        kind = pic.hdr.kind
        cp = Copier(packet)
        w = cp.w
        # the header, field by field
        w.put(kind, 2)
        w.put(pic.hdr.quant, 5)
        rl, rlc = dec.rl_table_index, dec.rl_chroma_table_index
        per_mb = per_mb_rl and rl == rlc  # one index a macroblock: luma's and chroma's
        dct = dec.dc_table_index if dc_table is None else dc_table
        mvt = dec.mv_table_index if mv_table is None else mv_table
        if kind == 0:
            w.put(0x17 if not slices else 0x16 + dec.mbh // slices, 5)
            if version == msmpeg4.V3:
                put012(w, rlc)
                put012(w, rl)
            elif version == msmpeg4.WMV1:
                bb = Bits(packet, 12)
                w.put(bb.read(17), 17)  # the extension header as it was
                if dec.bit_rate > msmpeg4.MBAC_BITRATE:
                    w.put(int(per_mb), 1)
                if not per_mb:
                    put012(w, rlc)
                    put012(w, rl)
            if version > msmpeg4.V2:
                w.put(dct, 1)
        else:
            w.put(dec.use_skip_mb_code, 1)
            if version == msmpeg4.V3:
                put012(w, rl)
            elif version == msmpeg4.WMV1:
                if dec.bit_rate > msmpeg4.MBAC_BITRATE:
                    w.put(int(per_mb), 1)
                if not per_mb:
                    put012(w, rl)
            if version > msmpeg4.V2:
                w.put(dct, 1)
                w.put(mvt, 1)
        cp.skip_to(rec.header_end)
        old_dc = dec.dc_table_index
        mvs = {}
        mbw = dec.mbw
        height_ = dec.slice_height if slices else None
        model = DcModel(dec, pic.qscale) if slices and version < msmpeg4.WMV1 else None
        for mb in rec.mbs:
            cp.copy_to(mb["start"])
            x, y = mb["x"], mb["y"]
            k = y * mbw + x
            mvs[k] = mb["mv"] if mb["kind"] == msmpeg4.INTER else (0, 0)
            if model:
                model.macroblock(x, y, mb["kind"] == msmpeg4.INTRA)
                if mb["kind"] == msmpeg4.INTRA and y % height_ == 0 and y and mb["ac_pred"]:
                    raise ValueError(f"ac_pred in macroblock ({x}, {y}), a slice's first row")
            if mb["end"] - mb["start"] == 1 and kind == 1 and mb["kind"] == msmpeg4.SKIP:
                cp.copy_to(mb["end"])
                continue
            if per_mb:
                cbp = _mb_cbp(packet, mb, kind, dec)
                type_end = mb["type_end"]
                cp.copy_to(type_end)
                if mb["kind"] == msmpeg4.INTRA:
                    cp.copy_to(type_end + 1)  # ac_pred
                if cbp:
                    put012(w, rl)
            for n, s, e, level in mb["dc"]:
                cp.copy_to(s)
                if model:
                    diff = level - model.predict(n, x, y, level)
                elif version == msmpeg4.V2:
                    diff = None
                else:
                    diff = _dc_diff(packet, s, old_dc, int(n >= 4))
                if diff is None:
                    cp.copy_to(e)
                    continue
                if version == msmpeg4.V2:
                    put_v2_dc(w, diff, int(n >= 4))
                else:
                    put_dc(w, diff, dct, int(n >= 4))
                cp.skip_to(e)
            if "mv_span" in mb:
                s, e = mb["mv_span"]
                cp.copy_to(s)
                mx, my = mb["mv"]
                px, py = _slice_pred(mvs, x, y, mbw, height_) if slices else mb["pred"]
                if version == msmpeg4.V2:
                    put_v2_mv(w, mx, px)
                    put_v2_mv(w, my, py)
                else:
                    put_mv(w, (mx - px + 32) % 64, (my - py + 32) % 64, mvt)
                cp.skip_to(e)
            cp.copy_to(mb["end"])
        cp.copy_to(rec.end)
        out.append(w.bytes())
    return out


class DcModel:
    """The DC predictors of v2 and v3 (``ff_msmpeg4_pred_dc`` with the
    resets of ``ff_mpeg4_clean_buffers`` at each slice), kept apart from
    ``msmpeg4.py``'s: what a re-sliced picture predicts."""

    def __init__(self, dec, quant: int):
        self.dec, self.q = dec, quant
        self.mbw, self.mbh = dec.mbw, dec.mbh
        self.luma = np.full((2 * self.mbh + 1, 2 * self.mbw + 2), 1024, np.int64)
        self.chroma = np.full((2, self.mbh + 1, self.mbw + 2), 1024, np.int64)

    def macroblock(self, x: int, y: int, intra: bool) -> None:
        if x == 0 and y and y % self.dec.slice_height == 0:
            self.luma[2 * y] = 1024  # the row above (with this row's border)
            self.chroma[:, y] = 1024
        if not intra:
            self.luma[2 * y + 1:2 * y + 3, 2 * x + 1:2 * x + 3] = 1024
            self.chroma[:, y + 1, x + 1] = 1024

    def predict(self, n: int, x: int, y: int, level: int) -> int:
        """Block ``n``'s predicted DC level; ``level``, its level, stored."""
        if n < 4:
            grid, r, c = self.luma, 2 * y + 1 + (n >> 1), 2 * x + 1 + (n & 1)
            scale = self.dec.y_dc[self.q]
        else:
            grid, r, c = self.chroma[n - 4], y + 1, x + 1
            scale = self.dec.c_dc[self.q]
        a, b, top = grid[r, c - 1], grid[r - 1, c - 1], grid[r - 1, c]
        a, b, top = ((int(v) + (scale >> 1)) * -(-(1 << 32) // scale) >> 32 for v in (a, b, top))
        grid[r, c] = level * scale
        return top if abs(a - b) <= abs(b - top) else a


def put_v2_dc(w: BitWriter, diff: int, chroma: int) -> None:
    """v2's DC differential: H.263's size code with its bits inverted, the
    value, a marker past 8 bits."""
    from v2e2v_tpu_torch.utils.mpeg4 import DC_CHROMA, DC_LUMA

    if not -256 <= diff <= 255:
        raise ValueError(f"a v2 DC differential of {diff}")
    size = abs(diff).bit_length()
    code, n = (DC_CHROMA if chroma else DC_LUMA)[size]
    w.put(code ^ ((1 << n) - 1), n)
    if size:
        w.put(diff if diff > 0 else diff + (1 << size) - 1, size)
        if size > 8:
            w.put(1, 1)


def put_v2_mv(w: BitWriter, value: int, pred: int) -> None:
    """v2's vector component: H.263's MVD (up to +-32) from ``pred``, which
    the decoder wraps into -63..63."""
    from v2e2v_tpu_torch.utils.mpeg4 import MVD

    d = (value - pred + 32) % 64 - 32
    if _wrap(pred + d) != value:
        raise ValueError(f"a v2 vector of {value} past {pred}'s reach")
    w.put(*MVD[abs(d)])
    if d:
        w.put(int(d < 0), 1)


def _wrap(v: int) -> int:
    """A vector component as the decoders wrap it into -63..63."""
    return v + 64 if v <= -64 else v - 64 if v >= 64 else v


def _slice_pred(mvs: dict, x: int, y: int, mbw: int, slices: int) -> tuple[int, int]:
    if y % slices == 0:
        return mvs.get(y * mbw + x - 1, (0, 0)) if x else (0, 0)
    a = mvs.get(y * mbw + x - 1, (0, 0)) if x else (0, 0)
    b = mvs[(y - 1) * mbw + x]
    c = mvs.get((y - 1) * mbw + x + 1, (0, 0)) if x + 1 < mbw else (0, 0)
    return sorted((a[0], b[0], c[0]))[1], sorted((a[1], b[1], c[1]))[1]


def _mb_cbp(packet: bytes, mb: dict, kind: int, dec) -> int:
    """The macroblock's coded block pattern, read again from its type code
    (and notes where the code ends, ``mb["type_end"]``)."""
    b = Bits(packet, mb["start"])
    t = msmpeg4.tables()
    if kind == 1:
        if dec.use_skip_mb_code:
            b.read(1)
        code = t["mb_non_intra"][msmpeg4.DEFAULT_INTER_INDEX].read(b, "", "mb")
        mb["type_end"] = b.pos
        return code & 0x3F
    t["mb_intra"].read(b, "", "mb")
    mb["type_end"] = b.pos
    return mb["cbp"]


def _escape_header(w: BitWriter, quant: int, level_length: int, run_length: int) -> None:
    """WMV1's and WMV2's third escape lengths, as the picture's first
    third escape sends them at ``quant``."""
    if quant < 8:
        if level_length >= 8:
            w.put(0, 3)
            w.put(level_length - 8, 1)
        else:
            w.put(level_length, 3)
    else:
        if not 2 <= level_length <= 8:
            raise ValueError(f"a level length of {level_length} at QP {quant}")
        w.put(1, level_length - 1) if level_length < 8 else w.put(0, 6)
    w.put(run_length - 3, 2)


def recode_wmv2(packets: list[bytes], width: int, height: int, extradata: bytes,
                rng: np.random.Generator, quant=None, cbp_index: int = 0,
                per_mb_rl: bool = False, skip_type: int | None = None,
                skip_all: tuple = (), top_left: bool = False, mspel: bool = False,
                far: bool = False):
    """WMV2 pictures re-coded, values kept unless ``mspel``: the
    quantiser of P-pictures set to ``quant`` and their macroblock types
    under ``cbp_index``'s table (the third escapes' lengths re-sent in the
    new quantiser's form), ``per_mb_rl`` (the run/level index in every
    macroblock with coded blocks), ``skip_type`` (inter MBs without coded
    blocks at vector 0 sent as skipped, in the skip map of that type),
    the P-pictures numbered in ``skip_all`` replaced by a row map skipping
    every macroblock (FFmpeg gives no frame), ``top_left`` (the hybrid
    predictor's bit, a random choice of the left or top vector, the
    vector re-coded against it), ``mspel`` (random ``hshift`` bits after
    odd vectors: the pictures change), ``far`` (every inter macroblock's
    vector replaced by its predictor plus a random difference, wrapped as
    the decoder wraps it: vectors over the whole +-63 half-pels, sources
    past the picture's edges). Returns (extradata, packets)."""
    ext = bytearray(extradata)
    if top_left:
        ext[2] |= 0x08  # top_left_mv_flag: bit 20 of the 4 bytes
    dec = wmv2.Wmv2Decoder(width, height, extradata)
    out = []
    mbw, mbh = dec.mbw, dec.mbh
    t = msmpeg4.tables()
    for index, packet in enumerate(packets):
        rec, _ = parse_recorded(dec, packet)
        pic = rec.pic
        kind = pic.hdr.kind
        cp = Copier(packet)
        w = cp.w
        q_old = pic.hdr.quant
        q = q_old if quant is None or kind == 0 else quant
        w.put(kind, 1)
        if kind == 0:
            w.put(Bits(packet, 1).read(7), 7)
        w.put(q, 5)
        if kind == 1 and index in skip_all:
            w.put(wmv2.SKIP_ROW, 2)
            w.put((1 << mbh) - 1, mbh)
            out.append(w.bytes())
            continue
        rl = dec.rl_table_index
        per_mb = per_mb_rl and rl == dec.rl_chroma_table_index
        skip = [0] * (mbw * mbh)
        if kind == 0:
            w.put(0, 1)  # j_type
            w.put(int(per_mb), 1)
            if not per_mb:
                put012(w, dec.rl_chroma_table_index)
                put012(w, rl)
            w.put(dec.dc_table_index, 1)
        else:
            for mb in rec.mbs:
                k = mb["y"] * mbw + mb["x"]
                cbp = _wmv2_code(packet, mb, dec) & 0x3F if mb["kind"] != 2 else 1
                skip[k] = int(skip_type is not None and mb["kind"] == msmpeg4.INTER and not cbp
                              and mb["mv"] == (0, 0))
            w.put(skip_type or 0, 2)
            if skip_type == wmv2.SKIP_MPEG:
                for f in skip:
                    w.put(f, 1)
            elif skip_type in (wmv2.SKIP_ROW, wmv2.SKIP_COL):
                outer, inner = (mbh, mbw) if skip_type == wmv2.SKIP_ROW else (mbw, mbh)
                for a in range(outer):
                    flags = [skip[a * mbw + b] if skip_type == wmv2.SKIP_ROW else skip[b * mbw + a]
                             for b in range(inner)]
                    if all(flags):
                        w.put(1, 1)
                    else:
                        w.put(0, 1)
                        for f in flags:
                            w.put(f, 1)
            put012(w, cbp_index)
            w.put(int(mspel), 1)
            w.put(1, 1)  # per_mb_abt 0
            put012(w, 0)  # abt_type 8x8
            w.put(int(per_mb), 1)
            if not per_mb:
                put012(w, rl)
            w.put(dec.dc_table_index, 1)
            w.put(dec.mv_table_index, 1)
        cp.skip_to(rec.header_end)
        table = wmv2.CBP_TABLE[(q > 10) + (q > 20)][cbp_index]
        mvs: dict = {}
        first_esc = True
        new_ll = None
        for mb in rec.mbs:
            k = mb["y"] * mbw + mb["x"]
            mvs[k] = mb["mv"] if mb["kind"] == msmpeg4.INTER else (0, 0)
            cp.skip_to(mb["start"])
            if kind == 1 and mb["kind"] == msmpeg4.SKIP:
                continue
            if skip[k]:
                cp.skip_to(mb["end"])
                continue
            if kind == 1:
                code = _wmv2_code(packet, mb, dec)
                w.put(*MB_NON_INTRA[table][code])
                cbp = code & 0x3F
            else:
                _wmv2_code(packet, mb, dec)
                cp.copy_to(mb["type_end"])
                cbp = mb["cbp"]
            cp.skip_to(mb["type_end"])
            if mb["kind"] == msmpeg4.INTRA:
                cp.copy_to(mb["type_end"] + 1)  # ac_pred
                if per_mb and cbp:
                    put012(w, rl)
            else:
                x, y = mb["x"], mb["y"]
                a = mvs.get(k - 1, (0, 0)) if x else (0, 0)
                b = mvs.get(k - mbw, (0, 0)) if y else (0, 0)
                pred = mb["pred"]
                if top_left and x and y and max(abs(a[0] - b[0]), abs(a[1] - b[1])) >= 8:
                    choice = int(rng.integers(0, 2))
                    w.put(choice, 1)
                    pred = b if choice else a
                if per_mb and cbp:
                    put012(w, rl)
                s, e = mb["mv_span"]
                mx, my = mb["mv"]
                if far:  # a random difference: the vectors walk over the whole range
                    pred = _slice_pred(mvs, x, y, mbw, dec.slice_height)
                    mx, my = (_wrap(p + int(d)) for p, d in zip(pred, rng.integers(-32, 32, 2)))
                    mvs[k] = (mx, my)
                put_mv(w, (mx - pred[0] + 32) % 64, (my - pred[1] + 32) % 64, dec.mv_table_index)
                if mspel and (mx | my) & 1:
                    w.put(int(rng.integers(0, 2)), 1)
                cp.skip_to(e)
            for start, end, header, last, run, level in mb["esc"]:
                cp.copy_to(start)
                if (q < 8) == (q_old < 8):
                    cp.copy_to(end)
                    continue
                if first_esc:
                    new_ll = min(max(pic.esc3_level_length, 2), 8)
                    if max(abs(v[5]) for m in rec.mbs for v in m["esc"]) >> new_ll:
                        raise ValueError("a third escape's level past the new length")
                w.put(last, 1)
                if first_esc:
                    _escape_header(w, q, new_ll, pic.esc3_run_length)
                    first_esc = False
                w.put(run, pic.esc3_run_length)
                w.put(int(level < 0), 1)
                w.put(abs(level), new_ll)
                cp.skip_to(end)
            cp.copy_to(mb["end"])
        cp.copy_to(rec.end)
        out.append(w.bytes())
    return bytes(ext), out


def _wmv2_code(packet: bytes, mb: dict, dec) -> int:
    """A WMV2 macroblock's type symbol, read again (``mb["type_end"]``
    noted)."""
    b = Bits(packet, mb["start"])
    t = msmpeg4.tables()
    if mb["kind"] != msmpeg4.INTRA or dec.skip_map is not None:
        code = t["mb_non_intra"][dec.cbp_table_index].read(b, "", "mb")
    else:
        code = t["mb_intra"].read(b, "", "mb")
    mb["type_end"] = b.pos
    return code


def clear_flipflop(packets: list[bytes], width: int, height: int) -> list[bytes]:
    """v3 pictures with ``flipflop_rounding`` cleared in each I-picture's
    extension header (its last bit, after the macroblocks)."""
    from make_h263_fixtures import _set_bits

    dec = msmpeg4.MsMpeg4Decoder("msmpeg4v3", width, height)
    out = []
    for packet in packets:
        rec, _ = parse_recorded(dec, packet)
        data = bytearray(packet)
        if rec.pic.hdr.kind == 0:
            _set_bits(data, 0, rec.end - 1, 1, 0)
        out.append(bytes(data))
    return out


# ----------------------------------------------------------------- clips

def _asf_stamps(n: int, fps: float) -> list[int]:
    return [round(1000 * i / fps) for i in range(n)]


def crafted(out: Path, rng: np.random.Generator, pan, writer) -> None:
    """The re-coded and written clips (see the module's notes)."""
    from make_rawvideo_fixtures import write_avi

    tmp = out / "_src"
    tmp.mkdir()
    h, w = 144, 176
    for tag in ("MP43", "WMV1"):
        src = tmp / f"{tag}.avi"
        writer(src, pan(rng, h, w, 6, (2, -3)), 10.0, tag)
        packets = list(AviFile(str(src)).frames())
        codec = codec_of_tag(tag)
        pics = recode_msmpeg4(packets, codec, w, h, dc_table=0, mv_table=0,
                              per_mb_rl=tag == "WMV1")
        write_avi(out / f"tables_{tag.lower()}.avi", pics, w, h, 10, tag.encode())
        if tag == "WMV1":
            pics = recode_msmpeg4(packets, codec, w, h, slices=2)
            write_avi(out / "slices_wmv1.avi", pics, w, h, 10, tag.encode())
        else:
            write_avi(out / "noflip_mp43.avi", clear_flipflop(packets, w, h), w, h, 10, b"MP43")
    # smooth content, whose intra macroblocks use no AC prediction: v2 and v3
    # re-sliced with their DC differentials predicted again
    yy, xx = np.mgrid[0:136, 0:168]
    smooth = np.stack([(xx * 1.3 + yy * 0.7) % 256, (xx * 0.5 + yy * 1.1 + 60) % 256,
                       (200 - xx * 0.6 + yy * 0.4) % 256], -1)
    smooth = np.stack([smooth[2 * i:2 * i + 96, 3 * i:3 * i + 128] for i in range(5)])
    for tag, rows in (("MP43", 2), ("MP42", 1)):
        writer(tmp / f"smooth_{tag}.avi", smooth.astype(np.uint8), 10.0, tag)
        packets = list(AviFile(str(tmp / f"smooth_{tag}.avi")).frames())
        pics = recode_msmpeg4(packets, codec_of_tag(tag), 128, 96, slices=rows)
        write_avi(out / f"slices_{tag.lower()}.avi", pics, 128, 96, 10, tag.encode())
    src = tmp / "WMV2.avi"
    writer(src, pan(rng, h, w, 6, (2, -3)), 10.0, "WMV2")
    avi = AviFile(str(src))
    packets, ext = list(avi.frames()), avi.extradata
    static = tmp / "WMV2_static.avi"
    frames = pan(rng, h, w, 1, (0, 0)).repeat(6, axis=0).copy()
    frames[3:, 40:80, 60:120] = 255 - frames[3:, 40:80, 60:120]
    writer(static, frames, 10.0, "WMV2")
    still = list(AviFile(str(static)).frames())
    turned = pan(rng, h, w, 6, (2, -3))
    turned[2:, :, :88] = 255 - turned[2:, :, :88]  # third escapes in P-pictures
    writer(tmp / "WMV2_turned.avi", turned, 10.0, "WMV2")
    escapes = list(AviFile(str(tmp / "WMV2_turned.avi")).frames())
    cases = {"wmv2_q12_cbp1.avi": (escapes, dict(quant=12, cbp_index=1)),
             "wmv2_q25_cbp0.avi": (escapes, dict(quant=25, cbp_index=0)),
             "wmv2_q5_cbp2.avi": (escapes, dict(quant=5, cbp_index=2)),
             "wmv2_per_mb_rl.avi": (packets, dict(per_mb_rl=True)),
             "wmv2_top_left.avi": (packets, dict(top_left=True)),
             "wmv2_mspel.avi": (packets, dict(mspel=True)),

             "wmv2_skip_mpeg.avi": (still, dict(skip_type=wmv2.SKIP_MPEG)),
             "wmv2_skip_row.avi": (still, dict(skip_type=wmv2.SKIP_ROW)),
             "wmv2_skip_col.avi": (still, dict(skip_type=wmv2.SKIP_COL, skip_all=(2,)))}
    for name, (src_packets, kw) in cases.items():
        new_ext, pics = recode_wmv2(src_packets, w, h, ext, rng, **kw)
        write_avi(out / name, pics, w, h, 10, b"WMV2", extradata=new_ext)
    # vectors past a picture whose size is no multiple of 16, where FFmpeg's
    # clipping of mspel sources to the picture (not the macroblock grid) shows
    writer(tmp / "WMV2_130x90.avi", pan(rng, 90, 130, 6, (2, -3)), 10.0, "WMV2")
    odd = AviFile(str(tmp / "WMV2_130x90.avi"))
    new_ext, pics = recode_wmv2(list(odd.frames()), 130, 90, odd.extradata, rng, mspel=True,
                                far=True)
    write_avi(out / "wmv2_mspel_far.avi", pics, 130, 90, 10, b"WMV2", extradata=new_ext)
    # ASF written here: single and multiple payloads, length types, padding
    fx = pan(rng, 48, 64, 5, (1, 2))
    writer(tmp / "src.wmv", fx, 10.0, "WMV2")
    a = asf.AsfFile(str(tmp / "src.wmv"))
    stamps = _asf_stamps(len(a.packets), 10.0)
    write_asf(out / "asf_single.wmv", a.packets, stamps, 64, 48, b"WMV2", a.extradata,
              packet_size=256, multiple=False, types=(2, 3, 2), length_type=2, pad_type=2)
    write_asf(out / "asf_multi.wmv", a.packets, stamps, 64, 48, b"WMV2", a.extradata,
              packet_size=512, types=(1, 2, 3), length_type=3, pad_type=3, per_packet=3)
    write_asf(out / "asf_fragments.wmv", a.packets, stamps, 64, 48, b"WMV2", a.extradata,
              packet_size=100, types=(1, 2, 1), pad_type=1, preroll=0)
    shutil.rmtree(tmp)


def clips(out: Path, rng: np.random.Generator) -> dict[str, str]:
    """Every clip; the value is its codec."""
    from make_mpeg4_fixtures import pan
    from make_rawvideo_fixtures import writer

    fh, fw, n, fps = FLAGSHIP
    codecs = {"flagship.wmv": "wmv2"}
    writer(out / "flagship.wmv", pan(rng, fh, fw, n, (3, -7)), fps, "WMV2")
    h, w = SIZE
    for name, tag in WMV_TAGS.items():
        writer(out / name, pan(rng, h, w, 4, (1, -2)), 10.0, tag)
        codecs[name] = codec_of_tag(tag)
    for tag in AVI_TAGS:
        name = f"{tag.lower()}.avi"
        writer(out / name, pan(rng, h, w, 3, (2, -1)), 10.0, tag)
        codecs[name] = codec_of_tag(tag)
    for tag in MKV_TAGS:
        name = f"{tag.lower()}.mkv"
        writer(out / name, pan(rng, h, w, 3, (-1, 1)), 10.0, tag)
        codecs[name] = codec_of_tag(tag)
    for tag in MOV_TAGS:
        name = f"{tag.lower()}.mov"
        writer(out / name, pan(rng, h, w, 3, (1, 1)), 10.0, tag)
        codecs[name] = codec_of_tag(tag)
    for tag, name in (("WMV2", "gop_wmv2.wmv"), ("MP43", "gop_mp43.avi"), ("WMV1", "gop_wmv1.mkv"),
                      ("MP42", "gop_mp42.wmv")):
        writer(out / name, pan(rng, 48, 64, 14, (1, 1)), 10.0, tag)
        codecs[name] = codec_of_tag(tag)
    for tag in ("WMV2", "MP43", "WMV1", "MP42"):
        name = f"noise_{tag.lower()}.wmv"
        writer(out / name, rng.integers(0, 256, (2, 32, 48, 3), np.uint8), 10.0, tag)
        codecs[name] = codec_of_tag(tag)
    for tag in ("WMV2", "MP42"):
        name = f"flat_{tag.lower()}.avi"
        writer(out / name, np.full((3, h, w, 3), (40, 90, 200), np.uint8), 10.0, tag)
        codecs[name] = codec_of_tag(tag)
    fading = np.stack([np.full((144, 176, 3), 40 + 7 * i, np.uint8) for i in range(5)])
    writer(out / "fade_mp43.avi", fading, 10.0, "MP43")  # v3's run/level table 0
    writer(out / "tiny_mp43.avi", pan(rng, 8, 8, 4, (1, 1)), 10.0, "MP43")
    codecs.update({"fade_mp43.avi": "msmpeg4v3", "tiny_mp43.avi": "msmpeg4v3"})
    writer(out / "portrait_wmv1.wmv", pan(rng, w, h, 3, (2, 1)), 10.0, "WMV1")
    writer(out / "cif4_wmv2.wmv", pan(rng, 576, 704, 2, (1, 2)), 10.0, "WMV2")
    lowrate = pan(rng, 64, 96, 6, (1, 2))
    lowrate[3:, 16:48, 32:80] = 255 - lowrate[3:, 16:48, 32:80]  # intra MBs in P-pictures
    writer(out / "lowrate_wmv1.avi", lowrate, 2.0, "WMV1")
    writer(out / "qcif_wmv1.avi", pan(rng, 144, 176, 4, (2, 2)), 10.0, "WMV1")
    codecs.update({"portrait_wmv1.wmv": "wmv1", "cif4_wmv2.wmv": "wmv2",
                   "lowrate_wmv1.avi": "wmv1", "qcif_wmv1.avi": "wmv1"})
    for name, (rate, frames) in RATES.items():
        tag = "MP43" if name.startswith("r2") else "WMV2"
        writer(out / name, pan(rng, 32, 32, frames, (1, -1)), rate, tag)
        codecs[name] = codec_of_tag(tag)
    for tag in ("WMV1", "WMV2", "MP42", "MP43"):
        for ext, (ow, oh) in (("avi", (129, 95)), ("wmv", (129, 95))):
            name = f"odd_{tag.lower()}.{ext}"
            writer(out / name, pan(rng, 96, 130, 3, (1, 2)), 10.0, tag)
            (out / name).write_bytes(patch_size((out / name).read_bytes(), ow, oh))
            codecs[name] = codec_of_tag(tag)
    crafted(out, rng, pan, writer)
    for p in sorted(out.iterdir()):
        if p.name not in codecs:
            codecs[p.name] = "wmv2" if "wmv2" in p.name or p.name.startswith("asf") else \
                "wmv1" if "wmv1" in p.name else "msmpeg4v2" if "mp42" in p.name else "msmpeg4v3"
    return dict(sorted(codecs.items()))


def main() -> None:
    from make_rawvideo_fixtures import records

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=ROOT / "tests" / "data" / "wmv")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.out.exists():
        shutil.rmtree(args.out)
    args.out.mkdir(parents=True)
    rng = np.random.default_rng(args.seed)
    records(args.out, clips(args.out, rng), args.seed, "scripts/make_wmv_fixtures.py")
    timing(args.out / "timing", rng)


def timing(folder: Path, rng: np.random.Generator) -> None:
    """``timing/mp43_960x720.avi``: 6 frames of MS-MPEG-4 v3 at the
    flagship's size, for ``chip_smoke.py``'s stage times (not a record)."""
    from make_mpeg4_fixtures import pan
    from make_rawvideo_fixtures import writer

    folder.mkdir()
    fh, fw, _, fps = FLAGSHIP
    writer(folder / "mp43_960x720.avi", pan(rng, fh, fw, 6, (3, -7)), fps, "MP43")


if __name__ == "__main__":
    main()
