"""The port's H.263 and Sorenson H.263 decoder (``v2e2v_tpu_torch/utils/h263.py``
behind ``utils/video.VideoFile``, ``data/video_readers.VideoReader`` and
``data/manifests.VideoSequence``) against cv2 and the JAX package's readers,
on the fixtures of ``tests/data/h263`` (``scripts/make_h263_fixtures.py``)
and on streams crafted here with that script's writers:

- every clip through ``VideoFile`` and both readers equals the records
  (cv2's fps, count, BGR and gray frames; the JAX readers' frames, stamps
  and hashes); this needs no cv2, so it runs on the card's machine too;
- the records are what cv2 and the JAX readers return;
- picture headers (every source format, Sorenson's size codes and picture
  types) and GOB headers (the slices they open at 1, 2 and 4 macroblock
  rows a GOB) as the decoder reads them, the pictures against cv2;
- each escape form (H.263's 8-bit level and its -128 extension, Sorenson's
  7- and 11-bit levels) read as the level written, against cv2;
- random streams (GOBs, stuffing, DQUANT, intra MBs in P pictures, vectors
  over the whole range, disposable pictures, odd sizes) against cv2;
- every refusal names what the stream is and ROADMAP item 4.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from v2e2v_tpu_torch.data.manifests import VideoSequence
from v2e2v_tpu_torch.data.video_readers import VideoReader
from v2e2v_tpu_torch.utils import mpeg4
from v2e2v_tpu_torch.utils.h263 import FORMATS, H263Decoder, gob_rows
from v2e2v_tpu_torch.utils.mpeg4 import Bits
from v2e2v_tpu_torch.utils.video import VideoFile

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "data" / "h263"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())["clips"]
CLIPS = sorted(MANIFEST)


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


RAW = _module("test_torch_rawvideo", REPO / "tests" / "test_torch_rawvideo.py")
FX = _module("make_h263_fixtures", REPO / "scripts" / "make_h263_fixtures.py")
_BGR: dict = {}  # the path -> the port's BGR frames: each clip decoded once a process


@pytest.fixture
def shared_bgr(monkeypatch):
    original = VideoFile.bgr

    def bgr(self):
        if self.path not in _BGR:
            _BGR[self.path] = list(original(self))
        return iter(_BGR[self.path])

    monkeypatch.setattr(VideoFile, "bgr", bgr)


@pytest.mark.parametrize("name", CLIPS)
def test_fixtures_match_records(name, shared_bgr):
    """Each clip (H.263 under every tag and container cv2 writes, Sorenson
    H.263 in FLV, AVI, MOV and Matroska, the flagship, rates, odd sizes,
    disposable pictures, crafted GOBs and escapes) through the port against
    cv2's frames and the JAX readers' records."""
    RAW.clip_against_records(FIXTURES, MANIFEST, name)


@pytest.mark.parametrize("name", CLIPS)
def test_records_match_cv2_and_the_jax_readers(name):
    RAW.records_against_cv2(FIXTURES, MANIFEST, name)


def _log(name):
    video = VideoFile(str(FIXTURES / name))
    dec = H263Decoder(video.codec, video.path)
    dec.log = []
    for data in video.packets():
        dec.decode(data)
    return dec.log


def test_fixtures_cover_what_they_are_there_for():
    """Every tag and container, a second I picture, the escapes' clips, GOB
    headers at 1 and 2 rows a GOB, disposable pictures, odd sizes."""
    codecs = {n: e["codec"] for n, e in MANIFEST.items()}
    assert {codecs[n] for n in FX.FLV_TAGGED} == {"flv"}
    assert {codecs[f"{t.lower()}.avi"] for t in FX.H263_TAGS} == {"h263"}
    assert {codecs[n] for n in ("h263.mov", "s263.mov", "h263.mkv", "sqcif.avi")} == {"h263"}
    for name, (rate, count) in FX.RATES.items():  # 30000/1001 reads as av_d2q's 989/33
        want = 989 / 33 if name == "r2997.flv" else rate
        assert (MANIFEST[name]["fps"], MANIFEST[name]["frame_count"]) == (want, count)
    for name in ("gop.avi", "gop.flv"):
        kinds = [h.kind for h, _ in _log(name)]
        assert kinds[0] == kinds[12] == 0 and kinds.count(0) == 2
    cif = [[row for row, _ in slices] for _, slices in _log("gobs_cif.avi")]
    assert cif == [[0, 3, 4, 9, 15], [0, 1, 2, 10], list(range(18))]
    assert [[row for row, _ in slices] for _, slices in _log("gobs_4cif.avi")] == [
        [0, 2, 8, 14, 30], [0, 4, 10]]
    assert [h.droppable for h, _ in _log("disposable.flv")] == [0, 0, 1, 0, 1, 0]
    v1 = _log("flv_v1.flv")
    assert [(h.flv_version, h.droppable, h.width, h.height) for h, _ in v1] == [
        (1, False, 300, 40), (1, False, 300, 40), (1, True, 300, 40), (1, False, 300, 40)]
    assert {h.flv_version for h, _ in _log("flv_v0.flv")} == {0}
    assert MANIFEST["odd.flv"]["shape"] == [47, 75]
    assert MANIFEST["portrait.flv"]["shape"] == [96, 64]
    assert MANIFEST["flagship.flv"]["shape"] == [720, 960]


# ------------------------------------------------------------ headers

def _header(bits_of, flavour):
    w = FX.BitWriter()
    bits_of(w)
    return H263Decoder(flavour).header(Bits(w.bytes() + bytes(8)))


@pytest.mark.parametrize("fmt", [1, 2, 3, 4, 5])
def test_h263_picture_header(fmt):
    """PTYPE's source formats and picture types, PQUANT, as read; the start
    code found past leading bytes, as FFmpeg searches for it."""
    for kind, quant in ((0, 1), (1, 31)):
        w = FX.BitWriter()
        w.put(0xA5, 8)  # a byte before the start code
        FX.h263_header(w, fmt, kind, quant, tr=77)
        h = H263Decoder("h263").header(Bits(w.bytes() + bytes(8)))
        assert (h.width, h.height) == FORMATS[fmt]
        assert (h.kind, h.quant, h.droppable) == (kind, quant, False)
    assert gob_rows(h.height) == {1: 1, 2: 1, 3: 1, 4: 2, 5: 4}[fmt]


@pytest.mark.parametrize("size", [(0, 75, 47), (1, 300, 2000), (2, 352, 288), (3, 176, 144),
                                  (4, 128, 96), (5, 320, 240), (6, 160, 120)])
def test_flv_picture_header(size):
    """Sorenson's size codes (8- and 16-bit width and height, the five
    presets), versions, picture types (2 and 3 disposable) and quantiser."""
    code, width, height = size
    for version, kind, quant in ((0, 0, 5), (1, 1, 17), (1, 2, 9), (0, 3, 1)):
        h = _header(lambda w: FX.flv_header(w, version, kind, width, height, quant,
                                            size_code=code), "flv")
        assert (h.width, h.height, h.flv_version) == (width, height, version)
        assert (h.kind, h.droppable, h.quant) == (min(kind, 1), kind > 1, quant)


def _cv2_frames(path):
    return RAW.FX.cv2_frames(Path(path))[0]


def _against_cv2(path, n):
    want = _cv2_frames(path)
    got = list(VideoFile(str(path)).bgr())
    assert len(got) == len(want) == n
    for g, c in zip(got, want):
        np.testing.assert_array_equal(g, c)


@pytest.mark.parametrize("size", [(352, 288), (704, 576), (1408, 1152)],
                         ids=["cif", "4cif", "16cif"])
def test_gob_headers_open_slices(tmp_path, size):
    """GOB headers at 1, 2 and 4 macroblock rows a GOB: each opens a slice
    at the row GN names, with its GQUANT; rows in between are no GOB's
    start and get none. The pictures equal cv2's."""
    pytest.importorskip("cv2")
    w, h = size
    per, mbh = gob_rows(h), h // 16
    rng = np.random.default_rng(w)
    rows = sorted(set(rng.choice(np.arange(1, mbh), 6, replace=False).tolist()))
    pics = [FX.random_picture(rng, "h263", 0, w, h, gobs=rows, coded=0.02, big=40),
            FX.random_picture(rng, "h263", 1, w, h, gobs=rows, skip=0.9, coded=0.3, big=40)]
    path = tmp_path / "gobs.avi"
    RAW.FX.write_avi(path, pics, w, h, 10, b"H263")
    dec = H263Decoder("h263", str(path))
    dec.log = []
    for data in pics:
        dec.decode(data)
    opened = [0] + [r for r in rows if r % per == 0]
    assert [[row for row, _ in slices] for _, slices in dec.log] == [opened, opened]
    _against_cv2(path, 2)


def _escape_picture(flavour, version, run, level, long, quant):
    """An I picture of DC-only blocks but the first, which holds one TCOEF
    at scan index ``run + 1`` written with an escape."""
    w = FX.BitWriter()
    width, height = (128, 96) if flavour == "h263" else (48, 32)
    if flavour == "h263":
        FX.h263_header(w, 1, 0, quant)
    else:
        FX.flv_header(w, version, 0, width, height, quant)
    for mb in range((width // 16) * (height // 16)):
        w.put(*mpeg4.INTRA_MCBPC[0])  # intra, no chroma coded
        w.put(*mpeg4.CBPY[8 if mb == 0 else 0])  # block 0 of MB 0 coded
        for n in range(6):
            w.put(100 + 7 * n, 8)
            if mb == 0 and n == 0:
                FX.put_tcoef(w, 1, run, level, flavour, version, escape=True, long=long)
    return w.bytes(), width, height


ESCAPES = {"h263_8bit": ("h263", 0, 1, 100, False, 4), "h263_8bit_negative": ("h263", 0, 5, -127,
                                                                                False, 4),
           "h263_extended": ("h263", 0, 1, 700, False, 2),
           "h263_extended_negative": ("h263", 0, 9, -1000, False, 1),
           "flv_7bit": ("flv", 1, 1, 63, False, 6), "flv_7bit_negative": ("flv", 1, 3, -64,
                                                                            False, 6),
           "flv_11bit_small": ("flv", 1, 2, 5, True, 6), "flv_11bit": ("flv", 1, 1, 1023, True, 1),
           "flv_11bit_negative": ("flv", 1, 12, -1024, True, 1),
           "flv_version_0": ("flv", 0, 1, 500, False, 2)}


@pytest.mark.parametrize("case", sorted(ESCAPES))
def test_escape_forms(tmp_path, case):
    """Each escape form read as the level written (H.263's 8-bit level and
    the -128 extension of 5 + 6 bits; Sorenson version 1's flag and 7- or
    11-bit level; version 0 as H.263), and the picture equal to cv2's."""
    pytest.importorskip("cv2")
    flavour, version, run, level, long, quant = ESCAPES[case]
    data, width, height = _escape_picture(flavour, version, run, level, long, quant)
    pic = H263Decoder(flavour).parse(data)
    blk = pic.intra_blocks[0][2]
    assert blk[mpeg4.ZIGZAG[run + 1]] == level
    assert sum(map(abs, blk)) == abs(level) + 100
    path = tmp_path / ("clip.avi" if flavour == "h263" else "clip.flv")
    if flavour == "h263":
        RAW.FX.write_avi(path, [data], width, height, 10, b"H263")
    else:
        FX.write_flv(path, [data], 10.0, width, height)
    _against_cv2(path, 1)


CRAFTED = [("h263", 0), ("h263", 1), ("h263", 2), ("flv0", 3), ("flv1", 4), ("flv1", 5)]


@pytest.mark.parametrize("case", CRAFTED, ids=[f"{f}-{s}" for f, s in CRAFTED])
def test_random_streams_match_cv2(tmp_path, case):
    """Random I and P pictures (GOB headers at random rows of an H.263
    sub-QCIF or QCIF; Sorenson of random sizes from 8-bit and 16-bit size
    codes, with disposable pictures) decoded as cv2 decodes them."""
    pytest.importorskip("cv2")
    flavour, seed = case
    rng = np.random.default_rng(100 + seed)
    if flavour == "h263":
        w, h = ((128, 96), (176, 144))[seed % 2]
        kinds = [0, 1, 1, 0, 1]
        pics = [FX.random_picture(rng, "h263", k, w, h, quant=int(rng.integers(2, 13)),
                                  gobs=rng.choice(np.arange(1, h // 16), 3).tolist())
                for k in kinds]
        path = tmp_path / "clip.avi"
        RAW.FX.write_avi(path, pics, w, h, 10, b"H263")
    else:
        version = int(flavour[-1])
        w, h = int(rng.integers(9, 120)), int(rng.integers(9, 90))
        kinds = [0, 1, 2, 1, 2, 2, 1]
        pics = [FX.random_picture(rng, "flv", k, w, h, version=version,
                                  quant=int(rng.integers(2, 13)), tr=i,
                                  size_code=int(rng.integers(0, 2)))
                for i, k in enumerate(kinds)]
        path = tmp_path / "clip.flv"
        FX.write_flv(path, pics, 10.0, w, h, kinds)
    _against_cv2(path, len(kinds))


# ------------------------------------------------------------ refusals

def _p_inter4v():
    w = FX.BitWriter()
    FX.h263_header(w, 1, 1, 5)
    w.put(0, 1)  # COD
    w.put(*mpeg4.INTER_MCBPC[16])  # inter4v, no chroma coded
    return w.bytes() + bytes(40)


def _refused_stream(tmp_path, case) -> Path:
    rng = np.random.default_rng(0)
    intra = FX.random_picture(rng, "h263", 0, 128, 96, coded=0.1)
    flags = {"umv": "umv", "sac": "sac", "ap": "ap", "pb": "pb", "cpm": "cpm", "pei": "pei"}
    path = tmp_path / "clip.avi"
    if case in flags or case in ("plusptype", "format_6"):
        w = FX.BitWriter()
        fmt = {"plusptype": 7, "format_6": 6}.get(case, 1)
        FX.h263_header(w, fmt, 0, 5, **({flags[case]: 1} if case in flags else {}))
        pics = [w.bytes() + bytes(60)]
    elif case == "inter4v":
        pics = [intra, _p_inter4v()]
    elif case == "size_change":
        pics = [intra, FX.random_picture(rng, "h263", 0, 176, 144, coded=0.1)]
    elif case == "p_first":
        pics = [FX.random_picture(rng, "h263", 1, 128, 96)]
    elif case == "gob_jump":  # a GOB header whose GN skips a row
        pic = FX.random_picture(rng, "h263", 0, 128, 96, gobs=(2,), coded=0.1)
        k = pic.index(b"\x00\x00", 4)  # the aligned GBSC: 16 zeros, then 1, GN, GFID
        assert pic[k + 2] >> 2 == 0x20 | 2
        pics = [pic[:k + 2] + bytes([pic[k + 2] + 4]) + pic[k + 3:]]
    elif case == "cut_short":
        pics = [intra[:len(intra) // 2]]
    elif case == "zygo":
        pics = [intra]
    else:
        w = FX.BitWriter()
        if case == "flv_pei":
            FX.flv_header(w, 1, 0, 48, 32, 5, pei=1)
        elif case == "flv_version_2":
            FX.flv_header(w, 2, 0, 48, 32, 5)
        else:  # flv_overflow: an 11-bit level of 1023 at quantiser 31
            FX.flv_header(w, 1, 0, 48, 32, 31)
            for mb in range(6):
                w.put(*mpeg4.INTRA_MCBPC[0])
                w.put(*mpeg4.CBPY[8 if mb == 0 else 0])
                for n in range(6):
                    w.put(128, 8)
                    if mb == 0 and n == 0:
                        FX.put_tcoef(w, 1, 0, 1023, "flv", 1, escape=True)
        path = tmp_path / "clip.flv"
        FX.write_flv(path, [w.bytes() + bytes(60)], 10.0, 48, 32)
        return path
    RAW.FX.write_avi(path, pics, 128, 96, 10, b"ZyGo" if case == "zygo" else b"H263")
    return path


REFUSALS = {"plusptype": "PLUSPTYPE", "format_6": "source format 6", "umv": "Annex D",
            "sac": "Annex E", "ap": "Annex F", "pb": "PB-frames", "cpm": "CPM",
            "pei": "PEI", "flv_pei": "PEI", "inter4v": "inter4v",
            "size_change": "176x144 picture in a stream of 128x96",
            "p_first": "P-picture with no picture before it",
            "gob_jump": "GOB header of GN 3", "cut_short": "corrupt H.263",
            "zygo": "codec 'ZyGo'", "flv_version_2": "version 2",
            "flv_overflow": "outside 16 bits"}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_name_item_4(tmp_path, case):
    """What the port leaves (H.263+ by PLUSPTYPE or source format 6, the
    optional modes UMV, SAC, AP and PB-frames, CPM, PEI, inter4v MBs, a
    size that changes, a P picture first, a GOB header that skips rows, a
    picture cut short, ZyGo's tag, whose I pictures FFmpeg reads a debug
    dump into, Sorenson version 2, a level past 16 bits) raises naming it
    and ROADMAP item 4, from both readers."""
    path = str(_refused_stream(tmp_path, case))
    with pytest.raises(ValueError, match=f"(?s){REFUSALS[case]}.*item 4"):
        VideoReader((180, 240)).initialize(path)
    with pytest.raises(ValueError, match="item 4"):
        list(VideoSequence(path))
