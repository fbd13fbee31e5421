"""The port's MS-MPEG-4 v2, v3 and WMV1 decoder (``v2e2v_tpu_torch/utils/msmpeg4.py``
and its tables ``msmpeg4tables.py``, behind ``utils/video.VideoFile`` and
the readers) against cv2 and the JAX package's readers, on the AVI,
Matroska and MOV fixtures of ``tests/data/wmv`` (``scripts/make_wmv_fixtures.py``)
and on streams re-coded here with that script's writers:

- the tables: shapes, checksums, the codes prefix-free with a Kraft sum of
  at most 1, the scans permutations, the motion vector symbols distinct
  with one escape, and (where cv2 is installed) each table as the
  extraction script cuts it out of the bundled libavcodec;
- every clip (each tag in AVI, Matroska and MOV, second I-pictures, noise,
  flat content, 4CIF, portrait, low-rate WMV1 with ``inter_intra_pred``,
  odd sizes, the re-coded tables, slices and cleared flip-flop) through the
  port equals the records (cv2's fps, count, BGR and gray frames; the JAX
  readers' frames, stamps and hashes), and the records are what cv2 and the
  JAX readers return;
- the fixtures reach what they are there for (both DC and vector tables,
  every run/level table index, the three escapes, ``inter_intra_pred``'s
  pixel predictors, per-macroblock tables, both rounding modes, slices);
- cv2's streams re-coded with random tables, against cv2;
- every refusal names what the stream is and ROADMAP item 4.
"""

import collections
import hashlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from v2e2v_tpu_torch.data.manifests import VideoSequence
from v2e2v_tpu_torch.data.video_readers import VideoReader
from v2e2v_tpu_torch.utils import msmpeg4
from v2e2v_tpu_torch.utils import msmpeg4tables as T
from v2e2v_tpu_torch.utils.avi import AviFile
from v2e2v_tpu_torch.utils.video import VideoFile

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "data" / "wmv"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())["clips"]
CLIPS = sorted(n for n, e in MANIFEST.items()
               if not n.endswith(".wmv") and e["codec"] in ("msmpeg4v2", "msmpeg4v3", "wmv1"))


def _module(name, path):
    sys.path.insert(0, str(REPO / "scripts"))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


RAW = _module("test_torch_rawvideo", REPO / "tests" / "test_torch_rawvideo.py")
WF = _module("make_wmv_fixtures", REPO / "scripts" / "make_wmv_fixtures.py")

# ---------------------------------------------------------------- tables

VLCS = ["RL0_VLC", "RL1_VLC", "RL3_VLC", "RL4_VLC", "MB_INTRA", "V2_MB_TYPE", "V2_INTRA_CBPC",
        "INTER_INTRA"] + [f"MB_NON_INTRA[{k}]" for k in range(4)] + \
    [f"DC[{t}][{c}]" for t in (0, 1) for c in (0, 1)] + ["MV0", "MV1"]


def _codes(name):
    if name in ("MV0", "MV1"):
        return msmpeg4.from_lengths(getattr(T, f"{name}_LENS"))
    base, _, rest = name.partition("[")
    a = getattr(T, base)
    for k in rest.replace("]", " ").replace("[", " ").split():
        a = a[int(k)]
    return [(int(c), int(n)) for c, n in np.asarray(a).reshape(-1, 2)]


@pytest.mark.parametrize("name", list(T.CHECKSUMS))
def test_table_checksums(name):
    a = getattr(T, name)
    assert hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16] == \
        T.CHECKSUMS[name]


@pytest.mark.parametrize("name", VLCS)
def test_codes_are_prefix_free(name):
    """Each table's codes: distinct, none a prefix of another, Kraft's sum at
    most 1 (exactly 1 where FFmpeg builds the table from lengths)."""
    codes = _codes(name)
    words = sorted(format(c, f"0{n}b") for c, n in codes)
    assert all(n <= 26 and c < 1 << n for c, n in codes)
    assert len(set(words)) == len(words)
    assert not any(b.startswith(a) for a, b in zip(words, words[1:]))
    assert sum(2.0 ** -n for _, n in codes) <= 1.0


def test_table_shapes_and_invariants():
    """The run/level tables' sizes and 'last' splits (ff_rl_table's n and
    last), the scans permutations, each motion vector symbol once with one
    escape, the DC scales FFmpeg's."""
    for name, n, last in (("RL0", 132, 85), ("RL1", 185, 119), ("RL3", 148, 81),
                          ("RL4", 168, 99)):
        assert getattr(T, f"{name}_VLC").shape == (n + 1, 2)
        assert getattr(T, f"{name}_LAST") == last
        assert getattr(T, f"{name}_LEVEL").min() >= 1
    for scan in T.WMV1_SCAN:
        assert sorted(scan) == list(range(64))
    for k in (0, 1):
        syms = getattr(T, f"MV{k}_SYMS")
        assert len(set(syms.tolist())) == 1100 and (syms == 0).sum() == 1
        assert (syms >> 8).max() < 64 and (syms & 0xFF).max() < 64
    assert list(T.WMV1_Y_DC_SCALE[:9]) == [0, 8, 8, 8, 8, 8, 9, 9, 10]
    assert T.MB_NON_INTRA.shape == (4, 128, 2) and T.DC.shape == (2, 2, 120, 2)


def test_tables_are_the_bundled_libavcodecs():
    """The extraction script, run on the libavcodec cv2 bundles, cuts out
    the tables the module holds."""
    cv2 = pytest.importorskip("cv2")
    ex = _module("extract_msmpeg4_tables", REPO / "scripts" / "extract_msmpeg4_tables.py")
    lib = ex._lib(Path(cv2.__file__).resolve().parents[1] / "opencv_python.libs")
    fresh = ex.extract(lib.read_bytes())
    assert list(fresh) == list(T.CHECKSUMS)
    for name, a in fresh.items():
        np.testing.assert_array_equal(a, getattr(T, name))


# ---------------------------------------------------------------- clips

@pytest.mark.parametrize("name", CLIPS)
def test_fixtures_match_records(name):
    """Each MS-MPEG-4 v2, v3 and WMV1 clip in AVI, Matroska and MOV through
    the port against cv2's frames, rate and count and the JAX readers'
    records."""
    RAW.clip_against_records(FIXTURES, MANIFEST, name)


@pytest.mark.parametrize("name", CLIPS)
def test_records_match_cv2_and_the_jax_readers(name):
    RAW.records_against_cv2(FIXTURES, MANIFEST, name)


def _coverage(names):
    """What decoding ``names`` reaches, counted."""
    seen = collections.Counter()
    pic = msmpeg4._PictureDecoder

    class Counted(pic):
        def parse(self):
            super().parse()
            d = self.dec
            seen["slices", d.slice_height < d.mbh] += 1
            seen[self.version, "rounding", d.no_rounding if self.p_picture else None] += 1

        def macroblock(self, mbx, mby, first_row):
            super().macroblock(mbx, mby, first_row)
            d = self.dec
            seen[self.version, "dc", d.dc_table_index] += 1
            seen[self.version, "rl", d.rl_table_index, d.rl_chroma_table_index] += 1
            seen[self.version, "per_mb_rl", d.per_mb_rl_table] += 1
            seen[self.version, "inter_intra_pred", d.inter_intra_pred] += 1
            if self.p_picture:
                seen[self.version, "mv", d.mv_table_index] += 1

        def _escape3(self):
            seen[self.version, "esc3"] += 1
            return super()._escape3()

        def _plain(self, rl):
            seen[self.version, "esc1/2"] += 1
            return super()._plain(rl)

        def _pixel_dcs(self, *a):
            seen[self.version, "pixel_dc"] += 1
            return super()._pixel_dcs(*a)

    orig = msmpeg4.MsMpeg4Decoder.picture
    msmpeg4.MsMpeg4Decoder.picture = lambda self, bits, hdr: Counted(self, bits, hdr)
    try:
        for name in names:
            list(VideoFile(str(FIXTURES / name)).planes())
    finally:
        msmpeg4.MsMpeg4Decoder.picture = orig
    return seen


def test_fixtures_cover_what_they_are_there_for():
    """Both DC and vector tables, every run/level index, the escapes,
    ``inter_intra_pred`` and its pixel predictors, per-macroblock tables,
    both rounding modes, slices, a second I-picture."""
    v2, v3, wmv1 = msmpeg4.V2, msmpeg4.V3, msmpeg4.WMV1
    seen = _coverage(CLIPS + [n for n in MANIFEST if n.endswith(".wmv") and
                              MANIFEST[n]["codec"] in ("msmpeg4v2", "msmpeg4v3", "wmv1")])
    for v in (v3, wmv1):
        assert seen[v, "dc", 0] and seen[v, "dc", 1] and seen[v, "mv", 0] and seen[v, "mv", 1]
        assert seen[v, "rounding", 0] and seen[v, "rounding", 1]
        assert {k[2] for k in seen if k[:2] == (v, "rl")} == {0, 1, 2}
    for v in (v2, v3, wmv1):
        assert seen[v, "esc3"] and seen[v, "esc1/2"]
    assert seen[v2, "rounding", 0] and not seen[v2, "rounding", 1]
    assert seen[wmv1, "per_mb_rl", 1] and seen[wmv1, "inter_intra_pred", 1]
    assert seen[wmv1, "pixel_dc"] and seen["slices", True]
    assert {MANIFEST[f"{t.lower()}.avi"]["codec"] for t in WF.AVI_TAGS} == {
        "msmpeg4v2", "msmpeg4v3", "wmv1", "wmv2"}
    noflip = _coverage(["noflip_mp43.avi"])
    assert noflip[v3, "rounding", 0] and not noflip[v3, "rounding", 1]


@pytest.mark.parametrize("seed", range(3))
def test_recoded_streams_match_cv2(tmp_path, seed):
    """cv2's v3 and WMV1 streams re-coded under random DC and vector tables
    (and WMV1's slices and per-macroblock tables) read as cv2 reads them."""
    cv2 = pytest.importorskip("cv2")
    mf = _module("make_mpeg4_fixtures", REPO / "scripts" / "make_mpeg4_fixtures.py")
    rng = np.random.default_rng(seed)
    tag = ("MP43", "WMV1")[seed % 2]
    h, w = 48 + 16 * seed, 64
    src = tmp_path / "src.avi"
    RAW.FX.writer(src, mf.pan(rng, h, w, 4, (1, 2)), 10.0, tag)
    packets = list(AviFile(str(src)).frames())
    kw = dict(dc_table=int(rng.integers(0, 2)), mv_table=int(rng.integers(0, 2)))
    if tag == "WMV1":
        kw.update(slices=int(rng.integers(1, 3)), per_mb_rl=True)
    pics = WF.recode_msmpeg4(packets, WF.codec_of_tag(tag), w, h, **kw)
    path = tmp_path / "recoded.avi"
    RAW.FX.write_avi(path, pics, w, h, 10, tag.encode())
    want = [cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) for f in RAW._cv2_bgr(path)]
    got = list(VideoFile(str(path)))
    assert len(got) == len(want) == 4
    for g, c in zip(got, want):
        np.testing.assert_array_equal(g, c)


# ------------------------------------------------------------- refusals

def _refused(tmp_path, case):
    src = AviFile(str(FIXTURES / "mp43.avi"))
    packets = list(src.frames())
    tag = b"MP43"
    if case == "p_first":
        packets = packets[1:]
    elif case == "slice_code":  # a slice code under 0x17
        p = bytearray(packets[0])
        p[0] = p[0] & 0xFE  # the code's top bit, the picture's 8th
        p[1] = p[1] & 0x3F
        packets[0] = bytes(p)
    elif case == "cut_short":
        packets[0] = packets[0][:len(packets[0]) // 3]
    elif case == "junk":  # more bits after the macroblocks than FFmpeg's padding
        packets[1] = packets[1] + bytes(8)
    elif case == "b_picture":
        packets[1] = bytes([packets[1][0] & 0x3F | 0x80]) + packets[1][1:]
    elif case == "mp41":
        tag = b"MP41"
    path = tmp_path / "clip.avi"
    RAW.FX.write_avi(path, packets, src.width, src.height, 10, tag)
    return path


REFUSALS = {"p_first": "P-picture with no picture before it", "slice_code": "slice code",
            "cut_short": "corrupt MS-MPEG-4", "junk": "bits left after",
            "b_picture": "picture of type 3", "mp41": "MS-MPEG-4 v1"}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_name_item_4(tmp_path, case):
    """What the port leaves (a P-picture first, a slice code FFmpeg
    rejects, a picture cut short or followed by junk that FFmpeg conceals,
    a picture type past P, MS-MPEG-4 v1's tags) raises naming it and
    ROADMAP item 4, from both readers."""
    path = str(_refused(tmp_path, case))
    with pytest.raises(ValueError, match=f"(?s){REFUSALS[case]}.*item 4"):
        VideoReader((180, 240)).initialize(path)
    with pytest.raises(ValueError, match="item 4"):
        list(VideoSequence(path))
