"""The port's MPEG-1/2 video decoder (``v2e2v_tpu_torch/utils/mpeg12.py``,
``mpeg12mb.py``, ``mpeg12dec.py`` and the tables ``mpeg12tables.py``)
against cv2, which decodes through FFmpeg's ``mpeg1video`` /
``mpeg2video`` decoders and swscale, on cv2's own streams rewritten by
``scripts/make_mpeg12_fixtures.py``:

- the tables: shapes, checksums, the codes prefix-free with a Kraft sum of
  at most 1, the scans permutations, the matrices in 1..255, and (where cv2
  is installed) each table as the extraction script cuts it out of the
  bundled libavcodec;
- every rewritten stream (headers changed field by field, slices kept; or
  macroblocks written again under table B-15, with concealment vectors,
  or with ``frame_pred_frame_dct`` 0's modes) equals cv2's BGR at every
  pixel of every frame it returns, and each case asserts that the feature
  it names was used;
- a seeded handful of random cv2-written clips, from 8x8 up;
- every refusal raises a ValueError naming ROADMAP item 4.

cv2 is read on one decoding thread (``CAP_PROP_N_THREADS`` 1), as the
other video tests read it; its frame threads gave the same frames on every
fixture (``scripts/make_mpeg12_fixtures.py`` asserts it).
"""

import hashlib
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

from v2e2v_tpu_torch.utils import mpeg12tables as tables
from v2e2v_tpu_torch.utils.mpeg12dec import Mpeg12Decoder
from v2e2v_tpu_torch.utils.mpegps import ProgramStream
from v2e2v_tpu_torch.utils.video import VideoFile

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "data" / "mpeg12"


def _script(name):
    sys.path.insert(0, str(REPO / "scripts"))
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MF = _script("make_mpeg12_fixtures")


def _es(name):
    return _es_of(FIXTURES / name)


def _es_of(path):
    return ProgramStream(str(path)).es


# -------------------------------------------------------------- tables

VLCS = ("MB_ADDR_INCR", "MB_PTYPE", "MB_BTYPE", "CBP", "MOTION", "DCT_B14", "DCT_B15")


def _codes(name):
    if name == "DC_LUMA":
        return list(zip(tables.DC_LUMA_CODE, tables.DC_LUMA_BITS))
    if name == "DC_CHROMA":
        return list(zip(tables.DC_CHROMA_CODE, tables.DC_CHROMA_BITS))
    return [tuple(e) for e in getattr(tables, name)]


@pytest.mark.parametrize("name", list(tables.CHECKSUMS))
def test_table_checksums(name):
    """Each table's bytes hash to what the extraction script recorded."""
    a = getattr(tables, name)
    assert hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16] == \
        tables.CHECKSUMS[name]


@pytest.mark.parametrize("name", VLCS + ("DC_LUMA", "DC_CHROMA"))
def test_codes_are_prefix_free(name):
    """A code table is prefix-free and its Kraft sum at most 1 (MPEG-2's
    stuffing-free address table and the DCT tables with their escape and
    end of block)."""
    codes = [(int(c), int(n)) for c, n in _codes(name)]
    assert sum(2.0 ** -n for _, n in codes) <= 1
    words = [format(c, f"0{n}b") for c, n in codes]
    assert all(len(w) == n for w, (_, n) in zip(words, codes))
    for i, a in enumerate(words):
        for j, b in enumerate(words):
            assert i == j or not b.startswith(a), (name, a, b)


def test_table_shapes_and_invariants():
    """Shapes, scans as permutations, matrices in 1..255, the non-linear
    scale increasing, the frame rates FFmpeg's."""
    assert tables.DCT_B14.shape == tables.DCT_B15.shape == (113, 2)
    assert tables.DCT_RUN.shape == tables.DCT_LEVEL.shape == (111,)
    assert tables.MB_ADDR_INCR.shape == (36, 2) and tables.CBP.shape == (64, 2)
    assert len(tables.PTYPE_FLAGS) == len(tables.MB_PTYPE) == 7
    assert len(tables.BTYPE_FLAGS) == len(tables.MB_BTYPE) == 11
    for scan in (tables.ZIGZAG, tables.ALTERNATE):
        assert sorted(scan.tolist()) == list(range(64))
    for m in (tables.INTRA_MATRIX, tables.NON_INTRA_MATRIX):
        assert m.shape == (64,) and m.min() >= 1 and m.max() <= 255
    assert tables.INTRA_MATRIX[0] == 8 and set(tables.NON_INTRA_MATRIX.tolist()) == {16}
    q = tables.NON_LINEAR_QSCALE.tolist()
    assert q[0] == 0 and all(a < b for a, b in zip(q[1:], q[2:])) and q[-1] == 112
    rates = [tuple(r) for r in tables.FRAME_RATE.tolist()]
    assert rates[1:9] == [(24000, 1001), (24, 1), (25, 1), (30000, 1001), (30, 1), (50, 1),
                          (60000, 1001), (60, 1)]
    # every run/level pair once, runs 0..31, levels 1..40
    pairs = list(zip(tables.DCT_RUN.tolist(), tables.DCT_LEVEL.tolist()))
    assert len(set(pairs)) == 111 and max(tables.DCT_RUN) == 31 and max(tables.DCT_LEVEL) == 40


def test_tables_are_the_bundled_libavcodecs():
    """The extraction script, run on the libavcodec that cv2 bundles, gives
    the committed tables."""
    cv2 = pytest.importorskip("cv2")
    ex = _script("extract_mpeg12_tables")
    lib = ex._lib(Path(cv2.__file__).resolve().parents[1] / "opencv_python.libs")
    fresh = ex.extract(lib.read_bytes())
    assert list(fresh) == list(tables.CHECKSUMS)
    for name, a in fresh.items():
        np.testing.assert_array_equal(a, getattr(tables, name), err_msg=name)


# --------------------------------------------------- rewritten streams

def _picture_ext(field, value):
    def change(f, i):
        if f["kind"] == "picture_extension":
            f[field] = value
    return change


def _sequence(**fields):
    def change(f, i):
        if f["kind"] == "sequence":
            f.update(fields)
    return change


def _gop(closed, broken):
    def change(f, i):
        if f["kind"] == "gop":
            f["closed_gop"], f["broken_link"] = closed, broken
    return change


_RNG = np.random.default_rng(7)
MATRIX_A = [int(v) for v in _RNG.integers(8, 48, 64)]
MATRIX_B = [int(v) for v in _RNG.integers(8, 48, 64)]


def _quant_ext(f, i):
    if f["kind"] == "picture_extension" and i % 2 == 0:
        return MF.quant_extension(MATRIX_A, MATRIX_B, MATRIX_B, MATRIX_A)
    return None


def _display(mc):
    def change(f, i):
        if f["kind"] == "sequence_extension":
            return MF.display_extension(mc, 128, 96)
        return None
    return change


def _full_pel(f, i):
    if f["kind"] == "picture" and f["type"] == 2:
        f["full_pel_f"] = 1


# case -> (source clip, the stream's change, (width, height) or None, what
# the decode must show: a name in PictureSyntax.used, or a check)
REWRITES = {
    "alternate_scan": ("twin.mpg", lambda es: MF.rewrite(es, _picture_ext("alternate_scan", 1)),
                       None, "alternate_scan"),
    "q_scale_type": ("twin.mpg", lambda es: MF.rewrite(es, _picture_ext("q_scale_type", 1)),
                     None, "q_scale_type"),
    "intra_dc_precision_1": ("twin.mpg", lambda es: MF.rewrite(
        es, _picture_ext("intra_dc_precision", 1)), None, "intra_dc_precision"),
    "intra_dc_precision_2": ("twin.mpg", lambda es: MF.rewrite(
        es, _picture_ext("intra_dc_precision", 2)), None, "intra_dc_precision"),
    "intra_dc_precision_3": ("twin.mpg", lambda es: MF.rewrite(
        es, _picture_ext("intra_dc_precision", 3)), None, "intra_dc_precision"),
    "sequence_matrices": ("twin.mpg", lambda es: MF.rewrite(
        es, _sequence(intra=MATRIX_A, inter=MATRIX_B)), None, "differs"),
    "sequence_matrices_mpeg1": ("mpeg1.mpg", lambda es: MF.rewrite(
        es, _sequence(intra=MATRIX_A, inter=MATRIX_B)), None, "differs"),
    "quant_matrix_extension": ("twin.mpg", lambda es: MF.rewrite(es, _quant_ext), None,
                               "differs"),
    "intra_vlc_format": ("twin.mpg", lambda es: MF.reencode_intra(es, True, False), None,
                         "intra_vlc_format"),
    "concealment_vectors": ("twin.mpg", lambda es: MF.reencode_intra(es, False, True), None,
                            "concealment_motion_vectors"),
    "intra_vlc_and_concealment": ("noise.mpg", lambda es: MF.reencode_intra(es, True, True),
                                  None, "intra_vlc_format"),
    "odd_size": ("twin.mpg", lambda es: MF.rewrite(es, _sequence(width=125, height=91)),
                 (125, 91), "odd"),
    "odd_height": ("twin.mpg", lambda es: MF.rewrite(es, _sequence(height=91)), (128, 91),
                   "odd"),
    "odd_size_mpeg1": ("mpeg1.mpg", lambda es: MF.rewrite(es, _sequence(width=75, height=61)),
                       (75, 61), "odd"),
    "full_pel": ("mpeg1.mpg", lambda es: MF.rewrite(es, _full_pel), None, "full_pel"),
    "closed_gops": ("gops.mpg", lambda es: MF.rewrite(es, _gop(1, 0)), None, "closed"),
    "broken_link": ("gops.mpg", lambda es: MF.rewrite(es, _gop(0, 1)), None, "broken"),
    "cut_at_second_gop": ("gops.mpg", MF.cut_at_gop, None, "dropped"),
    "cut_closed": ("gops.mpg", lambda es: MF.rewrite(MF.cut_at_gop(es), _gop(1, 0)), None,
                   "closed"),
    "frame_motion": ("twin.mpg", MF.frame_modes, None, "frame_motion_type"),
    "frame_motion_noise": ("noise.mpg", MF.frame_modes, None, "frame_motion_type"),
    "progressive_frame_0": ("twin.mpg", lambda es: MF.rewrite(
        es, _picture_ext("progressive_frame", 0)), None, "interlaced_flag"),
    "colour_bt601": ("twin.mpg", lambda es: MF.rewrite(es, _display(6)), None, "display"),
    "colour_unspecified": ("twin.mpg", lambda es: MF.rewrite(es, _display(2)), None, "display"),
}
SIZES = {"twin.mpg": (128, 96), "mpeg1.mpg": (80, 64), "gops.mpg": (96, 64),
         "noise.mpg": (128, 96)}
RATES = {"twin.mpg": 10, "mpeg1.mpg": 30, "gops.mpg": 25, "noise.mpg": 10}


def _cv2_bgr(cv2, path):
    cap = cv2.VideoCapture(str(path), cv2.CAP_FFMPEG, [cv2.CAP_PROP_N_THREADS, 1])
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    count = cap.get(cv2.CAP_PROP_FRAME_COUNT)
    cap.release()
    return out, count


def _to_avi(tmp_path, name, es, source, size=None):
    w, h = size or SIZES[source]
    path = tmp_path / f"{name}.avi"
    MF.to_avi(path, es, w, h, RATES[source], b"mpg1" if source == "mpeg1.mpg" else b"mpg2")
    return path


def _port(path):
    video = VideoFile(str(path))
    video.syntax_log = []
    frames = list(video.bgr())
    return video, frames


@pytest.mark.parametrize("case", sorted(REWRITES))
def test_rewritten_streams_match_cv2(tmp_path, case):
    """Each rewritten stream, in an AVI of one picture a chunk, equals cv2
    at every pixel of every frame, and uses what its name says."""
    cv2 = pytest.importorskip("cv2")
    source, make, size, shows = REWRITES[case]
    es = _es(source)
    made = make(es)
    path = _to_avi(tmp_path, case, made, source, size)
    want, count = _cv2_bgr(cv2, path)
    video, got = _port(path)
    assert video.frame_count == count
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"{case} frame {i}")
    log = video.syntax_log
    used = set().union(*(s.used for s in log))
    headers = [s.pic for s in log]
    if shows == "differs":  # loaded matrices change the pictures
        plain = list(_port(_to_avi(tmp_path, "plain", es, source))[1])
        assert any(not np.array_equal(a, b) for a, b in zip(got, plain))
    elif shows == "odd":
        assert got[0].shape[:2] == (size[1], size[0]) and (size[0] % 2 or size[1] % 2)
    elif shows in ("closed", "broken"):
        key = "closed_gop" if shows == "closed" else "broken_link"
        assert getattr(video.decoder.h, key) == 1
        assert len(got) == len(log)  # every picture output, the leading B-pictures too
    elif shows == "dropped":  # the open GOP's leading B-pictures are dropped
        assert len(got) == len(log) < made.count(b"\x00\x00\x01\x00")
    elif shows == "interlaced_flag":
        assert all(p.progressive_frame == 0 for p in headers)
    elif shows == "display":
        assert video.decoder.h.seq.display is not None
    else:
        assert shows in used, used


def test_b_pictures_average_every_half_pel_kind():
    """cv2's B-pictures (the noise fixture's) hold bidirectional macroblocks
    at every half-pel kind of each direction's vector, so the exact
    ``avg_pixels`` / ``put_pixels`` the decoder computes is held by the
    fixtures' frames against cv2's."""
    video = VideoFile(str(FIXTURES / "noise.mpg"))
    video.syntax_log = []
    list(video.planes())
    kinds = set()
    for s in video.syntax_log:
        for k, d, v in zip(s.kind, s.direction, s.vectors):
            if k == 1 and d == 3:
                kinds.add(((v[0] & 1) | (v[1] & 1) << 1, (v[2] & 1) | (v[3] & 1) << 1))
    assert {a for a, _ in kinds} == {0, 1, 2, 3} and {b for _, b in kinds} == {0, 1, 2, 3}


# --------------------------------------------------------- random clips

@pytest.mark.parametrize("seed", range(4))
def test_random_clips_match_cv2(tmp_path, seed):
    """A seeded cv2-written clip of random size (8x8 up), length, codec,
    rate and content: frames, fps and count equal cv2's."""
    cv2 = pytest.importorskip("cv2")
    mp4f = _script("make_mpeg4_fixtures")
    rng = np.random.default_rng(100 + seed)
    h, w = [(8, 8), (16, 32), (48, 64), (96, 80)][seed]
    n = int(rng.integers(3, 14))
    codec = ("MPG2", "PIM1")[seed % 2]
    fps = float(rng.choice([10.0, 25.0] if codec == "MPG2" else [25.0, 30.0]))
    frames = (rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8) if seed == 3
              else mp4f.pan(rng, h, w, n, (1, 1)))
    path = tmp_path / "r.mpg"
    MF.write(path, frames, fps, codec)
    want, count = _cv2_bgr(cv2, path)
    video, got = _port(path)
    assert (video.fps, video.frame_count) == (cv2.VideoCapture(str(path)).get(cv2.CAP_PROP_FPS),
                                              count)
    assert len(got) == len(want) == n
    for i, (g, w_) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w_, err_msg=f"seed {seed} frame {i}")


# ------------------------------------------------------------ refusals

def _drop_first_picture(es):
    us = MF.units(es)
    first = next(k for k, u in enumerate(us) if u[3] == 0x00)
    nxt = next(k for k in range(first + 1, len(us)) if us[k][3] == 0x00)
    return b"".join(us[:first] + us[nxt:])


def _drop_slice(es):
    us = MF.units(es)
    k = next(k for k, u in enumerate(us) if 0x01 <= u[3] <= 0xAF)
    return b"".join(us[:k] + us[k + 1:])


def _truncate_slice(es):
    us = MF.units(es)
    k = next(k for k, u in enumerate(us) if 0x01 <= u[3] <= 0xAF)
    return b"".join(us[:k] + [us[k][:len(us[k]) // 2] + b"\xff\xff"] + us[k + 1:])


def _scalable(f, i):
    if f["kind"] == "sequence_extension":
        return b"\x00\x00\x01\xb5\x50\x00\x00\x00"
    return None


def _d_picture(f, i):
    if f["kind"] == "picture" and f["type"] == 2:
        f["type"] = 4


def _ext(field, value):
    def change(f, i):
        if f["kind"] == "sequence_extension":
            f[field] = value
    return change


def _size_change(es):
    return es + MF.rewrite(es, _sequence(width=112))


def _field_vector_past_the_edge(es):
    """Interlaced frame pictures (the stream's sequence header, made
    interlaced) coded by ``scripts/make_mpeg2i_fixtures.py``'s writer: an
    I-picture, then a P-picture of field motion with field DCT whose bottom
    macroblock row takes field vectors 2 field lines down, past its
    reference field's last line (FFmpeg leaves such a macroblock
    unpredicted)."""
    mi = _script("make_mpeg2i_fixtures")
    us = MF.units(es)
    seq = MF.parse_header(us[0])
    coder = mi.Coder(seq["width"], seq["height"], np.random.default_rng(0), (us[0], us[1]),
                     residual=1.0)
    inside = coder._vector

    def vector(row, col, sel, h, top=None):
        if coder.kind == mi.P and row == coder.mbh - 1:
            return 0, 4
        return inside(row, col, sel, h, top)

    coder._vector = vector
    plan = [[mi.Picture(mi.I), mi.Picture(mi.P, temporal=1, modes={"field"})]]
    scene = np.full((2, seq["height"], seq["width"], 3), 128, np.uint8)
    out = coder.stream(plan, scene)
    assert {"frame_field", "field_dct"} <= coder.used
    return out


# field pictures, field and dual-prime motion and field DCT are read since
# interlaced MPEG-2 is (tests/test_torch_mpeg2i.py); their cases here hold
# what stays refused of them: field pictures and dual prime in a progressive
# sequence, motion type 0 (reserved), a field vector past the edge of its
# reference field in a picture of field DCT
REFUSALS = {
    "field_picture": ("twin.mpg", lambda es: MF.rewrite(es, _picture_ext("picture_structure", 1)),
                      "field picture in a progressive sequence"),
    "field_motion": ("twin.mpg", lambda es: MF.frame_modes(es, motion=(0, 0)), "motion_type 0"),
    "dual_prime": ("twin.mpg", lambda es: MF.frame_modes(es, motion=(1, 1)),
                   "dual-prime motion in a progressive sequence"),
    "field_dct": ("twin.mpg", _field_vector_past_the_edge, "past the reference's edge"),
    "chroma_422": ("twin.mpg", lambda es: MF.rewrite(es, _ext("chroma_format", 2)), "4:2:2"),
    "chroma_444": ("twin.mpg", lambda es: MF.rewrite(es, _ext("chroma_format", 3)), "4:4:4"),
    "scalable": ("twin.mpg", lambda es: MF.rewrite(es, _scalable), "scalable"),
    "d_picture": ("mpeg1.mpg", lambda es: MF.rewrite(es, _d_picture), "D-picture"),
    "size_change": ("twin.mpg", _size_change, "a change inside the stream"),
    "p_before_i": ("mpeg1.mpg", _drop_first_picture, "before any I-picture"),
    "colour_bt709": ("twin.mpg", lambda es: MF.rewrite(es, _display(1)), "matrix_coefficients 1"),
    "missing_slice": ("twin.mpg", _drop_slice, "coded by no slice"),
    "truncated": ("twin.mpg", _truncate_slice, "corrupt or truncated"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_name_item_4(case):
    """What the decoder does not read raises a ValueError naming it and
    ROADMAP item 4, from the stream's bytes alone (no cv2)."""
    source, make, text = REFUSALS[case]
    es = make(_es(source))
    dec = Mpeg12Decoder(case)
    with pytest.raises(ValueError, match=f"(?s){text}.*item 4"):
        dec.decode(es)
        dec.flush()


def test_vectors_past_the_edge_are_refused(tmp_path):
    """A vector whose prediction reaches past the reference's macroblock
    grid: FFmpeg's MPEG-1/2 path leaves the macroblock unpredicted, so the
    port refuses it (here an MPEG-1 pan whose P-pictures' ``full_pel``
    flags are set, which doubles their vectors)."""
    pytest.importorskip("cv2")
    mp4f = _script("make_mpeg4_fixtures")
    path = tmp_path / "e.mpg"
    MF.write(path, mp4f.pan(np.random.default_rng(0), 64, 64, 6, (5, 9)), 30.0, "PIM1")
    dec = Mpeg12Decoder("edge")
    with pytest.raises(ValueError, match="(?s)past the reference's edge.*item 4"):
        dec.decode(MF.rewrite(_es_of(path), _full_pel))
        dec.flush()
