"""Interlaced MPEG-2 in the port (``v2e2v_tpu_torch/utils/mpeg12*.py``:
field pictures, field and 16x8 motion, dual prime, field DCT) and the rates
and counts cv2 reports for soft-telecined and interlaced program and
transport streams (``utils/mpegrate.py``), on the fixtures of
``tests/data/mpeg2i`` (``scripts/make_mpeg2i_fixtures.py``) and on streams
that script's syntax writer codes here:

- every fixture through ``VideoFile`` and both readers equals its records:
  FFmpeg's decoded planes, the BGR frames, cv2's fps and count, and the JAX
  readers' stamps and frames (no cv2 needed, so this runs on the card's
  machine too);
- the records are FFmpeg's and cv2's: FFmpeg's planes (its ``mpeg2video``
  decoder through the libavcodec cv2 bundles), cv2's fps and count, and
  cv2's frames where cv2 converts them. cv2 5.0.0 does not convert a frame
  FFmpeg flags interlaced (field pictures, ``progressive_frame`` 0 in an
  interlaced sequence: its swscale refuses "interlaced to progressive" and
  cv2 returns an unconverted buffer that differs from run to run); there the
  records hold cv2's conversion of FFmpeg's planes;
- one case per feature, coded here at 176x128 and held against FFmpeg's
  planes: field DCT, field motion and dual prime in frame pictures, field
  pictures of each order, field, 16x8 and dual-prime motion in them, I/P
  field pairs, skipped macroblocks, concealment vectors, a mix of frame and
  field pictures; rates and counts in each container against cv2;
- the telecine sweep: cv2's clips of ``tests/data/mpeg12`` with 3:2 and
  other repeat cadences patched into their headers, in program streams,
  VOBs, transport streams, M2TS, AVI and Matroska: ``VideoFile``'s fps and
  count against cv2's, ``VideoReader``'s stamps, count and frames against
  the JAX reader's;
- a program stream of minutes opens in the time of FFmpeg's analysis, not
  of its length;
- streams whose first video PES packets carry no time stamp: fps and count
  against cv2's (FFmpeg's relative stamps); with no stamp at all, refused;
- what stays refused raises naming ROADMAP item 4.

The 720x576 flagship is decoded once per process.
"""

import hashlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from v2e2v_tpu.data.video_readers import VideoReader as JaxVideoReader
from v2e2v_tpu_torch.data.manifests import VideoSequence
from v2e2v_tpu_torch.data.video_readers import VideoReader
from v2e2v_tpu_torch.utils import mpegrate
from v2e2v_tpu_torch.utils.mpeg12dec import Mpeg12Decoder
from v2e2v_tpu_torch.utils.mpegps import ProgramStream
from v2e2v_tpu_torch.utils.video import VideoFile

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "data" / "mpeg2i"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())["clips"]
CLIPS = sorted(MANIFEST)
_DECODED: dict = {}  # path -> the port's planes: the flagship once a process


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _yuv_sha(planes):
    return hashlib.sha256(b"".join(np.ascontiguousarray(p).tobytes() for p in planes)).hexdigest()


def _script(name):
    sys.path.insert(0, str(REPO / "scripts"))
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shared_planes(monkeypatch):
    original = VideoFile.planes

    def planes(self):
        if self.path not in _DECODED:
            _DECODED[self.path] = list(original(self))
        return iter(_DECODED[self.path])

    monkeypatch.setattr(VideoFile, "planes", planes)


# ------------------------------------------------------------ fixtures

@pytest.mark.parametrize("name", CLIPS)
def test_fixtures_match_records(name, monkeypatch):
    """Each clip through the port: FFmpeg's planes, the BGR frames, cv2's
    fps and count, and the JAX readers' stamps, frames and hashes."""
    _shared_planes(monkeypatch)
    want = MANIFEST[name]
    path = str(FIXTURES / name)
    video = VideoFile(path)
    assert video.codec == "mpeg2"
    assert (video.fps, video.frame_count) == (want["fps"], want["frame_count"])
    assert [_yuv_sha(p) for p in video.planes()] == want["yuv_sha256"]
    assert [_sha(f) for f in VideoFile(path).bgr()] == want["bgr_sha256"]
    reader = VideoReader((720, 960), ds=(0.25, 0.25))
    reader.initialize(path)
    assert reader.num_frames == want["frames_read"]
    assert reader.timestamps == want["timestamps"]
    assert list(reader.frames[0].shape) == want["reader_shape"]
    assert [_sha(f) for f in reader.frames] == want["reader_sha256"]
    stack = np.load(FIXTURES / "reader_frames.npz")[want["frames"]]
    np.testing.assert_array_equal(np.stack(reader.frames), stack[:reader.num_frames])
    pairs = list(VideoSequence(path))
    full = [pairs[0][0]] + [p[1] for p in pairs]
    assert list(full[0].shape) == want["shape"]
    assert [_sha(f) for f in full] == want["sequence_sha256"]


@pytest.mark.parametrize("name", CLIPS)
def test_records_are_ffmpegs_and_cv2s(name, tmp_path):
    """The committed records are FFmpeg's decode and cv2's rate, count and
    conversion, so the port is held to them, not to itself; cv2 converts
    the progressive frames (telecine) and not the interlaced ones."""
    cv2 = pytest.importorskip("cv2")
    mi = _script("make_mpeg2i_fixtures")
    want = MANIFEST[name]
    path = FIXTURES / name
    cap = cv2.VideoCapture(str(path))
    assert (cap.get(cv2.CAP_PROP_FPS), cap.get(cv2.CAP_PROP_FRAME_COUNT)) == \
        (want["fps"], want["frame_count"])
    cap.release()
    planes = mi.ffmpeg_planes(path)
    assert [_yuv_sha(p) for p in planes] == want["yuv_sha256"]
    converted = mi.cv2_conversion(planes, tmp_path)
    assert [_sha(f) for f in converted] == want["bgr_sha256"]
    frames, _, _ = mi.mf.cv2_frames(path)
    same = all(np.array_equal(a, b) for a, b in zip(frames, converted))
    assert same == want["cv2_converts"] == ("telecine" in name)


def test_fixtures_hold_what_they_are_for():
    """The flagship is PAL DVD video: 720x576 field pictures, top field
    first, an I/P field pair, then P- and B-fields; the small clips reach
    every motion type, field DCT, both field orders and the containers."""
    flagship = MANIFEST["flagship.vob"]
    assert flagship["shape"] == [576, 720] and flagship["reader_shape"] == [144, 180]
    assert flagship["fps"] == 25.0 and len(flagship["yuv_sha256"]) == 12
    video = VideoFile(str(FIXTURES / "fields_tff.vob"))
    video.syntax_log = []
    list(video.planes())
    log = video.syntax_log
    assert all(s.pic.picture_structure != 3 for s in log)
    assert [s.pic.picture_structure for s in log[:2]] == [1, 2]
    assert [s.pic.kind for s in log[:2]] == [1, 2]  # an I-field, then a P-field
    used = set().union(*(s.used for s in log))
    assert {"motion_field", "motion_16x8", "motion_dmv", "skipped", "field_picture"} <= used
    frames = VideoFile(str(FIXTURES / "frames.avi"))
    frames.syntax_log = []
    list(frames.planes())
    used = set().union(*(s.used for s in frames.syntax_log))
    assert {"motion_field", "motion_dmv", "motion_frame", "field_dct"} <= used
    bff = VideoFile(str(FIXTURES / "fields_bff.vob"))
    bff.syntax_log = []
    list(bff.planes())
    assert bff.syntax_log[0].pic.picture_structure == 2
    mixed = VideoFile(str(FIXTURES / "mixed.vob"))
    mixed.syntax_log = []
    list(mixed.planes())
    used = set().union(*(s.used for s in mixed.syntax_log))
    assert {"concealment_motion_vectors", "intra_vlc_format", "alternate_scan",
            "q_scale_type", "intra_dc_precision"} <= used
    assert {s.pic.picture_structure for s in mixed.syntax_log} == {1, 2, 3}
    with open(FIXTURES / "telecine.vob", "rb") as f:
        assert f.read(5)[4] >> 6 == 1  # MPEG-2 pack headers


# ------------------------------------------------------------ features

SMALL = (128, 176)


def _plan(mi, name, rng):
    """The pictures of the feature case ``name`` (coded order, GOPs)."""
    I, P, B, TOP, BOTTOM, FRAME = mi.I, mi.P, mi.B, mi.TOP, mi.BOTTOM, mi.FRAME
    gop = mi.gop_plan
    return {
        "field_dct": [gop("IPBBP", lambda i: FRAME, rng, modes=["intra", "frame", "zero"])],
        "field_motion": [gop("IPBBPBBP", lambda i: FRAME, rng, modes=["field"])],
        "dual_prime_frame": [gop("IPPP", lambda i: FRAME, rng, modes=["dmv"])],
        "fields_top_first": [gop("IBBPBBP", lambda i: TOP, rng, modes=["intra", "field"])],
        "fields_bottom_first": [gop("IBBPBBP", lambda i: BOTTOM, rng,
                                    modes=["intra", "field"])],
        "field_16x8": [gop("IPBBP", lambda i: TOP, rng, modes=["16x8"])],
        "dual_prime_field": [gop("IPPP", lambda i: BOTTOM, rng, modes=["dmv"])],
        "ip_pair_at_start": [gop("IPPBBP", lambda i: "IP" if i == 0 else TOP, rng)],
        "ip_pair_later": [gop("IPBBP", lambda i: BOTTOM, rng),
                          gop("IPBBP", lambda i: "IPb" if i == 0 else BOTTOM, rng,
                              first=False)],
        "skipped": [gop("IPBBPBBP", lambda i: TOP if i % 2 else FRAME, rng,
                        modes=["field", "frame", "zero"])],
        "concealment": [gop("IPBBP", lambda i: TOP, rng, concealment=1)],
        "mixed": [gop("IBBPBBPBBP", lambda i: (FRAME, TOP, BOTTOM)[i % 3], rng,
                      intra_vlc=1, alternate=1, q_scale_type=1, dc_precision=2)],
    }[name]


FEATURES = {  # case -> what the port's syntax must show
    "field_dct": {"field_dct"}, "field_motion": {"motion_field"},
    "dual_prime_frame": {"motion_dmv"}, "fields_top_first": {"field_picture"},
    "fields_bottom_first": {"field_picture"}, "field_16x8": {"motion_16x8"},
    "dual_prime_field": {"motion_dmv", "field_picture"}, "ip_pair_at_start": {"field_picture"},
    "ip_pair_later": {"field_picture"}, "skipped": {"skipped", "field_picture"},
    "concealment": {"concealment_motion_vectors", "field_picture"},
    "mixed": {"field_picture", "intra_vlc_format", "alternate_scan"},
}


def _coded(mi, tmp_path, name, ext=".avi", seed=0):
    mi.crafted(tmp_path, name, SMALL, 25.0, (25, 1), lambda rng: _plan(mi, name, rng), seed,
               [ext], tmp_path)
    return tmp_path / f"{name}{ext}"


@pytest.mark.parametrize("name", sorted(FEATURES))
def test_feature_matches_ffmpeg(name, tmp_path):
    """A stream of one feature, coded here into an AVI: the port's planes
    equal FFmpeg's at every sample of every frame, its rate and count cv2's,
    and the port's syntax shows the feature."""
    cv2 = pytest.importorskip("cv2")
    mi = _script("make_mpeg2i_fixtures")
    path = _coded(mi, tmp_path, name, seed=sorted(FEATURES).index(name))
    want = mi.ffmpeg_planes(path)
    video = VideoFile(str(path))
    video.syntax_log = []
    got = list(video.planes())
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        for k in range(3):
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{name} frame {i} plane {k}")
    cap = cv2.VideoCapture(str(path))
    assert (video.fps, video.frame_count) == (cap.get(cv2.CAP_PROP_FPS),
                                              cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    used = set().union(*(s.used for s in video.syntax_log))
    assert FEATURES[name] <= used, used
    if name == "ip_pair_at_start":
        kinds = [(s.pic.kind, s.pic.picture_structure) for s in video.syntax_log[:2]]
        assert kinds == [(1, 1), (2, 2)]
    if name == "skipped":  # skipped macroblocks in field pictures too
        assert any("skipped" in s.used and s.pic.picture_structure != 3
                   for s in video.syntax_log)


CONTAINERS = [(s, ext) for s in ("fields_top_first", "field_motion")
              for ext in (".vob", ".ts", ".m2ts", ".mkv")]


@pytest.mark.parametrize("case", CONTAINERS, ids=lambda c: f"{c[0]}{c[1]}")
def test_counts_and_rates_match_cv2(case, tmp_path):
    """Field and interlaced frame pictures in each container: the port's fps
    and count equal cv2's (a program stream's from its packs' stamps) and
    its frames FFmpeg's."""
    cv2 = pytest.importorskip("cv2")
    mi = _script("make_mpeg2i_fixtures")
    name, ext = case
    path = _coded(mi, tmp_path, name, ext, seed=7)
    video = VideoFile(str(path))
    cap = cv2.VideoCapture(str(path))
    assert (video.fps, video.frame_count) == (cap.get(cv2.CAP_PROP_FPS),
                                              cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    want = mi.ffmpeg_planes(path)
    got = list(video.planes())
    assert [_yuv_sha(p) for p in got] == [_yuv_sha(p) for p in want]


def test_a_long_program_stream_opens_in_its_analysis_time(tmp_path, monkeypatch):
    """A 5.4-minute program stream (``fields_tff.vob``'s 13 frames 625 times
    over, 8 MB): its rate's parse stops where FFmpeg's analysis does (7 s of
    packets), so the open reads the file once and parses 7 s of it, where a
    parse of every packet against every start code took 28 s; fps and count
    are cv2's."""
    cv2 = pytest.importorskip("cv2")
    mi = _script("make_mpeg2i_fixtures")
    path = tmp_path / "long.vob"
    mi.long_program_stream(path, ProgramStream(str(FIXTURES / "fields_tff.vob")).es, 625)
    cut = []
    packet = mpegrate._Parser._packet

    def counted(self, *args):
        cut.append(args[0])
        return packet(self, *args)

    monkeypatch.setattr(mpegrate._Parser, "_packet", counted)
    t0 = time.perf_counter()
    stream = ProgramStream(str(path))
    seconds = time.perf_counter() - t0
    cap = cv2.VideoCapture(str(path))
    assert (stream.fps, stream.frame_count) == (cap.get(cv2.CAP_PROP_FPS),
                                                cap.get(cv2.CAP_PROP_FRAME_COUNT)) == (25.0, 8122)
    cap.release()
    assert 7 * 25 < len(cut) <= 7 * 25 + 8  # 7 s of 25 fps packets, one PES packet's ahead
    assert seconds < 8, seconds


def _unstamped(data, starts, k):
    """The file's bytes with the time stamps of the video PES packets at
    ``starts[:k]`` (a pack's PES, or the transport packet that opens it)
    made stuffing (MPEG-2 headers) or taken out (MPEG-1)."""
    d = bytearray(data)
    for pos in starts[:k]:
        j = data.find(b"\x00\x00\x01", pos) + 6
        while d[j] == 0xFF:
            j += 1
        if d[j] & 0xC0 == 0x40:  # STD buffer scale and size
            j += 2
        if d[j] & 0xC0 == 0x80:
            n = d[j + 2]
            d[j + 1] &= 0x3F
            d[j + 3:j + 3 + n] = b"\xff" * n
        elif d[j] & 0xE0 == 0x20:
            n = 10 if d[j] & 0x10 else 5
            d[j:j + n] = b"\xff" * (n - 1) + b"\x0f"
    return bytes(d)


# twin.mpg's two stamped PES packets: with none left cv2 counts by the bit rate
UNSTAMPED = [(src, k) for src in ("mpeg12/short.mpg", "mpeg12/gops.mpg", "mpeg2i/flagship.vob",
                                  "mpeg2i/mixed.vob", "mpeg2i/telecine.vob",
                                  "mpeg2i/fields_tff.ts")
             for k in (1, 3)] + [("mpeg12/twin.mpg", 1)]


@pytest.mark.parametrize("case", UNSTAMPED, ids=lambda c: f"{c[0]}-{c[1]}")
def test_counts_and_rates_without_the_first_stamps_match_cv2(case, tmp_path):
    """A stream whose first ``k`` video PES packets carry no time stamp:
    FFmpeg stamps the packets before the first stamp relative to it and
    takes the stream's start from them once it arrives; the port's fps and
    count equal cv2's (MPEG-1 and MPEG-2, frame and field pictures, soft
    telecine, program and transport streams)."""
    cv2 = pytest.importorskip("cv2")
    source, k = case
    src = REPO / "tests" / "data" / source
    stream = VideoFile(str(src)).container
    stamped = [pos for pos, (pts, _) in zip(stream.starts, stream.payloads) if pts is not None]
    path = tmp_path / src.name
    path.write_bytes(_unstamped(src.read_bytes(), stamped, k))
    cap = cv2.VideoCapture(str(path))
    want = cap.get(cv2.CAP_PROP_FPS), cap.get(cv2.CAP_PROP_FRAME_COUNT)
    cap.release()
    video = VideoFile(str(path))
    assert (video.fps, video.frame_count) == want


def test_a_stream_without_stamps_is_refused(tmp_path):
    """With no stamp left (``twin.mpg``'s two stamped PES packets cleared)
    cv2 counts by the bit rate, which the port does not emulate: refused
    naming ROADMAP item 4."""
    src = REPO / "tests" / "data" / "mpeg12" / "twin.mpg"
    stream = ProgramStream(str(src))
    stamped = [pos for pos, (pts, _) in zip(stream.starts, stream.payloads) if pts is not None]
    path = tmp_path / src.name
    path.write_bytes(_unstamped(src.read_bytes(), stamped, len(stamped)))
    with pytest.raises(ValueError, match="(?s)with no PTS .*item 4"):
        VideoFile(str(path))


# -------------------------------------------------------- telecine sweep

PULLDOWN = ((1, 1), (0, 0), (0, 1), (1, 0))
CADENCES = {f"pulldown{k}": (lambda k: lambda i: PULLDOWN[(i + k) % 4])(k) for k in range(4)}
CADENCES.update(alternate=lambda i: (1, i % 2), every=lambda i: (1, 1),
                first_only=lambda i: (1, int(i == 0)))
# cv2's clips whose interlaced macroblock grid is their progressive one
# (small.mpg's 48 rows are 3 macroblock rows, an interlaced grid's 4: see the
# refusals)
SOURCES = ("twin.mpg", "twin.vob", "twin.ts", "twin.m2ts", "twin.avi", "twin.mkv", "gops.mpg",
           "ntsc.mpg", "flat.mpg", "portrait.mpg")
SWEEP = [(src, cad) for src in SOURCES for cad in sorted(CADENCES)]


@pytest.mark.parametrize("case", SWEEP, ids=lambda c: f"{c[0]}-{c[1]}")
def test_telecine_rate_and_count_match_cv2(case, tmp_path):
    """cv2's clip with soft telecine patched in (an interlaced sequence of
    progressive frames, ``repeat_first_field`` and ``top_field_first`` by
    the cadence): the port's fps and frame count are cv2's, and its
    ``VideoReader``'s stamps, frame count and frames the JAX reader's over
    cv2."""
    cv2 = pytest.importorskip("cv2")
    mf = _script("make_mpeg12_fixtures")
    source, cadence = case
    order = CADENCES[cadence]

    def change(f, i):
        if f["kind"] == "sequence_extension":
            f["progressive_sequence"] = 0
        if f["kind"] == "picture_extension":
            f["progressive_frame"] = 1
            f["top_field_first"], f["repeat_first_field"] = order(i)

    path = tmp_path / source
    path.write_bytes(mf.patch_file((REPO / "tests" / "data" / "mpeg12" / source).read_bytes(),
                                   change))
    cap = cv2.VideoCapture(str(path))
    fps, count = cap.get(cv2.CAP_PROP_FPS), cap.get(cv2.CAP_PROP_FRAME_COUNT)
    cap.release()
    video = VideoFile(str(path))
    assert (video.fps, video.frame_count) == (fps, count), case
    reader, want = VideoReader((180, 240)), JaxVideoReader((180, 240))
    reader.initialize(str(path))
    want.initialize(str(path))
    assert want.num_frames > 0
    assert (reader.num_frames, reader.timestamps) == (want.num_frames, want.timestamps)
    assert [_sha(f) for f in reader.frames] == [_sha(f) for f in want.frames]


# ------------------------------------------------------------ refusals

def _es(name):
    return ProgramStream(str(REPO / "tests" / "data" / name)).es


def _units(es):
    mf = _script("make_mpeg12_fixtures")
    return mf, mf.units(es)


def _lone_last_field(es):
    """The stream without its last field picture (and the end code)."""
    _, us = _units(es)
    pics = [k for k, u in enumerate(us) if u[3] == 0x00]
    return b"".join(us[:pics[-1]])


def _same_parity(es):
    """Every field picture made a top field."""
    mf, _ = _units(es)

    def change(f, i):
        if f["kind"] == "picture_extension" and f["picture_structure"] != 3:
            f["picture_structure"] = 1
    return mf.rewrite(es, change)


def _chroma_422(es):
    mf, _ = _units(es)

    def change(f, i):
        if f["kind"] == "sequence_extension":
            f["chroma_format"] = 2
    return mf.rewrite(es, change)


def _same_parity_at_start(es):
    """The stream's I/P pair's P-field made to predict its zero-vector and
    skipped macroblocks from its own parity: its frame is the stream's first,
    so there is no earlier field of that parity (FFmpeg reads the field being
    decoded)."""
    mf, us = _units(es)
    # the second picture's macroblocks: a P-field whose every macroblock is a
    # zero-vector one (type '1' 0 vector in a P-field predicts from its own parity)
    pics = [k for k, u in enumerate(us) if u[3] == 0x00]
    head = us[:pics[1]]
    field = [u for u in us[pics[1]:pics[2]] if not 0x01 <= u[3] <= 0xAF]
    rows = [u for u in us[pics[1]:pics[2]] if 0x01 <= u[3] <= 0xAF]
    mi = _script("make_mpeg2i_fixtures")
    t = mi.tables()
    slices = []
    for u in rows:  # q 4, no extra info; macroblocks: increment '1', type 'P no MC coded'
        w = mi.Bits()
        w.put(5, 4)
        w.put(1, 0)
        for col in range(11):  # 176 / 16 macroblocks a row
            w.code(t.MB_ADDR_INCR[0])  # increment 1
            w.code(t.MB_PTYPE[t.PTYPE_FLAGS.index(mi.PATTERN | mi.ZERO | mi.FORWARD)])
            w.code(t.CBP[60])  # blocks 0-3
            for _ in range(4):
                w.put(2, 2)  # '1s' level 1, then end of block '10'
                w.put(2, 2)
        slices.append(u[:4] + w.bytes())
    return b"".join(head + field + slices + us[pics[2]:])


def _interlaced(es):
    """The sequence made interlaced, its frame pictures kept as they are."""
    mf, _ = _units(es)

    def change(f, i):
        if f["kind"] == "sequence_extension":
            f["progressive_sequence"] = 0
    return mf.rewrite(es, change)


REFUSALS = {
    "lone_field": ("mpeg2i/fields_tff.vob", _lone_last_field,
                   "field picture without its second"),
    "two_top_fields": ("mpeg2i/fields_tff.vob", _same_parity, "two field pictures of one parity"),
    "fields_422": ("mpeg2i/fields_tff.vob", _chroma_422, "4:2:2"),
    "own_parity_at_start": ("mpeg2i/fields_tff.vob", _same_parity_at_start,
                            "its own parity with no earlier reference"),
    # 48 rows made interlaced: 4 macroblock rows, of which the stream codes 3
    # (FFmpeg conceals the last, in the cropped area; real encoders code it)
    "missing_row": ("mpeg12/small.mpg", _interlaced, "coded by no slice"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_name_item_4(case):
    """What the decoder still does not read of interlaced MPEG-2 (4:2:2, a
    field without its pair, corrupt field pairs, a P-field predicting from a
    field the stream has not given, a macroblock row no slice codes) raises
    naming it and ROADMAP item 4."""
    source, make, text = REFUSALS[case]
    dec = Mpeg12Decoder(case)
    with pytest.raises(ValueError, match=f"(?s){text}.*item 4"):
        dec.decode(make(_es(source)))
        dec.flush()
