"""The port's Matroska / WebM demuxer (``v2e2v_tpu_torch/utils/mkv.py``) and
its place behind ``utils/video.VideoFile`` against cv2, which reads through
FFmpeg's ``matroskadec.c``, on the same files.

Held bit for bit: every clip's packets (cv2's raw mode,
``CAP_PROP_FORMAT = -1``), its ``CAP_PROP_FPS`` and ``CAP_PROP_FRAME_COUNT``
on the fixtures of ``tests/data/mkv`` and on ``DefaultDuration`` and
``Duration`` rewrites, on layouts this file's muxer writes (elements of
unknown size, ``Void``, ``BlockGroup`` blocks, many clusters, audio tracks
before the video one), and MJPEG fields woven by the order FFmpeg takes from
``FieldOrder``. Every refusal names what the file is and ROADMAP item 4.
The fixtures' records are checked without cv2, so that part runs on the
card's machine too.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from v2e2v_tpu_torch.data.manifests import VideoSequence
from v2e2v_tpu_torch.data.video_readers import VideoReader
from v2e2v_tpu_torch.utils.mkv import MkvFile, av_reduce
from v2e2v_tpu_torch.utils.video import VideoFile

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "data" / "mkv"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())["clips"]
CLIPS = sorted(MANIFEST)
READ = [n for n in CLIPS if n != "no_default_duration.webm"]


def _script():
    sys.path.insert(0, str(REPO / "scripts"))
    spec = importlib.util.spec_from_file_location("make_mkv_fixtures",
                                                  REPO / "scripts" / "make_mkv_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FX = _script()


def _raw_packets(cv2, path):
    cap = cv2.VideoCapture(str(path), cv2.CAP_FFMPEG, [cv2.CAP_PROP_FORMAT, -1])
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f.tobytes())
    cap.release()
    return out


def _cv2_rate(cv2, path):
    cap = cv2.VideoCapture(str(path))
    got = cap.get(cv2.CAP_PROP_FPS), cap.get(cv2.CAP_PROP_FRAME_COUNT)
    cap.release()
    return got


# ------------------------------------------------------------ the records

@pytest.mark.parametrize("name", READ)
def test_rate_and_count_match_manifest(name):
    """``fps`` and ``frame_count`` as cv2 reported them when the fixtures
    were written (no cv2 needed), and the codec."""
    want = MANIFEST[name]
    video = VideoFile(str(FIXTURES / name))
    assert (video.fps, video.frame_count) == (want["fps"], want["frame_count"])
    assert video.codec == want["codec"]


def test_fixture_directory_stays_small():
    total = sum(p.stat().st_size for p in FIXTURES.rglob("*") if p.is_file())
    assert total < 1 << 20, total


def test_flagship_twins_hold_one_stream():
    """``flagship.webm`` and ``flagship.mkv`` carry the same VP8 frames, of
    which only the first is a key frame."""
    webm, mkv = MkvFile(str(FIXTURES / "flagship.webm")), MkvFile(str(FIXTURES / "flagship.mkv"))
    assert (webm.doctype, mkv.doctype) == ("WebM", "Matroska")
    frames = list(webm.frames())
    assert frames == list(mkv.frames())
    assert [f[0] & 1 for f in frames] == [0] + [1] * 11
    gop = [f[0] & 1 for f in MkvFile(str(FIXTURES / "gop.webm")).frames()]
    assert [i for i, inter in enumerate(gop) if not inter] == [0, 12, 24]


# ------------------------------------------------------------- against cv2

@pytest.mark.parametrize("name", CLIPS)
def test_demuxer_matches_cv2(name):
    """Each clip's packets equal cv2's raw packets, and its rate and count
    are cv2's, here and in the manifest."""
    cv2 = pytest.importorskip("cv2")
    path = FIXTURES / name
    assert _cv2_rate(cv2, path) == (MANIFEST[name]["fps"], MANIFEST[name]["frame_count"])
    if name == "no_default_duration.webm":
        with pytest.raises(ValueError, match="(?s)without DefaultDuration.*item 4"):
            MkvFile(str(path))
        return
    assert list(MkvFile(str(path)).frames()) == _raw_packets(cv2, path)


TIMINGS = [(33366667, 200.2), (33366667, 10000.0), (41708333, 1001.7), (4166666, 50.0),
           (4166667, 49.99), (142857142, 2001.0), (123456789, 500.5), (40000000, 99.9),
           (1, 0.5), (999999999, 12345.678), (16683333, 250.25), (20000000, 1e-3)]


@pytest.mark.parametrize("default_duration,duration", TIMINGS)
def test_rate_and_count_match_cv2_on_rewritten_timing(tmp_path, default_duration, duration):
    """``DefaultDuration`` (FFmpeg's ``av_reduce`` to terms of 30000 at
    most) and ``Duration`` (microseconds, truncated; the count rounded)
    rewritten on a cv2-written clip give cv2's rate and count; a Duration so
    short that cv2's count goes negative is refused."""
    cv2 = pytest.importorskip("cv2")
    data = (FIXTURES / "ntsc.webm").read_bytes()
    data = FX.set_float(FX.set_uint(data, 0x23E383, default_duration), 0x4489, duration)
    path = tmp_path / "t.webm"
    path.write_bytes(data)
    want = _cv2_rate(cv2, path)
    if want[1] < 0:  # a Duration under OpenCV's 25 microseconds: its count goes negative
        with pytest.raises(ValueError, match="(?s)Duration 0.001.*item 4"):
            MkvFile(str(path))
        return
    mkv = MkvFile(str(path))
    assert (mkv.fps, mkv.frame_count) == want


def test_av_reduce_keeps_exact_fractions_and_limits_terms():
    """FFmpeg's ``av_reduce``: exact where both terms fit, else the closest
    fraction of terms at most the limit (a convergent or semiconvergent)."""
    assert av_reduce(10 ** 9, 33333333, 30000) == (30, 1)
    assert av_reduce(10 ** 9, 33366667, 30000) == (30000, 1001)
    assert av_reduce(10 ** 9, 4166666, 30000) == (240, 1)
    assert av_reduce(6, 4, 30000) == (3, 2)
    rng = np.random.default_rng(0)
    for _ in range(200):
        num, den = (int(v) for v in rng.integers(1, 10 ** 9, 2))
        n, d = av_reduce(num, den, 30000)
        assert 0 < n <= 30000 and 0 < d <= 30000
        x, q = num / den, np.arange(1, 30001)
        p = np.rint(x * q)
        ok = (p > 0) & (p <= 30000)
        assert abs(x - n / d) <= np.abs(x - p[ok] / q[ok]).min() * (1 + 1e-9) + 1e-15


LAYOUTS = {
    "live": dict(live=True, per_cluster=3),
    "one_cluster": dict(per_cluster=100),
    "block_groups": dict(block_extra=FX.uint(0x9B, 33)),
    "audio_first": dict(tracks_first=FX.element(0xAE, FX.uint(0xD7, 2) + FX.uint(0x73C5, 2)
                                                + FX.uint(0x83, 2) + FX.element(0x86, b"A_OPUS"))),
    "matroska_doctype": dict(doctype="matroska"),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_muxer_layouts_match_cv2(tmp_path, layout):
    """``gop.webm``'s frames remuxed with each layout: the same packets and
    rate as cv2 reads them, and the same gray frames."""
    cv2 = pytest.importorskip("cv2")
    src = (FIXTURES / "gop.webm").read_bytes()
    frames = [src[s:e] for s, e in FX.vp8_frames(src)][:9]
    opts = dict(LAYOUTS[layout])
    path = tmp_path / "t.webm"
    FX.write_webm(path, frames, 96, 64, **opts)
    assert list(MkvFile(str(path)).frames()) == _raw_packets(cv2, path) == frames
    video = VideoFile(str(path))
    assert (video.fps, video.frame_count) == _cv2_rate(cv2, path)
    cap = cv2.VideoCapture(str(path))
    for got in video:
        ok, bgr = cap.read()
        assert ok
        np.testing.assert_array_equal(got, cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY))
    assert not cap.read()[0]


@pytest.mark.parametrize("order", [None, 1, 2, 6, 9, 14])
def test_interlaced_mjpeg_field_order_matches_cv2(tmp_path, order):
    """Two MJPEG fields a block: FFmpeg puts the first on the odd rows only
    for ``FlagInterlaced`` 1 with ``FieldOrder`` 6 (bottom field first),
    else on the even rows; the port's gray frames equal cv2's."""
    cv2 = pytest.importorskip("cv2")
    import make_mpeg4_fixtures as mpeg4_fx
    import make_video_fixtures as video_fx

    fields = video_fx.scene(np.random.default_rng(4), 40, 96, 4)
    packets = [mpeg4_fx.avi1(video_fx.imencode(f), 0) for f in fields]
    extra = b"" if order is None else FX.uint(0x9A, 1) + FX.uint(0x9D, order)
    path = tmp_path / "i.mkv"
    FX.write_webm(path, [packets[0] + packets[1], packets[2] + packets[3]], 96, 80,
                  default_duration=40000000, doctype="matroska", codec_id="V_MJPEG",
                  video_extra=extra)
    assert MkvFile(str(path)).bottom_field_first == (order == 6)
    got = list(VideoFile(str(path)))
    cap = cv2.VideoCapture(str(path))
    for g in got:
        ok, bgr = cap.read()
        np.testing.assert_array_equal(g, cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY))
    assert len(got) == 2 and not cap.read()[0]


@pytest.mark.parametrize("fourcc", ["MJPG", "AVI1", "JPEG", "mjpg"])
def test_interlaced_mjpeg_avi_field_order_follows_the_codec_tag(tmp_path, fourcc):
    """In an AVI, FFmpeg takes the fields as bottom first only for the codec
    tag ``MJPG`` exactly; other MJPEG tags weave the first field on the even
    rows. The port's frames equal cv2's for each."""
    cv2 = pytest.importorskip("cv2")
    import make_mpeg4_fixtures as mpeg4_fx
    import make_video_fixtures as video_fx

    fields = video_fx.scene(np.random.default_rng(5), 40, 96, 2)
    packets = [mpeg4_fx.avi1(video_fx.imencode(f), 0) for f in fields]
    path = tmp_path / "i.avi"
    video_fx.write_avi(path, [packets[0] + packets[1]], 96, 80, 30, fourcc=fourcc.encode())
    got = list(VideoFile(str(path)))
    cap = cv2.VideoCapture(str(path))
    ok, bgr = cap.read()
    assert len(got) == 1 and ok
    np.testing.assert_array_equal(got[0], cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY))


# ---------------------------------------------------------------- refusals

def _frames():
    src = (FIXTURES / "gop.webm").read_bytes()
    return [src[s:e] for s, e in FX.vp8_frames(src)][:4]


def _vp9_profile_1():
    """VP9 frames (``tests/data/vp9/gop.webm``, 96x64) whose headers say
    profile 1 (4:2:2, 4:4:0 or 4:4:4), which the port does not decode."""
    spec = importlib.util.spec_from_file_location("make_vp9_fixtures",
                                                  REPO / "scripts" / "make_vp9_fixtures.py")
    vp9fx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(vp9fx)
    packets = list(MkvFile(str(REPO / "tests" / "data" / "vp9" / "gop.webm")).frames())[:4]
    return vp9fx.rewrite(packets, lambda i, h: h.update(profile=1), (96, 64))


def _refused_file(path: Path, case: str) -> None:
    frames = _frames()
    video = lambda **kw: FX.write_webm(path, frames, 96, 64, **kw)  # noqa: E731
    if case == "vp9":  # VP9 is read, but not a profile-1 track
        FX.write_webm(path, _vp9_profile_1(), 96, 64, codec_id="V_VP9")
    elif case in ("avc", "hevc", "av1", "theora", "unknown"):
        video(codec_id={"avc": "V_MPEG4/ISO/AVC", "hevc": "V_MPEGH/ISO/HEVC",
                        "av1": "V_AV1", "theora": "V_THEORA", "unknown": "V_MS/VFW/FOURCC"}[case])
    elif case == "lacing":
        video(lacing=True)
    elif case == "content_encodings":
        video(track_extra=FX.element(0x6D80, FX.element(0x6240, FX.uint(0x5031, 0))))
    elif case == "two_video_tracks":
        video(tracks_extra=FX.element(0xAE, FX.uint(0xD7, 2) + FX.uint(0x83, 1)
                                      + FX.element(0x86, b"V_VP8")))
    elif case == "no_video_track":
        FX.write_webm(path, frames, 96, 64, codec_id="A_OPUS")
        data = path.read_bytes()
        at = data.index(b"\x83\x81\x01") + 2  # TrackType 1 -> 2 (audio)
        path.write_bytes(data[:at] + b"\x02" + data[at + 1:])
    elif case == "block_additions":
        video(block_extra=FX.element(0x75A1, FX.element(0xA6, FX.uint(0xEE, 1)
                                                        + FX.element(0xA5, b"x"))))
    elif case == "stereo":
        video(video_extra=FX.uint(0x53B8, 1))
    elif case == "colour":
        video(video_extra=FX.element(0x55B0, FX.uint(0x55B1, 1)))
    elif case == "full_range_vp8_track":
        video(video_extra=FX.element(0x55B0, FX.uint(0x55B9, 2)))
    elif case == "crop":
        video(video_extra=FX.uint(0x54AA, 2))
    elif case == "no_default_duration":
        video(default_duration=None)
    elif case == "no_duration":
        video()
        path.write_bytes(FX.to_void(path.read_bytes(), 0x4489))
    elif case == "doctype":
        video(doctype="mka2")
    elif case == "truncated":
        video()
        data = path.read_bytes()
        path.write_bytes(data[:len(data) // 2])
    elif case == "bare":
        path.write_bytes(b"\x1a\x45\xdf\xa3" + bytes(60))
    elif case == "size_mismatch":  # cv2 would scale the 96x64 frames to the track's size
        video()
        path.write_bytes(FX.set_uint(path.read_bytes(), 0xB0, 80))


REFUSED = {"vp9": "VP9 video: profile 1", "avc": "H.264", "hevc": "HEVC", "av1": "AV1",
           "theora": "Theora", "unknown": "codec 'V_MS/VFW/FOURCC'", "lacing": "laced block",
           "content_encodings": "ContentEncodings", "two_video_tracks": "2 video tracks",
           "no_video_track": "no video track", "block_additions": "BlockAdditions",
           "stereo": "StereoMode 1", "colour": "Colour values", "full_range_vp8_track":
           "Colour values", "crop": "PixelCrop", "no_default_duration": "without DefaultDuration",
           "no_duration": "without Duration", "doctype": "DocType 'mka2'",
           "truncated": "corrupt or truncated Matroska/WebM", "bare": "Matroska",
           "size_mismatch": "64x96 frame in a 64x80 track"}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_what_it_does_not_read_raises(tmp_path, case):
    """Each refusal raises a ValueError naming what the file holds and
    ROADMAP item 4, from both readers the CLIs and trainers use."""
    path = tmp_path / "r.webm"
    _refused_file(path, case)
    with pytest.raises(ValueError, match=f"(?s){REFUSED[case]}.*item 4"):
        VideoReader((180, 240)).initialize(str(path))
    with pytest.raises(ValueError, match="item 4"):
        list(VideoSequence(str(path)))


def test_unknown_elements_and_crc_are_skipped(tmp_path):
    """Elements the demuxer does not know, ``CRC-32`` and ``Void`` in a
    cluster and in the track leave the packets as they are."""
    cv2 = pytest.importorskip("cv2")
    frames = _frames()
    path = tmp_path / "u.webm"
    FX.write_webm(path, frames, 96, 64, track_extra=FX.element(0xBF, bytes(4))
                  + FX.element(0x536E, b"name") + FX.element(0xEC, bytes(5)),
                  video_extra=FX.uint(0x54B0, 96) + FX.uint(0x54BA, 64))
    assert list(MkvFile(str(path)).frames()) == _raw_packets(cv2, path) == frames
