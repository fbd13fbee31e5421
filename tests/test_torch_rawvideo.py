"""The port's readers over raw video and over its decoders' other tags and
containers (``utils/rawvideo.py::raw_to_bgr``, the tag tables of
``avi.py``, ``mp4.py`` and ``mkv.py``, behind ``utils/video.VideoFile``,
``data/video_readers.VideoReader`` and ``data/manifests.VideoSequence``)
against cv2 and the JAX package's readers, on the fixtures of
``tests/data/rawvideo`` (``scripts/make_rawvideo_fixtures.py``):

- every clip through ``VideoFile`` and both readers equals the records
  (cv2's fps, count, BGR and gray frames; the JAX readers' frames, stamps
  and hashes); this needs no cv2, so it runs on the card's machine too;
- the records are what cv2 and the JAX readers return;
- Y800/GREY rows at FFmpeg's stride on widths of each residue mod 4, raw
  4:2:0 and RGBA at random odd sizes from 1 x 1, and packets of every
  length, against cv2 on files written byte by byte;
- what is still refused (WMV, MS-MPEG-4 and ZyGo's H.263 among it) raises
  naming ROADMAP item 4.
"""

import hashlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from v2e2v_tpu_torch.data.manifests import VideoSequence
from v2e2v_tpu_torch.data.video_readers import VideoReader
from v2e2v_tpu_torch.utils import rawvideo
from v2e2v_tpu_torch.utils.video import VideoFile

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "data" / "rawvideo"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())["clips"]
CLIPS = sorted(MANIFEST)


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _script(name="make_rawvideo_fixtures"):
    sys.path.insert(0, str(REPO / "scripts"))
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FX = _script()
WF = _script("make_wmv_fixtures")


def clip_against_records(folder: Path, manifest: dict, name: str) -> None:
    """``name`` under ``folder`` through ``VideoFile`` (fps, count, gray
    frames, and BGR frames where it has them) and the port's readers
    against ``manifest.json`` and ``reader_frames.npz``."""
    want = manifest[name]
    path = str(folder / name)
    video = VideoFile(path)
    assert video.codec == want["codec"]
    assert (video.fps, video.frame_count) == (want["fps"], want["frame_count"])
    if video.codec != "mjpeg":
        assert [_sha(f) for f in video.bgr()] == want["cv2_sha256"]
    assert [_sha(f) for f in video] == want["gray_sha256"]
    reader = VideoReader((720, 960), ds=(0.25, 0.25))
    reader.initialize(path)
    assert reader.num_frames == want["frames_read"]
    assert reader.timestamps == want["timestamps"]
    assert [_sha(f) for f in reader.frames] == want["reader_sha256"]
    np.testing.assert_array_equal(np.stack(reader.frames),
                                  np.load(folder / "reader_frames.npz")[want["frames"]])
    pairs = list(VideoSequence(path))
    full = [pairs[0][0]] + [p[1] for p in pairs]
    assert [_sha(f) for f in full] == want["sequence_sha256"]
    assert list(full[0].shape) == want["shape"]


def records_against_cv2(folder: Path, manifest: dict, name: str) -> None:
    """The records of ``name`` are what cv2 and the JAX readers return now."""
    cv2 = pytest.importorskip("cv2")
    from v2e2v_tpu.data.manifests import VideoSequence as JaxSequence
    from v2e2v_tpu.data.video_readers import VideoReader as JaxReader

    want = manifest[name]
    path = str(folder / name)
    frames, fps, count = FX.cv2_frames(Path(path))
    assert (fps, count) == (want["fps"], want["frame_count"])
    assert [_sha(f) for f in frames] == want["cv2_sha256"]
    assert [_sha(cv2.cvtColor(f, cv2.COLOR_BGR2GRAY)) for f in frames] == want["gray_sha256"]
    ref = JaxReader((720, 960), ds=(0.25, 0.25))
    ref.initialize(path)
    assert [_sha(f) for f in ref.frames] == want["reader_sha256"]
    pairs = list(JaxSequence(path))
    assert [_sha(f) for f in [pairs[0][0]] + [p[1] for p in pairs]] == want["sequence_sha256"]


@pytest.mark.parametrize("name", CLIPS)
def test_fixtures_match_records(name):
    """Each clip (MJPEG, MPEG-4, VP8 and VP9 under their other tags and
    containers; raw I420, IYUV, YV12, Y800, GREY and RGBA in AVI, MOV and
    Matroska, cv2's and crafted) through the port against cv2's frames and
    the JAX readers' records."""
    clip_against_records(FIXTURES, MANIFEST, name)


@pytest.mark.parametrize("name", CLIPS)
def test_records_match_cv2_and_the_jax_readers(name):
    records_against_cv2(FIXTURES, MANIFEST, name)


def test_fixtures_cover_what_they_are_there_for():
    """Every tag and container of the slice, each raw layout, each residue
    of a Y800 width mod 4, a short, a long and an empty packet."""
    codecs = {n: e["codec"] for n, e in MANIFEST.items()}
    assert {codecs[n] for n in ("cjpg.avi", "ljpg.avi", "jpgl.avi", "mjpa.avi", "jpeg.mov",
                                "mjpa.mov", "mjpg.mp4")} == {"mjpeg"}
    assert {codecs[n] for n in ("mp4s.avi", "m4s2.avi", "xvid.mov", "divx.mov")} == {"mpeg4"}
    assert (codecs["vp80.avi"], codecs["vp90.avi"], codecs["vp09.mp4"]) == ("vp8", "vp9", "vp9")
    assert {n for n, c in codecs.items() if c == "raw"} >= {
        "i420.avi", "iyuv.avi", "yv12.avi", "y800.avi", "grey.avi", "rgba.avi", "rgba.mov",
        "i420.mkv", "yv12.mkv", "y800.mkv", "rgba.mkv", "y800_w130.avi", "y800_w130.mkv"}
    assert {int(n[6:8]) % 4 for n in codecs if n.startswith("y800_w6")} == {0, 1, 2, 3}
    assert MANIFEST["i420_short.avi"]["frames_read"] == 3  # the fourth packet is short
    assert MANIFEST["i420_short.avi"]["frame_count"] == 4
    assert MANIFEST["i420_dropped.avi"]["frames_read"] == 3
    xvid = VideoFile(str(FIXTURES / "xvid.mov"))
    assert xvid.container.config[:4] == b"\x00\x00\x01\xb0"  # the VOL headers from 'glbl'
    assert not next(xvid.packets()).startswith(b"\x00\x00\x01\xb0")


# ------------------------------------------------ against cv2, crafted

def _cv2_bgr(path):
    return FX.cv2_frames(Path(path))[0]


@pytest.mark.parametrize("residue", [0, 1, 2, 3])
def test_y800_stride_matches_cv2(tmp_path, residue):
    """Y800 and GREY packets at widths of ``residue`` mod 4, at random
    heights, of 4:2:0 size (as cv2 writes them), of W x H bytes and a few
    bytes more: FFmpeg reads the rows at the width rounded up to 4 where
    that many rows fit in the packet, else at the width."""
    pytest.importorskip("cv2")
    rng = np.random.default_rng(residue)
    for k in range(6):
        w = residue + 4 * int(rng.integers(0, 12)) or 4
        h = int(rng.integers(1, 20))
        n = {0: w * h + 2 * ((w + 1) // 2) * ((h + 1) // 2), 1: w * h, 2: w * h + 3}[k % 3]
        packets = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for _ in range(2)]
        path = tmp_path / f"y{k}.avi"
        FX.write_avi(path, packets, w, h, 30, b"Y800" if k % 2 else b"GREY", 8)
        want = _cv2_bgr(path)
        got = list(VideoFile(str(path)).bgr())
        assert len(got) == len(want) == 2, (w, h, n)
        for g, c in zip(got, want):
            np.testing.assert_array_equal(g, c, err_msg=f"{w}x{h}, {n} bytes")


@pytest.mark.parametrize("fourcc", ["I420", "IYUV", "YV12", "RGBA"])
def test_raw_odd_sizes_match_cv2(tmp_path, fourcc):
    """Raw 4:2:0 (limited range, centred chroma: swscale's unscaled
    converter at even heights, its general scaler at odd ones) and RGBA at
    random sizes from 1 x 1, odd and even, against ``cap.read()``."""
    pytest.importorskip("cv2")
    rng = np.random.default_rng(sum(fourcc.encode()))
    fmt = rawvideo.FORMATS[fourcc.encode()]
    sizes = [(1, 1), (2, 1), (1, 3)] + [tuple(int(v) for v in rng.integers(1, 70, 2))
                                        for _ in range(7)]
    for k, (w, h) in enumerate(sizes):
        n = rawvideo.frame_size(fmt, w, h)
        packets = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for _ in range(2)]
        path = tmp_path / f"r{k}.avi"
        FX.write_avi(path, packets, w, h, 30, fourcc.encode(), 32 if fmt == "rgba" else 12)
        want = _cv2_bgr(path)
        got = list(VideoFile(str(path)).bgr())
        assert len(got) == len(want) == 2
        for g, c in zip(got, want):
            np.testing.assert_array_equal(g, c, err_msg=f"{fourcc} {w}x{h}")


@pytest.mark.parametrize("fourcc", ["I420", "Y800", "RGBA"])
def test_packet_lengths_as_ffmpeg_reads_them(tmp_path, fourcc):
    """A packet shorter than a frame ends cv2's read there (FFmpeg's
    decoder fails on it), wherever it lies; longer packets are read from
    their start; an empty chunk is skipped by the demuxer."""
    pytest.importorskip("cv2")
    rng = np.random.default_rng(7)
    fmt = rawvideo.FORMATS[fourcc.encode()]
    w, h = 14, 9
    n = rawvideo.frame_size(fmt, w, h)
    for short_at in (0, 2, None):
        packets = [rng.integers(0, 256, n + 5 * k, dtype=np.uint8).tobytes() for k in range(4)]
        if short_at is not None:
            packets[short_at] = packets[short_at][:n - 1 - short_at]
        else:
            packets.insert(1, b"")
        path = tmp_path / f"p{short_at}.avi"
        FX.write_avi(path, packets, w, h, 30, fourcc.encode())
        want = _cv2_bgr(path)
        assert len(want) == {0: 0, 2: 2, None: 4}[short_at]
        got = list(VideoFile(str(path)).bgr())
        assert len(got) == len(want)
        for g, c in zip(got, want):
            np.testing.assert_array_equal(g, c)
        assert len(list(VideoFile(str(path)))) == len(want)


# ------------------------------------------------------------ refusals

def _refused(tmp_path, case):
    cv2 = pytest.importorskip("cv2")
    frames = np.random.default_rng(0).integers(0, 256, (2, 96, 128, 3), np.uint8)
    # (the file cv2 writes, its tag, the tag written over it): the MS-MPEG-4
    # family is read since it came in; what stays refused is retagged so
    h263 = {"mp43": ("clip.avi", "MP43", b"MPG4"), "zygo": ("clip.avi", "ZyGo", None),
            "wmv1": ("clip.wmv", "WMV1", None), "wmv2": ("clip.wmv", "WMV2", b"WMV3"),
            "mp42": ("clip.avi", "MP42", b"MP41"), "div3": ("clip.avi", "DIV3", b"DIV1"),
            "raw_mov": ("clip.mov", "I420", None), "wmv2_mkv": ("clip.mkv", "WMV2", b"WMV3")}
    if case in h263:
        name, fourcc, retag = h263[case]
        path = tmp_path / name
        FX.writer(path, frames, 10.0, fourcc)
        if case != "raw_mov":
            assert len(_cv2_bgr(path)) == 2  # cv2 reads them all
        if retag:
            path.write_bytes(path.read_bytes().replace(fourcc.encode(), retag))
        if case == "wmv1":  # a second video stream: its Stream Properties object twice
            path.write_bytes(WF.second_video_stream(path.read_bytes()))
        return path
    path = tmp_path / f"{case}.avi"
    packet = bytes(rawvideo.frame_size("yuv420p", 16, 8))
    if case == "bi_rgb":  # biCompression 0: bottom-up BGR, which cv2 never writes
        FX.write_avi(path, [bytes(16 * 8 * 3)] * 2, 16, 8, 30, b"\0\0\0\0", 24)
    elif case == "negative_height":
        FX.write_avi(path, [packet] * 2, 16, 8, 30, b"I420")
        data = bytearray(path.read_bytes())
        at = data.index(b"strf") + 16
        data[at:at + 4] = (-8).to_bytes(4, "little", signed=True)
        path.write_bytes(bytes(data))
    elif case == "yuy2_mkv":
        path = tmp_path / "clip.mkv"
        FX.writer(path, frames, 10.0, "I420")
        data = path.read_bytes()
        path.write_bytes(data.replace(b"I420", b"YUY2"))
    elif case == "vpcc_full_range":
        path = tmp_path / "clip.mp4"
        path.write_bytes((FIXTURES / "vp09.mp4").read_bytes())
        data = bytearray(path.read_bytes())
        at = data.index(b"vpcC") + 4 + 6
        data[at] |= 1
        path.write_bytes(bytes(data))
    elif case == "jpeg_fields":
        path = tmp_path / "clip.mov"
        mf = _script("make_mpeg4_fixtures")
        data = (FIXTURES / "jpeg.mov").read_bytes()
        fiel = b"\x00\x00\x00\x0afiel\x02\x06"  # two fields, bottom first
        places = [mf.find(data, box)[0] for box in (b"moov", b"trak", b"mdia", b"minf",
                                                   b"stbl", b"stsd", b"jpeg")]
        at = places[-1] + 8 + 78  # past the VisualSampleEntry's fields
        data = bytearray(data[:at] + fiel + data[at:])
        for k in places:
            data[k:k + 4] = (int.from_bytes(data[k:k + 4], "big") + len(fiel)).to_bytes(4, "big")
        path.write_bytes(bytes(data))
    return path


REFUSALS = {"mp43": "codec 'MPG4'", "zygo": "codec 'ZyGo'", "wmv1": "more than one video",
            "wmv2": "codec 'WMV3'", "mp42": "codec 'MP41'", "div3": "codec 'DIV1'",
            "raw_mov": "codec 'raw '", "wmv2_mkv": "names 'WMV3'", "bi_rgb": r"x00' \(biCompression\)", "negative_height":
            "negative height", "yuy2_mkv": "layout 'YUY2'", "vpcc_full_range": "full range 1",
            "jpeg_fields": "two fields"}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_what_it_does_not_read_raises(tmp_path, case):
    """What the port still refuses of the H.263 family: cv2's MS-MPEG-4 v2
    and v3 AVIs (MP42, DIV3, MP43) retagged as MS-MPEG-4 v1 (MP41, DIV1,
    MPG4), its WMV2 in ASF and Matroska retagged WMV3 (VC-1), its WMV1 ASF
    given a second video stream, and H.263 under ZyGo, whose I pictures
    FFmpeg reads a debug dump into,
    and the raw and container cases the port leaves
    (QuickTime 'raw ', which cv2 reads as no frame; BI_RGB; a negative
    height; a Matroska layout it does not know; a ``vpcC`` of full range; an
    MJPEG MOV of two fields) raise naming what they are and ROADMAP item 4,
    from both readers."""
    path = str(_refused(tmp_path, case))
    with pytest.raises(ValueError, match=f"(?s){REFUSALS[case]}.*item 4"):
        VideoReader((180, 240)).initialize(path)
    with pytest.raises(ValueError, match="item 4"):
        list(VideoSequence(path))
