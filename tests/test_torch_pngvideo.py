"""The port's readers over PNG video (``utils/rawvideo.py::png_to_bgr`` on
``utils/image_io.decode_png``, MPNG in AVI, ``png `` in MOV, ``mp4v`` of
object type 0x6D in MP4, ``V_MS/VFW/FOURCC`` in Matroska, behind
``utils/video.VideoFile``, ``data/video_readers.VideoReader`` and
``data/manifests.VideoSequence``) against cv2 and the JAX package's readers,
on the fixtures of ``tests/data/pngvideo``
(``scripts/make_rawvideo_fixtures.py``):

- every clip, the 960x720 flagship among them, through ``VideoFile`` and
  both readers equals the records (cv2's fps, count, BGR and gray frames;
  the JAX readers' frames, stamps and hashes), with no cv2 needed;
- the records are what cv2 and the JAX readers return;
- a PNG video frame's BGR is ``cv2.imdecode``'s and its gray is
  ``cvtColor``'s, which is not ``cv2.imread``'s libpng gray;
- every colour type and depth up to 8 bits, with ``gAMA``, ``sRGB`` and
  ``tRNS``, against cv2; 16-bit and Adam7 frames are refused.

The flagship is decoded once per process.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from v2e2v_tpu_torch.utils import image_io, rawvideo, yuv
from v2e2v_tpu_torch.utils.video import VideoFile

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "data" / "pngvideo"


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


RAW = _module("test_torch_rawvideo", REPO / "tests" / "test_torch_rawvideo.py")
FX = RAW.FX
MANIFEST = RAW.json.loads((FIXTURES / "manifest.json").read_text())["clips"]
CLIPS = sorted(MANIFEST)
_BGR: dict = {}  # the path -> the port's BGR frames: the flagship once a process


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
    """Each PNG-video clip through the port against cv2's frames and the JAX
    readers' records."""
    RAW.clip_against_records(FIXTURES, MANIFEST, name)


@pytest.mark.parametrize("name", CLIPS)
def test_records_match_cv2_and_the_jax_readers(name):
    RAW.records_against_cv2(FIXTURES, MANIFEST, name)


def test_fixtures_cover_every_container():
    """MPNG in AVI, ``png `` in MOV, object type 0x6D in MP4, MPNG and PNG1
    in Matroska's VFW track, the flagship at 960x720, every colour type."""
    fourccs = {n: VideoFile(str(FIXTURES / n)).container for n in CLIPS}
    assert fourccs["png.mov"].fourcc == b"png "
    assert (fourccs["png.mp4"].fourcc, fourccs["png.mp4"].object_type) == (b"mp4v", 0x6D)
    assert fourccs["mpng.mkv"].track.codec_id == "V_MS/VFW/FOURCC"
    assert fourccs["png1.mkv"].config[16:20] == b"PNG1"
    assert MANIFEST["flagship.avi"]["shape"] == [720, 960]
    assert MANIFEST["flagship.avi"]["frames_read"] == 12
    types = [image_io.decode_png(p) for p in VideoFile(str(FIXTURES / "types.avi")).packets()]
    assert {(t.color, t.depth) for t in types} == {(0, 1), (0, 2), (0, 4), (0, 8), (2, 8),
                                                   (3, 4), (3, 8), (4, 8), (6, 8)}


@pytest.mark.parametrize("name", ["mpng.avi", "flagship.avi", "types.avi"])
def test_gray_is_cvtcolor_not_imread(name, shared_bgr):
    """A PNG video frame's BGR is ``cv2.imdecode``'s of its packet (FFmpeg's
    png decoder and swscale give the samples unchanged) and its gray is
    ``cvtColor``'s 15-bit one; ``cv2.imread(..., IMREAD_GRAYSCALE)``'s libpng
    gray, which ``image_io.decode_gray`` gives, differs on some frames."""
    cv2 = pytest.importorskip("cv2")
    video = VideoFile(str(FIXTURES / name))
    differ = 0
    for packet, bgr, gray in zip(video.packets(), video.bgr(), video, strict=True):
        decoded = cv2.imdecode(np.frombuffer(packet, np.uint8), cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(bgr, decoded)
        np.testing.assert_array_equal(gray, cv2.cvtColor(decoded, cv2.COLOR_BGR2GRAY))
        still = image_io.decode_gray(packet)
        np.testing.assert_array_equal(still, cv2.imdecode(np.frombuffer(packet, np.uint8),
                                                          cv2.IMREAD_GRAYSCALE))
        differ += not np.array_equal(still, gray)
    assert differ > 0


def _adam7(samples, color):
    """``samples`` as an interlaced (Adam7) 8-bit PNG, filter None."""
    h, w = samples.shape[:2]
    raw = b""
    for x0, y0, dx, dy in image_io._ADAM7:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            rows = sub.reshape(sub.shape[0], -1)
            raw += np.concatenate([np.zeros((rows.shape[0], 1), np.uint8), rows], 1).tobytes()
    import zlib
    return (image_io.PNG_SIGNATURE
            + FX._png_chunk(b"IHDR", FX.struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 1))
            + FX._png_chunk(b"IDAT", zlib.compress(raw)) + FX._png_chunk(b"IEND", b""))


def _with_chunk(png, kind, body):
    at = png.index(b"IDAT") - 4
    return png[:at] + FX._png_chunk(kind, body) + png[at:]


CASES = ["types", "gamma", "srgb", "trns"]


@pytest.mark.parametrize("case", CASES)
def test_colour_types_and_chunks_match_cv2(tmp_path, case):
    """Every colour type and depth up to 8 bits (gray scaled to 8 bits, a
    palette looked up, alpha dropped), and chunks FFmpeg does not apply to
    a video frame (``gAMA`` 0.45455, ``sRGB``, ``tRNS``), at odd sizes, in
    an MPNG AVI against ``cap.read()``."""
    pytest.importorskip("cv2")
    rng = np.random.default_rng(CASES.index(case))
    h, w = 7, 13
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    packets = {
        "types": FX.png_types(rng, h, w),
        "gamma": [_with_chunk(FX.png_bytes(rgb, 2), b"gAMA", FX.struct.pack(">I", 45455))],
        "srgb": [_with_chunk(FX.png_bytes(rgb, 2), b"sRGB", b"\0")],
        "trns": [_with_chunk(FX.png_bytes(rgb, 2), b"tRNS", bytes(6))],
    }[case]
    path = tmp_path / f"{case}.avi"
    FX.write_avi(path, packets + packets[:1], w, h, 30, b"MPNG", 24)
    want = FX.cv2_frames(path)[0]
    got = list(VideoFile(str(path)).bgr())
    assert len(got) == len(want) == len(packets) + 1
    for g, c in zip(got, want):
        np.testing.assert_array_equal(g, c)
    for g, c in zip(VideoFile(str(path)), want):
        np.testing.assert_array_equal(g, yuv.bgr_to_gray(c))


@pytest.mark.parametrize("color", [0, 2])
def test_adam7_frames_raise(tmp_path, color):
    """An interlaced (Adam7) PNG frame: FFmpeg marks the frame interlaced and
    swscale refuses to convert it, so cv2 returns its buffer's old contents
    (the progressive frame before it, here). The port refuses the frame,
    naming ROADMAP item 4."""
    pytest.importorskip("cv2")
    rgb = np.random.default_rng(color).integers(0, 256, (7, 13, 3), dtype=np.uint8)
    first = FX.png_bytes(rgb[..., :1] if color == 0 else rgb, color)
    path = tmp_path / "adam7.avi"
    FX.write_avi(path, [first, _adam7(rgb[..., :1] if color == 0 else rgb, color)], 13, 7, 30,
                 b"MPNG", 24)
    want = FX.cv2_frames(path)[0]
    assert len(want) == 2 and np.array_equal(want[1], want[0])  # the stale buffer
    with pytest.raises(ValueError, match="(?s)interlaced \\(Adam7\\) PNG video frame.*item 4"):
        list(VideoFile(str(path)))


def test_16_bit_and_resized_frames_raise(tmp_path):
    """16-bit PNG frames (swscale dithers them to 8 bits) and a frame of
    another size than the stream's raise naming ROADMAP item 4."""
    rgb16 = np.random.default_rng(0).integers(0, 1 << 16, (4, 6, 3)).astype(">u2")
    packet = (image_io.PNG_SIGNATURE
              + FX._png_chunk(b"IHDR", FX.struct.pack(">IIBBBBB", 6, 4, 16, 2, 0, 0, 0))
              + FX._png_chunk(b"IDAT", __import__("zlib").compress(
                  np.concatenate([np.zeros((4, 1), np.uint8),
                                  rgb16.reshape(4, -1).view(np.uint8)], 1).tobytes()))
              + FX._png_chunk(b"IEND", b""))
    FX.write_avi(tmp_path / "deep.avi", [packet] * 2, 6, 4, 30, b"MPNG", 48)
    with pytest.raises(ValueError, match="(?s)16-bit PNG video frame.*item 4"):
        list(VideoFile(str(tmp_path / "deep.avi")))
    small = FX.png_bytes(np.zeros((4, 6, 3), np.uint8), 2)
    FX.write_avi(tmp_path / "sized.avi", [small] * 2, 8, 4, 30, b"MPNG", 24)
    with pytest.raises(ValueError, match="(?s)a 4x6 frame in a 4x8 track.*item 4"):
        list(VideoFile(str(tmp_path / "sized.avi")))
    with pytest.raises(ValueError, match="16-bit"):
        rawvideo.png_to_bgr(packet)
