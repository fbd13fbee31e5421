"""The port's readers over VP9 video in WebM and Matroska
(``utils/vp9dec.py`` through ``utils/video.VideoFile``,
``data/video_readers.VideoReader`` and ``data/manifests.VideoSequence``)
against cv2 (FFmpeg's native ``vp9`` decoder and swscale) and the JAX
package's readers, on the fixtures of ``tests/data/vp9``
(``scripts/make_vp9_fixtures.py``):

- every clip through both readers equals the JAX readers' records (frames,
  stamps, hashes, ``CAP_PROP_FPS`` and ``CAP_PROP_FRAME_COUNT``); this
  needs no cv2, so it runs on the card's machine too;
- the port's BGR frames equal ``cv2.VideoCapture``'s at every pixel, read
  live on one thread and as recorded; the records are what the JAX readers
  return;
- each clip covers what it is there for (the noise clip every block size to
  32x32, transform size and type and intra mode; two and four tile
  columns; a second key frame; the golden frame refreshed).

The 960x720 flagship is decoded once per process and shared by its WebM
and Matroska files.
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from v2e2v_tpu_torch.data.manifests import VideoSequence
from v2e2v_tpu_torch.data.video_readers import VideoReader
from v2e2v_tpu_torch.utils import vp9dec
from v2e2v_tpu_torch.utils.video import VideoFile

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "data" / "vp9"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())["clips"]
CLIPS = sorted(MANIFEST)
_BGR: dict = {}  # the packets' digest -> the port's BGR frames: the flagship once a process


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _shared_bgr(monkeypatch):
    """``VideoFile.bgr`` decoded once per stream of packets, whichever
    container holds them."""
    original = VideoFile.bgr

    def bgr(self):
        key = hashlib.sha256(b"".join(self.packets())).hexdigest()
        if key not in _BGR:
            _BGR[key] = list(original(self))
        return iter(_BGR[key])

    monkeypatch.setattr(VideoFile, "bgr", bgr)


@pytest.mark.parametrize("name", CLIPS)
def test_fixtures_match_manifest(name, monkeypatch):
    """The port's readers over each clip against what the JAX readers
    returned when the fixtures were written: fps, count, stamps, shapes and
    every frame's hash; the reader's frames against ``reader_frames.npz``."""
    _shared_bgr(monkeypatch)
    want = MANIFEST[name]
    path = str(FIXTURES / name)
    video = VideoFile(path)
    assert video.codec == "vp9"
    assert (video.fps, video.frame_count) == (want["fps"], want["frame_count"])
    assert [_sha(f) for f in video.bgr()] == want["cv2_sha256"]
    reader = VideoReader((720, 960), ds=(0.25, 0.25))
    reader.initialize(path)
    assert reader.num_frames == want["frames_read"]
    assert reader.timestamps == want["timestamps"]
    assert list(reader.frames[0].shape) == want["reader_shape"]
    assert [_sha(f) for f in reader.frames] == want["reader_sha256"]
    np.testing.assert_array_equal(np.stack(reader.frames),
                                  np.load(FIXTURES / "reader_frames.npz")[want["frames"]])
    pairs = list(VideoSequence(path))
    full = [pairs[0][0]] + [p[1] for p in pairs]
    assert list(full[0].shape) == want["shape"]
    assert [_sha(f) for f in full] == want["sequence_sha256"]
    assert [p[2:] for p in pairs] == [((i - 1) / want["fps"], i / want["fps"])
                                      for i in range(1, len(full))]


def test_manifest_is_cv2s():
    """The committed records are what the JAX readers (through cv2) and cv2
    itself return, so the port is held to cv2, not to itself (the
    flagship's cv2 frames are read by ``test_frames_match_cv2``)."""
    cv2 = pytest.importorskip("cv2")
    from v2e2v_tpu.data.manifests import VideoSequence as JaxSequence
    from v2e2v_tpu.data.video_readers import VideoReader as JaxReader

    for name, want in MANIFEST.items():
        if name.startswith("flagship"):
            continue
        path = str(FIXTURES / name)
        cap = cv2.VideoCapture(path)
        assert (cap.get(cv2.CAP_PROP_FPS), cap.get(cv2.CAP_PROP_FRAME_COUNT)) == \
            (want["fps"], want["frame_count"]), name
        cap.release()
        reader = JaxReader((720, 960), ds=(0.25, 0.25))
        reader.initialize(path)
        assert [_sha(f) for f in reader.frames] == want["reader_sha256"], name
        pairs = list(JaxSequence(path))
        assert [_sha(f) for f in [pairs[0][0]] + [p[1] for p in pairs]] == \
            want["sequence_sha256"], name


@pytest.mark.parametrize("name", CLIPS)
def test_frames_match_cv2(name, monkeypatch):
    """Every fixture's frames, BGR as cv2 returns them on one decoding
    thread, at every pixel, and cv2's frames as recorded."""
    cv2 = pytest.importorskip("cv2")
    _shared_bgr(monkeypatch)
    got = list(VideoFile(str(FIXTURES / name)).bgr())
    cap = cv2.VideoCapture(str(FIXTURES / name), cv2.CAP_FFMPEG, [cv2.CAP_PROP_N_THREADS, 1])
    want = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        want.append(f)
    cap.release()
    assert len(got) == len(want) == MANIFEST[name]["frames_read"]
    assert [_sha(f) for f in want] == MANIFEST[name]["cv2_sha256"]
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        np.testing.assert_array_equal(g, w, err_msg=f"{name} frame {i}")


def _decode_log(name):
    dec = vp9dec.Vp9Decoder(name)
    dec.log = []
    for data in VideoFile(str(FIXTURES / name)).packets():
        list(dec.decode(data))
    return dec.log


def test_clips_cover_what_they_are_for():
    """The noise clip reaches every block size to 32x32, every transform
    size and type and every intra and inter mode; ``wide`` has four tile
    columns; ``gop`` a second key frame; the flagship two tile columns and
    a frame refreshing the golden slot."""
    log = _decode_log("noise.webm")
    blocks = [b for _, td in log for row in td.grid for b in row]
    assert {b.bs for b in blocks} >= set(range(10))
    assert {b.tx for b in blocks} == set(range(4))
    assert set().union(*(td.coefs for _, td in log)) >= {(t, k) for t in range(3)
                                                          for k in range(4)} | {(3, 0)}
    assert {m for b in blocks if not b.is_inter for m in b.bmodes} == set(range(10))
    assert {m for b in blocks if b.is_inter for m in b.bmodes} == {10, 11, 12, 13}
    assert any(not h.key and h.filter == 4 for h, _ in log)  # switchable
    assert [h.tile_cols_log2 for h, _ in _decode_log("wide.webm")] == [2] * 4
    assert [h.key for h, _ in _decode_log("gop.webm")].count(True) == 2
    mkv = VideoFile(str(FIXTURES / "flagship.webm")).container
    assert (mkv.width, mkv.height) == (960, 720)
    from v2e2v_tpu_torch.utils.vp9 import read_uncompressed
    headers = []
    dec = vp9dec.Vp9Decoder()
    for data in VideoFile(str(FIXTURES / "flagship.webm")).packets():
        headers.append(read_uncompressed(data, dec, "flagship"))
        if headers[-1].key:
            dec.refs = [type("Ref", (), {"size": (720, 960)})()] * 8
    assert headers[0].tile_cols_log2 == 1 and any(h.refresh & 2 for h in headers[1:])


def test_odd_clip_is_odd():
    """``odd.webm`` is 75x49 (cv2's writer keeps even sizes: the script
    rewrites its key frame and track), read by swscale's general route."""
    video = VideoFile(str(FIXTURES / "odd.webm"))
    assert (video.container.width, video.container.height) == (75, 49)
    assert next(iter(video.bgr())).shape == (49, 75, 3)
