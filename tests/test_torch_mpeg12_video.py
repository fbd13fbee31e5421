"""The port's readers over MPEG-1/2 video (``utils/mpegps.py``,
``mpegts.py``, the MPEG-1/2 parts of ``avi.py``, ``mp4.py``, ``mkv.py``
and ``video.py``, behind ``data/video_readers.VideoReader`` and
``data/manifests.VideoSequence``) against cv2 and the JAX package's
readers, on the fixtures of ``tests/data/mpeg12``
(``scripts/make_mpeg12_fixtures.py``):

- every clip through both readers equals the JAX readers' records (frames,
  stamps, hashes, ``CAP_PROP_FPS`` and ``CAP_PROP_FRAME_COUNT``, FFmpeg's
  estimated counts included); this needs no cv2, so it runs on the card's
  machine too;
- the port's BGR frames equal ``cv2.VideoCapture``'s at every pixel, and
  the records are what cv2 and the JAX readers return;
- each clip covers what it is there for;
- the rate and count rule of program and transport streams against cv2 on a
  seeded sweep of sizes (8x8 to 960x720), lengths, rates, codecs and
  content (flat, a pan, noise);
- what the containers refuse raises naming ROADMAP item 4.

The 960x720 flagship is decoded once per process.
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
from v2e2v_tpu_torch.utils.mpegps import ProgramStream
from v2e2v_tpu_torch.utils.mpegts import TransportStream
from v2e2v_tpu_torch.utils.video import VideoFile

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "data" / "mpeg12"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())["clips"]
CLIPS = sorted(MANIFEST)
_BGR: dict = {}  # the path -> the port's BGR frames: the flagship once a process


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _script(name):
    sys.path.insert(0, str(REPO / "scripts"))
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shared_bgr(monkeypatch):
    original = VideoFile.bgr

    def bgr(self):
        if self.path not in _BGR:
            _BGR[self.path] = list(original(self))
        return iter(_BGR[self.path])

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
    assert video.codec == want["codec"]
    assert (video.fps, video.frame_count) == (want["fps"], want["frame_count"])
    assert [_sha(f) for f in video.bgr()] == want["cv2_sha256"]
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


def test_manifest_is_cv2s():
    """The committed records are what the JAX readers (through cv2) and cv2
    itself return, so the port is held to cv2, not to itself."""
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
    assert len(got) == len(want) == len(MANIFEST[name]["cv2_sha256"])
    assert [_sha(f) for f in want] == MANIFEST[name]["cv2_sha256"]
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        np.testing.assert_array_equal(g, w, err_msg=f"{name} frame {i}")


def test_clips_cover_what_they_are_for():
    """The noise clip reaches all 63 coded block patterns, intra and
    zero-vector macroblocks in P-pictures and every direction in
    B-pictures; the GOP clip holds open GOPs; the small program streams'
    counts fall short of their frames (FFmpeg's estimate); the containers
    are the ones named."""
    video = VideoFile(str(FIXTURES / "noise.mpg"))
    video.syntax_log = []
    list(video.planes())
    used = set().union(*(s.used for s in video.syntax_log))
    assert {int(u[3:]) for u in used if u.startswith("cbp")} == set(range(1, 64))
    p_flags = {f for s in video.syntax_log if s.pic.kind == 2 for f in s.flags}
    b_dirs = {d for s in video.syntax_log if s.pic.kind == 3
              for k, d in zip(s.kind, s.direction) if k == 1}
    assert {1, 8, 10, 42} <= p_flags and b_dirs == {1, 2, 3}
    gops = VideoFile(str(FIXTURES / "gops.mpg"))
    gops.syntax_log = []
    list(gops.planes())
    assert gops.decoder.h.closed_gop == 0 and len(gops.syntax_log) == 40
    for name, frames, count in (("tiny.mpg", 12, 1), ("short.mpg", 12, 10),
                                ("twin.mpg", 12, 6)):
        assert MANIFEST[name]["frame_count"] == count < frames == len(
            MANIFEST[name]["cv2_sha256"])
    assert TransportStream(str(FIXTURES / "twin.m2ts")).frame_count == 12
    assert ProgramStream(str(FIXTURES / "twin.vob")).headers.seq.mpeg2
    with open(FIXTURES / "twin.vob", "rb") as f:
        assert f.read(5)[4] >> 6 == 1  # an MPEG-2 pack header
    with open(FIXTURES / "twin.mpg", "rb") as f:
        assert f.read(5)[4] >> 4 == 2  # an MPEG-1 pack header


# ------------------------------------------------------ the count rule

def _sweep_cases():
    rng = np.random.default_rng(0)
    sizes = [(8, 8), (16, 16), (32, 48), (48, 64), (64, 96), (120, 160), (240, 320),
             (480, 640), (720, 960)]
    cases = [("PIM1", ".mpg", 32, 48, 12, 30.0, "noise"), ("PIM1", ".mpg", 720, 960, 12, 30.0,
             "noise"), ("MPG2", ".mpg", 8, 8, 12, 10.0, "pan"),
             ("MPG2", ".mpg", 48, 64, 12, 10.0, "pan"), ("MPG2", ".vob", 720, 960, 6, 30000 / 1001,
                                                         "noise")]
    while len(cases) < 30:
        h, w = sizes[rng.integers(len(sizes))]
        codec = ("PIM1", "MPG2")[rng.integers(2)]
        ext = str(rng.choice([".mpg", ".vob"] if codec == "PIM1" else
                             [".mpg", ".vob", ".ts", ".m2ts"]))
        n = int(rng.integers(3, 41 if h * w < 100000 else 9))
        fps = float(rng.choice([24000 / 1001, 24, 25, 30000 / 1001, 30, 50, 60000 / 1001, 60]
                               if codec == "PIM1" else [10, 30000 / 1001, 25, 15, 12, 5, 20]))
        content = str(rng.choice(["flat", "pan", "noise"] if h * w < 100000 else
                                 ["flat", "pan"]))
        cases.append((codec, ext, h, w, n, fps, content))
    return cases


SWEEP = _sweep_cases()


@pytest.mark.parametrize("case", range(len(SWEEP)))
def test_rate_and_count_match_cv2(tmp_path, case):
    """A program or transport stream cv2 writes: the port's fps and frame
    count (FFmpeg's estimate from the PES time stamps) equal cv2's."""
    cv2 = pytest.importorskip("cv2")
    mf = _script("make_mpeg12_fixtures")
    mp4f = _script("make_mpeg4_fixtures")
    codec, ext, h, w, n, fps, content = SWEEP[case]
    rng = np.random.default_rng(case)
    if content == "flat":
        frames = np.full((n, h, w, 3), int(rng.integers(256)), np.uint8)
    elif content == "pan":
        frames = mp4f.pan(rng, h, w, n, (1, 2))
    else:
        frames = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    path = tmp_path / f"sweep{ext}"
    mf.write(path, frames, fps, codec)
    cap = cv2.VideoCapture(str(path))
    want = (cap.get(cv2.CAP_PROP_FPS), cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    stream = (TransportStream if ext in (".ts", ".m2ts") else ProgramStream)(str(path))
    assert (stream.fps, stream.frame_count) == want, SWEEP[case]


# ---------------------------------------------------------- refusals

def _write(tmp_path, name, fourcc, frames=4, fps=30.0):
    """A clip cv2 writes: noise, so that a program stream holds several PES
    packets."""
    mf = _script("make_mpeg12_fixtures")
    path = tmp_path / name
    mf.write(path, np.random.default_rng(1).integers(0, 256, (frames, 32, 48, 3), np.uint8),
             fps, fourcc)
    return path


def _second_video_stream(path):
    d = bytearray(path.read_bytes())
    k = d.rfind(b"\x00\x00\x01\xe0")
    d[k + 3] = 0xE1
    path.write_bytes(bytes(d))


def _skip_counter(path):
    d = bytearray(path.read_bytes())
    ts = TransportStream(str(path))
    k = ts.starts[-1]
    d[k + 3] = (d[k + 3] & 0xF0) | ((d[k + 3] + 5) & 15)
    path.write_bytes(bytes(d))


CONTAINER_REFUSALS = {
    "elementary_stream": ("clip.m2v", "MPG2", None, "elementary stream"),
    "two_pictures": ("clip.mpg", "MPG2", None, "2 pictures"),
    "mpeg1_in_ts": ("clip.ts", "PIM1", None, "MPEG-1 video in a transport stream"),
    "two_video_streams": ("clip.mpg", "MPG2", _second_video_stream, "several video streams"),
    "ts_discontinuity": ("clip.ts", "MPG2", _skip_counter, "continuity counter"),
    "truncated": ("clip.mpg", "MPG2", lambda p: p.write_bytes(p.read_bytes()[:1000]),
                  "corrupt or truncated"),
}


@pytest.mark.parametrize("case", sorted(CONTAINER_REFUSALS))
def test_container_refusals_name_item_4(tmp_path, case):
    """The files cv2 writes that the port leaves for later (a raw elementary
    stream, too few pictures to pin cv2's rate, MPEG-1 in a transport
    stream) and damaged ones raise naming what they are and ROADMAP item
    4, from both readers."""
    pytest.importorskip("cv2")
    name, fourcc, damage, text = CONTAINER_REFUSALS[case]
    path = _write(tmp_path, name, fourcc, frames=2 if case == "two_pictures" else 12)
    if damage is not None:
        damage(path)
    with pytest.raises(ValueError, match=f"(?s){text}.*item 4"):
        VideoReader((180, 240)).initialize(str(path))
    with pytest.raises(ValueError, match="item 4"):
        list(VideoSequence(str(path)))
