"""The port's VP8 video decoder (``v2e2v_tpu_torch/utils/vp8dec.py``) and the
readers over Matroska / WebM (``utils/video.VideoFile``,
``data/video_readers.VideoReader``, ``data/manifests.VideoSequence``)
against cv2 (FFmpeg's native ``vp8`` decoder and swscale) and the JAX
package's readers on the same files.

- The fixtures of ``tests/data/mkv`` (``scripts/make_mkv_fixtures.py``):
  every frame of every clip through both readers equals the JAX readers'
  records (no cv2 needed, so this runs on the card's machine too), and the
  port's BGR frames equal ``cv2.VideoCapture``'s at every pixel. The
  960x720 flagship is decoded once per process and shared.
- ``CRAFTED``: 14 hand-written streams (a header written field by field,
  macroblocks and tokens drawn at random through the port's own parser,
  ``make_mkv_fixtures.vp8_stream``), each named for what it covers and
  checked to cover it, plus ``RANDOM``: 24 streams of random headers and
  sizes. Each is read by cv2 and by the port, equal at every pixel of every
  frame, frames that are not shown absent from both.
- The pieces: the wavefront loop filter against raster order on random
  planes (libwebp's per-line filter), the 16-bit transforms against libwebp's
  where no lane overflows, the boolean encoder against the decoder, and
  each refusal, which names ROADMAP item 4.
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
from v2e2v_tpu_torch.utils import video as video_module
from v2e2v_tpu_torch.utils import vp8, vp8dec
from v2e2v_tpu_torch.utils.video import VideoFile

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "data" / "mkv"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())["clips"]
READ = sorted(n for n in MANIFEST if n != "no_default_duration.webm")
VP8 = [n for n in READ if MANIFEST[n]["codec"] == "vp8"]


def _script():
    sys.path.insert(0, str(REPO / "scripts"))
    spec = importlib.util.spec_from_file_location("make_mkv_fixtures",
                                                  REPO / "scripts" / "make_mkv_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FX = _script()
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


def _cv2_bgr(cv2, path, one_thread=False):
    """cv2's frames; ``one_thread`` reads with one decoding thread, as the
    crafted streams are read (see ``test_random_streams_match_cv2``)."""
    cap = (cv2.VideoCapture(str(path), cv2.CAP_FFMPEG, [cv2.CAP_PROP_N_THREADS, 1]) if one_thread
           else cv2.VideoCapture(str(path)))
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    cap.release()
    return out


# ------------------------------------------------------------ the records

@pytest.mark.parametrize("name", READ)
def test_fixtures_match_manifest(name, monkeypatch):
    """The port's readers over each clip against what the JAX readers
    returned when the fixtures were written: fps, count, stamps, shapes and
    every frame's hash; the reader's frames against ``reader_frames.npz``."""
    _shared_bgr(monkeypatch)
    want = MANIFEST[name]
    path = str(FIXTURES / name)
    video = VideoFile(path)
    assert (video.fps, video.frame_count) == (want["fps"], want["frame_count"])
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
    """The committed records are what the JAX readers return (through
    cv2), so the port is held to cv2, not to itself. The flagship's are
    held by ``test_flagship_frames_match_cv2`` instead (a second read of
    it would cost a minute here)."""
    pytest.importorskip("cv2")
    from v2e2v_tpu.data.manifests import VideoSequence as JaxSequence
    from v2e2v_tpu.data.video_readers import VideoReader as JaxReader

    for name, want in MANIFEST.items():
        if name.startswith("flagship"):
            continue
        path = str(FIXTURES / name)
        reader = JaxReader((720, 960), ds=(0.25, 0.25))
        reader.initialize(path)
        assert [_sha(f) for f in reader.frames] == want["reader_sha256"], name
        pairs = list(JaxSequence(path))
        assert [_sha(f) for f in [pairs[0][0]] + [p[1] for p in pairs]] == \
            want["sequence_sha256"], name


@pytest.mark.parametrize("name", VP8)
def test_frames_match_cv2(name, monkeypatch):
    """Every VP8 fixture's frames, BGR as cv2 returns them, at every pixel
    (the flagship's twice: the WebM and the Matroska file)."""
    cv2 = pytest.importorskip("cv2")
    _shared_bgr(monkeypatch)
    got = list(VideoFile(str(FIXTURES / name)).bgr())
    want = _cv2_bgr(cv2, FIXTURES / name)
    assert len(got) == len(want) == MANIFEST[name]["frames_read"] or name == "odd_rate.webm"
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        np.testing.assert_array_equal(g, w, err_msg=f"{name} frame {i}")


# ------------------------------------------------------- crafted streams

def _key(**kw):
    return {"key": 1, "level": 12, "q": 24, **kw}


def _inter(**kw):
    return {"level": 10, "q": 24, **kw}


CRAFTED = {  # name -> (frames, width, height)
    "every_inter_mode": ([_key()] + [_inter(prob_last=128, prob_gf=128, refresh_golden=k == 1,
                                            refresh_altref=k == 2) for k in range(8)], 160, 112),
    "far_vectors": ([_key()] + [_inter(mv_updates=0.5, prob_intra=250) for _ in range(5)], 40, 24),
    "golden_altref_sign_bias": ([_key()] + [
        _inter(refresh_golden=1, sign_golden=1), _inter(refresh_altref=1, sign_altref=1),
        _inter(sign_golden=1, sign_altref=0), _inter(sign_golden=0, sign_altref=1),
        _inter(sign_golden=1, sign_altref=1, prob_last=60, prob_gf=128)], 64, 48),
    "copy_buffers": ([_key(), _inter(refresh_golden=1), _inter(copy_golden=1, copy_altref=2),
                      _inter(copy_golden=2, copy_altref=1, refresh_last=0),
                      _inter(refresh_altref=1, copy_golden=1, prob_last=40),
                      _inter(copy_golden=2, copy_altref=2, prob_last=40)], 48, 32),
    "entropy_not_refreshed": ([_key(coeff_updates=0.3, refresh_probs=0)] + [
        _inter(coeff_updates=0.2, mv_updates=0.5, refresh_probs=k % 2,
               ymode_probs=[90, 60, 200, 30], uvmode_probs=[120, 80, 150], prob_intra=150)
        for k in range(6)], 48, 48),
    "segments_and_deltas": ([
        _key(segmentation={"probs": [128, 100, 150], "quant": [5, None, -10, 20],
                           "filter": [10, -5, None, 30], "absolute": 0},
             deltas={"ref": [2, 0, -2, -2], "mode": [4, -2, 2, 4]}),
        _inter(segmentation={}, deltas={}),  # the map and the deltas kept
        _inter(segmentation={"quant": [40, 10, 70, 1], "filter": [20, 0, 63, 5], "absolute": 1},
               deltas={"ref": [None, 10, -8, None], "mode": [-6, None, 12, -63]}),
        _inter(segmentation={"probs": [None, 30, 200]}, q_deltas=[3, -2, 5, -7, 1]),
        _inter(deltas={}, level=40, sharpness=5),
        _inter(segmentation={}, deltas={}, level=63, sharpness=7)], 64, 48),
    "hidden_frames": ([_key(), _inter(show=0, refresh_golden=1), _inter(),
                       _inter(show=0, refresh_altref=1, refresh_last=0), _inter(show=0),
                       _inter(prob_last=60)], 48, 32),
    "version_1": ([_key(version=1, simple=1)] + [_inter(version=1, simple=1)] * 4, 56, 40),
    "version_2": ([_key(version=2)] + [_inter(version=2, mv_updates=0.3)] * 4, 56, 40),
    "version_3": ([_key(version=3)] + [_inter(version=3, mv_updates=0.3)] * 4, 56, 40),
    "token_partitions": ([_key(parts_log2=3)] + [_inter(parts_log2=k % 4) for k in range(4)],
                         48, 144),
    "full_range_key_frames": ([_key(clamping=1), _inter(), _key(clamping=0), _inter(),
                               _key(clamping=1)], 48, 33),
    "odd_size": ([_key()] + [_inter(mv_updates=0.2) for _ in range(4)], 53, 37),
    "large_coefficients": ([_key(q=127, coeff_updates=0.6)] + [
        _inter(q=120, coeff_updates=0.6, q_deltas=[15, 15, 15, 15, 15]) for _ in range(3)],
        48, 32),
}


class _Log(vp8dec.Vp8Decoder):
    """The decoder, recording each frame's header and macroblocks."""

    log: list = []

    def macroblocks(self, br, hdr, key):
        out = super().macroblocks(br, hdr, key)
        _Log.log.append((key, hdr, out[0], dict(self.refs), list(self.sign_bias)))
        return out


def _check_stream(tmp_path, frames, width, height, seed, monkeypatch):
    """The crafted stream through cv2 and the port: equal frames; returns
    the port's record of what it decoded."""
    cv2 = pytest.importorskip("cv2")
    data = FX.vp8_stream(frames, width, height, seed)
    path = tmp_path / "c.webm"
    FX.write_webm(path, data, width, height)
    _Log.log = []
    monkeypatch.setattr(video_module, "Vp8Decoder", _Log)
    got = list(VideoFile(str(path)).bgr())
    want = _cv2_bgr(cv2, path, one_thread=True)
    assert len(got) == len(want) == sum(f.get("show", 1) for f in frames)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"frame {i}")
    return _Log.log


@pytest.mark.parametrize("name", sorted(CRAFTED))
def test_crafted_streams_match_cv2(tmp_path, name, monkeypatch):
    """Each crafted stream equals cv2 at every pixel of every shown frame,
    and covers what it is named for."""
    frames, width, height = CRAFTED[name]
    log = _check_stream(tmp_path, frames, width, height, sorted(CRAFTED).index(name), monkeypatch)
    inter = [mb for key, _, mbs, _, _ in log if not key for mb in mbs]
    if name == "every_inter_mode":
        assert {mb.lf_mode for mb in inter} >= {vp8dec.LF_NONE, vp8dec.LF_BPRED, vp8dec.LF_ZERO,
                                                vp8dec.LF_MV, vp8dec.LF_SPLIT}
        assert {mb.part for mb in inter} == set(range(5))
        assert {mb.ref for mb in inter} == {0, 1, 2, 3}
    elif name == "far_vectors":  # some block reads wholly past the frame's edge
        assert any(abs(v) >= 4 * (width + 16) for mb in inter if mb.ref for mv in mb.bmv
                   for v in mv)
    elif name == "golden_altref_sign_bias":
        assert {tuple(bias) for *_, bias in log} >= {(0, 0, 1, 1), (0, 0, 1, 0), (0, 0, 0, 1)}
        assert {mb.ref for mb in inter} == {0, 1, 2, 3}
    elif name == "copy_buffers":
        assert {(h["golden"], h["altref"]) for key, h, *_ in log if not key} >= {
            (vp8dec.LAST, vp8dec.GOLDEN), (vp8dec.ALTREF, vp8dec.LAST)}
    elif name == "entropy_not_refreshed":
        assert sum(h["saved"] is not None for _, h, *_ in log) >= 3
    elif name == "segments_and_deltas":
        assert len({mb.segment for _, _, mbs, _, _ in log for mb in mbs}) == 4
    elif name == "version_3":
        assert any(mb.part != vp8dec.SPLIT_NONE for mb in inter)


RANDOM = range(24)


def _random_header(rng, key, version):
    f = {"key": key, "version": version, "q": int(rng.integers(0, 90)),
         "level": int(rng.integers(0, 64)), "sharpness": int(rng.integers(0, 8)),
         "simple": int(rng.random() < 0.3), "parts_log2": int(rng.integers(0, 4)),
         "uniform": bool(rng.random() < 0.7), "coeff_updates": float(rng.choice([0, 0.02, 0.2])),
         "skip_prob": None if rng.random() < 0.2 else int(rng.integers(1, 256)),
         "refresh_probs": int(rng.random() < 0.6), "show": int(key or rng.random() < 0.85)}
    if rng.random() < 0.5:
        f["q_deltas"] = [None if rng.random() < 0.5 else int(rng.integers(-15, 16))
                         for _ in range(5)]
    if rng.random() < 0.5:
        quant = [None if rng.random() < 0.3 else int(rng.integers(-30, 31)) for _ in range(4)]
        lf = [None if rng.random() < 0.3 else int(rng.integers(-30, 31)) for _ in range(4)]
        absolute = int(rng.random() < 0.3)
        if absolute:
            quant = [None if v is None else abs(v) for v in quant]
            lf = [None if v is None else abs(v) for v in lf]
        f["segmentation"] = {"probs": [None if rng.random() < 0.3 else int(rng.integers(1, 256))
                                       for _ in range(3)], "absolute": absolute}
        if rng.random() < 0.7:
            f["segmentation"].update(quant=quant, filter=lf)
    if rng.random() < 0.6:
        f["deltas"] = {} if rng.random() < 0.3 else {
            "ref": [None if rng.random() < 0.3 else int(rng.integers(-20, 21)) for _ in range(4)],
            "mode": [None if rng.random() < 0.3 else int(rng.integers(-20, 21)) for _ in range(4)]}
    if key:
        f["clamping"] = int(rng.random() < 0.3)
    else:
        f.update(refresh_golden=int(rng.random() < 0.3), refresh_altref=int(rng.random() < 0.3),
                 copy_golden=int(rng.integers(0, 3)), copy_altref=int(rng.integers(0, 3)),
                 sign_golden=int(rng.random() < 0.5), sign_altref=int(rng.random() < 0.5),
                 refresh_last=int(rng.random() < 0.8), prob_intra=int(rng.integers(1, 256)),
                 prob_last=int(rng.integers(1, 256)), prob_gf=int(rng.integers(1, 256)),
                 mv_updates=float(rng.choice([0, 0.1, 0.5])))
        if rng.random() < 0.3:
            f["ymode_probs"] = [int(x) for x in rng.integers(1, 256, 4)]
        if rng.random() < 0.3:
            f["uvmode_probs"] = [int(x) for x in rng.integers(1, 256, 3)]
    return f


@pytest.mark.parametrize("seed", RANDOM)
def test_random_streams_match_cv2(tmp_path, seed, monkeypatch):
    """Streams of 8 frames with random headers (segments kept or updated,
    deltas, partitions, references, copies, sign biases, probabilities kept
    or restored, frames not shown), sizes 8-89 x 8-69 and versions 0-3.

    A segment map is kept only from a frame that had one: FFmpeg keeps the
    previous frame's map buffer, which a frame without segmentation leaves
    as its buffer pool gave it, so what cv2 reads then varies with its
    decoding threads (random stream 1 read that way differed in 18 of 200
    threaded reads under load); the port takes it as zeros. cv2 reads these
    streams with one thread."""
    rng = np.random.default_rng(1000 + seed)
    width, height = int(rng.integers(8, 90)), int(rng.integers(8, 70))
    version = int(rng.integers(0, 4))
    frames = [_random_header(rng, i == 0 or rng.random() < 0.1, version) for i in range(8)]
    had_map = False
    for f in frames:
        seg = f.get("segmentation")
        if seg is not None and seg["probs"] is None and (f["key"] or not had_map):
            seg["probs"] = [128, 128, 128]
        had_map = seg is not None
    _check_stream(tmp_path, frames, width, height, 1000 + seed, monkeypatch)


def test_crafted_stream_readers_match_the_jax_readers(tmp_path):
    """A crafted stream with frames not shown, at an odd size, through both
    readers of each package."""
    pytest.importorskip("cv2")
    from v2e2v_tpu.data.manifests import VideoSequence as JaxSequence
    from v2e2v_tpu.data.video_readers import VideoReader as JaxReader

    frames, width, height = CRAFTED["hidden_frames"]
    path = str(tmp_path / "h.webm")
    FX.write_webm(Path(path), FX.vp8_stream(frames, 37, 53, 7), 37, 53)
    port, ref = VideoReader((180, 240), ds=(0.5, 0.5)), JaxReader((180, 240), ds=(0.5, 0.5))
    port.initialize(path)
    ref.initialize(path)
    assert port.num_frames == ref.num_frames == 3
    assert port.timestamps == ref.timestamps
    for g, w in zip(port.frames, ref.frames, strict=True):
        np.testing.assert_array_equal(g, w)
    got, want = list(VideoSequence(path)), list(JaxSequence(path))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        assert g[2:] == w[2:]


# ------------------------------------------------------------- the pieces

def _filter_line(px: list, thresh2: int, ithresh: int, hev_thresh: int, mode: int):
    """One line across an edge, ``px`` = p3 p2 p1 p0 q0 q1 q2 q3: the new
    values, or None where the edge is left as it is. ``mode`` 0 is the
    simple filter (``DoFilter2`` where ``NeedsFilter``), 1 an inner edge of
    the normal filter (``FilterLoop24``), 2 a macroblock edge
    (``FilterLoop26``)."""
    p3, p2, p1, p0, q0, q1, q2, q3 = px
    if 4 * abs(p0 - q0) + abs(p1 - q1) > thresh2:
        return None
    if mode and (abs(p3 - p2) > ithresh or abs(p2 - p1) > ithresh or abs(p1 - p0) > ithresh
                 or abs(q3 - q2) > ithresh or abs(q2 - q1) > ithresh or abs(q1 - q0) > ithresh):
        return None
    if not mode or abs(p1 - p0) > hev_thresh or abs(q1 - q0) > hev_thresh:  # DoFilter2
        a = 3 * (q0 - p0) + min(max(p1 - q1, -128), 127)
        a1, a2 = min(max((a + 4) >> 3, -16), 15), min(max((a + 3) >> 3, -16), 15)
        return [p3, p2, p1, min(max(p0 + a2, 0), 255), min(max(q0 - a1, 0), 255), q1, q2, q3]
    if mode == 2:  # DoFilter6
        a = min(max(3 * (q0 - p0) + min(max(p1 - q1, -128), 127), -128), 127)
        a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
        return [p3, min(max(p2 + a3, 0), 255), min(max(p1 + a2, 0), 255),
                min(max(p0 + a1, 0), 255), min(max(q0 - a1, 0), 255),
                min(max(q1 - a2, 0), 255), min(max(q2 - a3, 0), 255), q3]
    a = 3 * (q0 - p0)  # DoFilter4
    a1, a2 = min(max((a + 4) >> 3, -16), 15), min(max((a + 3) >> 3, -16), 15)
    a3 = (a1 + 1) >> 1
    return [p3, p2, min(max(p1 + a3, 0), 255), min(max(p0 + a2, 0), 255),
            min(max(q0 - a1, 0), 255), min(max(q1 - a3, 0), 255), q2, q3]


def _raster_filter(planes, level, ilimit, hev, inner, simple):
    """The loop filter in raster order, one line at a time, by libwebp's
    ``_filter_line`` (the still decoder's filter before it shared the
    wavefront)."""
    rows = [p.tolist() for p in planes]
    mb_h, mb_w = level.shape
    for mb_y in range(mb_h):
        for mb_x in range(mb_w):
            lv = int(level[mb_y, mb_x])
            if not lv:
                continue
            il, hv = int(ilimit[mb_y, mb_x]), int(hev[mb_y, mb_x])
            for k, size in ((0, 16),) if simple else ((0, 16), (1, 8), (2, 8)):
                plane, y0, x0 = rows[k], size * mb_y, size * mb_x
                for way in ("v", "h"):
                    first = x0 if way == "v" else y0
                    edges = [(first, 2)] if (mb_x if way == "v" else mb_y) else []
                    edges += [(first + d, 1) for d in range(4, size, 4)] if inner[mb_y, mb_x] \
                        else []
                    for at, mode in edges:
                        limit = 2 * lv + il + (4 if mode == 2 else 0)
                        mode = 0 if simple else mode
                        for j in range(size):
                            if way == "v":
                                line = plane[y0 + j][at - 4:at + 4]
                            else:
                                line = [plane[r][x0 + j] for r in range(at - 4, at + 4)]
                            new = _filter_line(line, 2 * limit + 1, il, hv, mode)
                            if new is None:
                                continue
                            if way == "v":
                                plane[y0 + j][at - 4:at + 4] = new
                            else:
                                for r, v in zip(range(at - 4, at + 4), new):
                                    plane[r][x0 + j] = v
    return [np.array(r, np.int32) for r in rows]


@pytest.mark.parametrize("simple", [False, True])
def test_wavefront_loop_filter_equals_raster_order(simple):
    """The wavefront filter (each step's macroblocks at once) leaves every
    pixel as raster order does, on smooth random planes where most edges
    filter, with random levels (some 0), limits, thresholds and inner flags."""
    rng = np.random.default_rng(int(simple))
    mb_h, mb_w = 5, 7
    y = np.cumsum(rng.integers(-3, 4, (16 * mb_h, 16 * mb_w)), axis=1) + 128
    planes = [np.clip(y, 0, 255).astype(np.int32)] + [
        np.clip(128 + np.cumsum(rng.integers(-2, 3, (8 * mb_h, 8 * mb_w)), axis=0), 0,
                255).astype(np.int32) for _ in range(2)]
    level = rng.integers(0, 64, (mb_h, mb_w)) * (rng.random((mb_h, mb_w)) > 0.15)
    ilimit = rng.integers(1, 10, (mb_h, mb_w))
    hev = rng.integers(0, 4, (mb_h, mb_w))
    inner = rng.random((mb_h, mb_w)) < 0.7
    want = _raster_filter(planes, level, ilimit, hev, inner, simple)
    got = [p.copy() for p in planes]
    vp8dec.loop_filter(got, level, ilimit, hev, inner, simple)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert any((g != p).any() for g, p in zip(got, planes))


def test_transforms_equal_libwebps_where_no_lane_overflows():
    """The 16-bit IDCT and WHT equal the still decoder's (libwebp's) on
    coefficients small enough that no lane overflows, and wrap where one
    does (a lone coefficient past 2^14 turns the sign of the 35468 product)."""
    rng = np.random.default_rng(2)
    c = rng.integers(-600, 601, (500, 16))
    np.testing.assert_array_equal(vp8dec._idct(c), vp8._idct(c))
    np.testing.assert_array_equal(vp8dec._iwht(c), vp8._iwht(c))
    big = np.zeros((1, 16), np.int64)
    big[0, 1] = -17604
    assert (vp8dec._idct(big)[0, 0, 1:3] > 0).tolist() == [True, False]
    assert (vp8._idct(big)[0, 0, 1:3] > 0).tolist() == [False, True]


def test_boolean_encoder_round_trips():
    rng = np.random.default_rng(3)
    probs = rng.integers(0, 256, 5000)
    bits = (rng.random(5000) * 256 >= probs).astype(int)
    enc = FX.BoolEncoder()
    for p, b in zip(probs, bits):
        enc.put(int(p), int(b))
    dec = vp8._Bool(enc.flush(), "<bits>")
    assert [dec.bit(int(p)) for p in probs] == bits.tolist()


def _refused_stream(case):
    data = FX.vp8_stream([_key(), _inter()], 32, 32, 0)
    if case == "scaling":
        return [FX.vp8_stream([_key(hscale=1)], 32, 32, 0)[0]]
    if case == "inter_first":
        return data[1:]
    if case == "size_change":
        return data + FX.vp8_stream([_key()], 48, 32, 1)
    if case == "truncated_partition":
        return [data[0][:20]]
    if case == "version":
        return [bytes((data[0][0] | (5 << 1),)) + data[0][1:]]
    return [data[0][:2]]  # a truncated tag


REFUSED = {"scaling": "scaling bits", "inter_first": "inter frame before any key frame",
           "size_change": "size change", "truncated_partition": "past the frame's end",
           "version": "version 5", "truncated_tag": "truncated frame tag"}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_what_the_decoder_does_not_read_raises(tmp_path, case):
    """Each refusal raises a ValueError naming it and ROADMAP item 4, from
    the decoder and from the readers over a WebM of the stream."""
    frames = _refused_stream(case)
    with pytest.raises(ValueError, match=f"(?s){REFUSED[case]}.*item 4"):
        dec = vp8dec.Vp8Decoder("<crafted>")
        for data in frames:
            list(dec.decode(data))
    path = tmp_path / "r.webm"
    FX.write_webm(path, frames, 32, 32)
    with pytest.raises(ValueError, match="item 4"):
        VideoReader((180, 240)).initialize(str(path))
