"""The port's MPEG-4 Part 2 path (``v2e2v_tpu_torch/utils/mp4.py``,
``mpeg4.py``, ``yuv.yuv420p_to_bgr``, ``avi.py``'s MPEG-4 fourccs,
``video.py``) against cv2 and the JAX package's readers, which read through
``cv2.VideoCapture`` (FFmpeg's ``mov`` and ``avi`` demuxers, its ``mpeg4``
decoder and swscale) on the same files.

Each stage is held bit for bit: the demuxer's fps, frame count and packets
(cv2's raw mode, ``CAP_PROP_FORMAT = -1``) on every fixture and on
faststart, ``co64``, timing and display-matrix rewrites; the decoder's Y
plane (``CAP_PROP_CONVERT_RGB = 0``); the limited-range conversion
(``cap.read()``) on crafted DC-only VOPs that feed chosen (Y, Cb, Cr)
triples and on raw I420 clips of odd sizes; FFmpeg's ``simple_idct`` add
variant against a scalar copy of the C code; and the readers: the port's
``VideoReader`` and ``VideoSequence`` frames equal the JAX ones at every
pixel on every clip of ``tests/data/mpeg4`` (MP4, MOV, M4V, XVID and FMP4
AVI; I- and P-VOPs, a second GOP, portrait, 30000/1001 fps, 75x49,
interlaced MJPEG of both polarities). Every refusal names ROADMAP item 4.

The fixtures (``scripts/make_mpeg4_fixtures.py``) are checked twice: the
port against ``manifest.json`` and ``reader_frames.npz``, which needs no
cv2, and those records against cv2 and the JAX readers where installed.
"""

import hashlib
import importlib.util
import json
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

from v2e2v_tpu_torch.data.manifests import VideoSequence
from v2e2v_tpu_torch.data.video_readers import VideoReader
from v2e2v_tpu_torch.utils import jpeg, mpeg4, yuv
from v2e2v_tpu_torch.utils.avi import AviFile
from v2e2v_tpu_torch.utils.mp4 import Mp4File
from v2e2v_tpu_torch.utils.video import VideoFile

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "data" / "mpeg4"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())["clips"]
CLIPS = sorted(MANIFEST)
MPEG4 = [n for n in CLIPS if MANIFEST[n]["codec"] == "mpeg4"]
LAVC = b"\x00\x00\x01\xb2Lavc62.28.101"


def _script(name):
    sys.path.insert(0, str(REPO / "scripts"))
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _cv2_frames(cv2, path, **props):
    cap = cv2.VideoCapture(str(path))
    for k, v in props.items():
        assert cap.set(getattr(cv2, k), v)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    cap.release()
    return out


# ------------------------------------------------------------ the records

@pytest.mark.parametrize("name", CLIPS)
def test_fixtures_match_manifest(name):
    """The port's readers over each clip against what the JAX readers
    returned when the fixtures were written: fps, count, stamps, shapes and
    every frame's hash; the reader's frames against ``reader_frames.npz``."""
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


def test_fixture_directory_stays_small():
    total = sum(p.stat().st_size for p in FIXTURES.rglob("*") if p.is_file())
    assert total < 1 << 20, total


def test_manifest_is_cv2s():
    """The committed records are what cv2 reports and what the JAX readers
    return, so the port is held to cv2, not to itself."""
    cv2 = pytest.importorskip("cv2")
    from v2e2v_tpu.data.manifests import VideoSequence as JaxSequence
    from v2e2v_tpu.data.video_readers import VideoReader as JaxReader

    for name, want in MANIFEST.items():
        path = str(FIXTURES / name)
        cap = cv2.VideoCapture(path)
        assert (cap.get(cv2.CAP_PROP_FPS), cap.get(cv2.CAP_PROP_FRAME_COUNT)) == (
            want["fps"], want["frame_count"]), name
        cap.release()
        reader = JaxReader((720, 960), ds=(0.25, 0.25))
        reader.initialize(path)
        assert [_sha(f) for f in reader.frames] == want["reader_sha256"], name
        pairs = list(JaxSequence(path))
        assert [_sha(f) for f in [pairs[0][0]] + [p[1] for p in pairs]] == \
            want["sequence_sha256"], name


def test_flagship_containers_hold_one_stream():
    """The five flagship files carry the same VOPs: the MP4, MOV and M4V
    the same samples and VOL, the two AVIs the same chunks, whose first
    leads with that VOL."""
    mp4 = Mp4File(str(FIXTURES / "flagship.mp4"))
    samples = list(mp4.frames())
    for name in ("flagship.mov", "flagship.m4v"):
        other = Mp4File(str(FIXTURES / name))
        assert other.config == mp4.config and list(other.frames()) == samples
    chunks = list(AviFile(str(FIXTURES / "flagship_xvid.avi")).frames())
    assert chunks == list(AviFile(str(FIXTURES / "flagship_fmp4.avi")).frames())
    assert len(chunks) == len(samples) == 12
    assert chunks[0].startswith(b"\x00\x00\x01\xb0") and mp4.config.startswith(b"\x00\x00\x01\xb0")


# ------------------------------------------------------------- the demuxer

@pytest.mark.parametrize("name", CLIPS)
def test_demuxer_matches_cv2(name):
    """fps and count as ``CAP_PROP_FPS`` / ``CAP_PROP_FRAME_COUNT``, and each
    packet's bytes as cv2's raw mode hands out FFmpeg's."""
    cv2 = pytest.importorskip("cv2")
    path = FIXTURES / name
    video = VideoFile(str(path))
    cap = cv2.VideoCapture(str(path))
    assert (video.fps, video.frame_count) == (cap.get(cv2.CAP_PROP_FPS),
                                              cap.get(cv2.CAP_PROP_FRAME_COUNT))
    assert cap.set(cv2.CAP_PROP_FORMAT, -1)
    raw = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        raw.append(f.tobytes())
    assert list(video.packets()) == raw


LAYOUTS = ["faststart", "co64", "faststart_co64", "timing_25", "timing_ntsc", "size_0_mdat",
           "edit_500ms", "edit_0"]


@pytest.mark.parametrize("case", LAYOUTS)
def test_demuxer_layouts_match_cv2(tmp_path, case):
    """Rewrites of a written MP4: ``moov`` before ``mdat`` with ``stco``
    moved on, 64-bit ``co64`` offsets, both, other ``mdhd``/``stts``
    timings (whose edit list, left as written, then ends before the last
    samples at 25 fps), an ``mdat`` whose size field is 0 (to the end of
    the file), and edits of 500 ms and 0: fps, count and every frame as cv2
    reads them."""
    cv2 = pytest.importorskip("cv2")
    mf = _script("make_mpeg4_fixtures")
    data = (FIXTURES / "gop.mp4").read_bytes()
    if case == "faststart":
        data = mf.faststart(data)
    elif case == "co64":
        data = mf.to_co64(data)
    elif case == "faststart_co64":
        data = mf.to_co64(mf.faststart(data))
    elif case == "timing_25":
        data = mf.set_timing(data, 25, 1)
    elif case == "timing_ntsc":
        data = mf.set_timing(data, 60000, 2002)
    elif case == "size_0_mdat":  # mdat last, its size 0
        data = mf.faststart(data)
        pos, _, _ = mf.find(data, b"mdat")
        data = data[:pos] + struct.pack(">I", 0) + data[pos + 4:]
    else:  # the edit's duration, in the movie's milliseconds
        pos, head, _ = mf.find(data, b"elst")
        ms = 500 if case == "edit_500ms" else 0
        data = data[:pos + head + 8] + struct.pack(">I", ms) + data[pos + head + 12:]
    path = tmp_path / "t.mp4"
    path.write_bytes(data)
    video = VideoFile(str(path))
    cap = cv2.VideoCapture(str(path))
    assert (video.fps, video.frame_count) == (cap.get(cv2.CAP_PROP_FPS),
                                              cap.get(cv2.CAP_PROP_FRAME_COUNT))
    want = [cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) for f in _cv2_frames(cv2, path)]
    got = list(video)
    assert len(got) == len(want) == {"timing_25": 21, "edit_500ms": 15, "edit_0": 0}.get(case, 25)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("turn", [90, 180, 270])
def test_display_matrix_turns_as_cv2(tmp_path, turn):
    """A ``tkhd`` matrix of a quarter turn (as phones write them): cv2 turns
    each frame (``CAP_PROP_ORIENTATION_AUTO``) and so does the port; the
    JAX readers see the turned frames."""
    cv2 = pytest.importorskip("cv2")
    from v2e2v_tpu.data.video_readers import VideoReader as JaxReader

    mf = _script("make_mpeg4_fixtures")
    matrix = {90: (0, 1, -1, 0), 180: (-1, 0, 0, -1), 270: (0, -1, 1, 0)}[turn]
    path = tmp_path / "turned.mp4"
    path.write_bytes(mf.set_matrix((FIXTURES / "portrait.mp4").read_bytes(), *matrix))
    video = VideoFile(str(path))
    assert video.rotation == turn
    want = [cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) for f in _cv2_frames(cv2, path)]
    got = list(video)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    port, ref = VideoReader((180, 240)), JaxReader((180, 240))
    port.initialize(str(path))
    ref.initialize(str(path))
    for g, w in zip(port.frames, ref.frames, strict=True):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------ the headers

def test_vol_and_vop_headers():
    """The flagship's VOL as cv2's writer sets it, the Lavc user data, and
    the VOP types and quantisers of the 25-frame clip: I-VOPs at 0, 12 and
    24, P-VOPs between, whose rounding type flips every P-VOP."""
    dec = mpeg4.Mpeg4Decoder(Mp4File(str(FIXTURES / "flagship.mp4")).config)
    v = dec.vol
    assert (v.width, v.height, v.time_resolution, v.time_bits, v.object_type,
            v.low_delay) == (960, 720, 240, 8, 1, 1)
    assert dec.lavc_build == (62 << 16) + (28 << 8) + 101
    dec = mpeg4.Mpeg4Decoder(Mp4File(str(FIXTURES / "gop.mp4")).config)
    kinds, rounding = [], []
    for data in Mp4File(str(FIXTURES / "gop.mp4")).frames():
        bits = mpeg4.Bits(data)
        assert dec._headers(bits) is not None
        hdr = dec._vop(bits)
        kinds.append("IP"[hdr["kind"]])
        rounding.append(hdr["rounding"])
        assert 1 <= hdr["quant"] <= 31 and hdr["fcode"] >= 1
    assert "".join(kinds) == "I" + "P" * 11 + "I" + "P" * 11 + "I"
    flips = [rounding[k] for k in range(1, 12)]
    assert flips == [(k + 1) % 2 for k in range(11)] or flips == [k % 2 for k in range(11)]


@pytest.mark.parametrize("name", MPEG4)
def test_y_plane_matches_ffmpeg(name):
    """The decoded Y plane, every VOP of the clip (the flagship's first 4),
    against the plane cv2 returns with ``CAP_PROP_CONVERT_RGB = 0``."""
    cv2 = pytest.importorskip("cv2")
    path = FIXTURES / name
    want = _cv2_frames(cv2, path, CAP_PROP_CONVERT_RGB=0)
    video = VideoFile(str(path))
    n = 4 if name.startswith("flagship") else len(want)
    for i, (y, _cb, _cr) in zip(range(n), video.planes()):
        np.testing.assert_array_equal(y, want[i].reshape(-1)[:y.size].reshape(y.shape),
                                      err_msg=f"{name} frame {i}")


# ------------------------------------------------------ a stream writer

class BitWriter:
    def __init__(self):
        self.bits = []

    def put(self, value: int, n: int):
        self.bits += [(value >> (n - 1 - k)) & 1 for k in range(n)]

    def stuff(self) -> bytes:
        """MPEG-4's next_start_code stuffing: a 0, then 1s to a byte."""
        self.put(0, 1)
        while len(self.bits) % 8:
            self.put(1, 1)
        return bytes(int("".join(map(str, self.bits[k:k + 8])), 2)
                     for k in range(0, len(self.bits), 8))


def vol(width, height, *, verid=1, shape=0, interlaced=0, obmc_disable=1, sprite=0,
        not_8_bit=0, quant_type=0, quarter=0, complexity_disable=1, resync_disable=1,
        partitioned=0, newpred=0, resolution=30) -> bytes:
    """VOS, VO and a simple-profile VOL with these fields, and Lavc user data."""
    w = BitWriter()
    w.put(0, 1)  # random_accessible_vol
    w.put(1, 8)  # simple object type
    w.put(1, 1)
    w.put(verid, 4)
    w.put(1, 3)
    w.put(1, 4)  # square pixels
    w.put(1, 1)  # vol_control_parameters
    w.put(1, 2)
    w.put(1, 1)  # low_delay
    w.put(0, 1)  # vbv_parameters
    w.put(shape, 2)
    w.put(1, 1)
    w.put(resolution, 16)
    w.put(1, 1)
    w.put(0, 1)  # fixed_vop_rate
    if shape == 0:
        w.put(1, 1)
        w.put(width, 13)
        w.put(1, 1)
        w.put(height, 13)
        w.put(1, 1)
    w.put(interlaced, 1)
    w.put(obmc_disable, 1)
    w.put(sprite, 1 if verid == 1 else 2)
    w.put(not_8_bit, 1)
    if not_8_bit:
        w.put(5, 4)
        w.put(8, 4)
    w.put(quant_type, 1)
    if quant_type:
        w.put(0, 2)  # no matrices loaded
    if verid != 1:
        w.put(quarter, 1)
    w.put(complexity_disable, 1)
    w.put(resync_disable, 1)
    w.put(partitioned, 1)
    if partitioned:
        w.put(0, 1)
    if verid != 1:
        w.put(newpred, 1)
        if newpred:
            w.put(0, 3)
        w.put(0, 1)  # reduced_resolution_vop_enable
    w.put(0, 1)  # scalability
    return (b"\x00\x00\x01\xb0\x01\x00\x00\x01\xb5\x09\x00\x00\x01\x00\x00\x00\x01\x20"
            + w.stuff() + LAVC)


def vop_header(kind: int, quant: int = 2, time_bits: int = 5, fcode: int = 1, thr: int = 0,
               rounding: int = 0) -> BitWriter:
    """A VOP's header up to its first macroblock."""
    w = BitWriter()
    for byte in b"\x00\x00\x01\xb6":
        w.put(byte, 8)
    w.put(kind, 2)
    w.put(0, 1)  # modulo_time_base
    w.put(1, 1)
    w.put(0, time_bits)
    w.put(1, 1)
    w.put(1, 1)  # vop_coded
    if kind in (1, 3):
        w.put(rounding, 1)  # vop_rounding_type
    w.put(thr, 3)  # intra_dc_vlc_thr: 0, the DC VLCs always
    w.put(quant, 5)
    if kind != 0:
        w.put(fcode, 3)
    if kind == 2:
        w.put(1, 3)
    return w


def dc_only_vop(ylev: np.ndarray, cblev: np.ndarray, crlev: np.ndarray) -> bytes:
    """An I-VOP of DC-only intra blocks at QP 2 (dc_scaler 8): each luma
    block of ``ylev`` ([2 mbh, 2 mbw]) and chroma block flat at its level.
    The DC differences follow the decoder's gradient prediction."""
    w = vop_header(0)
    pred = [np.full((a.shape[0] + 1, a.shape[1] + 1), 1024) for a in (ylev, cblev, crlev)]
    mbh, mbw = cblev.shape
    for my in range(mbh):
        for mx in range(mbw):
            w.put(1, 1)  # MCBPC: intra, no chroma coded
            w.put(0, 1)  # ac_pred_flag
            w.put(*mpeg4.CBPY[0])  # no luma coded
            for n in range(6):
                comp = 0 if n < 4 else n - 3
                r, c = (2 * my + (n >> 1), 2 * mx + (n & 1)) if n < 4 else (my, mx)
                level = int((ylev, cblev, crlev)[comp][r, c])
                p = pred[comp]
                a, b, cc = int(p[r + 1, c]), int(p[r, c]), int(p[r, c + 1])
                near = cc if abs(a - b) < abs(b - cc) else a
                diff = level - (near + 4) // 8
                p[r + 1, c + 1] = level * 8
                size = abs(diff).bit_length()
                w.put(*(mpeg4.DC_LUMA if n < 4 else mpeg4.DC_CHROMA)[size])
                if size:
                    w.put(diff if diff > 0 else diff + (1 << size) - 1, size)
                    if size > 8:
                        w.put(1, 1)
    return w.stuff()


def _tcoef_codes(vlc, runs, levels, first_last):
    """(last, run, level) -> (code, length) of a TCOEF table, and its
    max_level[last][run] and max_run[last][level]."""
    codes, max_level, max_run = {}, {}, {}
    for sym in range(len(vlc) - 1):
        last = int(sym >= first_last)
        codes[last, runs[sym], levels[sym]] = vlc[sym]
        max_level[last, runs[sym]] = max(max_level.get((last, runs[sym]), 0), levels[sym])
        max_run[last, levels[sym]] = max(max_run.get((last, levels[sym]), -1), runs[sym])
    return codes, max_level, max_run


TCOEF = {True: _tcoef_codes(mpeg4.INTRA_VLC, mpeg4.INTRA_RUN, mpeg4.INTRA_LEVEL,
                            mpeg4.INTRA_LAST),
         False: _tcoef_codes(mpeg4.INTER_VLC, mpeg4.INTER_RUN, mpeg4.INTER_LEVEL,
                             mpeg4.INTER_LAST)}


def put_tcoef(w: BitWriter, intra: bool, last: int, run: int, level: int) -> None:
    """One TCOEF as FFmpeg's encoder picks it: its VLC, else escape 1
    (the level less max_level), else escape 2 (the run less max_run + 1),
    else escape 3."""
    codes, max_level, max_run = TCOEF[intra]
    esc = (mpeg4.INTRA_VLC if intra else mpeg4.INTER_VLC)[-1]
    mag, sign = abs(level), int(level < 0)
    if (last, run, mag) in codes:
        w.put(*codes[last, run, mag])
        w.put(sign, 1)
        return
    lv1 = mag - max_level.get((last, run), 0)
    if lv1 > 0 and (last, run, lv1) in codes:
        w.put(*esc)
        w.put(0, 1)
        w.put(*codes[last, run, lv1])
        w.put(sign, 1)
        return
    run2 = run - max_run.get((last, mag), -10 ** 6) - 1
    if run2 >= 0 and (last, run2, mag) in codes:
        w.put(*esc)
        w.put(0b10, 2)
        w.put(*codes[last, run2, mag])
        w.put(sign, 1)
        return
    w.put(*esc)
    w.put(0b11, 2)
    w.put(last, 1)
    w.put(run, 6)
    w.put(1, 1)
    w.put(level & 0xFFF, 12)
    w.put(1, 1)


def put_block(w: BitWriter, rng, intra: bool, first: int) -> None:
    """A random block of TCOEFs from scan index ``first``: sparse, mostly
    small levels, now and then a long run or a level past the tables."""
    n = int(rng.choice([1, 2, 4, 9]))
    pos = sorted(rng.choice(np.arange(first, 64), min(n, 64 - first), replace=False))
    prev = first - 1
    for k, p in enumerate(pos):
        big = rng.random() < 0.15
        mag = int(rng.integers(1, 31 if big else 4))
        put_tcoef(w, intra, int(k == len(pos) - 1), int(p - prev - 1),
                  mag if rng.random() < 0.5 else -mag)
        prev = p


def put_mvd(w: BitWriter, d: int, fcode: int) -> None:
    """A motion vector difference of ``d`` half-pels at ``fcode``."""
    if d == 0:
        w.put(*mpeg4.MVD[0])
        return
    shift = fcode - 1
    code, r = ((abs(d) - 1) >> shift) + 1, (abs(d) - 1) & ((1 << shift) - 1)
    w.put(*mpeg4.MVD[code])
    w.put(int(d < 0), 1)
    if shift:
        w.put(r, shift)


def random_vop(rng, kind: int, mbw: int, mbh: int, fcode: int = 1, thr: int = 0,
               rounding: int = 0, quant: int = 8) -> bytes:
    """An I- or P-VOP of random macroblocks, each syntax element within what
    FFmpeg decodes without concealment: skipped, inter and intra MBs,
    DQUANT (+q types) keeping QP in 1-12, MCBPC stuffing, AC prediction,
    coded and uncoded blocks, TCOEFs through every escape, MVDs over the
    whole range of ``fcode``. Intra DCs follow the decoder's prediction to
    land on levels of 1-255 (FFmpeg refuses a negative one)."""
    w = vop_header(kind, quant=quant, fcode=fcode, thr=thr, rounding=rounding)
    q = quant
    # the DC predictors, as the decoder keeps them: level x dc_scaler per
    # block, 1024 outside and for the blocks of non-intra MBs
    pred = [np.full((2 * mbh + 1, 2 * mbw + 1), 1024), np.full((mbh + 1, mbw + 1), 1024),
            np.full((mbh + 1, mbw + 1), 1024)]
    for mb in range(mbw * mbh):
        my, mx = divmod(mb, mbw)
        intra = kind == 0 or rng.random() < 0.25
        skip = kind == 1 and rng.random() < 0.2
        if not intra:
            pred[0][2 * my + 1:2 * my + 3, 2 * mx + 1:2 * mx + 3] = 1024
            pred[1][my + 1, mx + 1] = pred[2][my + 1, mx + 1] = 1024
        if kind == 1:
            w.put(int(skip), 1)  # not_coded
            if skip:
                continue
            if rng.random() < 0.05:
                w.put(*mpeg4.INTER_MCBPC[20])  # stuffing, then the MB again
                w.put(0, 1)
        steps = [k for k, d in enumerate(mpeg4.DQUANT) if 1 <= q + d <= 12]
        dq = rng.random() < 0.3
        cbpc, cbpy = int(rng.integers(0, 4)), int(rng.integers(0, 16))
        if kind == 0:
            if rng.random() < 0.05:
                w.put(*mpeg4.INTRA_MCBPC[8])  # stuffing
            w.put(*mpeg4.INTRA_MCBPC[4 * dq + cbpc])
        else:
            w.put(*mpeg4.INTER_MCBPC[(12 if intra else 8) * dq + 4 * (intra and not dq)
                                     + cbpc])
        if intra:
            w.put(int(rng.random() < 0.5), 1)  # ac_pred_flag
            w.put(*mpeg4.CBPY[cbpy])
        else:
            w.put(*mpeg4.CBPY[cbpy ^ 15])
        if dq:
            step = int(rng.choice(steps))
            w.put(step, 2)
            q += mpeg4.DQUANT[step]
        if not intra:
            span = 16 << (fcode - 1)
            for _ in range(2):
                put_mvd(w, int(rng.integers(-span, span)), fcode)
        cbp = (cbpy << 2) | cbpc
        use_dc = intra and q < mpeg4.DC_THRESHOLD[thr]
        for n in range(6):
            if intra:
                comp = 0 if n < 4 else n - 3
                r, c = (2 * my + (n >> 1), 2 * mx + (n & 1)) if n < 4 else (my, mx)
                scale = (mpeg4.Y_DC_SCALE if n < 4 else mpeg4.C_DC_SCALE)[q]
                p = pred[comp]
                a, b, cc = int(p[r + 1, c]), int(p[r, c]), int(p[r, c + 1])
                near = cc if abs(a - b) < abs(b - cc) else a
                level = int(rng.integers(1, 256)) * 8 // scale
                p[r + 1, c + 1] = min(level * scale, 2047)
            if use_dc:
                diff = level - (near + (scale >> 1)) // scale
                size = abs(diff).bit_length()
                w.put(*(mpeg4.DC_LUMA if n < 4 else mpeg4.DC_CHROMA)[size])
                if size:
                    w.put(diff if diff > 0 else diff + (1 << size) - 1, size)
                    if size > 8:
                        w.put(1, 1)
            if (cbp >> (5 - n)) & 1:
                put_block(w, rng, intra, 1 if use_dc else 0)
    return w.stuff()


RANDOM_CASES = ["intra_dc_vlc", "intra_dc_in_tcoef", "fcode_1", "fcode_3", "fcode_7",
                "odd_75x49"]


@pytest.mark.parametrize("case", RANDOM_CASES)
def test_random_vops_match_ffmpeg(tmp_path, case):
    """Crafted streams of random macroblocks (80x48, or 75x49 on the same
    grid): an I-VOP, P-VOPs of both rounding types, an I-VOP among them,
    decoded by cv2 (FFmpeg) and by the port: the Y plane
    (``CAP_PROP_CONVERT_RGB = 0``) and the BGR frame equal at every pixel.
    They reach what cv2's writer never writes: DQUANT in every MB type and
    AC prediction rescaled across MBs of other QPs, the intra DC coded among
    the TCOEFs (intra_dc_vlc_thr 7), escapes of long runs and large levels,
    MCBPC stuffing, vectors over the whole range of f_code 1, 3 and 7 (far
    past the edges), and chroma's inexact no-rounding averages next to 0."""
    cv2 = pytest.importorskip("cv2")
    fx = _script("make_video_fixtures")
    rng = np.random.default_rng(RANDOM_CASES.index(case))
    thr = 7 if case == "intra_dc_in_tcoef" else 0
    fcode = int(case[-1]) if case.startswith("fcode") else 2
    w, h = (75, 49) if case == "odd_75x49" else (80, 48)
    mbw, mbh = -(-w // 16), -(-h // 16)
    vops = [random_vop(rng, 0, mbw, mbh, thr=thr)]
    for k in range(6):
        vops.append(random_vop(rng, 0 if k == 3 else 1, mbw, mbh, fcode=fcode, thr=thr,
                               rounding=k % 2, quant=int(rng.integers(2, 13))))
    vops[0] = vol(w, h) + vops[0]
    path = tmp_path / "random.avi"
    fx.write_avi(path, vops, w, h, 30, fourcc=b"XVID")
    want_y = _cv2_frames(cv2, path, CAP_PROP_CONVERT_RGB=0)
    want = _cv2_frames(cv2, path)
    got = list(VideoFile(str(path)).planes())
    assert len(got) == len(want) == len(want_y) == 7
    for i, ((y, cb, cr), wy, bgr) in enumerate(zip(got, want_y, want)):
        np.testing.assert_array_equal(y, wy.reshape(-1)[:y.size].reshape(y.shape),
                                      err_msg=f"{case} VOP {i}")
        np.testing.assert_array_equal(yuv.yuv420p_to_bgr(y, cb, cr), bgr,
                                      err_msg=f"{case} VOP {i}")


# ---------------------------------------------------- the conversion

def test_conversion_holds_on_chosen_triples(tmp_path):
    """Crafted DC-only I-VOPs at 512x512 feed (Y, Cb, Cr) triples through
    cv2's whole MPEG-4 path: every Y against four chroma pairs, every Cb and
    every Cr at Y 16, 128 and 235, then random triples. The port decodes
    the intended flat planes, and converts them to cv2's BGR at every pixel
    (limited range, clipping included)."""
    cv2 = pytest.importorskip("cv2")
    fx = _script("make_video_fixtures")
    rng = np.random.default_rng(11)
    frames = []
    for k in range(6):
        y = rng.integers(0, 256, (64, 64))
        cb, cr = rng.integers(0, 256, (2, 32, 32))
        if k == 0:
            y.flat[:256 * 4] = np.repeat(np.arange(256), 4)
            cb[:16], cr[:16] = 128, 128
            cb[16:24], cr[16:24] = 0, 255
            cb[24:], cr[24:] = 255, 0
        elif k in (1, 2):
            ch = cb if k == 1 else cr
            ch.flat[:256], ch.flat[256:512], ch.flat[512:768] = (np.arange(256),) * 3
            (cr if k == 1 else cb)[:] = 128
            y[:16], y[16:32], y[32:48] = 16, 128, 235
        frames.append((y, cb, cr))
    chunks = [dc_only_vop(*f) for f in frames]
    chunks[0] = vol(512, 512) + chunks[0]
    fx.write_avi(tmp_path / "dc.avi", chunks, 512, 512, 30, fourcc=b"XVID")
    want = _cv2_frames(cv2, tmp_path / "dc.avi")
    video = VideoFile(str(tmp_path / "dc.avi"))
    got = list(video.planes())
    assert len(got) == len(want) == len(frames)
    for (yl, cbl, crl), (y, cb, cr), bgr in zip(frames, got, want):
        np.testing.assert_array_equal(y, yl.repeat(8, 0).repeat(8, 1))
        np.testing.assert_array_equal(cb, cbl.repeat(8, 0).repeat(8, 1))
        np.testing.assert_array_equal(cr, crl.repeat(8, 0).repeat(8, 1))
        np.testing.assert_array_equal(yuv.yuv420p_to_bgr(y, cb, cr), bgr)


def test_odd_heights_take_the_general_scaler(tmp_path):
    """A clip written at 80x64 whose VOL says 80x49: an odd height sends
    swscale to its general scaler with half-width chroma (the MMX output,
    the C one on the last two rows), MPEG-4's left-sited chroma at position
    64; the port's frames equal cv2's."""
    cv2 = pytest.importorskip("cv2")
    mf = _script("make_mpeg4_fixtures")
    path = tmp_path / "h49.mp4"
    path.write_bytes(mf.patch_vol_size((FIXTURES / "odd.mp4").read_bytes(), 80, 49))
    want = [cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) for f in _cv2_frames(cv2, path)]
    got = list(VideoFile(str(path)))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.shape == (49, 80)
        np.testing.assert_array_equal(g, w)


def test_limited_general_scaler_on_raw_i420(tmp_path):
    """swscale's general scaler at limited range on raw I420 AVIs of random
    odd heights, odd and even widths (FFmpeg's rawvideo: unspecified range,
    chroma sited at the centre, position 128): ``general_bgr`` at limited range
    equals ``cap.read()``. Raw I420 of an even height takes another route
    than the decoders' frames (unaligned rows), so only odd heights are
    held here."""
    cv2 = pytest.importorskip("cv2")
    fx = _script("make_video_fixtures")
    rng = np.random.default_rng(5)
    for k in range(8):
        h = int(rng.integers(3, 200)) | 1
        w = int(rng.integers(4, 200))
        w = w | 1 if k % 2 else w & ~1
        ch, cw = (h + 1) // 2, (w + 1) // 2
        y = rng.integers(0, 256, (h, w), dtype=np.uint8)
        cb, cr = rng.integers(0, 256, (2, ch, cw), dtype=np.uint8)
        fx.write_avi(tmp_path / "r.avi", [y.tobytes() + cb.tobytes() + cr.tobytes()], w, h, 30,
                     fourcc=b"I420")
        want = _cv2_frames(cv2, tmp_path / "r.avi")[0]
        np.testing.assert_array_equal(yuv.general_bgr(y, cb, cr, (1, 1), limited=True), want,
                                      err_msg=f"{h}x{w}")


# ------------------------------------------------------------- the IDCT

W = (0, 22725, 21407, 19266, 16383, 12873, 8867, 4520)


def _scalar_idct_add(block, dest):
    """``simple_idct_template.c``'s ``idctRowCondDC`` and ``idctSparseColAdd``
    at 8 bits, element by element as the C code goes (rows stored as int16)."""
    b = [list(map(int, block[8 * r:8 * r + 8])) for r in range(8)]
    for row in b:
        if not any(row[1:]):
            v = ((row[0] * 8) & 0xFFFF)
            row[:] = [v - 0x10000 if v >= 0x8000 else v] * 8
            continue
        a0 = W[4] * row[0] + (1 << 10)
        a1, a2, a3 = a0 + W[6] * row[2], a0 - W[6] * row[2], a0 - W[2] * row[2]
        a0 += W[2] * row[2]
        b0 = W[1] * row[1] + W[3] * row[3]
        b1 = W[3] * row[1] - W[7] * row[3]
        b2 = W[5] * row[1] - W[1] * row[3]
        b3 = W[7] * row[1] - W[5] * row[3]
        a0 += W[4] * row[4] + W[6] * row[6]
        a1 += -W[4] * row[4] - W[2] * row[6]
        a2 += -W[4] * row[4] + W[2] * row[6]
        a3 += W[4] * row[4] - W[6] * row[6]
        b0 += W[5] * row[5] + W[7] * row[7]
        b1 += -W[1] * row[5] - W[5] * row[7]
        b2 += W[7] * row[5] + W[3] * row[7]
        b3 += W[3] * row[5] - W[1] * row[7]
        row[:] = [(a0 + b0) >> 11, (a1 + b1) >> 11, (a2 + b2) >> 11, (a3 + b3) >> 11,
                  (a3 - b3) >> 11, (a2 - b2) >> 11, (a1 - b1) >> 11, (a0 - b0) >> 11]
    out = np.array(dest, np.int64).reshape(8, 8)
    for c in range(8):
        col = [b[r][c] for r in range(8)]
        a0 = W[4] * (col[0] + ((1 << 19) // W[4]))
        a1, a2, a3 = a0 + W[6] * col[2], a0 - W[6] * col[2], a0 - W[2] * col[2]
        a0 += W[2] * col[2]
        b0 = W[1] * col[1] + W[3] * col[3]
        b1 = W[3] * col[1] - W[7] * col[3]
        b2 = W[5] * col[1] - W[1] * col[3]
        b3 = W[7] * col[1] - W[5] * col[3]
        a0, a1, a2, a3 = (a0 + W[4] * col[4], a1 - W[4] * col[4], a2 - W[4] * col[4],
                          a3 + W[4] * col[4])
        b0, b1, b2, b3 = (b0 + W[5] * col[5], b1 - W[1] * col[5], b2 + W[7] * col[5],
                          b3 + W[3] * col[5])
        a0, a1, a2, a3 = (a0 + W[6] * col[6], a1 - W[2] * col[6], a2 + W[2] * col[6],
                          a3 - W[6] * col[6])
        b0, b1, b2, b3 = (b0 + W[7] * col[7], b1 - W[5] * col[7], b2 + W[3] * col[7],
                          b3 - W[1] * col[7])
        vals = [a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3, a2 - b2, a1 - b1, a0 - b0]
        for r in range(8):
            out[r, c] = min(max(out[r, c] + (vals[r] >> 20), 0), 255)
    return out.reshape(64)


def test_idct_simple_add_matches_the_c_code():
    """``jpeg.idct_simple_add`` (inter residuals added to the prediction)
    against a scalar copy of FFmpeg's ``ff_simple_idct_add_int16_8bit`` on
    sparse and dense blocks, DC-only rows among them, and clipping both
    ways; with a zero prediction it is ``idct_simple``."""
    rng = np.random.default_rng(2)
    blocks = np.zeros((40, 64), np.int64)
    for k in range(40):
        n = [1, 3, 10, 64][k % 4]
        blocks[k, rng.choice(64, n, replace=False)] = rng.integers(-400, 400, n)
    blocks[0] = 0
    blocks[0, 0] = 1000
    pred = rng.integers(0, 256, (40, 64))
    pred[1] = 250
    got = jpeg.idct_simple_add(blocks, pred)
    for k in range(40):
        np.testing.assert_array_equal(got[k], _scalar_idct_add(blocks[k], pred[k]),
                                      err_msg=f"block {k}")
    zero = np.zeros_like(pred)
    np.testing.assert_array_equal(jpeg.idct_simple_add(blocks, zero), jpeg.idct_simple(blocks))


# ------------------------------------------------------------- refusals

def _written(tmp_path, fourcc="XVID"):
    """A small clip of cv2's writer: its AVI chunks."""
    mf = _script("make_mpeg4_fixtures")
    rng = np.random.default_rng(4)
    mf.write(tmp_path / "w.avi", mf.pan(rng, 32, 48, 3, (1, 1)), 30.0, fourcc)
    return list(AviFile(str(tmp_path / "w.avi")).frames())


def _vop_case(case):
    """A crafted VOP (after an I-VOP of the VOL ``vol(48, 32)``) that the
    port refuses."""
    if case == "b_vop":
        return vop_header(2).stuff()
    if case == "s_vop":
        return vop_header(3).stuff()
    w = vop_header(1)  # a P-VOP whose first MB is inter4v
    w.put(0, 1)
    w.put(*mpeg4.INTER_MCBPC[16])
    return w.stuff()


MPEG4_REFUSALS = {
    "b_vop": "B-VOP", "s_vop": "S-VOP", "inter4v": "inter4v",
    "sprite": "sprites or GMC", "quarter_pel": "quarter-pel", "interlaced": "interlaced VOL",
    "obmc": "OBMC", "data_partitioning": "data partitioning",
    "resync_markers": "resync markers", "mpeg_quant": "MPEG quantisation",
    "short_video_header": "short_video_header", "shape": "non-rectangular",
    "not_8_bit": "not_8_bit", "newpred": "newpred", "complexity": "complexity estimation",
    "no_lavc": "no libavcodec user data",
}
VOL_FIELDS = {"sprite": {"sprite": 1}, "quarter_pel": {"verid": 2, "quarter": 1},
              "interlaced": {"interlaced": 1}, "obmc": {"obmc_disable": 0},
              "data_partitioning": {"partitioned": 1}, "resync_markers": {"resync_disable": 0},
              "mpeg_quant": {"quant_type": 1}, "shape": {"shape": 1},
              "not_8_bit": {"not_8_bit": 1}, "newpred": {"verid": 2, "newpred": 1},
              "complexity": {"complexity_disable": 0}}


@pytest.mark.parametrize("case", sorted(MPEG4_REFUSALS))
def test_mpeg4_refusals_name_item_4(tmp_path, case):
    """Each MPEG-4 tool the port does not decode, reached by a crafted VOL
    or VOP in an XVID AVI (the first chunk cv2's I-VOP behind the crafted
    headers), raises from the readers naming what it is and ROADMAP item 4."""
    fx = _script("make_video_fixtures")
    first = dc_only_vop(np.full((4, 6), 100), np.full((2, 3), 128), np.full((2, 3), 128))
    headers = vol(48, 32, **VOL_FIELDS.get(case, {}))
    if case == "no_lavc":
        headers = headers[:-len(LAVC)]
    chunks = [headers + first]
    if case == "short_video_header":
        chunks = [b"\x00\x00\x80\x02\x08" + bytes(20)]
    elif case in ("b_vop", "s_vop", "inter4v"):
        chunks.append(_vop_case(case))
    path = tmp_path / "refused.avi"
    fx.write_avi(path, chunks, 48, 32, 30, fourcc=b"XVID")
    with pytest.raises(ValueError, match=f"(?s){MPEG4_REFUSALS[case]}.*item 4"):
        VideoReader((180, 240)).initialize(str(path))
    with pytest.raises(ValueError, match="item 4"):
        list(VideoSequence(str(path)))


CONTAINER_REFUSALS = {"avc1": "codec 'avc1'", "object_type": "object type 0x6A",
                      "two_tracks": "2 video tracks", "flip": "display matrix",
                      "truncated": "corrupt or truncated", "edit_shift": "edit list",
                      "wmv": "ASF video stream of codec 'WMV3'",
                      "flv_avc": "AVC \\(H.264\\) \\(codec id 7\\)"}


def _container_case(cv2, tmp_path, case):
    mf = _script("make_mpeg4_fixtures")
    data = (FIXTURES / "flat.mp4").read_bytes()
    path = tmp_path / "refused.mp4"
    if case == "avc1":
        pos, head, _ = mf.find(data, b"mp4v")
        data = data[:pos + 4] + b"avc1" + data[pos + 8:]
    elif case == "object_type":
        k = data.find(b"esds")
        k = data.index(b"\x04", k + 12)  # DecoderConfigDescriptor's tag
        while data[k + 1] & 0x80:
            k += 1
        data = data[:k + 2] + b"\x6a" + data[k + 3:]
    elif case == "two_tracks":
        pos, head, size = mf.find(data, b"trak")
        mpos, mhead, msize = mf.find(data, b"moov")
        trak = data[pos:pos + size]
        data = (data[:mpos] + struct.pack(">I", msize + size) + data[mpos + 4:pos + size]
                + trak + data[pos + size:])
    elif case == "flip":
        data = mf.set_matrix(data, -1, 0, 0, 1)
    elif case == "truncated":
        mpos, _, _ = mf.find(data, b"moov")
        data = data[:mpos + 200]
    elif case == "edit_shift":
        pos, head, _ = mf.find(data, b"elst")
        data = data[:pos + head + 12] + struct.pack(">i", 512) + data[pos + head + 16:]
    else:  # the formats cv2 writes that the port leaves for later
        path = tmp_path / f"clip.{case[:3]}"
        fourcc = {"wmv": "WMV2", "flv_avc": "FLV1"}[case]
        mf.write(path, np.full((2, 32, 48, 3), 90, np.uint8), 30.0, fourcc)
        assert len(_cv2_frames(cv2, path)) == 2
        if case == "wmv":  # WMV2 in ASF is read: its tag rewritten to WMV3's (VC-1)
            path.write_bytes(path.read_bytes().replace(b"WMV2", b"WMV3"))
        if case == "flv_avc":  # Sorenson H.263 is read: its tags rewritten to AVC's codec id
            data = bytearray(path.read_bytes())
            pos = 13
            while pos + 11 <= len(data):
                if data[pos] == 9:
                    data[pos + 11] = data[pos + 11] & 0xF0 | 7
                pos += 15 + int.from_bytes(data[pos + 1:pos + 4], "big")
            path.write_bytes(bytes(data))
        return path
    path.write_bytes(data)
    return path


@pytest.mark.parametrize("case", sorted(CONTAINER_REFUSALS))
def test_container_refusals_name_item_4(tmp_path, case):
    """MP4s the port does not read (another codec or object type, two video
    tracks, a flip in the display matrix, a truncated ``moov``, an edit list
    that shifts the media), the WMV2 files cv2 writes retagged WMV3 (VC-1)
    and its FLV1 files rewritten to AVC's codec id raise
    naming what they are and ROADMAP item 4."""
    cv2 = pytest.importorskip("cv2")
    path = _container_case(cv2, tmp_path, case)
    with pytest.raises(ValueError, match=f"(?s){CONTAINER_REFUSALS[case]}.*item 4"):
        VideoReader((180, 240)).initialize(str(path))


def test_dropped_chunks_are_skipped_as_ffmpeg_does(tmp_path):
    """An XVID AVI whose third chunk is empty (a dropped frame): FFmpeg's
    demuxer skips it, no frame comes out for it, and the port's frames are
    cv2's."""
    cv2 = pytest.importorskip("cv2")
    fx = _script("make_video_fixtures")
    chunks = _written(tmp_path)
    chunks.insert(2, b"")
    fx.write_avi(tmp_path / "dropped.avi", chunks, 48, 32, 30, fourcc=b"XVID")
    want = [cv2.cvtColor(f, cv2.COLOR_BGR2GRAY)
            for f in _cv2_frames(cv2, tmp_path / "dropped.avi")]
    got = list(VideoFile(str(tmp_path / "dropped.avi")))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fourcc", ["DIVX", "DX50", "mp4v"])
def test_other_mpeg4_fourccs_read(tmp_path, fourcc):
    """The XVID clip's chunks under the other fourccs FFmpeg decodes with
    ``mpeg4`` (DIVX, DX50, and mp4v, which cv2 also writes): the same
    frames as cv2's."""
    cv2 = pytest.importorskip("cv2")
    fx = _script("make_video_fixtures")
    chunks = _written(tmp_path)
    fx.write_avi(tmp_path / "f.avi", chunks, 48, 32, 30, fourcc=fourcc.encode())
    want = [cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) for f in _cv2_frames(cv2, tmp_path / "f.avi")]
    got = list(VideoFile(str(tmp_path / "f.avi")))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
