"""The port's video path (``v2e2v_tpu_torch/utils/avi.py``, ``jpeg.py::
decode_mjpeg_frame``, ``yuv.py``, ``image_io.resize_linear_u8``, ``video.py``,
``data/video_readers.VideoReader``, ``data/manifests.VideoSequence``) against
cv2 and the JAX package's readers, which read through ``cv2.VideoCapture``
(FFmpeg) on the same files.

Every stage is held bit for bit: the demuxer's fps, frame count and packets
(cv2's raw mode, ``CAP_PROP_FORMAT = -1``), the Y plane (cv2's
``CAP_PROP_CONVERT_RGB = 0``), the BGR frame (``cap.read()``), the gray
(``cvtColor``, all 2^24 BGR triples), ``cv2.resize``, and so the readers: the
port's ``VideoReader`` and ``VideoSequence`` frames equal the JAX ones at
every pixel (exact share 1.0, max difference 0) on every fixture clip, with
equal stamps, counts and shapes: 4:2:0, 4:2:2, 4:4:4, 4:1:1, 4:4:0 and gray
frames, baseline and progressive, of even and odd sizes (swscale's unscaled
converter, its palette converter and its general scaler, ``utils/yuv.py``).
What the port does not read raises and names ROADMAP item 4.

The fixtures under ``tests/data/video`` (``scripts/make_video_fixtures.py``)
are checked twice: the port against ``manifest.json`` and
``reader_frames.npz``, which needs no cv2, and those records against cv2 and
the JAX readers wherever they are installed.
"""

import hashlib
import importlib.util
import json
import struct
from pathlib import Path

import numpy as np
import pytest

from v2e2v_tpu_torch.data.manifests import VideoSequence
from v2e2v_tpu_torch.data.video_readers import VideoReader
from v2e2v_tpu_torch.utils import jpeg, yuv
from v2e2v_tpu_torch.utils.avi import AviFile
from v2e2v_tpu_torch.utils.image_io import resize_linear_u8
from v2e2v_tpu_torch.utils.video import VideoFile

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "data" / "video"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())["clips"]
PORTED = sorted(n for n, e in MANIFEST.items() if e["ported"])
SMALL = [n for n in PORTED if n != "flagship.avi" and not n.startswith("hd_")]


def _fixture_script():
    spec = importlib.util.spec_from_file_location(
        "make_video_fixtures", REPO / "scripts" / "make_video_fixtures.py")
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

@pytest.mark.parametrize("name", PORTED)
def test_fixtures_match_manifest(name):
    """The port's readers over each clip against what the JAX readers
    returned when the fixtures were written: fps, count, stamps, shapes and
    every frame's hash; the reader's frames against ``reader_frames.npz``."""
    want = MANIFEST[name]
    path = str(FIXTURES / name)
    video = VideoFile(path)
    assert (video.fps, video.frame_count) == (want["fps"], want["frame_count"])
    reader = VideoReader((180, 240))
    reader.initialize(path)
    assert reader.num_frames == want["frames_read"]
    assert reader.timestamps == want["timestamps"]
    assert list(reader.frames[0].shape) == want["reader_shape"]
    assert [_sha(f) for f in reader.frames] == want["reader_sha256"]
    np.testing.assert_array_equal(np.stack(reader.frames),
                                  np.load(FIXTURES / "reader_frames.npz")[name[:-4]])
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
        if name == "flagship.avi":
            continue  # test_flagship_matches_the_jax_reader reads it
        reader = JaxReader((180, 240))
        reader.initialize(path)
        assert [_sha(f) for f in reader.frames] == want["reader_sha256"], name
        pairs = list(JaxSequence(path))
        assert [_sha(f) for f in [pairs[0][0]] + [p[1] for p in pairs]] == \
            want["sequence_sha256"], name


# ------------------------------------------------------------- the demuxer

@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_demuxer_matches_cv2(name):
    """fps and count as ``CAP_PROP_FPS`` / ``CAP_PROP_FRAME_COUNT``, and
    each frame's bytes as cv2's raw mode hands out FFmpeg's packets (the
    dropped frame of restart.avi skipped by both)."""
    cv2 = pytest.importorskip("cv2")
    path = FIXTURES / name
    avi = AviFile(str(path))
    cap = cv2.VideoCapture(str(path))
    assert avi.fps == cap.get(cv2.CAP_PROP_FPS)
    assert avi.frame_count == cap.get(cv2.CAP_PROP_FRAME_COUNT)
    cap.release()
    packets = [p.tobytes() for p in _cv2_frames(cv2, path, CAP_PROP_FORMAT=-1)]
    assert packets and list(avi.frames()) == packets


@pytest.mark.parametrize("case", ["idx1", "idx1_absolute", "none", "rec_junk", "odml_2",
                                  "odml_4", "dmlh_9",
                                  "length_0", "length_9", "rate_24000_1001", "rate_7_3",
                                  "dropped_first", "dropped_last"])
def test_demuxer_layouts_match_cv2(tmp_path, case):
    """The AVI layouts a demuxer meets, each against cv2: with and without
    an index (``idx1`` offsets from the 'movi' tag, or from the file's start
    as some writers put them), OpenDML over 2 and 4 RIFFs, a ``dwLength``
    or ``dmlh`` that disagrees with the chunks (cv2 reports ``dwLength`` all
    the same, 0 included), odd rates, and empty chunks first and last."""
    cv2 = pytest.importorskip("cv2")
    fx = _fixture_script()
    frames = [fx.imencode(f) for f in fx.scene(np.random.default_rng(1), 32, 48, 6)]
    kw = {"idx1": {}, "idx1_absolute": {}, "none": {"index": "none"},
          "rec_junk": {"rec": True, "junk": True},
          "odml_2": {"index": "odml", "riffs": 2}, "odml_4": {"index": "odml", "riffs": 4},
          "dmlh_9": {"index": "odml"}, "length_0": {}, "length_9": {},
          "rate_24000_1001": {"rate": 24000, "scale": 1001}, "rate_7_3": {"rate": 7, "scale": 3},
          "dropped_first": {}, "dropped_last": {"index": "none"}}[case]
    if case == "dropped_first":
        frames[0] = b""
    if case == "dropped_last":
        frames[-1] = b""
    kw.setdefault("rate", 30)
    path = tmp_path / "clip.avi"
    fx.write_avi(path, frames, 48, 32, **kw)
    if case in ("length_0", "length_9", "dmlh_9"):
        data = bytearray(path.read_bytes())
        if case == "dmlh_9":
            pos = data.index(b"dmlh") + 8
        else:
            pos = data.index(b"strh") + 8 + 32
        data[pos:pos + 4] = struct.pack("<I", 0 if case == "length_0" else 9)
        path.write_bytes(bytes(data))
    if case == "idx1_absolute":
        data = bytearray(path.read_bytes())
        movi, idx1 = data.index(b"movi"), data.index(b"idx1") + 8
        for k in range(6):
            at = idx1 + 16 * k + 8
            data[at:at + 4] = struct.pack("<I", struct.unpack("<I", data[at:at + 4])[0] + movi)
        path.write_bytes(bytes(data))
    avi = AviFile(str(path))
    cap = cv2.VideoCapture(str(path))
    assert (avi.fps, avi.frame_count) == (cap.get(cv2.CAP_PROP_FPS),
                                          cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    packets = [p.tobytes() for p in _cv2_frames(cv2, path, CAP_PROP_FORMAT=-1)]
    assert list(avi.frames()) == packets == [f for f in frames if f]


# ------------------------------------------------------ the frame decoder

@pytest.mark.parametrize("name", PORTED)
def test_y_plane_matches_ffmpeg(name):
    """The decoded Y plane, FFmpeg's simple_idct and all, against the plane
    cv2 returns with ``CAP_PROP_CONVERT_RGB = 0`` (the flagship's first 3
    frames)."""
    cv2 = pytest.importorskip("cv2")
    path = FIXTURES / name
    want = _cv2_frames(cv2, path, CAP_PROP_CONVERT_RGB=0)[:3]
    video = VideoFile(str(path))
    tables = None
    for i, data in zip(range(len(want)), video.avi.frames()):
        frame = video.decode(data, i, tables)
        tables = frame.tables
        np.testing.assert_array_equal(frame.planes[0], want[i], err_msg=f"{name} frame {i}")


@pytest.mark.parametrize("name", SMALL)
def test_bgr_matches_swscale(name):
    """The planes converted by ``yuv.mjpeg_to_bgr`` against ``cap.read()``,
    and their gray against ``cvtColor`` of it."""
    cv2 = pytest.importorskip("cv2")
    path = FIXTURES / name
    want = _cv2_frames(cv2, path)
    video = VideoFile(str(path))
    tables = None
    for i, data in enumerate(video.avi.frames()):
        frame = video.decode(data, i, tables)
        tables = frame.tables
        bgr = yuv.mjpeg_to_bgr(frame.planes, frame.factors)
        np.testing.assert_array_equal(bgr, want[i], err_msg=f"{name} frame {i}")
        np.testing.assert_array_equal(yuv.bgr_to_gray(bgr),
                                      cv2.cvtColor(want[i], cv2.COLOR_BGR2GRAY))
    assert i + 1 == len(want)


def _dc_only_jpeg(y, cb, cr):
    """A 4:2:0 baseline JPEG of flat blocks: ``y`` one value per 8x8 block,
    ``cb``, ``cr`` one per 16x16 MCU; all-one quantization tables and the
    standard DC tables, so each block decodes to its value exactly through
    any IDCT. Its AC tables code EOB alone."""
    dc = {0: jpeg.STD_DC_LUMA, 1: jpeg.STD_DC_CHROMA}
    codes = {}
    for t, (counts, symbols) in dc.items():
        code, k, codes[t] = 0, 0, {}
        for n in range(1, 17):
            for _ in range(counts[n - 1]):
                codes[t][symbols[k]] = (code, n)
                code, k = code + 1, k + 1
            code <<= 1
    eob = {0: (0, 1), 1: (0, 1)}  # AC tables of one code, '0', for symbol 0
    bits, pred = [], [0, 0, 0]

    def put(value, comp):
        t = min(comp, 1)
        d = 8 * (int(value) - 128) - pred[comp]
        pred[comp] += d
        s = abs(d).bit_length()
        bits.append(codes[t][s])
        if s:
            bits.append((d if d > 0 else d + (1 << s) - 1, s))
        bits.append(eob[t])
    for my in range(cb.shape[0]):
        for mx in range(cb.shape[1]):
            for v in range(2):
                for h in range(2):
                    put(y[2 * my + v, 2 * mx + h], 0)
            put(cb[my, mx], 1)
            put(cr[my, mx], 2)
    acc = "".join(format(c, f"0{n}b") for c, n in bits)
    acc += "1" * (-len(acc) % 8)
    ecs = bytes(int(acc[i:i + 8], 2) for i in range(0, len(acc), 8)).replace(b"\xff", b"\xff\x00")

    def seg(marker, body):
        return bytes((0xFF, marker)) + struct.pack(">H", len(body) + 2) + body
    h, w = y.shape[0] * 8, y.shape[1] * 8
    return (b"\xff\xd8" + seg(0xDB, b"\x00" + b"\x01" * 64 + b"\x01" + b"\x01" * 64)
            + seg(0xC0, struct.pack(">BHHB", 8, h, w, 3) + bytes((1, 0x22, 0, 2, 0x11, 1,
                                                                   3, 0x11, 1)))
            + seg(0xC4, b"\x00" + b"".join(jpeg.STD_DC_LUMA) + b"\x01"
                  + b"".join(jpeg.STD_DC_CHROMA)
                  + b"\x10" + bytes((1,) + (0,) * 15) + b"\x00"
                  + b"\x11" + bytes((1,) + (0,) * 15) + b"\x00")
            + seg(0xDA, bytes((3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0))) + ecs + b"\xff\xd9")


def test_conversion_holds_on_chosen_triples(tmp_path):
    """Flat DC-only frames feed (Y, Cb, Cr) triples into the conversion:
    every Cb and every Cr at Y 128, the other chroma at 128, then 98,304
    random triples, each at the middle of a block, away from the MCU's edges
    where chroma upsampling could blend. cv2's BGR equals the port's at
    every one, clipping included."""
    cv2 = pytest.importorskip("cv2")
    fx = _fixture_script()
    rng = np.random.default_rng(7)
    mh = mw = 32  # 512 x 512
    planes = []
    for k in range(8):
        y = rng.integers(0, 256, (2 * mh, 2 * mw))
        cb, cr = rng.integers(0, 256, (2, mh, mw))
        if k < 2:
            y[:] = 128
            (cb if k == 0 else cr).flat[:256] = np.arange(256)
            (cr if k == 0 else cb)[:] = 128
        planes.append((y, cb, cr))
    fx.write_avi(tmp_path / "dc.avi", [_dc_only_jpeg(*p) for p in planes], 16 * mw, 16 * mh, 30)
    got = _cv2_frames(cv2, tmp_path / "dc.avi")
    for (y, cb, cr), bgr in zip(planes, got, strict=True):
        for py, px, by, bx in ((4, 4, 0, 0), (4, 11, 0, 1), (11, 4, 1, 0), (11, 11, 1, 1)):
            yy, uu, vv = y[by::2, bx::2].astype(np.uint8), cb.astype(np.uint8), cr.astype(np.uint8)
            want = bgr[py::16, px::16]
            mine = yuv.mjpeg_to_bgr([yy.repeat(2, 0).repeat(2, 1), uu, vv],
                                    [(2, 2), (1, 1), (1, 1)])[::2, ::2]
            np.testing.assert_array_equal(mine, want)


def test_bgr_to_gray_matches_cv2_on_every_triple():
    cv2 = pytest.importorskip("cv2")
    gr = np.stack(np.meshgrid(np.arange(256), np.arange(256), indexing="ij"), -1).astype(np.uint8)
    for b0 in range(0, 256, 64):
        bgr = np.empty((64, 256 * 256, 3), np.uint8)
        bgr[..., 0] = np.arange(b0, b0 + 64)[:, None]
        bgr[..., 1:] = gr.reshape(-1, 2)
        np.testing.assert_array_equal(yuv.bgr_to_gray(bgr), cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY))


def test_standard_tables_are_libjpegs():
    """The Annex K.3 tables the decoder starts from are those libjpeg
    writes (``cv2.imencode`` without optimisation)."""
    cv2 = pytest.importorskip("cv2")
    ok, buf = cv2.imencode(".jpg", np.zeros((16, 16, 3), np.uint8))
    data, specs = buf.tobytes(), {}
    fx = _fixture_script()
    for marker, start, end in fx.segments(data):
        if marker == 0xC4:
            body, pos = data[start + 4:end], 0
            while pos < len(body):
                n = sum(body[pos + 1:pos + 17])
                specs[body[pos]] = (body[pos + 1:pos + 17], body[pos + 17:pos + 17 + n])
                pos += 17 + n
    assert specs == {0x00: jpeg.STD_DC_LUMA, 0x01: jpeg.STD_DC_CHROMA,
                     0x10: jpeg.STD_AC_LUMA, 0x11: jpeg.STD_AC_CHROMA}


def test_tables_persist_from_frame_to_frame(tmp_path):
    """A frame without DQT or DHT takes the previous frame's tables, as
    FFmpeg's decoder keeps them: equal to cv2, where a fresh decoder would
    find no quantization table."""
    cv2 = pytest.importorskip("cv2")
    fx = _fixture_script()
    imgs = fx.scene(np.random.default_rng(2), 32, 48, 3)
    first = fx.imencode(imgs[0], [cv2.IMWRITE_JPEG_QUALITY, 60])
    rest = []
    for img in imgs[1:]:
        data = fx.imencode(img, [cv2.IMWRITE_JPEG_QUALITY, 60])
        cut = [(s, e) for m, s, e in fx.segments(data) if m in (0xDB, 0xC4)]
        for s, e in reversed(cut):
            data = data[:s] + data[e:]
        rest.append(data)
    fx.write_avi(tmp_path / "t.avi", [first, *rest], 48, 32, 30)
    got = list(VideoFile(str(tmp_path / "t.avi")))
    want = [cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) for f in _cv2_frames(cv2, tmp_path / "t.avi")]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="no quantization table"):
        jpeg.decode_mjpeg_frame(rest[0])


def test_exif_orientation_is_not_applied(tmp_path):
    """An MJPEG frame's Exif orientation (6: rotate 90 degrees) is not
    applied, by FFmpeg or by the port: the frames keep the stream's 32x48."""
    cv2 = pytest.importorskip("cv2")
    fx = _fixture_script()
    spec = importlib.util.spec_from_file_location(
        "make_jpeg_fixtures", REPO / "scripts" / "make_jpeg_fixtures.py")
    jfx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jfx)
    frames = [jfx.with_segment(fx.imencode(f), jfx.exif_app1(6))
              for f in fx.scene(np.random.default_rng(4), 32, 48, 2)]
    fx.write_avi(tmp_path / "exif.avi", frames, 48, 32, 30)
    got = list(VideoFile(str(tmp_path / "exif.avi")))
    want = [cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) for f in _cv2_frames(cv2, tmp_path / "exif.avi")]
    assert [g.shape for g in got] == [w.shape for w in want] == [(32, 48)] * 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_idct_simple_dc_rows_and_range():
    """A row with no AC term takes simple_idct's shortcut (DC << 3, which
    the full row pass misses at DC -1024); flat blocks decode exactly."""
    x = np.zeros((3, 64), np.int64)
    x[0, 0] = -1024 + 1024  # a flat block of 0
    x[1, 0] = 8 * 127 + 1024  # a flat block of 255
    x[2, 0], x[2, 1] = 1024, 40
    out = jpeg.idct_simple(x)
    assert (out[0] == 0).all() and (out[1] == 255).all()
    assert out[2].reshape(8, 8)[:, 0].min() > 128 > out[2].reshape(8, 8)[:, 7].max()
    with pytest.raises(ValueError, match="outside 16 bits"):
        jpeg.idct_simple(np.full((1, 64), 40000))


# ------------------------------------------------------------------ resize

RESIZES = [((720, 960), (240, 180)), ((161, 97), (24, 40)), ((49, 75), (18, 12)),
           ((64, 64), (32, 32)), ((720, 960), (480, 360)), ((33, 47), (11, 8)),
           ((50, 60), (120, 100)), ((30, 31), (77, 61)), ((1, 17), (5, 3)), ((9, 1), (1, 2))]


@pytest.mark.parametrize("shape,dsize", RESIZES, ids=[f"{s[0]}x{s[1]}to{d[1]}x{d[0]}"
                                                      for s, d in RESIZES])
def test_resize_matches_cv2(shape, dsize):
    """The reader's quarter (also on odd sizes), an exact 2x downscale (cv2
    takes INTER_AREA), other downscales, upscales and one-pixel edges."""
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(resize_linear_u8(img, dsize), cv2.resize(img, dsize))


def test_resize_matches_cv2_on_random_sizes():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(11)
    for _ in range(100):
        h, w, oh, ow = (int(v) for v in rng.integers(1, 200, 4))
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        np.testing.assert_array_equal(resize_linear_u8(img, (ow, oh)), cv2.resize(img, (ow, oh)),
                                      err_msg=f"{h}x{w} -> {oh}x{ow}")


# ----------------------------------------------------------------- readers

@pytest.mark.parametrize("num_load_frames", [-1, 0, 2, 50])
@pytest.mark.parametrize("name", ["portrait.avi", "ntsc.avi", "restart.avi"])
def test_video_reader_matches_the_jax_reader(name, num_load_frames):
    """``initialize`` with every kind of ``num_load_frames`` (N loads N + 1
    frames), landscape and portrait (transposed), a dropped frame: the same
    count, stamps (float64 ``count / fps``) and frames, exact at every
    pixel. Then the packs the CLI reads."""
    pytest.importorskip("cv2")
    from v2e2v_tpu.data.video_readers import VideoReader as JaxReader

    path = str(FIXTURES / name)
    port, ref = VideoReader((180, 240)), JaxReader((180, 240))
    port.initialize(path, num_load_frames)
    ref.initialize(path, num_load_frames)
    assert port.num_frames == ref.num_frames == (
        min(num_load_frames + 1, MANIFEST[name]["frames_read"]) if num_load_frames >= 0
        else MANIFEST[name]["frames_read"])
    assert port.timestamps == ref.timestamps
    for g, w in zip(port.frames, ref.frames, strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
    if name == "portrait.avi":
        assert port.frames[0].shape == (24, 40)
    while port.frame_id < port.num_frames:
        got, want = port.update_frame_pack(3), ref.update_frame_pack(3)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[2], want[2])


def test_flagship_matches_the_jax_reader():
    """The flagship clip, 960x720 read as 180x240: the port's frames equal the
    JAX reader's at every pixel (exact share 1.0, max 0), the stamps
    ``i / 240``."""
    pytest.importorskip("cv2")
    from v2e2v_tpu.data.video_readers import VideoReader as JaxReader

    path = str(FIXTURES / "flagship.avi")
    port, ref = VideoReader((180, 240)), JaxReader((180, 240))
    port.initialize(path)
    ref.initialize(path)
    got, want = np.stack(port.frames), np.stack(ref.frames)
    assert got.shape == want.shape == (12, 180, 240)
    assert np.abs(got.astype(int) - want).max() == 0
    assert port.timestamps == ref.timestamps == [i / 240.0 for i in range(12)]


@pytest.mark.parametrize("name", ["portrait.avi", "no_dht.avi", "opendml.avi"])
def test_video_sequence_matches_the_jax_sequence(name):
    pytest.importorskip("cv2")
    from v2e2v_tpu.data.manifests import VideoSequence as JaxSequence

    got, want = list(VideoSequence(str(FIXTURES / name))), list(JaxSequence(str(FIXTURES / name)))
    assert len(got) == len(want) == MANIFEST[name]["frames_read"] - 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        assert g[2:] == w[2:]


# ---------------------------------------------------------------- refusals

def _vp9_profile_1(path):
    """The cv2-written VP9 WebM at ``path`` remuxed with its frames' headers
    saying profile 1 (4:2:2, 4:4:0 or 4:4:4)."""
    from v2e2v_tpu_torch.utils.mkv import MkvFile

    mods = {}
    for name in ("make_mkv_fixtures", "make_vp9_fixtures"):
        spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    mkv = MkvFile(str(path))
    packets = mods["make_vp9_fixtures"].rewrite(list(mkv.frames()),
                                                lambda i, h: h.update(profile=1),
                                                (mkv.width, mkv.height))
    mods["make_mkv_fixtures"].write_webm(path, packets, mkv.width, mkv.height, codec_id="V_VP9")


def _field_pictures(path):
    """The cv2-written MPEG-2 program stream at ``path`` with its pictures'
    coding extensions saying top field pictures (``picture_structure`` 1)."""
    spec = importlib.util.spec_from_file_location(
        "make_mpeg12_fixtures", REPO / "scripts" / "make_mpeg12_fixtures.py")
    mf = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mf)

    def field(f, i):
        if f["kind"] == "picture_extension":
            f["picture_structure"] = 1

    path.write_bytes(mf.patch_file(path.read_bytes(), field))


def _flv_codec_id(path, codec):
    """Every video tag of the FLV at ``path`` given the codec id ``codec``."""
    data, pos = bytearray(path.read_bytes()), 13
    while pos + 11 <= len(data):
        size = int.from_bytes(data[pos + 1:pos + 4], "big")
        if data[pos] == 9:
            data[pos + 11] = data[pos + 11] & 0xF0 | codec
        pos += 15 + size
    path.write_bytes(bytes(data))


def _case_file(tmp_path, case):
    """A file of a format or tool the port refused before, or still refuses."""
    cv2 = pytest.importorskip("cv2")
    fx = _fixture_script()
    imgs = fx.scene(np.random.default_rng(3), 32, 48, 2)
    path = tmp_path / f"{case}.avi"
    written = {"mp4": ("clip.mp4", "mp4v"), "mpeg4_avi": ("clip.avi", "FMP4"),
               "wmv": ("clip.wmv", "WMV2"), "flv": ("clip.flv", "FLV1"),
               "mpeg_ps": ("clip.mpg", "MPG2"), "vp8_webm": ("clip.webm", "VP80"),
               "vp9_webm": ("clip.webm", "VP90"), "vp9_webm_read": ("clip.webm", "VP90")}
    if case in written or case == "flv_vp6":  # VP6 in FLV: cv2's FLV1 tags say codec id 4
        name, fourcc = written.get(case, written["flv"])
        path = tmp_path / name
        vw = cv2.VideoWriter(str(path), cv2.CAP_FFMPEG, cv2.VideoWriter_fourcc(*fourcc),
                             30.0, (48, 32))
        assert vw.isOpened()
        for f in (np.concatenate([imgs, imgs]) if case == "mpeg_ps" else imgs):
            vw.write(f)
        vw.release()
        if case == "vp9_webm":  # VP9 is read, but not profile 1: the headers rewritten so
            _vp9_profile_1(path)
        if case == "mpeg_ps":  # MPEG-2 is read, but not field pictures: rewritten so
            _field_pictures(path)
        if case == "flv_vp6":
            _flv_codec_id(path, 4)
        if case == "wmv":  # WMV2 in ASF is read: its tag rewritten to WMV3's (VC-1)
            path.write_bytes(path.read_bytes().replace(b"WMV2", b"WMV3"))
    elif case == "matroska":
        path.write_bytes(b"\x1a\x45\xdf\xa3" + bytes(60))
    elif case == "riff_wave":
        path.write_bytes(b"RIFF" + struct.pack("<I", 4) + b"WAVE")
    elif case == "h263":  # an H.263 picture (short_video_header) in an MPEG-4 AVI
        fx.write_avi(path, [b"\x00\x00\x80\x02\x08" + bytes(40)], 48, 32, 30, fourcc=b"XVID")
    elif case == "interlaced":  # each frame one field: half the stream's height
        fx.write_avi(path, [fx.imencode(f) for f in imgs], 48, 64, 30)
    elif case == "interlaced_pair":  # both fields in one packet, which cv2 weaves
        fx.write_avi(path, [fx.imencode(imgs[0]) + fx.imencode(imgs[1])], 48, 64, 30)
    else:  # 4:1:1 at 24 wide: 6 chroma samples, under bicubic's 7
        fx.write_avi(path, [fx.imencode(f[:, :24], [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])
                            for f in imgs], 24, 32, 30)
    return path


REFUSALS = {"matroska": "Matroska", "riff_wave": "'WAVE'", "wmv": "ASF video stream of codec 'WMV3'",
            "flv_vp6": "On2 VP6", "mpeg_ps": "field picture", "vp9_webm": "VP9 video: profile 1",
            "h263": "short_video_header"}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_what_it_does_not_read_raises(tmp_path, case):
    """Other containers and codecs (among them the WMV2 files cv2's writer
    makes, FLV1, VP9 and MPEG-2 files rewritten to WMV3 (VC-1), VP6, profile
    1 and field pictures, and H.263 pictures in an MPEG-4 stream, of which cv2
    reads no frame) raise a ValueError
    naming ROADMAP item 4 and what they are, from the readers the CLIs use."""
    path = str(_case_file(tmp_path, case))
    with pytest.raises(ValueError, match=f"(?s){REFUSALS[case]}.*item 4"):
        VideoReader((180, 240)).initialize(path)
    with pytest.raises(ValueError, match="item 4"):
        list(VideoSequence(path))


FORMERLY_REFUSED = ["mp4", "mpeg4_avi", "interlaced", "interlaced_pair", "tiny_411", "vp8_webm",
                    "vp9_webm_read", "flv"]


@pytest.mark.parametrize("case", FORMERLY_REFUSED)
def test_formerly_refused_files_match_the_jax_readers(tmp_path, case):
    """The files the port refused before: MPEG-4 in MP4 and in an FMP4 AVI,
    interlaced MJPEG of one field a packet (cv2 reads no frame, and neither
    does the port) and of two (woven), 4:1:1 at 24 wide (swscale's cut
    chroma filter), VP8 and VP9 in WebM, and Sorenson H.263 in FLV: the
    port's readers equal the JAX ones."""
    from v2e2v_tpu.data.manifests import VideoSequence as JaxSequence
    from v2e2v_tpu.data.video_readers import VideoReader as JaxReader

    path = str(_case_file(tmp_path, case))
    port, ref = VideoReader((180, 240)), JaxReader((180, 240))
    port.initialize(path)
    ref.initialize(path)
    assert port.num_frames == ref.num_frames == (0 if case == "interlaced" else
                                                1 if case == "interlaced_pair" else 2)
    assert port.timestamps == ref.timestamps
    for g, w in zip(port.frames, ref.frames, strict=True):
        np.testing.assert_array_equal(g, w)
    got, want = list(VideoSequence(path)), list(JaxSequence(path))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        assert g[2:] == w[2:]


# ------------------------------------------------------ every sampling

NEW = ["gray.avi", "odd_height.avi", "progressive.avi", "progressive_422.avi", "yuv411.avi",
       "yuv422.avi", "yuv440.avi", "yuv444.avi", "hd_yuv422.avi", "hd_yuv411.avi"]


@pytest.mark.parametrize("name", NEW)
def test_every_sampling_matches_the_jax_readers(name):
    """Each sampling, gray, progressive and odd-height clip through the port's
    ``VideoReader`` and ``VideoSequence`` against the JAX ones on the same
    file: equal frames at every pixel, stamps and counts."""
    pytest.importorskip("cv2")
    from v2e2v_tpu.data.manifests import VideoSequence as JaxSequence
    from v2e2v_tpu.data.video_readers import VideoReader as JaxReader

    path = str(FIXTURES / name)
    port, ref = VideoReader((180, 240)), JaxReader((180, 240))
    port.initialize(path)
    ref.initialize(path)
    assert port.num_frames == ref.num_frames == MANIFEST[name]["frames_read"] > 1
    assert port.timestamps == ref.timestamps
    for g, w in zip(port.frames, ref.frames, strict=True):
        np.testing.assert_array_equal(g, w)
    got, want = list(VideoSequence(path)), list(JaxSequence(path))
    assert len(got) == len(want) == port.num_frames - 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        assert g[2:] == w[2:]


SAMPLING_FACTORS = ["411", "420", "422", "440", "444"]


@pytest.mark.parametrize("sampling", SAMPLING_FACTORS)
def test_conversion_matches_swscale_on_random_sizes(tmp_path, sampling):
    """Clips of random sizes (8 to 200 on a side, odd and even) and
    qualities, a third of them progressive, at each sampling: every frame,
    those whose chroma swscale's bicubic filter is cut to (``tiny`` below)
    among them, equals ``cap.read()``."""
    cv2 = pytest.importorskip("cv2")
    fx = _fixture_script()
    factor = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
    rng = np.random.default_rng(int(sampling))
    for k in range(12):
        h, w = (int(v) for v in rng.integers(8, 200, 2))
        params = [cv2.IMWRITE_JPEG_QUALITY, int(rng.integers(10, 101)),
                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor]
        if k % 3 == 0:
            params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
        data = fx.imencode(fx.scene(rng, h, w, 1)[0], params)
        fx.write_avi(tmp_path / "r.avi", [data], w, h, 30)
        want = _cv2_frames(cv2, tmp_path / "r.avi")[0]
        frame = jpeg.decode_mjpeg_frame(data)
        got = yuv.mjpeg_to_bgr(frame.planes, frame.factors)
        np.testing.assert_array_equal(got, want, err_msg=f"{sampling} {h}x{w}")


@pytest.mark.parametrize("sampling", SAMPLING_FACTORS)
def test_tiny_frames_match_swscale(tmp_path, sampling):
    """Every size from 1 to 12 on each side at each sampling: swscale cuts
    its bicubic chroma filter to the plane (under 7 chroma samples where it
    doubles them, under 11 where it halves them), takes ``yuv2packed1`` with
    its uvalpha for rows of a two-tap vertical filter, and forces full-width
    chroma by the format alone (a one-row 4:4:0 frame keeps half-width
    chroma); the port's BGR equals ``cap.read()`` on all 144."""
    cv2 = pytest.importorskip("cv2")
    fx = _fixture_script()
    factor = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
    rng = np.random.default_rng(100 + int(sampling))
    cut = 0
    for h in range(1, 13):
        for w in range(1, 13):
            data = fx.imencode(fx.scene(rng, h, w, 1)[0], [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor])
            fx.write_avi(tmp_path / "t.avi", [data], w, h, 30)
            want = _cv2_frames(cv2, tmp_path / "t.avi")[0]
            frame = jpeg.decode_mjpeg_frame(data)
            np.testing.assert_array_equal(yuv.mjpeg_to_bgr(frame.planes, frame.factors), want,
                                          err_msg=f"{sampling} {h}x{w}")
            cut += tiny(frame)
    assert cut > 0 or sampling == "444"


def tiny(frame) -> bool:
    """Whether swscale resamples a chroma plane of under 7 samples up (or
    under 11 down) in this frame: the filter cut to the plane."""
    (h, w), (ch, cw) = frame.planes[0].shape, frame.planes[1].shape
    full = frame.factors[0] == (1, 1) or w % 2
    dst_w = w if full else -(-w // 2)
    return any(n != d and n < (11 if n > d else 7) for n, d in ((cw, dst_w), (ch, h)))


def test_gray_frames_pass_every_value_through(tmp_path):
    """A gray frame of flat blocks at every value 0-255 (quality 100: each
    block decodes to its value): cv2 gives B = G = R = Y, no range
    expansion, and so does the port, at even and odd sizes."""
    cv2 = pytest.importorskip("cv2")
    fx = _fixture_script()
    img = np.arange(256, dtype=np.uint8).reshape(16, 16).repeat(8, 0).repeat(8, 1)
    for h, w in ((128, 128), (127, 125)):
        data = fx.imencode(img[:h, :w], [cv2.IMWRITE_JPEG_QUALITY, 100])
        fx.write_avi(tmp_path / "g.avi", [data], w, h, 30)
        want = _cv2_frames(cv2, tmp_path / "g.avi")[0]
        frame = jpeg.decode_mjpeg_frame(data)
        np.testing.assert_array_equal(frame.planes[0], img[:h, :w])
        np.testing.assert_array_equal(yuv.mjpeg_to_bgr(frame.planes, frame.factors), want)
        np.testing.assert_array_equal(yuv.mjpeg_to_gray(frame.planes, frame.factors),
                                      img[:h, :w])


def test_other_sampling_factors_raise():
    y = np.zeros((16, 24), np.uint8)
    with pytest.raises(ValueError, match="(?s)sampling factors.*item 4"):
        yuv.mjpeg_to_bgr([y, y[:, :8], y[:, :8]], [(3, 1), (1, 1), (1, 1)])
    with pytest.raises(ValueError, match="(?s)chroma planes.*item 4"):
        yuv.mjpeg_to_bgr([y, y[:, :8], y[:, :8]], [(2, 1), (1, 1), (1, 1)])


def test_bicubic_filters_are_normalised():
    """Each output's taps sum to the filter's one, start inside the plane
    and stay inside it, for the upscales and downscale the samplings use."""
    for src, dst, one, align in ((16, 32, 1 << 14, 4), (25, 49, 1 << 12, 2),
                                 (80, 40, 1 << 14, 4), (7, 13, 1 << 14, 4)):
        pos, taps = yuv.bicubic_filter(src, dst, one, align)
        assert taps.shape == (dst, taps.shape[1]) and taps.shape[1] % align == 0
        assert (taps.sum(1) == one).all()
        assert (pos >= 0).all() and (pos + taps.shape[1] <= max(src, taps.shape[1])).all()
