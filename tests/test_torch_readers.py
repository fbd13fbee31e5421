"""The port's readers (v2e2v_tpu_torch.data) against the JAX package's on data
from scripts/make_synth_data.py: the same voxel grids bit for bit, the same
GT frames, event counts and ``ending``, for .npz, .txt and .zip events."""

import io
import os
import shutil
import subprocess
import sys
import zipfile

import numpy as np
import pandas as pd
import pytest

from _torch_parity import no_new_jax_cache_entries  # noqa: F401
from v2e2v_tpu import runtime as jruntime
from v2e2v_tpu.data import event_readers as jev
from v2e2v_tpu.data import video_readers as jvr
from v2e2v_tpu_torch import runtime as truntime
from v2e2v_tpu_torch.data import event_readers as tev
from v2e2v_tpu_torch.data import video_readers as tvr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The synthetic set (2 sequences, 24 frames, 32x40, per-interval .npz),
    and copies whose events are one events.txt or events.zip per sequence."""
    root = tmp_path_factory.mktemp("synth")
    npz = root / "npz"
    subprocess.run([sys.executable, os.path.join(REPO, "scripts", "make_synth_data.py"),
                    "--out_dir", str(npz), "--num_sequences", "2", "--num_frames", "24",
                    "--image_dim", "32", "40", "--num_pack_frames", "6"],
                   check=True, capture_output=True)
    out = {"npz": str(npz)}
    for kind in ("txt", "zip"):
        dst = root / kind
        shutil.copytree(npz, dst)
        for seq in sorted(dst.glob("sequence_*")):
            files = sorted((seq / "events").glob("*.npz"))
            rows = []
            for f in files:
                d = np.load(f)
                rows += [f"{t:.9f} {x} {y} {p}\n" for t, x, y, p in zip(d["t"], d["x"], d["y"],
                                                                         d["p"])]
            shutil.rmtree(seq / "events")
            text = "".join(rows)
            if kind == "txt":
                (seq / "events.txt").write_text(text)
            else:
                with zipfile.ZipFile(seq / "events.zip", "w") as zf:
                    zf.writestr("events.txt", text)
        out[kind] = str(dst)
    return out


def _no_native_parser(monkeypatch):
    """Both packages' native parsers refuse, as they do on a table they
    cannot read; the native voxeliser stays."""
    for runtime in (jruntime, truntime):
        def refuse(path, runtime=runtime):
            raise runtime.NativeUnavailable(f"native parse failed for {path!r}")

        monkeypatch.setattr(runtime, "parse_events_txt", refuse)


@pytest.mark.parametrize("mode,limit", [("real", 300), ("upsampled", 300), ("real", 3000),
                                        ("upsampled", -1)])
@pytest.mark.parametrize("kind", ["npz", "txt", "zip", "txt-numpy"])
def test_image_reader_matches_jax(datasets, monkeypatch, kind, mode, limit):
    if kind == "txt-numpy":
        _no_native_parser(monkeypatch)
    root = datasets[kind.split("-")[0]]
    for seq in sorted(os.listdir(root)):
        path = os.path.join(root, seq)
        if not os.path.isdir(path):
            continue
        want_r = jvr.ImageReader([180, 240], num_bins=5, is_with_events=True)
        got_r = tvr.ImageReader([180, 240], num_bins=5, is_with_events=True)
        want_r.initialize(path, 20)
        got_r.initialize(path, 20)
        assert (got_r.height, got_r.width, got_r.num_frames) == (32, 40, 20)
        assert got_r.timestamps == want_r.timestamps
        packs = 0
        while not want_r.ending:
            want_v, want_gt = want_r.update_event_frame_pack(limit, mode)
            got_v, got_gt = got_r.update_event_frame_pack(limit, mode)
            assert got_r.ending == want_r.ending and got_r.num_events == want_r.num_events
            np.testing.assert_array_equal(got_gt, want_gt)
            assert len(got_v) == len(want_v)
            for g, w in zip(got_v, want_v):
                assert g.dtype == np.float32
                np.testing.assert_array_equal(g, w)
            packs += 1
        assert got_r.ending and packs > 1


@pytest.mark.parametrize("mode", ["real", "upsampled"])
def test_synthetic_dataset_reads_the_same_in_both_packages(tmp_path, mode):
    """The dataset the card's runs write without PIL (data/synthetic.py):
    its PNGs are what cv2 reads, and both packages' readers give the same
    voxel grids and GT frames from it."""
    import cv2

    from v2e2v_tpu_torch.data.synthetic import write_dataset
    from v2e2v_tpu_torch.utils.image_io import read_gray

    write_dataset(tmp_path, 3, 2, 6, 36, 48, (200, 400))
    seqs = sorted(tmp_path.iterdir())
    assert [s.name for s in seqs] == ["sequence_0000000001", "sequence_0000000002"]
    for seq in seqs:
        pngs = sorted((seq / "frames").glob("frame_*.png"))
        assert len(pngs) == 6 and len(list((seq / "events").glob("*.npz"))) == 5
        for png in pngs:
            img = cv2.imread(str(png), cv2.IMREAD_GRAYSCALE)
            assert img.shape == (36, 48) and img.min() < img.max()
            np.testing.assert_array_equal(read_gray(str(png)), img)
        want_r = jvr.ImageReader([36, 48], num_bins=5, is_with_events=True)
        got_r = tvr.ImageReader([36, 48], num_bins=5, is_with_events=True)
        want_r.initialize(str(seq), -1)
        got_r.initialize(str(seq), -1)
        packs = 0
        while not want_r.ending:
            want_v, want_gt = want_r.update_event_frame_pack(500, mode)
            got_v, got_gt = got_r.update_event_frame_pack(500, mode)
            assert got_r.ending == want_r.ending and len(got_v) == len(want_v) > 0
            np.testing.assert_array_equal(got_gt, want_gt)
            for g, w in zip(got_v, want_v):
                np.testing.assert_array_equal(g, w)
            packs += 1
        assert packs > 1


def _jpeg_dataset(root, h, w):
    """``data/synthetic.write_dataset``'s layout with colour JPEG frames: each
    PNG frame tinted per channel, given texture and written by ``cv2.imwrite``
    (4:2:0, 4:4:4, progressive, restart intervals in turn), the PNG removed."""
    import cv2

    from v2e2v_tpu_torch.data.synthetic import write_dataset

    write_dataset(root, 5, 2, 8, h, w, (200, 400))
    params = [[], [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
              [cv2.IMWRITE_JPEG_PROGRESSIVE, 1], [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]]
    rng = np.random.default_rng(0)
    for i, png in enumerate(sorted(root.glob("*/frames/frame_*.png"))):
        gray = cv2.imread(str(png), cv2.IMREAD_GRAYSCALE).astype(np.float64)
        bgr = gray[..., None] * rng.uniform(0.6, 1.1, 3) + rng.normal(0, 8, (h, w, 3))
        assert cv2.imwrite(str(png.with_suffix(".jpg")),
                           np.clip(bgr, 0, 255).astype(np.uint8), params[i % 4])
        png.unlink()


@pytest.mark.parametrize("mode", ["frames", "real", "upsampled"])
def test_image_reader_over_jpeg_frames_matches_jax(tmp_path, mode):
    """Both packages' ``ImageReader`` over folders of colour JPEG frames: the
    same frame packs (odd frames, cropped to even) or the same voxel grids and
    GT frames, pack for pack."""
    with_events = mode != "frames"
    _jpeg_dataset(tmp_path, *((36, 50) if with_events else (37, 51)))
    for seq in sorted(tmp_path.iterdir()):
        assert len(list((seq / "frames").glob("*.jpg"))) == 8
        want_r = jvr.ImageReader([36, 50], num_bins=5, is_with_events=with_events)
        got_r = tvr.ImageReader([36, 50], num_bins=5, is_with_events=with_events)
        want_r.initialize(str(seq), -1)
        got_r.initialize(str(seq), -1)
        assert (got_r.height, got_r.width, got_r.num_frames) == (36, 50, 8)
        packs = 0
        while not want_r.ending and packs < (6 if with_events else 2):
            if with_events:
                want_v, want_gt = want_r.update_event_frame_pack(500, mode)
                got_v, got_gt = got_r.update_event_frame_pack(500, mode)
                assert got_r.ending == want_r.ending and len(got_v) == len(want_v) > 0
                np.testing.assert_array_equal(got_gt, want_gt)
                for g, w in zip(got_v, want_v):
                    np.testing.assert_array_equal(g, w)
            else:
                want = want_r.update_frame_pack(4)
                got = got_r.update_frame_pack(4)
                assert len(got) == len(want)
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w)
                assert got[0].shape[1:] == (36, 50) and got[0].std() > 0
            packs += 1
        assert packs > 1


def test_frame_pack_continuation_matches_jax(datasets):
    path = os.path.join(datasets["npz"], "sequence_0000000001")
    want_r, got_r = jvr.ImageReader([32, 40]), tvr.ImageReader([32, 40])
    want_r.initialize(path)
    got_r.initialize(path)
    for _ in range(5):
        want = want_r.update_frame_pack(6)
        got = got_r.update_frame_pack(6)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert len(got[2]) == len(got[0]) + 1  # cached stamp prepended


@pytest.mark.parametrize("unit", ["s", "us", "ns", "ms"])
def test_timestamps_file_matches_jax(tmp_path, unit):
    rng = np.random.default_rng(0)
    for name, col in (("timestamps.txt", 1), ("images.txt", 0)):
        path = tmp_path / name
        ts = np.sort(rng.uniform(0, 1e6, 30))
        path.write_text("".join(f"{i} {t:.6f}\n" if col else f"{t:.6f} x\n"
                                for i, t in enumerate(ts)) + "\n")
        assert tvr.read_timestamps_file(str(path), unit) == jvr.read_timestamps_file(
            str(path), unit)


def test_ref_time_reader_windows_and_last_event_quirk(tmp_path):
    path = tmp_path / "events.txt"
    rows = [(0.05, 1, 2, 1), (0.15, 3, 4, 0), (0.25, 5, 6, 1), (0.35, 7, 8, 0)]
    path.write_text("".join(f"{t} {x} {y} {p}\n" for t, x, y, p in rows))
    # the last two stamps have no event at or after them: both point at the
    # last event, so the last window is empty and the one before it short
    stamps = [0.0, 0.1, 0.2, 0.5, 0.6]
    want = list(jev.RefTimeEventReader(str(path), stamps))
    got = list(tev.RefTimeEventReader(str(path), stamps))
    assert [len(w) for w in got] == [len(w) for w in want] == [1, 1, 1, 0]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _pandas_table(text):
    return pd.read_csv(io.StringIO(text), delimiter=" ", names=["t", "x", "y", "p"],
                       dtype={"t": np.float64, "x": np.int16, "y": np.int16, "p": np.int16},
                       engine="c", index_col=False).values.astype(np.float64)


@pytest.mark.parametrize("fmt,scale", [("%.9f", 1.0), ("%.9f", 1e6), ("%.12f", 1e4),
                                       ("%.17g", 1.0), ("%.20f", 1.0), ("%.25f", 1e-3),
                                       ("%.3e", 1.0), ("%.17e", 1e-300), ("%.5E", 1e200),
                                       ("%d", 1e6)])
def test_numpy_parser_gives_pandas_values(fmt, scale):
    rng = np.random.default_rng(len(fmt))
    t = np.sort(rng.uniform(0, scale, 4000)) * rng.choice([-1, 1], 4000)
    x, y, p = (rng.integers(0, 240, 4000), rng.integers(0, 180, 4000), rng.integers(0, 2, 4000))
    text = "".join(f"{fmt % a} {b} {c} {d}\n" for a, b, c, d in zip(t, x, y, p))
    np.testing.assert_array_equal(tev.parse_events_text(text.encode()), _pandas_table(text))


def test_zip_stamps_follow_pandas_and_txt_stamps_follow_strtod(tmp_path):
    """The JAX package parses .zip with pandas and .txt with strtod (native);
    both round this 16-digit stamp differently (ROADMAP.md section 3). The port
    gives each path's value."""
    stamp = "9007.209590438957"
    text = f"{stamp} 1 2 1\n9007.5 3 4 0\n"
    (tmp_path / "events.txt").write_text(text)
    with zipfile.ZipFile(tmp_path / "events.zip", "w") as zf:
        zf.writestr("events.txt", text)
    zip_t = tev.read_events_table(str(tmp_path / "events.zip"))
    np.testing.assert_array_equal(zip_t, jev.read_events_table(str(tmp_path / "events.zip")))
    np.testing.assert_array_equal(zip_t, _pandas_table(text))
    assert zip_t[0, 0] != float(stamp)
    assert abs(zip_t[0, 0] - float(stamp)) == np.spacing(float(stamp))
    if truntime.available() and jruntime.available():
        txt_t = tev.read_events_table(str(tmp_path / "events.txt"))
        np.testing.assert_array_equal(txt_t, jev.read_events_table(str(tmp_path / "events.txt")))
        assert txt_t[0, 0] == float(stamp)


def test_malformed_tables_raise(tmp_path):
    for text in (b"0.1 1 2\n", b"0.1 1 2 x\n", b"abc 1 2 1\n", b". 1 2 1\n", b"1e 1 2 1\n"):
        with pytest.raises(ValueError):
            tev.parse_events_text(text)
    with zipfile.ZipFile(tmp_path / "two.zip", "w") as zf:
        zf.writestr("a.txt", "0.1 1 2 1\n")
        zf.writestr("b.txt", "0.2 1 2 1\n")
    with pytest.raises(ValueError, match="one file"):
        tev.read_events_table(str(tmp_path / "two.zip"))
    assert tev.parse_events_text(b"").shape == (0, 4)
