"""The port's event previews and V2E2V writers (``utils/data_io.py``) and its
RGB PNG encoder (``utils/image_io.encode_rgb``) against
``v2e2v_tpu/utils/data_io.py`` (PIL): previews equal as arrays, the written
PNGs equal pixel for pixel when PIL decodes both.
"""

import io
import types

import numpy as np
import pytest
from PIL import Image

from _torch_parity import no_new_jax_cache_entries  # noqa: F401
from v2e2v_tpu.utils import data_io as jdata_io
from v2e2v_tpu_torch.utils import data_io as tdata_io
from v2e2v_tpu_torch.utils import image_io


def _voxel(seed, shape=(5, 12, 16)):
    rng = np.random.default_rng(seed)
    vox = rng.standard_normal(shape).astype(np.float32) * 3
    vox[:, rng.random(shape[1:]) < 0.3] = 0.0  # pixels without events
    return vox


@pytest.mark.parametrize("mode", ["red-blue", "grayscale"])
@pytest.mark.parametrize("bins", [-1, 1, 3])
@pytest.mark.parametrize("lead", [False, True], ids=["chw", "1chw"])
def test_event_preview_matches_jax(mode, bins, lead):
    vox = _voxel(bins + 7)
    if lead:
        vox = vox[None]
    got = tdata_io.make_event_preview(vox, mode=mode, num_bins_to_show=bins)
    want = jdata_io.make_event_preview(vox, mode=mode, num_bins_to_show=bins)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _cfgs(out, **kw):
    return types.SimpleNamespace(output_folder=str(out), test_data_name=None, **kw)


@pytest.mark.parametrize("mode", ["red-blue", "grayscale"])
def test_event_writer_pngs_match_jax(tmp_path, mode):
    preview = jdata_io.make_event_preview(_voxel(1), mode=mode)
    for pkg, name in ((tdata_io, "port"), (jdata_io, "jax")):
        pkg.EventWriter(_cfgs(tmp_path / name, is_write_event=True), "m", "seq")(preview, 7)
    got = Image.open(tmp_path / "port/m/seq/events/events_0000000007.png")
    want = Image.open(tmp_path / "jax/m/seq/events/events_0000000007.png")
    assert got.mode == want.mode == ("RGB" if mode == "red-blue" else "L")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(got), preview)


def test_event_writer_off_writes_nothing(tmp_path):
    tdata_io.EventWriter(_cfgs(tmp_path, is_write_event=False), "m", "seq")(
        np.zeros((4, 4, 3), np.uint8), 1)
    assert not (tmp_path / "m").exists()


def test_debug_panel_pngs_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    frame = rng.integers(0, 256, (12, 16), dtype=np.uint8)
    pred = (0.5 + 1e-4 * rng.standard_normal((12, 16))).astype(np.float32)
    short = rng.random((9, 10)).astype(np.float64)  # padded at the bottom
    panels = [frame, jdata_io.make_event_preview(_voxel(3), "red-blue"),
              jdata_io.make_event_preview(_voxel(4), "grayscale"), pred, short[None]]
    paths = {}
    for pkg, name in ((tdata_io, "port"), (jdata_io, "jax")):
        paths[name] = pkg.DebugPanelWriter(_cfgs(tmp_path / name), "m", "seq")(panels, 3)
    assert paths["port"].endswith("m/seq/display/panel_0000000003.png")
    got, want = (np.asarray(Image.open(paths[k])) for k in ("port", "jax"))
    assert got.shape == want.shape == (12, 16 * 4 + 10 + 2 * 4, 3)
    np.testing.assert_array_equal(got, want)


def test_to_u8_rounds_unlike_the_truncating_minmax():
    def level(v):
        img = np.array([[0.0, v, 1.0], [0.0, 0.0, 0.0]])
        u8 = tdata_io.DebugPanelWriter._to_u8(img)
        np.testing.assert_array_equal(u8, jdata_io.DebugPanelWriter._to_u8(img))
        return int(u8[0, 1, 0])

    assert (level(0.498 / 255), level(0.502 / 255), level(1.49 / 255)) == (0, 1, 1)


@pytest.mark.parametrize("shape", [(1, 1, 3), (7, 5, 3), (31, 64, 3)])
def test_encode_rgb_round_trips(shape):
    img = np.random.default_rng(shape[0]).integers(0, 256, shape, dtype=np.uint8)
    pil = Image.open(io.BytesIO(image_io.encode_rgb(img)))
    assert pil.mode == "RGB" and pil.size == (shape[1], shape[0])
    np.testing.assert_array_equal(np.asarray(pil), img)
    with pytest.raises(ValueError, match=r"\[H, W, 3\] uint8"):
        image_io.encode_rgb(img[..., :2])
    with pytest.raises(ValueError, match=r"\[H, W, 3\] uint8"):
        image_io.encode_rgb(img.astype(np.float32))
