"""The port's ``InterpolatingReader`` (``v2e2v_tpu_torch/data/
interpolating_reader.py``) against the JAX package's, both on the CPU, on a
folder of PNG frames with events (``data/synthetic.write_dataset``).
Both read one checkpoint through ``V2E2V_SUPERSLOMO_CKPT``: the JAX package's
random weights with the flow net's output conv scaled so that every pair is
interpolated (``tests/_torch_parity.jax_unet_params`` says why), so the
interpolation net runs. Frames upsampled, equal stamps, frames within one code; then the frame packs and event packs the
CLIs read, equal.

On these smooth frames the interpolated frames reproduce the uint8 inputs
within float32 rounding, so about half their pixels lie within 1e-4 of a
code, where the truncating uint8 cast turns the two packages' float
differences (up to 7e-7: the convs sum in other orders) into one code: 351 of
21,760 codes (1.6%) differ here.
"""

import numpy as np
import pytest
import torch

from _torch_parity import (  # noqa: F401
    assert_off_integers,
    no_new_jax_cache_entries,
    one_torch_thread,
    pair_magnitudes,
    write_ckpt,
)
from v2e2v_tpu.data.interpolating_reader import InterpolatingReader as JaxReader
from v2e2v_tpu_torch.data.interpolating_reader import InterpolatingReader
from v2e2v_tpu_torch.data.synthetic import write_dataset
from v2e2v_tpu_torch.models.superslomo import CKPT_ENV_VAR
from v2e2v_tpu_torch.utils.image_io import read_gray

FLOW_SCALE = 59.0  # counts 5-6 on this folder, magnitudes >= 0.17 from an integer
H, W, FRAMES = 32, 40, 5


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("lfr")
    write_dataset(root, 4, 1, FRAMES, H, W, (200, 400))
    return root / "sequence_0000000001", str(write_ckpt(root / "scaled.ckpt", FLOW_SCALE))


def test_reader_matches_jax_reader(folder, monkeypatch):
    seq, ckpt = folder
    monkeypatch.setenv(CKPT_ENV_VAR, ckpt)
    got = InterpolatingReader([180, 240], num_bins=5, is_with_events=True, device="cpu")
    want = JaxReader([180, 240], num_bins=5, is_with_events=True)
    got.initialize(str(seq))
    want.initialize(str(seq))
    assert (got.height, got.width) == (want.height, want.width) == (H, W)
    lfr = [read_gray(str(p)) for p in sorted((seq / "frames").glob("*.png"))]
    counts = assert_off_integers(pair_magnitudes(got._upsampler, lfr), 3, 6)
    assert got.num_frames == want.num_frames == sum(counts) + 1
    np.testing.assert_array_equal(got.timestamps, want.timestamps)
    diff = got.frames.astype(int) - want.frames.astype(int)
    assert got.frames.shape == want.frames.shape == (got.num_frames, H, W)
    assert np.abs(diff).max() <= 1, f"{np.count_nonzero(diff)} of {diff.size} codes differ"
    assert np.count_nonzero(diff) <= 0.05 * diff.size  # seen: 1.6%

    # the packs as the CLIs read them: frames (V2E2V), then GT + voxel grids
    # (E2V) from where the frames left off
    frames_g, gt_g, ts_g = got.update_frame_pack(4)
    frames_w, gt_w, ts_w = want.update_frame_pack(4)
    np.testing.assert_array_equal(ts_g, ts_w)
    assert np.abs(frames_g.astype(int) - frames_w.astype(int)).max() <= 1
    n = 0
    while not want.ending:
        ev_g, gt_g = got.update_event_frame_pack(300, "upsampled")
        ev_w, gt_w = want.update_event_frame_pack(300, "upsampled")
        assert len(ev_g) == len(ev_w) and got.num_events == want.num_events
        for a, b in zip(ev_g, ev_w):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)
        assert np.abs(gt_g.astype(int) - gt_w.astype(int)).max() <= 1
        n += 1
    assert got.ending and n > 3


def test_reader_without_device_needs_the_card(folder, monkeypatch):
    seq, ckpt = folder
    monkeypatch.setenv(CKPT_ENV_VAR, ckpt)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reader = InterpolatingReader([180, 240])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reader.initialize(str(seq))
