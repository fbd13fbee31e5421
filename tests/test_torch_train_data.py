"""The port's training data path against the JAX package's, on the CPU, on
data from scripts/make_synth_data.py (two sequences of 24 frames at 32x40):
the manifests of ``data/manifests.py`` byte for byte, the samples of
``TrainFixNEventData`` (with ``--add_noise``, ``--drop_seq_tails`` and
``--cache_samples``) and ``TrainSeqData`` bit for bit, the batch order of
``iterate_batches`` for a seed, the spawn-worker ``SampleLoader`` against
in-process loading; then the prefetch thread, the scalar logger and the
voxel noise augmentation.
"""

import argparse
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from _torch_parity import no_new_jax_cache_entries, one_torch_thread  # noqa: F401
from v2e2v_tpu.data import datasets as jds
from v2e2v_tpu.data import manifests as jman
from v2e2v_tpu.utils import configs as jconfigs
from v2e2v_tpu_torch.data import datasets as tds
from v2e2v_tpu_torch.data import manifests as tman
from v2e2v_tpu_torch.data.prefetch import DEPTH, device_prefetch, prefetch_iterator
from v2e2v_tpu_torch.ops.voxel import add_noise_to_voxel
from v2e2v_tpu_torch.utils import configs as tconfigs
from v2e2v_tpu_torch.utils.logging import ScalarLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACK = 6


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("train_synth"))
    subprocess.run([sys.executable, os.path.join(REPO, "scripts", "make_synth_data.py"),
                    "--out_dir", out, "--num_sequences", "2", "--num_frames", "24",
                    "--image_dim", "32", "40", "--num_pack_frames", str(PACK)],
                   check=True, capture_output=True)
    return out


def _flags(module, synth_dir, *extra):
    parser = argparse.ArgumentParser()
    module.set_configs(parser)
    return parser.parse_args(["--path_to_train_data", synth_dir, "--image_dim", "32", "40",
                              "--num_events", "300", "--len_sequence", "3", *extra])


def _assert_samples_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name,args", [
    ("make_train_e2v_txt", ()),
    ("make_train_txt", (3, 2)),
    ("make_train_txt_wo_events", (PACK, 3)),
], ids=["train_e2v", "intervals", "wo_events"])
def test_manifests_are_byte_equal(synth_dir, name, args):
    n_port = getattr(tman, name)(synth_dir, f"port_{name}.txt", *args)
    n_jax = getattr(jman, name)(synth_dir, f"jax_{name}.txt", *args)
    port = open(os.path.join(synth_dir, f"port_{name}.txt"), "rb").read()
    jax_ = open(os.path.join(synth_dir, f"jax_{name}.txt"), "rb").read()
    assert n_port == n_jax > 0 and port == jax_


def test_sequence_sniffing_and_image_sequence(synth_dir, tmp_path):
    seq = os.path.join(synth_dir, "sequence_0000000001")
    assert tman.get_sequence_or_none(seq) == jman.get_sequence_or_none(seq)
    assert tman.get_sequence_or_none(str(tmp_path)) is None
    video = tmp_path / "clip.mp4"
    video.write_bytes(b"")
    assert tman.get_sequence_or_none(str(video)) == ("video", str(video), None)
    got, want = list(tman.ImageSequence(seq)), list(jman.ImageSequence(seq))
    assert len(got) == len(want) == 23
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        assert g[2:] == w[2:]
    with pytest.raises(ValueError, match="unknown format, not RIFF AVI.*item 4"):
        list(tman.VideoSequence(str(video)))  # an empty file: not an MJPEG AVI


@pytest.mark.parametrize("extra", [(), ("--add_noise",), ("--drop_seq_tails",),
                                   ("--cache_samples", "--add_noise")],
                         ids=["plain", "add_noise", "drop_seq_tails", "cache_samples"])
def test_train_fix_n_event_data_is_bit_equal(synth_dir, extra):
    txt = os.path.join(synth_dir, "train_e2v.txt")
    port = tds.TrainFixNEventData(txt, _flags(tconfigs, synth_dir, *extra))
    ref = jds.TrainFixNEventData(txt, _flags(jconfigs, synth_dir, *extra))
    assert port.sequence_line_id == ref.sequence_line_id and len(port) > 2
    for epoch in (0, 1):
        port.epoch = ref.epoch = epoch
        for i in range(len(ref)):
            _assert_samples_equal(port[i], ref[i])
    if "--cache_samples" in extra:
        assert len(port._cache) == len(port)
        port.epoch = 0
        assert not np.array_equal(port[0][0], ref[0][0])  # ref's noise is epoch 1's


def test_train_fix_n_event_data_drops_tails(synth_dir):
    """num_events 1 makes each interval a group, and 9 groups a sample: the
    sequences leave tails, which --drop_seq_tails drops as JAX does."""
    txt = os.path.join(synth_dir, "train_e2v.txt")
    args = ("--num_events", "1", "--len_sequence", "9")
    keep = tds.TrainFixNEventData(txt, _flags(tconfigs, synth_dir, *args))
    drop = tds.TrainFixNEventData(txt, _flags(tconfigs, synth_dir, *args, "--drop_seq_tails"))
    ref = jds.TrainFixNEventData(txt, _flags(jconfigs, synth_dir, *args, "--drop_seq_tails"))
    assert any(len(s) < 9 for s in keep.sequence_line_id)
    assert drop.sequence_line_id == ref.sequence_line_id
    assert all(len(s) == 9 for s in drop.sequence_line_id)


@pytest.mark.parametrize("drop,cache", [(False, False), (True, True)],
                         ids=["tails", "drop_seq_tails-cache_samples"])
def test_train_seq_data_is_bit_equal(synth_dir, drop, cache):
    txt = os.path.join(synth_dir, "train_v2e2v.txt")
    port = tds.TrainSeqData(txt, synth_dir, 3, PACK, drop_seq_tails=drop, cache_samples=cache)
    ref = jds.TrainSeqData(txt, synth_dir, 3, PACK, drop_seq_tails=drop)
    assert (port.start_seq_id, port.len_seq) == (ref.start_seq_id, ref.len_seq)
    assert len(port) > 0
    for i in range(len(ref)):
        _assert_samples_equal(port[i], ref[i])
        if cache:
            _assert_samples_equal(port[i], ref[i])  # served from the cache


@pytest.mark.parametrize("batch,shuffle,seed", [(2, True, 3), (2, True, 4), (3, False, 0)])
def test_iterate_batches_order_is_jax_order(synth_dir, batch, shuffle, seed):
    txt = os.path.join(synth_dir, "train_e2v.txt")
    port = tds.TrainFixNEventData(txt, _flags(tconfigs, synth_dir, "--add_noise"))
    ref = jds.TrainFixNEventData(txt, _flags(jconfigs, synth_dir, "--add_noise"))
    got = list(tds.iterate_batches(port, batch, shuffle, seed=seed))
    want = list(jds.iterate_batches(ref, batch, shuffle, seed=seed))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        _assert_samples_equal(g, w)


def test_sample_loader_equals_in_process_loading(synth_dir):
    """Two spawn workers give the in-process batches in the same order, the
    per-sample noise included; with --cache_samples the parent's cache fills
    and a second epoch from it equals fresh loads."""
    txt = os.path.join(synth_dir, "train_e2v.txt")
    cached = tds.TrainFixNEventData(
        txt, _flags(tconfigs, synth_dir, "--add_noise", "--cache_samples"))
    plain = tds.TrainFixNEventData(txt, _flags(tconfigs, synth_dir, "--add_noise"))
    with tds.SampleLoader(cached, num_workers=2) as loader:
        pooled = list(tds.iterate_batches(cached, 2, True, seed=5, loader=loader))
        assert len(cached._cache) == len(cached)
        inline = list(tds.iterate_batches(plain, 2, True, seed=5))
        assert len(pooled) == len(inline) > 1
        for a, b in zip(pooled, inline):
            _assert_samples_equal(a, b)
        cached.epoch = plain.epoch = 1
        again = list(tds.iterate_batches(cached, 2, True, seed=6, loader=loader))
        fresh = list(tds.iterate_batches(plain, 2, True, seed=6))
        for a, b in zip(again, fresh):
            _assert_samples_equal(a, b)
    assert loader.pool is None


def test_prefetch_iterator_order_errors_and_end():
    assert list(prefetch_iterator(range(10))) == list(range(10))

    def boom():
        yield 1
        raise RuntimeError("producer failed")

    it = prefetch_iterator(boom())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="producer failed"):
        list(it)

    out = []

    def consume():  # the producer ends while the queue is full
        for x in prefetch_iterator(iter(range(DEPTH + 1))):
            time.sleep(0.3)
            out.append(x)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=15)
    assert not t.is_alive() and out == list(range(DEPTH + 1))


def test_prefetch_iterator_abandonment_closes_source():
    closed = []

    def src():
        try:
            yield from range(1000)
        finally:
            closed.append(True)

    it = prefetch_iterator(src())
    assert next(it) == 0
    it.close()
    deadline = time.time() + 10
    while not closed and time.time() < deadline:
        time.sleep(0.05)
    assert closed


def test_device_prefetch_places_tensors():
    batches = [(np.full((2, 3), i, np.float32), np.arange(2)) for i in range(3)]
    out = list(device_prefetch(batches, transform=lambda b: (b[0] * 2, b[1]), device="cpu"))
    assert len(out) == 3
    for i, (a, b) in enumerate(out):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.full((2, 3), 2 * i, np.float32))
        np.testing.assert_array_equal(b.numpy(), np.arange(2))


@pytest.mark.parametrize("tensorboard", [False, True], ids=["tsv", "tensorboardX"])
def test_scalar_logger(tmp_path, monkeypatch, tensorboard):
    if not tensorboard:
        monkeypatch.setitem(sys.modules, "tensorboardX", None)  # import fails: the TSV
    else:
        pytest.importorskip("tensorboardX")
    log = ScalarLogger(str(tmp_path / "run"))
    log.scalar("loss", 0.5, 3)
    log.close()
    files = os.listdir(tmp_path / "run")
    if tensorboard:
        assert any(f.startswith("events.out.tfevents") for f in files)
    else:
        assert (tmp_path / "run" / "scalars.tsv").read_text() == "3\tloss\t0.5\n"
    off = ScalarLogger(str(tmp_path / "off"), enabled=False)
    off.scalar("loss", 1.0, 0)
    off.close()
    assert not (tmp_path / "off").exists()


def test_add_noise_to_voxel():
    """Noise on a fraction of the entries with the law of JAX's
    ``add_noise_to_voxel``; at fraction 1 it is ``noise_std * randn`` from
    the generator; the input stays as it was."""
    voxel = torch.zeros(4, 64, 64, 5)
    noisy = add_noise_to_voxel(torch.Generator().manual_seed(0), voxel, 2.0, 0.1)
    share = float((noisy != 0).float().mean())
    assert abs(share - 0.1) < 0.01 and float(voxel.abs().max()) == 0.0
    std = float(noisy[noisy != 0].std())
    assert abs(std - 2.0) < 0.1
    full = add_noise_to_voxel(torch.Generator().manual_seed(1), voxel + 1, 0.1, 1.0)
    want = 1 + 0.1 * torch.randn(voxel.shape, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(full, want, atol=0, rtol=0)
