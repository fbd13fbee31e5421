"""The port's WMV2 decoder (``v2e2v_tpu_torch/utils/wmv2.py`` on
``msmpeg4.py``, behind ``utils/video.VideoFile`` and the readers) against
cv2 and the JAX package's readers, on the WMV2 fixtures of
``tests/data/wmv`` outside ASF (``scripts/make_wmv_fixtures.py``) and on
streams re-coded here with that script's writers:

- every clip (AVI, Matroska and MOV as cv2 writes them, odd sizes, and
  cv2's streams re-coded under every non-intra table, with per-macroblock
  run/level tables, the four skip map types, a picture that skips every
  macroblock, the hybrid vector predictor and ``mspel``) through the port
  equals the records, and the records are what cv2 and the JAX readers
  return;
- the fixtures reach what they are there for (each non-intra table, each
  skip type, ``hshift`` and every ``mspel`` filter, the predictor's bit,
  both forms of the third escape's lengths, both rounding modes);
- WMV2's IDCT and mspel filters on blocks whose results are known;
- cv2's streams re-coded with random choices, against cv2;
- every refusal names what the stream is and ROADMAP item 4.
"""

import collections
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from v2e2v_tpu_torch.data.manifests import VideoSequence
from v2e2v_tpu_torch.data.video_readers import VideoReader
from v2e2v_tpu_torch.utils import wmv2
from v2e2v_tpu_torch.utils.avi import AviFile
from v2e2v_tpu_torch.utils.video import VideoFile

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "data" / "wmv"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())["clips"]
CLIPS = sorted(n for n, e in MANIFEST.items() if not n.endswith(".wmv") and e["codec"] == "wmv2")


def _module(name, path):
    sys.path.insert(0, str(REPO / "scripts"))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


RAW = _module("test_torch_rawvideo", REPO / "tests" / "test_torch_rawvideo.py")
WF = _module("make_wmv_fixtures", REPO / "scripts" / "make_wmv_fixtures.py")


@pytest.mark.parametrize("name", CLIPS)
def test_fixtures_match_records(name):
    """Each WMV2 clip in AVI, Matroska and MOV, as cv2 writes it or
    re-coded, through the port against cv2's frames, rate and count and the
    JAX readers' records."""
    RAW.clip_against_records(FIXTURES, MANIFEST, name)


@pytest.mark.parametrize("name", CLIPS)
def test_records_match_cv2_and_the_jax_readers(name):
    RAW.records_against_cv2(FIXTURES, MANIFEST, name)


def _coverage(names):
    seen = collections.Counter()

    class Counted(wmv2._Wmv2Picture):
        def parse(self):
            super().parse()
            d = self.dec
            if self.p_picture:
                seen["table", d.cbp_table_index] += 1
                seen["skip", d.skip_kind] += 1
                seen["rounding", d.no_rounding] += 1
                seen["per_mb_rl", d.per_mb_rl_table] += 1
                seen["quant < 8", self.qscale < 8, bool(self.esc3_level_length)] += 1
                if d.mspel:
                    for mb, (mx, my) in enumerate(self.mv_list):
                        if self.kinds[mb] == wmv2.INTER:
                            seen["dxy", 2 * (((my & 1) << 1) | (mx & 1)) + self.hshift[mb]] += 1

        def _wmv2_predictor(self, k, mbx, first_row):
            start = self.bits.pos
            out = super()._wmv2_predictor(k, mbx, first_row)
            seen["top_left bit", self.bits.pos > start] += 1
            return out

    orig = wmv2.Wmv2Decoder.picture
    wmv2.Wmv2Decoder.picture = lambda self, bits, hdr: Counted(self, bits, hdr)
    skipped = 0
    try:
        for name in names:
            video = VideoFile(str(FIXTURES / name))
            list(video.planes())
            skipped += video.decoder.skipped_frames
    finally:
        wmv2.Wmv2Decoder.picture = orig
    return seen, skipped


def test_fixtures_cover_what_they_are_there_for():
    """Each non-intra table, each skip type, a picture skipping every
    macroblock, per-macroblock tables, the predictor's bit, every mspel
    filter, the third escape's lengths at quantisers on both sides of 8,
    both rounding modes."""
    seen, skipped = _coverage(CLIPS)
    assert seen["table", 0] and seen["table", 1] and seen["table", 2]
    assert all(seen["skip", k] for k in range(4)) and skipped == 1
    assert seen["per_mb_rl", 1] and seen["top_left bit", True]
    assert seen["rounding", 0] and seen["rounding", 1]
    assert {k[1] for k in seen if k[0] == "dxy"} >= {0, 2, 3, 4, 5, 6, 7}
    assert seen["quant < 8", True, True] and seen["quant < 8", False, True]


# ---------------------------------------------------------------- DSP

def test_idct_of_a_dc_block_is_flat():
    """A block of DC alone: every sample (dc x 2048 ... ) the same, as the
    row pass's (a0 + 128) >> 8 and the column pass's rounding give it."""
    for dc in (-300, -8, 0, 1, 8, 100, 1000):
        coef = np.zeros((1, 64), np.int64)
        coef[0, 0] = dc
        row = (2048 * dc + 128) >> 8
        col = ((2048 * row) >> 3) + (1 << 13) >> 14
        np.testing.assert_array_equal(wmv2._idct_values(coef), np.full((1, 8, 8), col))
        np.testing.assert_array_equal(wmv2.idct_put(coef), np.full((1, 64), min(max(col, 0), 255)))


def test_idct_is_near_the_float_idct():
    """WMV2's integer IDCT within 1 of the exact orthonormal IDCT (with its
    scale of 8) on random small blocks, and linear in its input up to
    rounding."""
    rng = np.random.default_rng(0)
    k = np.arange(8)
    basis = np.cos((2 * k[:, None] + 1) * k[None, :] * np.pi / 16) * np.where(k == 0, np.sqrt(
        1 / 8), np.sqrt(2 / 8))[None, :]
    coef = rng.integers(-64, 65, (200, 8, 8)) * (rng.random((200, 8, 8)) < 0.3)
    exact = np.einsum("xu,nuv,yv->nxy", basis, coef.astype(float), basis) / 8 * 8
    got = wmv2._idct_values(coef.reshape(-1, 64))
    assert np.abs(got - exact).max() <= 1.0


def test_mspel_filters():
    """``put_mspel_pixels_tab``: dxy 0 copies, a flat reference stays flat
    under every filter, and the half-sample filter is (9 (b + c) - (a + d)
    + 8) >> 4 along its axis."""
    rng = np.random.default_rng(1)
    ref = rng.integers(0, 256, (32, 32)).astype(np.uint8)
    sx, sy = np.array([4, 9]), np.array([5, 12])
    out = wmv2.mspel8(ref, sx, sy, np.array([0, 0]))
    np.testing.assert_array_equal(out[0], ref[5:13, 4:12])
    flat = np.full((32, 32), 77, np.uint8)
    for d in range(8):
        np.testing.assert_array_equal(wmv2.mspel8(flat, sx, sy, np.full(2, d)), 77)
    half = wmv2.mspel8(ref, sx, sy, np.array([2, 2]))[0].astype(int)
    r = ref.astype(int)[5:13]
    want = np.clip((9 * (r[:, 4:12] + r[:, 5:13]) - (r[:, 3:11] + r[:, 6:14]) + 8) >> 4, 0, 255)
    np.testing.assert_array_equal(half, want)


@pytest.mark.parametrize("seed", range(4))
def test_recoded_streams_match_cv2(tmp_path, seed):
    """cv2's WMV2 streams re-coded with random choices (the quantiser and
    non-intra table, per-macroblock tables, skip types, the predictor's bit
    or mspel) read as cv2 reads them."""
    cv2 = pytest.importorskip("cv2")
    mf = _module("make_mpeg4_fixtures", REPO / "scripts" / "make_mpeg4_fixtures.py")
    rng = np.random.default_rng(seed)
    h, w = 48, 64 + 16 * seed
    frames = mf.pan(rng, h, w, 4, (int(rng.integers(-2, 3)), 1))
    if seed % 2:
        frames[2:] = frames[1]  # a still part: macroblocks to skip
    src = tmp_path / "src.avi"
    RAW.FX.writer(src, frames, 10.0, "WMV2")
    avi = AviFile(str(src))
    kw = dict(quant=int(rng.integers(1, 32)), cbp_index=int(rng.integers(0, 3)),
              per_mb_rl=bool(rng.integers(0, 2)), skip_type=int(rng.integers(0, 4)))
    kw["top_left" if seed < 2 else "mspel"] = True
    try:
        ext, pics = WF.recode_wmv2(list(avi.frames()), w, h, avi.extradata, rng, **kw)
    except ValueError:  # a third escape's level past the new quantiser's lengths
        kw["quant"] = None
        ext, pics = WF.recode_wmv2(list(avi.frames()), w, h, avi.extradata, rng, **kw)
    path = tmp_path / "recoded.avi"
    RAW.FX.write_avi(path, pics, w, h, 10, b"WMV2", extradata=ext)
    want = [cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) for f in RAW._cv2_bgr(path)]
    got = list(VideoFile(str(path)))
    assert len(got) == len(want) == 4
    for g, c in zip(got, want):
        np.testing.assert_array_equal(g, c)


# ------------------------------------------------------------- refusals

def _refused(tmp_path, case):
    src = AviFile(str(FIXTURES / "wmv2.avi"))
    packets, ext = list(src.frames()), bytearray(src.extradata)
    if case == "loop_filter":
        ext[2] |= 0x40  # the extension header's loop filter bit
    elif case == "short_extradata":
        ext = ext[:2]
    elif case == "j_type":  # an I-picture's j_type bit (its 14th)
        p = bytearray(packets[0])
        p[1] |= 0x04
        packets[0] = bytes(p)
    elif case == "abt":  # P-pictures of ABT type 1 (8x4)
        rng = np.random.default_rng(0)
        ext, packets = WF.recode_wmv2(packets, src.width, src.height, bytes(ext), rng)
        packets = [p if k == 0 else _abt_type_1(p) for k, p in enumerate(packets)]
    path = tmp_path / "clip.avi"
    RAW.FX.write_avi(path, packets, src.width, src.height, 10, b"WMV2", extradata=bytes(ext))
    return path


def _abt_type_1(packet):
    """A P-picture header (skip type 0, non-intra index 0) with ``abt_type``
    '10' where it had '0': one bit more after bit 10."""
    bits = bin(int.from_bytes(packet, "big"))[2:].zfill(8 * len(packet))
    assert bits[6:11] == "00001"  # skip type 0, cbp index 0, mspel 0, per_mb_abt 0
    bits = bits[:11] + "10" + bits[12:]
    bits += "0" * (-len(bits) % 8)
    return int(bits, 2).to_bytes(len(bits) // 8, "big")


REFUSALS = {"loop_filter": "loop filter", "short_extradata": "2 bytes of extradata",
            "j_type": "j_type", "abt": "ABT block type 1"}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_name_item_4(tmp_path, case):
    """What the port leaves (WMV2's loop filter, extradata too short for
    the extension header, IntraX8 pictures, ABT's 8x4 and 4x8 blocks),
    which cv2's writer never sets, raises naming it and ROADMAP item 4,
    from both readers."""
    path = str(_refused(tmp_path, case))
    with pytest.raises(ValueError, match=f"(?s){REFUSALS[case]}.*item 4"):
        VideoReader((180, 240)).initialize(path)
    with pytest.raises(ValueError, match="item 4"):
        list(VideoSequence(path))
