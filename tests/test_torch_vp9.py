"""The port's VP9 decoder (``v2e2v_tpu_torch/utils/vp9*.py``) against cv2
(FFmpeg's native ``vp9`` decoder and swscale) on streams whose headers
``scripts/make_vp9_fixtures.py`` rewrites, on random cv2-written clips, and
piece by piece:

- ``CASES``: the frames of ``tests/data/vp9/noise.webm`` with uncompressed
  header fields rewritten (loop filter levels, sharpness and deltas, the
  quantisers and lossless, segmentation in every mode, backward adaptation,
  the probability contexts, compound prediction, each interpolation
  filter, low-precision vectors, hidden frames, superframes,
  ``show_existing_frame``, error resilience, reference slots, the colour
  range and spaces); the compressed header and tiles are kept, so each
  stream decodes deterministically. Each equals cv2 (read on one thread) at
  every pixel of every frame, and each asserts that what it names was used.
- ``RANDOM``: cv2-written clips of random sizes from 1x1 and random content.
- The tables of ``utils/vp9tables.py``: shapes, checksums, invariants.
- The wavefront loop filter against raster order; the inverse transforms
  against a float64 evaluation; each refusal, which names ROADMAP item 4.
"""

import hashlib
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

from v2e2v_tpu_torch.utils import video as video_module
from v2e2v_tpu_torch.utils import vp9dec, vp9itx, vp9lf
from v2e2v_tpu_torch.utils import vp9tables as T
from v2e2v_tpu_torch.utils.mkv import MkvFile
from v2e2v_tpu_torch.utils.video import VideoFile

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "data" / "vp9"


def _script(name):
    sys.path.insert(0, str(REPO / "scripts"))
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FX = _script("make_vp9_fixtures")
MK = _script("make_mkv_fixtures")


def _packets(name, count=None):
    mkv = MkvFile(str(FIXTURES / name))
    frames = FX.split_packets(list(mkv.frames()))
    return frames[:count], (mkv.width, mkv.height)


BASE, SIZE = _packets("noise.webm", 5)


class _Log(vp9dec.Vp9Decoder):
    """The decoder, keeping each frame's header and block records."""

    last = None

    def __init__(self, path="<stream>"):
        super().__init__(path)
        self.log = []
        _Log.last = self


def _cv2_bgr(cv2, path):
    cap = cv2.VideoCapture(str(path), cv2.CAP_FFMPEG, [cv2.CAP_PROP_N_THREADS, 1])
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    cap.release()
    return out


def _check(tmp_path, packets, size, monkeypatch):
    """The stream through cv2 and the port: equal frames; returns the port's
    decoder (its log of headers and block records)."""
    cv2 = pytest.importorskip("cv2")
    path = tmp_path / "c.webm"
    MK.write_webm(path, packets, size[0], size[1], codec_id="V_VP9")
    monkeypatch.setattr(video_module, "Vp9Decoder", _Log)
    got = list(VideoFile(str(path)).bgr())
    want = _cv2_bgr(cv2, path)
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"frame {i}")
    return _Log.last


# ------------------------------------------------------ rewritten headers

def _seg(update_map, temporal=0, update_data=0, absolute=0, features=None, tree=None, pred=None):
    return {"update_map": update_map, "tree_probs": tree or [120, 80, None, 200, 30, 150, 90],
            "temporal": temporal, "pred_probs": pred or [80, None, 200],
            "update_data": update_data, "abs": absolute, "features": features}


def _set(**kw):
    def change(i, h):
        for k, v in kw.items():
            h[k] = v(i, h) if callable(v) else v
    return change


def _inter(**kw):
    def change(i, h):
        if not h["key"]:
            _set(**kw)(i, h)
    return change


DELTA_FEATURES = [[10, None, None, 0], [-20, 5, None, 0], [None, -10, None, 0], [40, 20, None, 0],
                  [None, None, None, 0], [-5, -5, None, 0], [60, 30, None, 0], [None, 63, None, 0]]
ABS_FEATURES = [[100, 30, None, 0]] * 4 + [[None, None, None, 0]] * 4
REF_FEATURES = [[None, None, None, 0], [None, None, 1, 0], [None, None, 2, 0], [None, None, 3, 0],
                [None, None, 0, 0], [None, None, None, 1], [None, None, 1, 1], [5, None, None, 0]]


def _segmentation(i, h):
    if i == 0:
        h["seg"] = _seg(1, update_data=1, features=DELTA_FEATURES)
    elif i == 1:
        h["seg"] = {"update_map": 0, "update_data": 0}
    elif i == 2:
        h["seg"] = _seg(1, temporal=1, update_data=1, absolute=1, features=ABS_FEATURES)
    elif i == 3:
        h["seg"] = None
    else:
        h["seg"] = _seg(1, temporal=1, update_data=1, features=REF_FEATURES, tree=[128] * 7,
                        pred=[30, 128, 220])


def _lf_deltas(i, h):
    h["lf_level"] = 36
    if i in (0, 3):
        h["lf_deltas"] = {"update": 1, "ref": [5, -3, None, 12], "mode": [-7, 9]}


def _hidden(packets):
    """Frame 2 hidden (into slot 1), sent with frame 3 as a superframe, then
    shown by a ``show_existing_frame`` packet; frame 1 shown again too."""
    out = []
    for i, f in enumerate(packets):
        h, rest = FX.parse_header(f, SIZE)
        if i == 2:
            h["show"], h["intra_only"], h["refresh"] = 0, 0, 2
            hidden = FX.write_header(h) + rest
        elif i == 3:
            out += [FX.superframe([hidden, f]), FX.show_existing(1)]
        else:
            out.append(f)
        if i == 1:
            out.append(FX.show_existing(0))
    return out


CASES = {
    "lf_levels_and_sharpness": _set(lf_level=lambda i, h: (0, 1, 17, 40, 63)[i],
                                    sharpness=lambda i, h: (0, 3, 5, 7, 2)[i]),
    "lf_levels_sharpness_2": _set(lf_level=lambda i, h: (5, 31, 32, 9, 50)[i],
                                  sharpness=lambda i, h: (1, 4, 6, 0, 7)[i]),
    "lf_deltas": _lf_deltas,
    "lossless": _set(base_q=0, dq=[None] * 3),
    "q_sweep_and_q0": _set(base_q=lambda i, h: (0, 40, 100, 160, 220)[i],
                           dq=lambda i, h: [None, 2, None] if i == 0 else [None] * 3),
    "delta_q": _set(dq=lambda i, h: [[-15, 7, 15], [15, -15, 3], [-8, 15, -15]][i % 3]),
    "segmentation": _segmentation,
    "backward_adaptation": _set(parallel=0),
    "adaptation_contexts": _set(parallel=0, context_idx=lambda i, h: i % 4,
                                refresh_context=lambda i, h: int(i % 3 != 2)),
    "no_context_refresh": _set(refresh_context=0),
    "context_idx": _set(context_idx=lambda i, h: (0, 1, 2, 3, 1)[i]),
    "reset_context": _inter(reset_context=lambda i, h: i % 4, context_idx=lambda i, h: i % 4),
    "compound_golden_altref_bias": _inter(sign_bias=[0, 1, 1]),
    "compound_last_bias": _inter(sign_bias=[1, 0, 0]),
    "filter_smooth": _inter(filter=0),  # the header's literal: smooth, regular, sharp, bilinear
    "filter_regular": _inter(filter=1),
    "filter_sharp": _inter(filter=2),
    "filter_bilinear": _inter(filter=3),
    "low_precision_mvs": _inter(allow_hp=0),
    "error_resilient": _set(error_res=lambda i, h: int(i == 3)),
    "reference_slots": _inter(refresh=lambda i, h: (1, 2, 4, 3, 0x81)[i % 5],
                              ref_idx=lambda i, h: [[0, 1, 2], [1, 0, 2], [2, 1, 0]][i % 3]),
    "full_range": _set(color_range=lambda i, h: 1 if h["key"] else None),
    "hidden_superframe_show_existing": "hidden",
}
for _cs in (0, 1, 3):
    CASES[f"color_space_{_cs}"] = _set(color_space=lambda i, h, cs=_cs: cs if h["key"] else None)


def _rewritten(name):
    change = CASES[name]
    if change == "hidden":
        return _hidden(BASE)
    # the compound cases take 7 frames: the seventh's compressed header reads
    # as REFERENCE_MODE_SELECT once compound prediction is allowed, and some
    # of its blocks then read as compound
    frames = _packets("noise.webm", 7)[0] if name.startswith("compound") else BASE

    def clean(i, h):
        change(i, h)
        for k in [k for k, v in h.items() if v is None and k in ("color_range", "color_space")]:
            del h[k]
    return FX.rewrite(frames, clean, SIZE)


@pytest.mark.parametrize("name", sorted(CASES))
def test_rewritten_headers_match_cv2(tmp_path, name, monkeypatch):
    """Each rewritten stream equals cv2 at every pixel of every frame, and
    uses what it is named for."""
    dec = _check(tmp_path, _rewritten(name), SIZE, monkeypatch)
    hdrs = [h for h, _ in dec.log]
    tds = [td for _, td in dec.log]
    blocks = [b for td in tds for row in td.grid for b in row]
    if name.startswith("lf_levels"):
        assert len({h.lf_level for h in hdrs}) == 5 and len({h.sharpness for h in hdrs}) == 5
        assert any(td.lf_masks.any() for td in tds)
    elif name == "lf_deltas":
        assert all(h.lf_deltas_enabled for h in hdrs) and hdrs[3].lf_deltas_update
        assert dec.lf_ref_deltas == [5, -3, -1, 12] and dec.lf_mode_deltas == [-7, 9]
    elif name in ("lossless", "q_sweep_and_q0"):
        lossless = [h.lossless for h in hdrs]
        assert any(lossless) if name == "lossless" else lossless == [False] * 5
        assert name != "lossless" or any((0, 4) in td.coefs for td in tds)  # the WHT
        assert name == "lossless" or hdrs[0].base_q == 0
    elif name == "delta_q":
        assert all(h.dq_y_dc and h.dq_uv_dc and h.dq_uv_ac for h in hdrs)
    elif name == "segmentation":
        used = set().union(*(td.segments_used for td in tds))
        assert len(used) > 4
        assert any(b.seg_pred for b in blocks)  # temporal prediction
        assert {h.seg_update_data for h in hdrs} == {0, 1} and not hdrs[3].seg_enabled
        assert dec.seg_abs == 0 and hdrs[2].seg_update_data  # absolute, then delta values
        refs = {1: 1, 2: 2, 3: 3, 4: 0, 6: 1}  # frame 4's reference feature
        last = [b for row in tds[4].grid for b in row]
        assert any(b.seg in refs for b in last)
        assert all((b.ref[0] if b.is_inter else 0) == refs[b.seg] for b in last if b.seg in refs)
        assert all(b.skip for b in last if b.seg in (5, 6))
    elif name in ("backward_adaptation", "adaptation_contexts"):
        assert any(h.refresh_context and not h.parallel for h in hdrs)
    elif name == "no_context_refresh":
        assert not any(h.refresh_context for h in hdrs)
    elif name in ("context_idx", "reset_context"):
        assert {h.context_idx for h in hdrs if not h.key} >= {1, 2, 3}
    elif name.startswith("compound"):
        assert any(b.is_inter and b.ref[1] > 0 for b in blocks)
    elif name.startswith("filter_"):
        want = {"regular": 0, "smooth": 1, "sharp": 2, "bilinear": 3}[name[7:]]  # libvpx's
        assert {h.filter for h in hdrs if not h.key} == {want}
        assert any(b.is_inter and b.filter == want for b in blocks)
    elif name == "low_precision_mvs":
        mvs = [v for b in blocks if b.is_inter for m in b.mv for v in m[0]]
        assert not any(h.allow_hp for h in hdrs if not h.key) and mvs
    elif name == "error_resilient":
        assert hdrs[3].error_res
    elif name == "reference_slots":
        assert {h.refresh for h in hdrs[1:]} >= {2, 4, 3}
    elif name == "full_range":
        assert dec.full_range
    elif name == "hidden_superframe_show_existing":
        assert [h.show for h in hdrs] == [1, 1, 0, 1, 1] and len(dec.log) == 5
    elif name.startswith("color_space"):
        assert hdrs[0].color_space == int(name[-1])


# ----------------------------------------------------------- random clips

RANDOM = [(1, 1, 3), (3, 5, 2), (9, 7, 3), (33, 17, 3), (65, 65, 3), (40, 130, 2)]


@pytest.mark.parametrize("h,w,n", RANDOM)
def test_random_clips_match_cv2(tmp_path, h, w, n, monkeypatch):
    """cv2-written clips of random content at sizes from 1x1: cv2's writer
    keeps even sizes, so an odd size is written one pixel larger and its key
    frame's header rewritten to it (the same 8x8 grid)."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(h * 1000 + w)
    eh, ew = h + (h & 1), w + (w & 1)
    frames = rng.integers(0, 256, (n, eh, ew, 3), dtype=np.uint8)
    frames[1:] = np.roll(frames[:1], 1, axis=2) // 2 + frames[1:] // 2
    path = tmp_path / "r.webm"
    vw = cv2.VideoWriter(str(path), cv2.CAP_FFMPEG, cv2.VideoWriter_fourcc(*"VP90"), 10.0, (ew, eh))
    assert vw.isOpened()
    for f in frames:
        vw.write(f)
    vw.release()
    packets = FX.rewrite(list(MkvFile(str(path)).frames()),
                         _set(width=lambda i, hd: w, height=lambda i, hd: h), (w, h))
    _check(tmp_path, packets, (w, h), monkeypatch)


# ----------------------------------------------------------------- tables

def test_tables_shapes_checksums_and_invariants():
    """Every table of ``utils/vp9tables.py`` as the extraction script wrote
    it (sha256 of its bytes), and what a VP9 table must be: probabilities in
    1..255, scans permutations whose neighbours come earlier in the scan,
    kernels summing to 128, quantisers increasing."""
    for name, digest in T.CHECKSUMS.items():
        a = getattr(T, name)
        assert hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16] == digest, name
    shapes = {"COEF_PROBS": (4, 2, 2, 6, 6, 3), "PARETO8": (255, 8), "KF_Y_MODE_PROBS": (10, 10, 9),
              "KF_UV_MODE_PROBS": (10, 9), "Y_MODE_PROBS": (4, 9), "UV_MODE_PROBS": (10, 9),
              "PARTITION_PROBS": (16, 3), "KF_PARTITION_PROBS": (16, 3),
              "SUBPEL_FILTERS": (4, 16, 8),
              "DC_QLOOKUP": (256,), "AC_QLOOKUP": (256,), "MV_REF_BLOCKS": (13, 8, 2),
              "INV_MAP_TABLE": (255,), "DEFAULT_SCAN_32X32": (1024,)}
    for name, shape in shapes.items():
        assert getattr(T, name).shape == shape, name
    for name in T.CHECKSUMS:
        a = getattr(T, name)
        if name.endswith("_PROBS") or name == "PARETO8":
            vals = a[..., :3].ravel() if name == "COEF_PROBS" else a.ravel()
            if name == "COEF_PROBS":  # band 0 has three contexts; the rest are zero
                assert (a[:, :, :, 0, 3:] == 0).all() and a[:, :, :, 1:].min() >= 1
                vals = a[:, :, :, 0, :3].ravel()
            assert vals.min() >= 1 and vals.max() <= 255, name
        if "_SCAN_" in name and not name.endswith("NEIGHBORS"):
            n = len(a)
            assert sorted(a.tolist()) == list(range(n)), name
            nb = getattr(T, name + "_NEIGHBORS")
            pos = np.argsort(a)  # scan position of each raster index
            for c in range(1, n):
                assert pos[nb[c, 0]] < c and pos[nb[c, 1]] < c, (name, c)
    assert (T.SUBPEL_FILTERS.sum(-1) == 128).all()
    assert (np.diff(T.DC_QLOOKUP) >= 0).all() and (np.diff(T.AC_QLOOKUP) > 0).all()
    assert sorted(T.INV_MAP_TABLE[:-1].tolist()) == list(range(1, 255))


# ------------------------------------------------------------ the pieces

def test_wavefront_loop_filter_matches_raster_order():
    """The loop filter run by anti-diagonals of superblocks equals FFmpeg's
    raster order, on random planes with the masks of a decoded frame and
    with random masks and levels."""
    rng = np.random.default_rng(5)
    packets, _ = _packets("noise.webm")
    dec = vp9dec.Vp9Decoder()
    dec.log = []
    for p in packets[:2]:
        list(dec.decode(p))
    td = dec.log[1][1]
    cases = [(td.lf_masks, td.lf_level, 0)]
    shape = (3, 4)
    masks = rng.integers(0, 256, shape + (2, 2, 8, 4)) & rng.integers(0, 256, shape + (2, 2, 8, 4))
    cases.append((masks, rng.integers(1, 64, shape + (8, 8)), 3))
    for masks, levels, sharp in cases:
        h, w = masks.shape[0] * 64, masks.shape[1] * 64
        # blocky planes whose steps the filters smooth: flat 8x8 cells plus noise
        planes = []
        for ph, pw in ((h + 16, w + 16), (h // 2 + 16, w // 2 + 16), (h // 2 + 16, w // 2 + 16)):
            cells = rng.integers(60, 200, ((ph + 7) // 8, (pw + 7) // 8))
            cells = np.kron(cells, np.ones((8, 8), np.int64))[:ph, :pw]
            planes.append((cells + rng.integers(-2, 3, (ph, pw))).astype(np.int32))
        a = [p.copy() for p in planes]
        b = [p.copy() for p in planes]
        vp9lf.loop_filter(a, masks, levels, sharp, order="wavefront")
        vp9lf.loop_filter(b, masks, levels, sharp, order="raster")
        for pa, pb, p in zip(a, b, planes):
            np.testing.assert_array_equal(pa, pb)
            assert (pa != p).any()


def _basis(kind, n):
    i, k = np.arange(n)[:, None], np.arange(n)[None, :]
    if kind == "dct":
        c = np.cos((2 * i + 1) * k * np.pi / (2 * n))
        c[:, 0] /= np.sqrt(2)
        return c
    if n == 4:
        return 2 * np.sqrt(2) / 3 * np.sin(np.pi * (i + 1) * (2 * k + 1) / 9)
    return np.sin(np.pi * (2 * i + 1) * (2 * k + 1) / (4 * n))


@pytest.mark.parametrize("tx,ttype", [(t, k) for t in range(3) for k in range(4)] + [(3, 0)])
def test_inverse_transforms_match_float(tx, ttype):
    """Each size and type against its float64 evaluation (the DCT-II and
    the VP9 ADSTs, rows then columns, the final shift): within the
    roundings' reach, and exactly where the float value is an integer apart
    from them (a DC-only block of a multiple of the shift)."""
    n = 4 << tx
    rng = np.random.default_rng(tx * 4 + ttype)
    c = np.zeros((64, n * n), np.int64)
    for blk in c:
        idx = rng.choice(n * n, size=rng.integers(1, 12), replace=False)
        blk[idx] = rng.integers(-300, 301, len(idx))
    got = vp9itx.inverse(c, tx, ttype)
    cols, rows = vp9itx.TYPES[ttype]
    bc = _basis("dct" if cols == vp9itx.DCT else "adst", n)
    br = _basis("dct" if rows == vp9itx.DCT else "adst", n)
    want = np.einsum("ik,bkl,jl->bij", bc, c.reshape(-1, n, n).astype(float), br)
    want /= 1 << vp9itx.SHIFT[tx]
    assert np.abs(got - want).max() <= 1.5
    if ttype == 0:  # DC alone: 16384-scale rotations of a value round exactly
        dc = np.zeros((1, n * n), np.int64)
        dc[0, 0] = 2 * (1 << vp9itx.SHIFT[tx]) * 16
        assert (vp9itx.inverse(dc, tx, 0) == 16).all()
    lossless = np.zeros((1, 16), np.int64)
    lossless[0, 0] = 4 * 32
    assert (vp9itx.inverse(lossless, 0, 4) == 8).all()  # the WHT spreads a DC evenly


# --------------------------------------------------------------- refusals

def _refusal(case):
    """(packets, size, what the ValueError names)."""
    if case.startswith("profile"):
        p = int(case[-1])
        frames = [FX.write_header({**FX.parse_header(BASE[0], SIZE)[0], "profile": p})
                  + FX.parse_header(BASE[0], SIZE)[1]]
        return frames, SIZE, f"profile {p}"
    if case == "intra_only":
        def change(i, h):
            if i == 1:
                h["show"], h["intra_only"] = 0, 1
        return FX.rewrite(BASE[:3], change, SIZE), SIZE, "intra-only"
    if case == "size_change":
        gop, size = _packets("gop.webm")
        return FX.rewrite(gop[:14], _set(width=lambda i, h: 80 if i == 12 else h["width"]),
                          size), size, "size change"
    if case == "scaled_reference":
        return FX.rewrite(BASE[:3], _set(size_from_ref=lambda i, h: None if i == 2 else
                                         h.get("size_from_ref"),
                                         width=lambda i, h: 112 if i == 2 else h["width"]),
                          SIZE), SIZE, "scaled motion compensation"
    if case == "inter_first":
        return BASE[1:3], SIZE, "inter frame before any key frame"
    if case == "color_space":
        return FX.rewrite(BASE[:2], _set(color_space=lambda i, h: 2 if h["key"] else None),
                          SIZE), SIZE, "colour space 2"
    if case == "frame_marker":
        return [bytes([BASE[0][0] & 0x3F]) + BASE[0][1:]], SIZE, "frame marker"
    if case == "sync_code":
        return FX.rewrite(BASE[:1], _set(sync=0x498343), SIZE), SIZE, "sync code"
    if case == "marker_bit":
        h, rest = FX.parse_header(BASE[0], SIZE)
        return [FX.write_header(h) + bytes([rest[0] | 0x80]) + rest[1:]], SIZE, "marker bit"
    if case == "tile_past_packet":
        wide, size = _packets("wide.webm")
        return [wide[0][:len(wide[0]) // 3]], size, "past the frame's end"
    if case == "truncated_header":
        return [BASE[0][:5]], SIZE, "truncated frame header"
    if case == "simd_range_coefficients":
        return FX.rewrite(BASE[:2], _set(base_q=255), SIZE), SIZE, "leaves 16 bits"
    raise KeyError(case)


REFUSALS = ["profile_1", "profile_2", "profile_3", "intra_only", "size_change",
            "scaled_reference", "inter_first", "color_space", "frame_marker", "sync_code",
            "marker_bit", "tile_past_packet", "truncated_header", "simd_range_coefficients"]


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals_name_item_4(case):
    """Each stream the port does not decode raises a ValueError naming what
    it is and ROADMAP item 4 (``simd_range_coefficients``: ``base_q_idx`` 255
    on the noise clip drives transforms past 16 bits, where cv2's x86 code
    and FFmpeg's C code part; cv2 decodes it)."""
    packets, _, what = _refusal(case)
    dec = vp9dec.Vp9Decoder("<case>")
    with pytest.raises(ValueError, match=f"(?s){what}.*item 4"):
        for p in packets:
            list(dec.decode(p))
