"""The port's JPEG decoder (v2e2v_tpu_torch.utils.jpeg, behind
``utils/image_io.read_gray``) against ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``,
the JAX package's frame reader: equal, pixel for pixel and in shape, on files
``cv2.imencode`` writes from seeded colour scenes, with every Exif orientation
in both byte orders; each file it does not read raises, naming ROADMAP item 4.

The fixtures under ``tests/data/jpeg`` (``scripts/make_jpeg_fixtures.py``) are
checked twice: the decoder against ``manifest.json``'s hashes, which needs no
cv2 and so also runs on the card's machine (``pytest --noconftest``), and the
hashes against cv2 wherever cv2 is installed, so the committed expectation
stays cv2's.
"""

import hashlib
import json
import struct
from pathlib import Path

import numpy as np
import pytest

from v2e2v_tpu_torch.utils import image_io, jpeg

FIXTURES = Path(__file__).resolve().parent / "data" / "jpeg"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())["files"]


def _scene(seed, h, w):
    """A colour scene, BGR uint8: gradients, texture, saturated discs, noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([rng.uniform(40, 200) + rng.uniform(-80, 80) * (xx / w - yy / h)
                    for _ in range(3)], -1)
    img += 40 * np.sin(xx / rng.uniform(1.5, 6) + yy / rng.uniform(2, 9))[..., None]
    for _ in range(4):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(1, max(2, h / 3))
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.choice([0, 255], 3)
    img += rng.normal(0, 12, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def _cases():
    """(id, height, width, gray, encoder parameters as cv2 constant names)."""
    for sf in (411, 420, 422, 440, 444):
        for h, w in ((7, 13), (33, 47), (181, 243)):
            yield f"sampling_{sf}-{h}x{w}", h, w, False, [
                ("IMWRITE_JPEG_SAMPLING_FACTOR", f"IMWRITE_JPEG_SAMPLING_FACTOR_{sf}")]
    for h, w in ((1, 1), (8, 8), (33, 47), (181, 243)):
        yield f"gray-{h}x{w}", h, w, True, []
    for q in (5, 50, 90, 100):
        yield f"quality_{q}", 33, 47, False, [("IMWRITE_JPEG_QUALITY", q)]
    yield "quality_100-181x243", 181, 243, False, [("IMWRITE_JPEG_QUALITY", 100)]
    yield "quality_5-gray", 33, 47, True, [("IMWRITE_JPEG_QUALITY", 5)]
    for rst in (1, 3, 7):
        yield f"restart_{rst}", 33, 47, False, [("IMWRITE_JPEG_RST_INTERVAL", rst)]
    yield "restart_2-gray", 33, 47, True, [("IMWRITE_JPEG_RST_INTERVAL", 2)]
    yield "optimize", 33, 47, False, [("IMWRITE_JPEG_OPTIMIZE", 1)]
    yield "optimize-gray", 33, 47, True, [("IMWRITE_JPEG_OPTIMIZE", 1)]
    yield "progressive", 33, 47, False, [("IMWRITE_JPEG_PROGRESSIVE", 1)]
    yield "progressive-181x243-444", 181, 243, False, [
        ("IMWRITE_JPEG_PROGRESSIVE", 1),
        ("IMWRITE_JPEG_SAMPLING_FACTOR", "IMWRITE_JPEG_SAMPLING_FACTOR_444")]
    yield "progressive-gray", 31, 57, True, [("IMWRITE_JPEG_PROGRESSIVE", 1)]
    yield "progressive-restart-q100", 33, 47, False, [
        ("IMWRITE_JPEG_PROGRESSIVE", 1), ("IMWRITE_JPEG_RST_INTERVAL", 2),
        ("IMWRITE_JPEG_QUALITY", 100)]
    yield "progressive-q5-optimize", 33, 47, False, [
        ("IMWRITE_JPEG_PROGRESSIVE", 1), ("IMWRITE_JPEG_QUALITY", 5),
        ("IMWRITE_JPEG_OPTIMIZE", 1)]
    yield "progressive-1x1", 1, 1, False, [("IMWRITE_JPEG_PROGRESSIVE", 1)]
    for h, w in ((1, 1), (2, 3), (9, 1), (1, 17), (15, 16), (17, 31)):
        yield f"size-{h}x{w}", h, w, False, []


CASES = list(_cases())


def _encode(cv2, img, params):
    flat = []
    for key, value in params:
        flat += [getattr(cv2, key), getattr(cv2, value) if isinstance(value, str) else value]
    ok, buf = cv2.imencode(".jpg", img, flat)
    assert ok
    return buf.tobytes()


def _check(cv2, path):
    want = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    got = image_io.read_gray(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape, path.name
    np.testing.assert_array_equal(got, want, err_msg=path.name)
    return got


@pytest.mark.parametrize("h,w,gray,params", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_decoder_matches_cv2(tmp_path, h, w, gray, params):
    cv2 = pytest.importorskip("cv2")
    img = _scene(h * 1000 + w + len(params), h, w)
    if gray:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    path = tmp_path / "f.jpg"
    path.write_bytes(_encode(cv2, img, params))
    got = _check(cv2, path)
    np.testing.assert_array_equal(jpeg.decode_jpeg_gray(path.read_bytes()), got)


def _tiff(orientation, order="<", magic=42, extra=()):
    """A TIFF header and IFD0 with the orientation tag (SHORT) among ``extra``
    entries ``(tag, value)``, all sorted by tag."""
    entries = sorted([(0x0112, orientation), *extra])
    body = struct.pack(order + "H", len(entries)) + b"".join(
        struct.pack(order + "HHIHH", tag, 3, 1, value, 0) for tag, value in entries)
    return ((b"II" if order == "<" else b"MM") + struct.pack(order + "HI", magic, 8) + body
            + struct.pack(order + "I", 0))


def _app1(payload, prefix=b"Exif\x00\x00"):
    body = prefix + payload
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def _with_segments(data, segments):
    """``segments`` inserted after SOI and the APP0 segment after it."""
    pos = 4 + struct.unpack(">H", data[4:6])[0] if data[2:4] == b"\xff\xe0" else 2
    return data[:pos] + segments + data[pos:]


@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("orientation", range(10))
def test_exif_orientation_matches_cv2(tmp_path, orientation, order):
    """Every orientation value (1-8, and 0 and 9, which OpenCV leaves alone)
    in either byte order, on a 4:2:0 file whose width and height differ."""
    cv2 = pytest.importorskip("cv2")
    data = _encode(cv2, _scene(orientation, 21, 34), [])
    path = tmp_path / "f.jpg"
    path.write_bytes(_with_segments(data, _app1(_tiff(orientation, order))))
    got = _check(cv2, path)
    assert got.shape == ((34, 21) if orientation in (5, 6, 7, 8) else (21, 34))


EXIF_SEGMENTS = {  # the Exif segments before the first scan: cv2 decides which counts
    "first_exif_wins": _app1(_tiff(6)) + _app1(_tiff(3)),
    "xmp_app1_first": _app1(b"http://ns.adobe.com/xap/1.0/\x00<x/>", prefix=b"") + _app1(_tiff(6)),
    "no_exif_prefix": _app1(_tiff(6), prefix=b""),
    "other_exif_prefix": _app1(_tiff(6), prefix=b"Exif\x00\x01"),
    "bad_magic_then_good": _app1(_tiff(3, magic=43)) + _app1(_tiff(6)),
    "no_tag_then_tag": _app1(_tiff(0)[:8] + struct.pack("<HI", 0, 0)) + _app1(_tiff(6)),
    "value_9_then_6": _app1(_tiff(9)) + _app1(_tiff(6)),
    "truncated_ifd_then_6": _app1(_tiff(3)[:12]) + _app1(_tiff(6)),
    "entry_cut_to_10_bytes": _app1(_tiff(6)[:20]),
    "entry_cut_to_8_bytes": _app1(_tiff(6)[:18]),
    "among_other_tags": _app1(_tiff(5, ">", extra=((0x0100, 21), (0x0131, 2)))),
    "empty_exif": _app1(b""),
}


@pytest.mark.parametrize("name", list(EXIF_SEGMENTS))
def test_exif_segments_as_cv2_reads_them(tmp_path, name):
    cv2 = pytest.importorskip("cv2")
    data = _encode(cv2, _scene(7, 21, 34), [])
    path = tmp_path / "f.jpg"
    path.write_bytes(_with_segments(data, EXIF_SEGMENTS[name]))
    _check(cv2, path)


def test_exif_after_the_first_scan_is_not_read(tmp_path):
    """OpenCV reads the orientation from the header, before the first scan:
    an Exif segment between the scans of a progressive file leaves it alone."""
    cv2 = pytest.importorskip("cv2")
    data = _encode(cv2, _scene(8, 21, 34), [("IMWRITE_JPEG_PROGRESSIVE", 1)])
    second = data.find(b"\xff\xda", data.find(b"\xff\xda") + 2)
    path = tmp_path / "f.jpg"
    path.write_bytes(data[:second] + _app1(_tiff(6)) + data[second:])
    assert _check(cv2, path).shape == (21, 34)


def _tolerated(cv2):
    """name -> a file libjpeg reads with at most a warning."""
    base = _encode(cv2, _scene(12, 24, 40), [])
    sos = base.find(b"\xff\xda")
    header_end = sos + 2 + struct.unpack(">H", base[sos + 2:sos + 4])[0]
    return {
        # some baseline files carry zeros there; libjpeg warns and reads the scan whole
        "sequential_scan_zero_parameters": base[:header_end - 3] + bytes(3) + base[header_end:],
        "bytes_before_a_marker": _with_segments(base, b"\x00\x01\x02\xff\x00"),
        "fill_bytes_before_markers": base[:sos] + b"\xff\xff" + base[sos:-2] + b"\xff\xff\xd9",
        "comment_and_app_segments": _with_segments(
            base, b"\xff\xfe\x00\x07hello" + b"\xff\xe5\x00\x04ab"),
        "no_eoi": base[:-2],
        "data_after_eoi": base + b"trailing bytes",
    }


@pytest.mark.parametrize("name", ["sequential_scan_zero_parameters", "bytes_before_a_marker",
                                  "fill_bytes_before_markers", "comment_and_app_segments",
                                  "no_eoi", "data_after_eoi"])
def test_what_libjpeg_tolerates_matches_cv2(tmp_path, name):
    cv2 = pytest.importorskip("cv2")
    path = tmp_path / "f.jpg"
    path.write_bytes(_tolerated(cv2)[name])
    _check(cv2, path)


def _sof(data):
    """The position of the frame header's marker."""
    return min(p for p in (data.find(m) for m in (b"\xff\xc0", b"\xff\xc2")) if p >= 0)


def _patched(data, pos, value):
    return data[:pos] + bytes([value]) + data[pos + 1:]


def _refusals(cv2):
    """name -> (file bytes, what the message must name)."""
    img = _scene(11, 24, 40)
    base = _encode(cv2, img, [])
    prog = _encode(cv2, img, [("IMWRITE_JPEG_PROGRESSIVE", 1)])
    rst = _encode(cv2, img, [("IMWRITE_JPEG_RST_INTERVAL", 1)])
    sof = _sof(base)
    sos = base.find(b"\xff\xda")
    start = sos + 2 + struct.unpack(">H", base[sos + 2:sos + 4])[0]
    out = {}
    for marker, what in ((0xC9, "arithmetic coding"), (0xCA, "arithmetic coding"),
                         (0xCB, "arithmetic coding"), (0xC3, "lossless"),
                         (0xC5, "hierarchical"), (0xC7, "hierarchical"),
                         (0xCD, "hierarchical arithmetic")):
        out[f"sof_{marker:02x}"] = (_patched(base, sof + 1, marker), what)
    out["dac"] = (_with_segments(base, b"\xff\xcc\x00\x04\x00\x00"), "arithmetic coding")
    out["dhp"] = (_with_segments(base, b"\xff\xde\x00\x02"), "hierarchical")
    out["12_bit"] = (_patched(base, sof + 4, 12), "12-bit samples")
    out["cmyk"] = (_patched(base, sof + 9, 4), "four components")
    out["two_components"] = (_patched(base, sof + 9, 2), "2 components")
    # JFIF's APP0 taken out, Adobe's APP14 with transform 0 (RGB) put in
    app0_end = 4 + struct.unpack(">H", base[4:6])[0]
    adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
    out["adobe_rgb"] = (base[:2] + adobe + base[app0_end:], "Adobe transform 0")
    ids = base[:2] + base[app0_end:]
    s2, sos2 = _sof(ids), ids.find(b"\xff\xda")
    for k, cid in enumerate(b"RGB"):  # in the frame header and in the scan's
        ids = _patched(_patched(ids, s2 + 10 + 3 * k, cid), sos2 + 5 + 2 * k, cid)
    out["rgb_ids"] = (ids, "RGB")
    y_low = _patched(_patched(base, sof + 11, 0x11), sof + 14, 0x22)
    out["y_below_chroma"] = (y_low, "Y component sampled below")
    out["dnl_height_0"] = (base[:sof + 5] + b"\x00\x00" + base[sof + 7:], "DNL")
    out["dnl_marker"] = (base[:-2] + b"\xff\xdc\x00\x04\x00\x18" + base[-2:], "DNL")
    # a progressive file cut after its first three scans: Y's first AC
    # coefficients lack bits, where libjpeg smooths
    fourth = prog.find(b"\xff\xda")
    for _ in range(3):
        fourth = prog.find(b"\xff\xda", fourth + 2)
    out["progressive_smoothed"] = (prog[:fourth] + b"\xff\xd9", "smooths")
    out["truncated"] = (base[:start + (len(base) - start) // 2], "truncated")
    junk = base[:start + 20] + b"\xff\x00" * 12 + base[start + 44:]
    out["bad_huffman_code"] = (junk, "corrupt")
    first_rst = rst.find(b"\xff\xd0")
    out["restart_out_of_order"] = (_patched(rst, first_rst + 1, 0xD3), "restart markers")
    out["no_frame"] = (b"\xff\xd8\xff\xd9", "no frame header")
    return out


REFUSALS = ["sof_c9", "sof_ca", "sof_cb", "sof_c3", "sof_c5", "sof_c7", "sof_cd", "dac", "dhp",
            "12_bit", "cmyk", "two_components", "adobe_rgb", "rgb_ids", "y_below_chroma",
            "dnl_height_0", "dnl_marker", "progressive_smoothed", "truncated",
            "bad_huffman_code", "restart_out_of_order", "no_frame"]


@pytest.mark.parametrize("name", REFUSALS)
def test_what_it_does_not_read_raises(tmp_path, name):
    cv2 = pytest.importorskip("cv2")
    data, what = _refusals(cv2)[name]
    path = tmp_path / "f.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=f"{what}.*item 4"):
        image_io.read_gray(str(path))


def test_range_limit_table_is_libjpegs():
    """``prepare_range_limit_table`` as the IDCT indexes it: x + 128 clipped
    to [0, 255] within [-512, 511], wrapping past that."""
    x = np.arange(-1024, 1024)
    got = jpeg._RANGE_LIMIT[x & jpeg.RANGE_MASK]
    inside = (x >= -512) & (x <= 511)
    np.testing.assert_array_equal(got[inside], np.clip(x[inside] + 128, 0, 255))
    assert got[x == 512] == 0 and got[x == -513] == 255 and got[x == 1000] == 104


def test_idct_matches_a_float_dct_within_one_level():
    """``idct_islow`` against the exact inverse DCT in float64: within one
    level on random coefficients in the encoder's range."""
    rng = np.random.default_rng(0)
    coef = np.zeros((200, 64), np.int64)
    coef[:, 0] = rng.integers(-1000, 1000, 200)
    coef[:, 1:] = rng.integers(-60, 60, (200, 63)) * (rng.random((200, 63)) < 0.3)
    got = jpeg.idct_islow(coef).astype(np.float64)
    k = np.arange(8)
    c = np.where(k == 0, np.sqrt(0.5), 1.0)
    basis = c[:, None] * np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) / 2  # [u, x]
    want = np.einsum("nuv,ux,vy->nxy", coef.reshape(-1, 8, 8) / 8.0, basis, basis) * 8
    want = np.clip(np.round(want + 128), 0, 255).reshape(-1, 64)
    assert np.abs(got - want).max() <= 1


@pytest.mark.parametrize("rel", sorted(MANIFEST))
def test_fixtures_match_manifest(rel):
    """The decoder's output of each committed fixture has the shape and the
    sha256 ``cv2.imread(path, 0)`` gave (no cv2 needed: runs on the card's
    machine too)."""
    got = image_io.read_gray(str(FIXTURES / rel))
    assert list(got.shape) == MANIFEST[rel]["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == MANIFEST[rel]["sha256"]


def test_manifest_is_cv2s():
    """The manifest's hashes are what cv2 returns for the committed files."""
    cv2 = pytest.importorskip("cv2")
    assert len(MANIFEST) >= 27
    for rel, want in MANIFEST.items():
        img = cv2.imread(str(FIXTURES / rel), cv2.IMREAD_GRAYSCALE)
        assert list(img.shape) == want["shape"], rel
        assert hashlib.sha256(img.tobytes()).hexdigest() == want["sha256"], rel
    total = sum(p.stat().st_size for p in FIXTURES.rglob("*") if p.is_file())
    assert total < 1 << 20
