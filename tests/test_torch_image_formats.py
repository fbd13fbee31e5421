"""The port's still-frame decoders (v2e2v_tpu_torch.utils: PNG's remainder in
``image_io``, ``bmp``, ``pnm``, ``tiff``, ``webp``, ``vp8``) against
``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``, the JAX package's frame reader:
equal, pixel for pixel and in shape, on seeded files of each setting, one
module at a time; the readers over a folder that mixes the formats against the
JAX package's readers; and each file the port still refuses raises, naming
ROADMAP item 4.

The fixtures under ``tests/data/images`` (``scripts/make_image_fixtures.py``)
are checked twice: the decoders against ``manifest.json``'s hashes, which
needs no cv2 and so also runs on the card's machine (``pytest
--noconftest``), and the hashes against cv2 wherever cv2 is installed.
Every comparison with cv2 goes through files and ``cv2.imread``, as the JAX
package reads frames: ``cv2.imdecode`` differs on some (a TIFF turned by its
orientation tag).
"""

import hashlib
import importlib.util
import io
import json
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest

from v2e2v_tpu_torch.utils import image_io, webp

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "data" / "images"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())["files"]
SEQUENCE = "sequence_0000000001"
ITEM4 = "ROADMAP.md queue 1, item 4"


def _script():
    """``scripts/make_image_fixtures.py``, whose writers make the cases
    (it imports cv2)."""
    pytest.importorskip("cv2")
    spec = importlib.util.spec_from_file_location(
        "make_image_fixtures", REPO / "scripts" / "make_image_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _check(tmp_path, data: bytes, name: str):
    """``data`` written to ``name``: cv2 reads it, and the port reads the
    same array."""
    import cv2

    path = tmp_path / name
    path.write_bytes(data)
    want = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    assert want is not None, f"cv2 does not read {name}"
    got = image_io.read_gray(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape, name
    np.testing.assert_array_equal(got, want, err_msg=name)
    return got


# ------------------------------------------------------------ the records

@pytest.mark.parametrize("rel", sorted(MANIFEST))
def test_fixtures_match_manifest(rel):
    """Each committed fixture decodes to the shape and sha256 that
    ``cv2.imread(path, 0)`` gave (no cv2 needed: runs on the card's machine)."""
    got = image_io.read_gray(str(FIXTURES / rel))
    assert list(got.shape) == MANIFEST[rel]["shape"]
    assert _sha(got) == MANIFEST[rel]["sha256"]


def test_manifest_is_cv2s():
    """The manifest's hashes are what cv2 returns for the committed files;
    the twin holds the mixed folder's frames; the fixtures stay small."""
    cv2 = pytest.importorskip("cv2")
    assert len(MANIFEST) >= 80
    for rel, want in MANIFEST.items():
        img = cv2.imread(str(FIXTURES / rel), cv2.IMREAD_GRAYSCALE)
        assert list(img.shape) == want["shape"], rel
        assert _sha(img) == want["sha256"], rel
    frames = sorted((FIXTURES / "sequence" / SEQUENCE / "frames").glob("frame_*"))
    twins = sorted((FIXTURES / "sequence_png" / SEQUENCE / "frames").glob("frame_*.png"))
    assert len(frames) == len(twins) == 12
    assert {f.suffix for f in frames} == {".bmp", ".pgm", ".tiff", ".webp", ".png"}
    for f, t in zip(frames, twins):
        assert MANIFEST[f.relative_to(FIXTURES).as_posix()]["sha256"] == MANIFEST[
            t.relative_to(FIXTURES).as_posix()]["sha256"]
    assert sum(p.stat().st_size for p in FIXTURES.rglob("*") if p.is_file()) < 1 << 20


def test_webp_fixtures_use_every_tool(monkeypatch):
    """The WebP fixtures reach each part of the lossless decoder, the lossy
    one and an animation (no cv2 needed): the decoder's helpers, wrapped,
    record which of them each fixture reaches."""
    seen, stack = set(), []

    def spy(name, tool, when=lambda *a: True):
        real = getattr(webp, name)

        def wrapped(*args):
            if when(*args):
                seen.add(tool)
            return real(*args)
        monkeypatch.setattr(webp, name, wrapped)

    def image(bits, width, height, top_level):  # a sub-image read inside the top level one
        if stack and stack[-1]:
            seen.add("meta prefix codes")
        stack.append(top_level)
        try:
            return real_image(bits, width, height, top_level)
        finally:
            stack.pop()
    real_image = webp._image
    monkeypatch.setattr(webp, "_image", image)
    for name, tool in (("decode_vp8l", "lossless"), ("decode_vp8_bgr", "lossy"),
                       ("_undo_predictor", "predictor"), ("_undo_cross_color", "cross-colour"),
                       ("_undo_subtract_green", "subtract-green"),
                       ("_undo_color_indexing", "colour-indexing"),
                       ("_prefix_value", "backward references")):
        spy(name, tool)
    spy("_group", "colour cache", lambda bits, cache_size: cache_size > 0)
    for rel in MANIFEST:
        if rel.endswith(".webp"):
            data = (FIXTURES / rel).read_bytes()
            webp.decode_webp_bgr(data, rel)
            if any(kind == b"ANMF" for kind, _ in webp._chunks(data, 12, len(data), rel)):
                seen.add("animation")
    assert seen >= {"lossless", "lossy", "animation", "predictor", "cross-colour",
                    "subtract-green", "colour-indexing", "colour cache", "meta prefix codes",
                    "backward references"}


# ------------------------------------------------------------------- PNG

PNG_KINDS = [(0, 1, 1), (0, 1, 2), (0, 1, 4), (0, 1, 8), (0, 1, 16), (4, 2, 8), (4, 2, 16),
             (2, 3, 8), (2, 3, 16), (6, 4, 8), (6, 4, 16), (3, 1, 2), (3, 1, 8)]


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("color,channels,depth", PNG_KINDS)
def test_png_matches_cv2(tmp_path, interlace, color, channels, depth):
    """Every colour type at every depth, interlaced or not: 16-bit gray as
    its high byte, 16-bit colour through libpng's rounded sum."""
    mif = _script()
    rng = np.random.default_rng(color * 100 + depth * 2 + interlace)
    for h, w in ((1, 1), (5, 3), (17, 23)):
        samples = rng.integers(0, 1 << depth, (h, w, channels))
        samples[: h // 3] = samples[: h // 3, :, :1]  # R == G == B
        palette = rng.integers(0, 256, (1 << depth, 3)) if color == 3 else None
        _check(tmp_path, mif.png(samples, depth, color, interlace, palette=palette), "f.png")


@pytest.mark.parametrize("chunk", ["gAMA 0.45455", "gAMA 0.3", "gAMA 0.96", "sRGB",
                                   "sRGB after gAMA 0.3", "gAMA after IDAT", "iCCP",
                                   "iCCP after gAMA 0.45455", "gAMA 0.3 after iCCP",
                                   "iCCP after sRGB"])
@pytest.mark.parametrize("color", [2, 3], ids=["rgb", "palette"])
def test_png_gamma_matches_cv2(tmp_path, chunk, color):
    """A gamma that is not within 5% of 1 sends colour to gray through
    libpng's linear-light tables; sRGB wins over gAMA; gAMA after IDAT is
    ignored; an ICC profile (an sRGB one, as littlecms makes it) changes
    nothing, before or after gAMA and sRGB."""
    mif = _script()
    rng = np.random.default_rng(len(chunk) + color)
    gama = {"0.45455": 45455, "0.3": 30000, "0.96": 96000}
    chunks = b""
    for part in reversed(chunk.split(" after ")):  # in the file's order
        if part.startswith("gAMA") and part != "gAMA":
            chunks += mif._png_chunk(b"gAMA", struct.pack(">I", gama[part.split()[1]]))
        elif part == "sRGB":
            chunks += mif._png_chunk(b"sRGB", b"\0")
        elif part == "iCCP":
            cms = pytest.importorskip("PIL.ImageCms")
            profile = cms.ImageCmsProfile(cms.createProfile("sRGB")).tobytes()
            chunks += mif._png_chunk(b"iCCP", b"sRGB\0\0" + zlib.compress(profile))
    samples = rng.integers(0, 256 if color == 2 else 64, (20, 30, 3 if color == 2 else 1))
    samples[:5] = samples[:5, :, :1]
    data = mif.png(samples, 8, color, extra=chunks,
                   palette=rng.integers(0, 256, (64, 3)) if color == 3 else None)
    if chunk == "gAMA after IDAT":
        at = data.find(b"IEND") - 4
        data = data[:at] + mif._png_chunk(b"gAMA", struct.pack(">I", 30000)) + data[at:]
    _check(tmp_path, data, "g.png")


# ------------------------------------------------------------------- BMP

def _bmp_cases():
    for header in ("core", "info", "v4", "v5"):
        for bits in (1, 4, 8, 16, 24, 32):
            for top_down in (False, True):
                if header == "core" and (top_down or bits == 16):
                    continue
                yield header, bits, top_down


@pytest.mark.parametrize("header,bits,top_down", list(_bmp_cases()))
def test_bmp_matches_cv2(tmp_path, header, bits, top_down):
    """Every header, depth and row order; palettes of ``biClrUsed``
    entries, gray palettes, 5-5-5 words, imgcodecs' 14-bit gray."""
    mif = _script()
    rng = np.random.default_rng(bits * 10 + len(header) + top_down)
    h, w = 13, 29
    if bits <= 8:
        n = 1 << bits
        pal = rng.integers(0, 256, (n, 3))
        for palette, used in ((pal, 0), (pal[: max(1, n // 2)], max(1, n // 2)),
                              (np.repeat(np.arange(n) * (255 // (n - 1)), 3).reshape(n, 3), 0)):
            if header == "core" and used:
                continue
            idx = rng.integers(0, n, (h, w))
            rows = mif.bmp_rows(idx if top_down else idx[::-1], bits)
            _check(tmp_path, mif.bmp(header, bits, rows, w, h, palette, clr_used=used,
                                     top_down=top_down), "f.bmp")
    else:
        px = (rng.integers(0, 65536, (h, w)) if bits == 16 else
              rng.integers(0, 256, (h, w, bits // 8)))
        rows = mif.bmp_rows(px if top_down else px[::-1], bits)
        _check(tmp_path, mif.bmp(header, bits, rows, w, h, top_down=top_down), "f.bmp")


@pytest.mark.parametrize("header,bits,masks", [
    ("info", 16, (0x7C00, 0x3E0, 0x1F)), ("info", 16, (0xF800, 0x7E0, 0x1F)),
    ("info", 32, (0xFF0000, 0xFF00, 0xFF)), ("v4", 32, (0xFF0000, 0xFF00, 0xFF)),
    ("v5", 32, (0xFF, 0xFF00, 0xFF0000)), ("v5", 32, (0x3FF00000, 0xFFC00, 0x3FF)),
    ("v5", 32, (0xF800, 0x7E0, 0x1F)), ("v4", 32, (0x3, 0xC, 0x30))])
def test_bmp_bitfields_match_cv2(tmp_path, header, bits, masks):
    """``BI_BITFIELDS``: 5-5-5 and 5-6-5 words; 32 bits after a 40-byte
    header as plain BGRA, inside a V4/V5 header through OpenCV 5's float
    route (each field scaled by ``255 / max`` in float32)."""
    mif = _script()
    rng = np.random.default_rng(sum(masks) % 1000 + bits)
    h, w = 11, 37
    px = (rng.integers(0, 65536, (h, w)) if bits == 16 else
          rng.integers(0, 256, (h, w, 4)))
    _check(tmp_path, mif.bmp(header, bits, mif.bmp_rows(px[::-1], bits), w, h, compression=3,
                             masks=masks), "f.bmp")


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("seed", range(6))
def test_bmp_rle_matches_cv2(tmp_path, bits, seed):
    """RLE4 and RLE8: runs, absolute runs, end-of-line, delta and
    end-of-bitmap escapes, as OpenCV walks them."""
    mif = _script()
    rng = np.random.default_rng(seed * 2 + bits)
    for _ in range(8):
        w, h = int(rng.integers(1, 40)), int(rng.integers(1, 12))
        pal = rng.integers(0, 256, (1 << bits, 3))
        _check(tmp_path, mif.bmp("info", bits, mif.rle_stream(rng, w, h, bits), w, h, pal,
                                 compression=1 if bits == 8 else 2), "r.bmp")


def test_imgcodecs_gray_on_every_triple(tmp_path):
    """imgcodecs' 14-bit gray (24-bit BMP) and the float route of a V5 32-bit
    bit-field BMP, each on all 2^24 BGR triples, against cv2."""
    mif = _script()
    v = np.arange(1 << 24, dtype=np.int64).reshape(4096, 4096)
    bgr = np.stack([v & 255, (v >> 8) & 255, v >> 16], -1).astype(np.uint8)
    _check(tmp_path, mif.bmp("info", 24, mif.bmp_rows(bgr[::-1], 24), 4096, 4096), "all.bmp")
    bgra = np.concatenate([bgr, np.zeros((4096, 4096, 1), np.uint8)], -1)
    _check(tmp_path, mif.bmp("v5", 32, mif.bmp_rows(bgra[::-1], 32), 4096, 4096, compression=3,
                             masks=(0xFF0000, 0xFF00, 0xFF)), "all32.bmp")


# ------------------------------------------------------------------- PNM

@pytest.mark.parametrize("kind", [2, 3, 5, 6])
@pytest.mark.parametrize("maxval", [1, 7, 100, 255, 256, 1000, 65535])
def test_pnm_matches_cv2(tmp_path, kind, maxval):
    """P2/P3 (scaled to 8 bits, or the high byte above 255; values past
    maxval clipped) and P5/P6 (raw bytes, or the high byte), with comments."""
    mif = _script()
    rng = np.random.default_rng(kind * 7 + maxval)
    h, w = 9, 17
    samples = rng.integers(0, maxval + 1, (h, w, 3) if kind in (3, 6) else (h, w))
    if kind in (2, 3) and maxval < 65535:
        samples[0, 0] = maxval + 5  # clipped
    for comments in (False, True):
        _check(tmp_path, mif.pnm(kind, samples, maxval, comments), "f.pnm")


@pytest.mark.parametrize("kind", [1, 4])
def test_bitmap_pnm_matches_cv2(tmp_path, kind):
    mif = _script()
    rng = np.random.default_rng(kind)
    for h, w in ((1, 1), (5, 9), (9, 17)):
        _check(tmp_path, mif.pnm(kind, rng.integers(0, 2, (h, w)), comments=True), "b.pbm")
    if kind == 1:  # digits without separators
        _check(tmp_path, b"P1\n3 2\n010110\n", "n.pbm")


# ------------------------------------------------------------------ TIFF

def _tiff_cases():
    yield from ((b, p, a, c, pr, lay, pl) for b, p, a in (
        (1, 0, None), (1, 1, None), (8, 0, None), (8, 1, None), (16, 1, None), (16, 0, None),
        (1, 3, None), (4, 3, None), (8, 3, None), (8, 2, None), (16, 2, None), (8, 2, 1),
        (8, 2, 2), (16, 2, 2), (8, 2, 0))
        for c, pr in ((1, 1), (5, 1), (8, 2), (32773, 1), (32946, 1))
        for lay in ("strips", "tiles") for pl in (1, 2)
        if not (lay == "tiles" and c == 1) and not (pr == 2 and b < 8)
        and not (pl == 2 and p != 2) and not (lay == "tiles" and pl == 2 and c == 32773))


@pytest.mark.parametrize("bits,photometric,alpha,compression,predictor,layout,planar",
                         list(_tiff_cases()))
def test_tiff_matches_cv2(tmp_path, bits, photometric, alpha, compression, predictor, layout,
                          planar):
    """Strips and tiles (clipped at the right and bottom edges), planar 1 and
    2, each compression, predictor 2, each photometric interpretation and
    depth, alpha, both byte orders."""
    mif = _script()
    rng = np.random.default_rng(bits + 10 * photometric + compression + predictor)
    h, w = 37, 55
    spp = (3 if photometric == 2 else 1) + (alpha is not None)
    samples = rng.integers(0, 1 << bits, (h, w, spp))
    kw = dict(compression=compression, predictor=predictor, planar=planar,
              extra=None if alpha is None else [alpha],
              colormap=rng.integers(0, 65536, (3, 1 << bits)) if photometric == 3 else None)
    kw.update(tile=(16, 32)) if layout == "tiles" else kw.update(rows_per_strip=5)
    for order in ("<", ">"):
        _check(tmp_path, mif.tiff(samples, bits, photometric, order=order, **kw), "f.tif")


@pytest.mark.parametrize("case", ["cv2 gray", "cv2 bgr", "cv2 bgra", "cv2 gray16", "cv2 bgr16",
                                  "8-bit colormap", "orientation 2", "orientation 3",
                                  "orientation 4", "two pages", "fill order 2",
                                  "gray + untagged alpha", "gray + alpha"])
def test_tiff_special_cases_match_cv2(tmp_path, case):
    """What cv2 writes (LZW, no ExtraSamples beside a fourth sample), an
    8-bit colour map, orientations 2-4, the first of two pages, reversed
    bits, gray with an alpha sample."""
    import cv2

    mif = _script()
    rng = np.random.default_rng(len(case))
    h, w = 37, 55
    img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    if case.startswith("cv2"):
        arr = {"gray": img[..., 0], "bgr": img[..., :3], "bgra": img}.get(case[4:])
        if arr is None:
            wide = rng.integers(0, 65536, (h, w, 3), dtype=np.uint16)
            arr = wide[..., 0] if case.endswith("gray16") else wide
        for params in ([], [cv2.IMWRITE_TIFF_COMPRESSION, 1], [cv2.IMWRITE_TIFF_PREDICTOR, 2],
                       [cv2.IMWRITE_TIFF_ROWSPERSTRIP, 7]):
            _check(tmp_path, mif.imencode(".tiff", arr, params), "c.tiff")
        return
    gray = img[..., :1].astype(np.int64)
    data = {
        "8-bit colormap": lambda: mif.tiff(gray, 8, 3, colormap=rng.integers(0, 256, (3, 256))),
        "two pages": lambda: mif.tiff(gray, 8, 1, compression=5, pages=2),
        "fill order 2": lambda: mif.tiff(gray, 8, 1, fill_order=2),
        "gray + untagged alpha": lambda: mif.tiff(img[..., :2], 8, 1, compression=8),
        "gray + alpha": lambda: mif.tiff(img[..., :2], 8, 0, extra=[2], rows_per_strip=6),
    }.get(case)
    if data is None:
        _check(tmp_path, mif.tiff(gray, 8, 1, orientation=int(case[-1]), rows_per_strip=6,
                                  compression=5), "o.tif")
        if case != "orientation 4":
            return
        data = lambda: mif.tiff(gray, 8, 1, orientation=4, tile=(16, 16), compression=8)  # noqa
    _check(tmp_path, data(), "s.tif")


# ------------------------------------------------------------------ WebP

def _lossless_scene(kind, rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "smooth":
        return np.clip(np.stack([xx * 3 + yy, yy * 2 + 50 + xx, 128 + 60 * np.sin(xx / 7.0)
                                 * np.cos(yy / 5.0)], -1), 0, 255).astype(np.uint8)
    if kind == "tiles":
        tile = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
        return np.tile(tile, (h // 8 + 1, w // 8 + 1, 1))[:h, :w]
    colours = {"2": 2, "4": 4, "16": 16, "200": 200}[kind.split()[0]]
    return rng.integers(0, 256, (colours, 3), dtype=np.uint8)[rng.integers(0, colours, (h, w))]


@pytest.mark.parametrize("kind", ["noise", "smooth", "tiles", "2 colours", "4 colours",
                                  "16 colours", "200 colours"])
def test_webp_lossless_matches_cv2(tmp_path, kind):
    """Lossless streams from cv2 and from PIL at three effort levels (which
    pick other transforms, caches and codes), with alpha."""
    from PIL import Image

    mif = _script()
    import cv2

    rng = np.random.default_rng(len(kind))
    for h, w in ((1, 1), (7, 13), (45, 61)):
        img = _lossless_scene(kind, rng, h, w)
        _check(tmp_path, mif.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, 101]), "l.webp")
        for method in (0, 6):
            buf = io.BytesIO()
            Image.fromarray(img[..., ::-1]).save(buf, format="WEBP", lossless=True, method=method)
            if len(buf.getvalue()) >= 32:  # OpenCV refuses shorter files
                _check(tmp_path, buf.getvalue(), "p.webp")
        buf = io.BytesIO()
        rgba = np.dstack([img[..., ::-1], rng.integers(0, 256, (h, w), dtype=np.uint8)])
        Image.fromarray(rgba).save(buf, format="WEBP", lossless=True, exact=True)
        _check(tmp_path, buf.getvalue(), "a.webp")


@pytest.mark.parametrize("quality", [1, 20, 50, 80, 100])
def test_webp_lossy_matches_cv2(tmp_path, quality):
    """VP8 key frames at several sizes (partial macroblocks, odd sizes) and
    qualities (segments, every intra mode, filter levels), with alpha."""
    import cv2

    mif = _script()
    rng = np.random.default_rng(quality)
    for h, w in ((1, 1), (16, 16), (7, 13), (33, 47)):
        img = np.clip(mif.scene(rng, h, w)[0] + rng.normal(0, 8, (h, w, 3)), 0,
                      255).astype(np.uint8)
        _check(tmp_path, mif.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, quality]),
               "v.webp")
    rgba = np.dstack([img, rng.integers(0, 256, (h, w), dtype=np.uint8)])
    _check(tmp_path, mif.imencode(".webp", rgba, [cv2.IMWRITE_WEBP_QUALITY, quality]), "a.webp")


REWRITES = {"same": {}, "simple filter": dict(simple=1), "simple, sharpness 3":
            dict(simple=1, sharpness=3), "sharpness 2": dict(sharpness=2),
            "sharpness 6, level 40": dict(sharpness=6, level=40),
            "filter deltas": dict(deltas=(4, -6)), "deltas, level 20": dict(deltas=(-3, 9),
                                                                          level=20),
            "2 partitions": dict(partitions=2), "8 partitions": dict(partitions=8),
            "skip flag": dict(skip=True), "segment deltas": dict(segment_quant=[-10, 5, 20, 0]),
            "no filter": dict(level=0)}


@pytest.mark.parametrize("name", list(REWRITES))
def test_webp_lossy_header_settings_match_cv2(tmp_path, name):
    """The same macroblocks re-encoded with each loop-filter setting, token
    partitions, the skip flag and delta segments (libwebp's encoder picks
    none of them here)."""
    import cv2

    mif = _script()
    rng = np.random.default_rng(7)
    img = np.clip(mif.scene(rng, 45, 61)[0] + rng.normal(0, 6, (45, 61, 3)), 0,
                  255).astype(np.uint8)
    for quality in (30, 75):
        src = mif.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, quality])
        got = _check(tmp_path, mif.vp8_rewrite(src, **REWRITES[name]), "r.webp")
        if name == "same":
            np.testing.assert_array_equal(got, image_io.decode_gray(src))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_webp_exif_orientation_matches_cv2(tmp_path, orientation):
    """cv2 turns a WebP by the first EXIF chunk where VP8X flags one and the
    chunk is a bare TIFF header (not with an ``Exif\\0\\0`` prefix, not
    unflagged), in either byte order."""
    import cv2

    mif = _script()
    img = np.random.default_rng(orientation).integers(0, 256, (9, 14, 3), dtype=np.uint8)
    kind, payload = mif.image_chunk(mif.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, 101]))
    image = mif.webp_chunk(kind, payload)
    for order in "<>":
        exif = mif.webp_chunk(b"EXIF", mif.exif_tiff(orientation, order))
        got = _check(tmp_path, mif.riff([mif.vp8x(8, 14, 9), image, exif]), "e.webp")
        assert got.shape == ((14, 9) if orientation > 4 else (9, 14))
        _check(tmp_path, mif.riff([mif.vp8x(8, 14, 9), exif, image]), "b.webp")
    prefixed = mif.webp_chunk(b"EXIF", b"Exif\0\0" + mif.exif_tiff(orientation))
    unflagged = mif.webp_chunk(b"EXIF", mif.exif_tiff(orientation))
    for chunks in ([mif.vp8x(8, 14, 9), image, prefixed], [mif.vp8x(0, 14, 9), image, unflagged]):
        assert _check(tmp_path, mif.riff(chunks), "n.webp").shape == (9, 14)


def test_webp_containers_match_cv2(tmp_path):
    """ICC and XMP chunks; an animation's first frame, on the canvas (black
    around it) where it does not cover it; a lossy frame with ALPH."""
    import cv2

    mif = _script()
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (9, 14, 3), dtype=np.uint8)
    kind, payload = mif.image_chunk(mif.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, 101]))
    image = mif.webp_chunk(kind, payload)
    _check(tmp_path, mif.riff([mif.vp8x(32 | 4, 14, 9), mif.webp_chunk(b"ICCP", bytes(40)),
                               image, mif.webp_chunk(b"XMP ", b"<x/>")]), "i.webp")
    small = mif.image_chunk(mif.imencode(".webp", img[:5, :6], [cv2.IMWRITE_WEBP_QUALITY, 70]))
    anim = mif.webp_chunk(b"ANIM", bytes(6))
    for x, y, chunk, w, h in ((0, 0, image, 14, 9), (2, 4, mif.webp_chunk(*small), 6, 5)):
        _check(tmp_path, mif.riff([mif.vp8x(2, 14, 9), anim, mif.anmf(x, y, w, h, chunk),
                                   mif.anmf(0, 0, 14, 9, image)]), "m.webp")


# ------------------------------------------------------------ the readers

def test_readers_over_the_mixed_folder_match_jax(tmp_path):
    """The port's ``ImageReader``, ``ImageSequence`` and ``TrainSeqData``
    over the fixture folder (BMP, PGM, TIFF, lossless and lossy WebP, 16-bit,
    Adam7, gamma and sRGB PNGs) against the JAX package's, equal at every
    pixel; ``TrainSeqData`` over the folder and over its twin equal too."""
    import shutil

    from v2e2v_tpu.data import datasets as jds
    from v2e2v_tpu.data import manifests as jman
    from v2e2v_tpu.data import video_readers as jvr
    from v2e2v_tpu_torch.data import datasets as tds
    from v2e2v_tpu_torch.data import manifests as tman
    from v2e2v_tpu_torch.data import video_readers as tvr

    seq = FIXTURES / "sequence" / SEQUENCE
    # both ImageReaders list .jpg and .png frames only: the mixed folder's six
    # PNGs, every frame of the twin
    for folder, size, n in ((seq, [180, 240], 6), (seq, [90, 120], 6),
                            (FIXTURES / "sequence_png" / SEQUENCE, [180, 240], 12)):
        want_r = jvr.ImageReader(size, num_bins=5, is_with_events=False)
        got_r = tvr.ImageReader(size, num_bins=5, is_with_events=False)
        want_r.initialize(str(folder), -1)
        got_r.initialize(str(folder), -1)
        assert got_r.num_frames == want_r.num_frames == n
        while want_r.frame_id < want_r.num_frames:
            want, got = want_r.update_frame_pack(4), got_r.update_frame_pack(4)
            assert len(got) == len(want) and got_r.ending == want_r.ending
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    pairs = list(zip(tman.ImageSequence(str(seq)), jman.ImageSequence(str(seq))))
    assert len(pairs) == 11
    for got, want in pairs:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    data = tmp_path / "data"
    shutil.copytree(seq, data / SEQUENCE)
    assert jman.make_train_txt_wo_events(str(data), "train.txt", 4, 2) == 5
    txt = str(data / "train.txt")
    port, ref = tds.TrainSeqData(txt, str(data), 3, 4), jds.TrainSeqData(txt, str(data), 3, 4)
    twin = tmp_path / "twin"
    shutil.copytree(FIXTURES / "sequence_png" / SEQUENCE, twin / SEQUENCE)
    jman.make_train_txt_wo_events(str(twin), "train.txt", 4, 2)
    png = tds.TrainSeqData(str(twin / "train.txt"), str(twin), 3, 4)
    assert len(port) == len(ref) == len(png) > 0
    for i in range(len(ref)):
        for g, w, t in zip(port[i], ref[i], png[i]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, t)


# ------------------------------------------------------------- refusals

def _refusals(mif):
    """name -> the bytes of a file the port refuses (and what cv2 does)."""
    import cv2

    rng = np.random.default_rng(0)
    gray = rng.integers(0, 256, (20, 24, 1))
    img = rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)
    lossy = mif.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, 50])
    kind, payload = mif.image_chunk(lossy)
    inter = bytearray(payload)
    inter[0] |= 1
    lossless = mif.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, 101])
    return {
        "p7.pam": b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nTUPLTYPE GRAYSCALE\nENDHDR\n\1\2",
        "float.tif": mif.tiff(gray, 8, 1, sample_format=3),
        "predictor3.tif": mif.tiff(gray, 8, 1, predictor=3),
        "two_bit.tif": mif.tiff(gray >> 6, 2, 1),
        "ycbcr.tif": mif.tiff(img.astype(np.int64), 8, 6),
        "uncompressed_tiles.tif": mif.tiff(gray, 8, 1, tile=(16, 16)),
        "orientation_6.tif": mif.tiff(gray, 8, 1, orientation=6),
        "cut.tif": mif.tiff(gray, 8, 1, compression=8)[:-60],
        "v4_bitfields_16.bmp": mif.bmp("v4", 16, mif.bmp_rows(gray[..., 0], 16), 24, 20,
                                       compression=3, masks=(0xF800, 0x7E0, 0x1F)),
        "cut.bmp": mif.imencode(".bmp", img)[:-100],
        "gamma_rgb16.png": mif.png(gray.repeat(3, -1) * 257 + 5, 16, 2,
                                   extra=mif._png_chunk(b"gAMA", struct.pack(">I", 45455))),
        "inter_frame.webp": mif.riff([mif.webp_chunk(kind, bytes(inter))]),
        "cut_lossless.webp": lossless[:len(lossless) * 2 // 3],
        "short.webp": mif.riff([mif.webp_chunk(b"VP8L", b"\x2f\0\0\0")]),
        "junk.pgm": b"P5\n3 2 x\n255\n" + bytes(6),
    }


REFUSED = ["p7.pam", "float.tif", "predictor3.tif", "two_bit.tif", "ycbcr.tif",
           "uncompressed_tiles.tif", "orientation_6.tif", "cut.tif", "v4_bitfields_16.bmp",
           "cut.bmp", "gamma_rgb16.png", "inter_frame.webp", "cut_lossless.webp", "short.webp",
           "junk.pgm"]


@pytest.mark.parametrize("name", REFUSED)
def test_what_it_refuses_raises(tmp_path, name):
    """Each file the port does not read raises a ValueError naming ROADMAP
    item 4, whether cv2 reads it (P7, predictor 3, YCbCr, 16-bit colour
    with a gamma) or not."""
    mif = _script()
    path = tmp_path / name
    path.write_bytes(_refusals(mif)[name])
    with pytest.raises(ValueError, match=ITEM4):
        image_io.read_gray(str(path))
