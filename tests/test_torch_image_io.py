"""The port's PNG reader and writer (v2e2v_tpu_torch.utils.image_io) against
``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``, the JAX package's frame reader, and
PIL, the JAX package's frame writer: equal, pixel for pixel."""

import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from _torch_parity import no_new_jax_cache_entries  # noqa: F401
from v2e2v_tpu_torch.utils import image_io

SIZES = [(1, 1), (7, 13), (32, 40), (31, 57)]


def _image(rng, h, w, channels, smooth):
    if smooth:  # long runs of similar bytes: the adaptive writers pick Sub, Up, Paeth
        yy, xx = np.mgrid[0:h, 0:w]
        waves = np.sin(xx[..., None] / 5.0 + np.arange(channels)) + np.cos(yy[..., None] / 7.0)
        return (60 * waves + 128).astype(np.uint8)
    return rng.integers(0, 256, (h, w, channels), dtype=np.uint8)


def _cases():
    for (h, w) in SIZES:
        for smooth in (False, True):
            yield h, w, smooth


@pytest.mark.parametrize("h,w,smooth", list(_cases()))
def test_reader_matches_cv2_on_pil_and_cv2_files(tmp_path, h, w, smooth):
    rng = np.random.default_rng(h * 100 + w + smooth)
    img = _image(rng, h, w, 4, smooth)
    img[: h // 3] = img[: h // 3, :, :1]  # some pixels with R == G == B
    files = []
    for mode, arr in [("L", img[..., 0]), ("LA", img[..., :2]), ("RGB", img[..., :3]),
                      ("RGBA", img)]:
        path = tmp_path / f"pil_{mode}.png"
        Image.fromarray(np.ascontiguousarray(arr), mode).save(path)
        files.append(path)
    for name, arr in [("gray", img[..., 0]), ("bgr", img[..., 2::-1]),
                      ("bgra", img[..., [2, 1, 0, 3]])]:
        path = tmp_path / f"cv2_{name}.png"
        cv2.imwrite(str(path), np.ascontiguousarray(arr))
        files.append(path)
    for colors in (2, 4, 12, 200):  # palettes of 1, 2, 4 and 8 bits
        path = tmp_path / f"pal_{colors}.png"
        Image.fromarray(np.ascontiguousarray(img[..., :3])).convert(
            "P", palette=Image.ADAPTIVE, colors=colors).save(path)
        files.append(path)
    path = tmp_path / "pal_transparent.png"
    Image.fromarray(np.ascontiguousarray(img[..., :3])).convert(
        "P", palette=Image.ADAPTIVE, colors=100).save(path, transparency=3)
    files.append(path)
    path = tmp_path / "one_bit.png"
    Image.fromarray(img[..., 0] > 128).save(path)
    files.append(path)
    for path in files:
        want = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
        got = image_io.read_gray(str(path))
        assert got.dtype == np.uint8 and got.shape == want.shape, path.name
        np.testing.assert_array_equal(got, want, err_msg=path.name)


def _filter_row(line, prior, bpp, kind):
    """The PNG encoder's side of each row filter (spec section 9)."""
    line, prior = line.astype(np.int64), prior.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), line[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(line)
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = prior
    elif kind == 3:
        pred = (a + prior) // 2
    else:
        p = a + prior - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prior), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prior, c))
    return ((line - pred) & 0xFF).astype(np.uint8)


def _png(rows, width, height, depth, color, kinds, bpp, interlace=0, palette=None):
    """A PNG of the given packed rows, each row filtered with ``kinds[y]``."""
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    prior = np.zeros(rows.shape[1], np.uint8)
    raw = b""
    for y in range(height):
        raw += bytes([kinds[y]]) + _filter_row(rows[y], prior, bpp, kinds[y]).tobytes()
        prior = rows[y]
    out = (image_io.PNG_SIGNATURE
           + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, color, 0, 0, interlace)))
    if palette is not None:
        out += chunk(b"PLTE", palette.tobytes())
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "average", "paeth"])
@pytest.mark.parametrize("color,channels,depth", [(0, 1, 8), (4, 2, 8), (2, 3, 8), (6, 4, 8),
                                                  (3, 1, 8), (0, 1, 1), (0, 1, 2), (0, 1, 4),
                                                  (3, 1, 4)])
def test_every_row_filter_matches_cv2(tmp_path, kind, color, channels, depth):
    rng = np.random.default_rng(kind * 10 + color + depth)
    h, w = 9, 23  # odd sizes: partial bytes at 1, 2 and 4 bits
    samples = rng.integers(0, 1 << depth, (h, w * channels), dtype=np.uint8)
    if depth < 8:
        per = 8 // depth
        padded = np.zeros((h, -(-w // per) * per), np.uint8)
        padded[:, :w] = samples
        shifts = np.arange(8 - depth, -1, -depth)
        rows = (padded.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)
    else:
        rows = samples
    palette = rng.integers(0, 256, (1 << depth, 3), dtype=np.uint8) if color == 3 else None
    kinds = [kind] * h
    kinds[0] = (kind + 1) % 5  # and a second filter type in the same image
    path = tmp_path / "f.png"
    path.write_bytes(_png(rows, w, h, depth, color, kinds, max(1, channels * depth // 8),
                          palette=palette))
    want = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(image_io.read_gray(str(path)), want)


@pytest.mark.parametrize("h,w", SIZES)
def test_writer_round_trips_through_cv2_and_pil(tmp_path, h, w):
    img = np.random.default_rng(h + w).integers(0, 256, (h, w), dtype=np.uint8)
    path = tmp_path / "w.png"
    image_io.write_gray(str(path), img)
    np.testing.assert_array_equal(cv2.imread(str(path), cv2.IMREAD_UNCHANGED), img)
    with Image.open(path) as im:
        assert im.mode == "L"
        np.testing.assert_array_equal(np.array(im), img)
    np.testing.assert_array_equal(image_io.read_gray(str(path)), img)


def test_what_it_does_not_read_raises(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (8, 10), dtype=np.uint8)
    cases = {}
    cv2.imwrite(str(tmp_path / "g16.png"), img.astype(np.uint16) * 257)
    cases["g16.png"] = "16-bit"
    (tmp_path / "adam7.png").write_bytes(_png(img, 10, 8, 8, 0, [0] * 8, 1, interlace=1))
    cases["adam7.png"] = "interlaced"
    cv2.imwrite(str(tmp_path / "f.jpg"), img)
    cases["f.jpg"] = "JPEG.*item 4"
    (tmp_path / "junk.png").write_bytes(b"not an image")
    cases["junk.png"] = "not a PNG"
    for name, match in cases.items():
        with pytest.raises(ValueError, match=match):
            image_io.read_gray(str(tmp_path / name))
    with pytest.raises(ValueError, match="2-D uint8"):
        image_io.write_gray(str(tmp_path / "x.png"), img.astype(np.float32))
