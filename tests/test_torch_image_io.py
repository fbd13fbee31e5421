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
    # 16-bit and interlaced PNGs are read now; 16-bit colour under a gamma is not
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    rgb16 = np.repeat(img.astype(">u2") * 257, 3, 1).view(np.uint8)
    for name, interlace, extra in (("g16.png", 0, chunk(b"gAMA", struct.pack(">I", 45455))),
                                   ("adam7.png", 1, chunk(b"sRGB", b"\0"))):
        data = _png(rgb16, 10, 8, 16, 2, [0] * 8, 6, interlace=interlace)
        at = data.find(b"IDAT") - 4
        (tmp_path / name).write_bytes(data[:at] + extra + data[at:])
        cases[name] = "16-bit colour PNG with a gamma.*item 4"
    # JPEG frames are read now; what the decoder refuses names item 4
    ok, jpg = cv2.imencode(".jpg", img)
    jpg = jpg.tobytes()
    sof = jpg.find(b"\xff\xc0")
    (tmp_path / "arith.jpg").write_bytes(jpg[:sof + 1] + b"\xc9" + jpg[sof + 2:])
    cases["arith.jpg"] = "arithmetic coding.*item 4"
    (tmp_path / "b12.jpg").write_bytes(jpg[:sof + 4] + b"\x0c" + jpg[sof + 5:])
    cases["b12.jpg"] = "12-bit samples.*item 4"
    (tmp_path / "cut.jpg").write_bytes(jpg[:len(jpg) * 2 // 3])
    cases["cut.jpg"] = "truncated.*item 4"
    # BMP, PNM, WebP and TIFF are read now: what is still refused in each
    (tmp_path / "f.bmp").write_bytes(b"BM" + bytes(12) + struct.pack("<I", 20) + bytes(40))
    cases["f.bmp"] = "header size 20.*item 4"
    (tmp_path / "f.pgm").write_bytes(b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\n"
                                     b"TUPLTYPE GRAYSCALE\nENDHDR\n\x01\x02")
    cases["f.pgm"] = "P7.*item 4"
    ok, tif = cv2.imencode(".tiff", img, [cv2.IMWRITE_TIFF_COMPRESSION, 1])
    tif = bytearray(tif.tobytes())
    for tag, value in ((259, 7), (339, 3)):  # JPEG-in-TIFF, floating-point samples
        case = bytearray(tif)
        ifd = struct.unpack_from("<I", case, 4)[0]
        for i in range(struct.unpack_from("<H", case, ifd)[0]):
            at = ifd + 2 + 12 * i
            if struct.unpack_from("<H", case, at)[0] == tag:
                struct.pack_into("<HIHH", case, at + 2, 3, 1, value, 0)
                break
        else:
            count = struct.unpack_from("<H", case, ifd)[0]
            entries = [case[ifd + 2 + 12 * i:ifd + 14 + 12 * i] for i in range(count)]
            entries.append(struct.pack("<HHIHH", tag, 3, 1, value, 0))
            entries.sort(key=lambda e: struct.unpack_from("<H", e)[0])
            case = case[:ifd] + struct.pack("<H", count + 1) + b"".join(entries) + bytes(4)
        (tmp_path / f"t{tag}.tiff").write_bytes(bytes(case))
    cases["t259.tiff"] = "compression 7.*item 4"
    cases["t339.tiff"] = "sample format.*item 4"
    (tmp_path / "f.webp").write_bytes(b"RIFF" + struct.pack("<I", 28) + b"WEBPVP8 "
                                      + struct.pack("<I", 16) + b"\x01" + bytes(15))
    cases["f.webp"] = "inter frame.*item 4"
    (tmp_path / "mm_header.tif").write_bytes(b"MM\x00*" + bytes(16))
    cases["mm_header.tif"] = "TIFF.*item 4"
    (tmp_path / "junk.png").write_bytes(b"not an image")
    cases["junk.png"] = "not a PNG"
    for name, match in cases.items():
        with pytest.raises(ValueError, match=match):
            image_io.read_gray(str(tmp_path / name))
    with pytest.raises(ValueError, match="2-D uint8"):
        image_io.write_gray(str(tmp_path / "x.png"), img.astype(np.float32))


def _tiff(orientation, order="<", magic=42):
    """A TIFF header whose IFD0 holds the orientation tag (SHORT, one value)."""
    return ((b"II" if order == "<" else b"MM") + struct.pack(order + "HI", magic, 8)
            + struct.pack(order + "H", 1)
            + struct.pack(order + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(order + "I", 0))


def _png_with_exif(img, chunks, after_idat=False):
    """An 8-bit gray PNG of ``img`` with one ``eXIf`` chunk per body in
    ``chunks``, before IDAT or after it."""
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    exif = b"".join(chunk(b"eXIf", body) for body in chunks)
    data = image_io.encode_gray(img)
    at = data.find(b"IEND" if after_idat else b"IDAT") - 4
    return data[:at] + exif + data[at:]


@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("orientation", range(10))
def test_png_exif_orientation_matches_cv2(tmp_path, orientation, order):
    """The repaired fault: cv2.imread applies a PNG's eXIf orientation (1-8;
    0 and 9 leave the image alone), in either byte order."""
    img = np.random.default_rng(orientation).integers(0, 256, (20, 30), dtype=np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_png_with_exif(img, [_tiff(orientation, order)]))
    want = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    got = image_io.read_gray(str(path))
    assert got.shape == want.shape == ((30, 20) if orientation in (5, 6, 7, 8) else (20, 30))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["after_idat", "first_of_two", "bad_header_then_good",
                                  "bad_magic_then_good", "no_tag_then_tag", "exif_prefix",
                                  "entry_cut_to_10_bytes"])
def test_png_exif_chunks_as_cv2_reads_them(tmp_path, case):
    """Which eXIf chunk counts: libpng keeps the first whose TIFF header is
    valid, wherever it lies before IEND."""
    bodies = {
        "after_idat": [_tiff(6)],
        "first_of_two": [_tiff(6), _tiff(3)],
        "bad_header_then_good": [b"IM" + _tiff(3)[2:], _tiff(6)],
        "bad_magic_then_good": [_tiff(3, magic=43), _tiff(6)],
        "no_tag_then_tag": [_tiff(6)[:8] + struct.pack("<HI", 0, 0), _tiff(8)],
        "exif_prefix": [b"Exif\x00\x00" + _tiff(6)],
        "entry_cut_to_10_bytes": [_tiff(6)[:20]],
    }[case]
    img = np.random.default_rng(5).integers(0, 256, (20, 30), dtype=np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_png_with_exif(img, bodies, after_idat=case == "after_idat"))
    want = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    got = image_io.read_gray(str(path))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
