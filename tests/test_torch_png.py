"""The port's PNG reader and writer (virus_nerf_tpu_torch/data/png.py)
against OpenCV: files cv2 writes (its filter choice per row), rows of each
of the five filter types encoded here by hand, the writer's round trip, and
the files the reader refuses.  Every comparison is exact."""

import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest

from virus_nerf_tpu_torch.data import png
from virus_nerf_tpu_torch.data.png import read_png, read_pngs, write_png

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CHANNELS = {"gray": 1, "rgb": 3, "rgba": 4}


def to_rgb_order(img):
    """cv2's BGR(A) -> RGB(A); gray unchanged."""
    img = img.copy()
    if img.ndim == 3:
        img[:, :, :3] = img[:, :, 2::-1]
    return img


def cv2_read(path):
    return to_rgb_order(cv2.imread(path, cv2.IMREAD_UNCHANGED))


# OpenCV's default PNG write filters every row with Sub; with a compression
# level given, libpng chooses each row's filter (Paeth, Average, Up, ...),
# as in recordings written through libpng
WRITERS = {"default": [], "adaptive": [cv2.IMWRITE_PNG_COMPRESSION, 3]}


def smooth_image(rng, shape):
    """A noisy ramp, for which libpng's adaptive choice mixes filters."""
    img = rng.normal(128, 20, shape).clip(0, 255).astype(np.uint8)
    return (np.cumsum(img, axis=1) // 50).astype(np.uint8)


@pytest.mark.parametrize("kind", list(CHANNELS))
@pytest.mark.parametrize("width", [1, 3, 17, 64])
@pytest.mark.parametrize("content", ["noise", "smooth"])
@pytest.mark.parametrize("writer", list(WRITERS))
def test_decode_matches_cv2_on_cv2_files(tmp_path, kind, width, content, writer):
    rng = np.random.default_rng(width * 7 + CHANNELS[kind])
    C = CHANNELS[kind]
    shape = (23, width) + ((C,) if C > 1 else ())
    img = (rng.integers(0, 256, shape, dtype=np.uint8) if content == "noise"
           else smooth_image(rng, shape))
    path = str(tmp_path / "x.png")
    assert cv2.imwrite(path, to_rgb_order(img), WRITERS[writer])
    got = read_png(path)
    want = cv2_read(path)
    assert got.dtype == np.uint8 and got.shape == want.shape == img.shape
    np.testing.assert_array_equal(got, want)


def test_libpng_chooses_every_filter_on_these_files(tmp_path):
    # the adaptive writes above hold rows of all five filters, so the decode
    # test covers each of them on files libpng wrote
    rng = np.random.default_rng(0)
    seen = set()
    for C in (1, 3, 4):
        for width in (17, 64):
            path = str(tmp_path / f"s{C}_{width}.png")
            shape = (23, width) + ((C,) if C > 1 else ())
            for img in (rng.integers(0, 256, shape, dtype=np.uint8),
                        smooth_image(rng, shape)):
                cv2.imwrite(path, img, WRITERS["adaptive"])
                seen |= set(filter_bytes(path).tolist())
                np.testing.assert_array_equal(read_png(path), cv2_read(path))
    assert seen == {0, 1, 2, 3, 4}, seen


def test_decode_matches_cv2_on_the_fixture_images(tmp_path):
    from tools.make_ethz_fixture import generate_ethz_fixture

    root = generate_ethz_fixture(str(tmp_path / "ethz"), n_images=4,
                                 img_wh=(64, 48), n_gt_points=2000)
    d = os.path.join(root, "commonroom", "measurements")
    paths = [os.path.join(d, f"{cam}_color_image_raw", f"img{i}.png")
             for cam in ("CAM1", "CAM3") for i in range(4)]
    got = read_pngs(paths)
    assert len(got) == 8
    for p, img in zip(paths, got):
        np.testing.assert_array_equal(img, cv2_read(p))
        np.testing.assert_array_equal(img, read_png(p))


def filter_bytes(path):
    data = open(path, "rb").read()
    pos, idat, head = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    H = head[1]
    return np.frombuffer(zlib.decompress(idat), np.uint8).reshape(H, -1)[:, 0]


def paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def encode_by_hand(img, kinds):
    """The PNG of a uint8 (H, W, C) image with row y filtered by
    ``kinds[y]``, the filters computed byte by byte (PNG spec, section 9)."""
    H, W, C = img.shape
    rows = img.reshape(H, W * C).astype(int)
    raw = bytearray()
    for y in range(H):
        raw.append(kinds[y])
        for i in range(W * C):
            x = rows[y, i]
            a = rows[y, i - C] if i >= C else 0
            b = rows[y - 1, i] if y > 0 else 0
            c = rows[y - 1, i - C] if y > 0 and i >= C else 0
            pred = [0, a, b, (a + b) // 2, paeth(a, b, c)][kinds[y]]
            raw.append((x - pred) % 256)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[C]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kinds", ["0", "1", "2", "3", "4", "mixed"])
@pytest.mark.parametrize("C", [1, 3, 4])
def test_each_row_filter_written_by_hand(tmp_path, kinds, C):
    rng = np.random.default_rng(C)
    H, W = 9, 7
    img = rng.integers(0, 256, (H, W, C), dtype=np.uint8)
    img[::2] = np.minimum(img[::2], 40)  # near-equal neighbours, too
    ks = ([int(kinds)] * H if kinds != "mixed"
          else [4, 3, 2, 1, 0, 3, 4, 1, 2])
    path = str(tmp_path / "h.png")
    with open(path, "wb") as f:
        f.write(encode_by_hand(img, ks))
    assert filter_bytes(path).tolist() == ks
    want = img[:, :, 0] if C == 1 else img
    np.testing.assert_array_equal(read_png(path), want)
    np.testing.assert_array_equal(cv2_read(path), want)


@pytest.mark.parametrize("C", [1, 2, 3, 4])
def test_write_then_read_gives_the_image_back(tmp_path, C):
    rng = np.random.default_rng(10 + C)
    img = rng.integers(0, 256, (13, 11) + ((C,) if C > 1 else ()), np.uint8)
    path = str(tmp_path / "w.png")
    write_png(path, img)
    np.testing.assert_array_equal(read_png(path), img)
    if C != 2:  # OpenCV reads gray + alpha as colour
        np.testing.assert_array_equal(cv2_read(path), img)
    with pytest.raises(ValueError, match="uint8"):
        write_png(path, img.astype(np.float32))


def test_read_pngs_in_groups_equals_one_by_one(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    paths = []
    for i, shape in enumerate([(6, 5, 3), (6, 5, 3), (4, 9), (6, 5, 3),
                               (4, 9), (2, 2, 4)]):
        img = rng.integers(0, 256, shape, np.uint8)
        paths.append(str(tmp_path / f"g{i}.png"))
        cv2.imwrite(paths[-1], to_rgb_order(img))
    for group in (1, 2, 32):
        monkeypatch.setattr(png, "GROUP", group)
        for got, p in zip(read_pngs(paths), paths):
            np.testing.assert_array_equal(got, cv2_read(p))
    assert read_pngs([]) == []


def _patch_ihdr(path, **fields):
    """Rewrite IHDR fields (depth, ctype, interlace) with a valid CRC."""
    data = bytearray(open(path, "rb").read())
    W, H, depth, ctype, comp, filt, inter = struct.unpack(">IIBBBBB", data[16:29])
    vals = dict(depth=depth, ctype=ctype, interlace=inter)
    vals.update(fields)
    body = struct.pack(">IIBBBBB", W, H, vals["depth"], vals["ctype"], comp,
                       filt, vals["interlace"])
    data[16:29] = body
    data[29:33] = struct.pack(">I", zlib.crc32(b"IHDR" + body))
    with open(path, "wb") as f:
        f.write(bytes(data))


def test_refuses_palette_16_bit_and_interlaced_files(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(4)
    pal = str(tmp_path / "palette.png")
    Image.fromarray(rng.integers(0, 256, (8, 8, 3), np.uint8)).convert(
        "P").save(pal)
    deep = str(tmp_path / "deep.png")
    cv2.imwrite(deep, rng.integers(0, 65535, (8, 8), np.uint16))
    laced = str(tmp_path / "laced.png")
    write_png(laced, rng.integers(0, 256, (8, 8, 3), np.uint8))
    _patch_ihdr(laced, interlace=1)
    for path, what in ((pal, "palette"), (deep, "16-bit"), (laced, "interlaced")):
        with pytest.raises(ValueError, match=what) as err:
            read_png(path)
        assert os.path.basename(path) in str(err.value)
    not_png = str(tmp_path / "x.png")
    with open(not_png, "wb") as f:
        f.write(b"GIF89a")
    with pytest.raises(ValueError, match="x.png"):
        read_png(not_png)
