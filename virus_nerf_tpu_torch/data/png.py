"""8-bit PNG reading and writing with numpy and ``zlib``.

The JAX package reads and writes images through cv2 and PIL
(``virus_nerf_tpu/data/ethz.py:141-146``, ``:225-233``;
``virus_nerf_tpu/evaluation/evaluator.py:164-183``).  The port may not
lean on either, so it carries this reader of the files those libraries
write: 8-bit grayscale, grayscale + alpha, RGB and RGBA, not interlaced.
Palette, 16-bit, sub-byte and interlaced files raise ``ValueError``.

Every row of a PNG carries one of five filters (None, Sub, Up, Average,
Paeth).  Each byte is predicted from the byte of the pixel to its left
(a), above (b) and above-left (c), all already decoded, so every pixel of
one anti-diagonal ``x + y = d`` can be decoded at once.  The decoder lays
the image out diagonal by diagonal and walks the W + H - 1 diagonals with
numpy, whatever the rows' filters are; ``read_pngs`` walks a group of
same-size images together.  Files whose rows read no row above (None and
Sub, OpenCV's default write) take a row-wise running sum instead.  It returns RGB order (cv2 returns BGR).
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Sequence

import numpy as np
from numpy.lib.stride_tricks import as_strided

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel
# images decoded in lockstep: for 320x240 files with libpng's filters, 11 ms
# an image in groups of 32 against 25 ms one at a time on the host CPU of an
# H100 machine, OpenCV-written files; the group's int16 work buffer is 26 MB
GROUP = 32


def _chunks(data: bytes, path: str):
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def _unfilter(raw: np.ndarray, W: int, C: int) -> np.ndarray:
    """Undo the row filters of (N, H, 1 + W*C) bytes -> (N, H, W, C) uint8,
    the N images in lockstep."""
    N, H = raw.shape[:2]
    kinds = raw[:, :, 0]
    filt = raw[:, :, 1:].reshape(N, H, W, C)
    if not np.any(kinds >= 2):
        # no row reads the row above: each row's Sub is a running sum
        out = filt.copy()
        sub = kinds == 1
        out[sub] = np.cumsum(filt[sub], axis=1, dtype=np.uint8)
        return out
    # z[d + 2, n, y + 1] is pixel (y, d - y) of image n: one diagonal of
    # every image is one contiguous block.  z's zero borders are the bytes a
    # filter reads left of column 0 and above row 0.  fdiag and the result
    # are strided views of the filtered bytes and of z (no copies)
    D = H + W - 1
    f = np.ascontiguousarray(filt)
    fs = f.itemsize
    fdiag = as_strided(f, (D, N, H, C), (C * fs, f.strides[0], (W - 1) * C * fs, fs),
                       writeable=False)  # fdiag[d, n, y] = filt[n, y, d - y]
    z = np.zeros((D + 2, N, H + 1, C), np.int16)
    # the most frequent filter fills the prediction, the others are copied in
    present = sorted((int(t) for t in np.unique(kinds) if t),
                     key=lambda t: -int((kinds == t).sum()))
    masks = {t: (kinds == t)[:, :, None] for t in present[1:]}
    none = (kinds == 0)[:, :, None] if (kinds == 0).any() else None
    for d in range(D):
        y0, y1 = max(0, d - W + 1), min(H - 1, d) + 1
        a = z[d + 1, :, y0 + 1:y1 + 1]
        b = z[d + 1, :, y0:y1]
        c = z[d, :, y0:y1]
        pred = None
        for t in present:
            if t == 1:
                p = a
            elif t == 2:
                p = b
            elif t == 3:
                p = (a + b) >> 1
            else:  # Paeth: the one of a, b, c nearest a + b - c
                da, db = a - c, b - c
                pa, pb, pc = np.abs(db), np.abs(da), np.abs(da + db)
                p = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
            if pred is None:
                pred = p.copy() if t <= 2 else p
            else:
                np.copyto(pred, p, where=masks[t][:, y0:y1])
        if none is not None:
            np.copyto(pred, 0, where=none[:, y0:y1])
        out = z[d + 2, :, y0 + 1:y1 + 1]
        np.add(fdiag[d, :, y0:y1], pred, out=out)
        out &= 0xFF
    s = z.strides  # out[n, y, x] = z[y + x + 2, n, y + 1]
    return as_strided(z[2:, :, 1:], (N, H, W, C),
                      (s[1], s[0] + s[2], s[0], s[3])).astype(np.uint8)


def _read_raw(path: str):
    """(header (W, H, C), filtered bytes (H, 1 + W*C)) of one file."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, ctype, _, _, interlace = header
    if ctype == 3:
        raise ValueError(f"{path}: palette PNGs are not supported")
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: unknown PNG colour type {ctype}")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNGs are not supported (8 only)")
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    C = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (1 + W * C):
        raise ValueError(f"{path}: {raw.size} image bytes, want "
                         f"{H * (1 + W * C)}")
    raw = raw.reshape(H, 1 + W * C)
    if int(raw[:, 0].max()) > 4:
        raise ValueError(f"{path}: unknown row filter {int(raw[:, 0].max())}")
    return (W, H, C), raw


def read_pngs(paths: Sequence[str]) -> List[np.ndarray]:
    """Several 8-bit PNGs as uint8 arrays, :func:`read_png`'s shapes.  Files
    of one size are decoded ``GROUP`` at a time in lockstep, which spreads
    the per-diagonal cost of numpy's calls over the group."""
    heads, raws = zip(*(_read_raw(p) for p in paths)) if paths else ((), ())
    out: List[Optional[np.ndarray]] = [None] * len(raws)
    for (W, H, C) in dict.fromkeys(heads):
        idx = [i for i, h in enumerate(heads) if h == (W, H, C)]
        for j in range(0, len(idx), GROUP):
            part = idx[j:j + GROUP]
            imgs = _unfilter(np.stack([raws[i] for i in part]), W, C)
            for i, img in zip(part, imgs):
                out[i] = img[:, :, 0] if C == 1 else img
    return out


def read_png(path: str) -> np.ndarray:
    """An 8-bit PNG as uint8: (H, W) grayscale, else (H, W, C) with C = 2
    (gray, alpha), 3 (RGB) or 4 (RGBA)."""
    return read_pngs([path])[0]


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """Write a uint8 (H, W) or (H, W, C) image, C in 1..4, every row with
    filter 0 (None)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png: uint8 only, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    H, W, C = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[C]
    raw = np.zeros((H, 1 + W * C), np.uint8)
    raw[:, 1:] = img.reshape(H, W * C)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), level)))
        f.write(_chunk(b"IEND", b""))
