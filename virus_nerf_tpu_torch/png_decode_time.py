"""Time the PyTorch port's PNG reader (``virus_nerf_tpu_torch/data/png.py``)
on files OpenCV writes.

    python -m virus_nerf_tpu_torch.png_decode_time [--n-images 300] [--out DIR]

Writes the port's ETHZ fixture (``--n-images`` a camera at 320x240, two
cameras), then every colour image again through ``cv2.imwrite`` twice: with
OpenCV's default (libpng told to filter every row with Sub) and with a
compression level given (libpng then picks each row's filter, mostly
Paeth, as in recordings written through libpng).  Prints one JSON line:
the filter types of each set, the port's decode seconds of each set
(``read_pngs``, and one file at a time), OpenCV's decode seconds of the
same files, and whether every decode equals OpenCV's pixels.  Needs cv2,
which the port itself does not.
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import tempfile
import time
import zlib

import numpy as np

from virus_nerf_tpu_torch.data.ethz_fixture import generate_ethz_fixture
from virus_nerf_tpu_torch.data.png import read_png, read_pngs


def row_filters(path):
    """Counts of the five row filters of a PNG file."""
    data = open(path, "rb").read()
    pos, idat, height = 8, b"", 0
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            height = struct.unpack(">I", data[pos + 12:pos + 16])[0]
        elif kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(height, -1)
    return np.bincount(raw[:, 0], minlength=5)


def main(argv=None):
    import cv2

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n-images", type=int, default=300)
    p.add_argument("--out", default=None, help="directory (default: a temporary one)")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        out = args.out or tmp
        tic = time.perf_counter()
        root = generate_ethz_fixture(os.path.join(out, "ethz"),
                                     n_images=args.n_images, n_gt_points=1000)
        fixture_s = time.perf_counter() - tic
        meas = os.path.join(root, "commonroom", "measurements")
        src = [os.path.join(meas, f"{cam}_color_image_raw", f"img{i}.png")
               for cam in ("CAM1", "CAM3") for i in range(args.n_images)]
        sets = {"port_filter0": src}
        for name, params in (("cv2_default", []),
                             ("cv2_libpng_adaptive", [cv2.IMWRITE_PNG_COMPRESSION, 3])):
            d = os.path.join(out, name)
            os.makedirs(d, exist_ok=True)
            sets[name] = []
            for i, s in enumerate(src):
                sets[name].append(os.path.join(d, f"img{i}.png"))
                cv2.imwrite(sets[name][-1], cv2.imread(s, cv2.IMREAD_COLOR), params)
        result = {"n_files": len(src), "fixture_s": fixture_s}
        for name, paths in sets.items():
            tic = time.perf_counter()
            imgs = read_pngs(paths)
            batched = time.perf_counter() - tic
            tic = time.perf_counter()
            for path in paths[:60]:
                read_png(path)
            single = (time.perf_counter() - tic) / 60 * len(paths)
            tic = time.perf_counter()
            ref = [cv2.imread(path, cv2.IMREAD_COLOR)[:, :, ::-1] for path in paths]
            cv2_s = time.perf_counter() - tic
            result[name] = {
                "row_filters_none_sub_up_avg_paeth": sum(
                    row_filters(path) for path in paths[:20]).tolist(),
                "read_pngs_s": batched, "read_png_one_at_a_time_s": single,
                "cv2_imread_s": cv2_s,
                "equal_to_cv2": all(np.array_equal(a, b) for a, b in zip(imgs, ref)),
            }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
