"""The port's point-cloud I/O and transforms (virus_nerf_tpu_torch/data/
pcl.py) against the JAX package's ``virus_nerf_tpu/data/pcl.py``: PCD
loading in the ascii, binary and binary_compressed (LZF) modes, the bytes
``save_pcd`` writes, the quaternion / matrix / Euler conversions, ``SE3``
and the raw USS / ToF measurement conversions."""

import numpy as np
import pytest

from virus_nerf_tpu.data import pcl as jpcl
from virus_nerf_tpu_torch.data import pcl as tpcl


def lzf_compress(data: bytes) -> bytes:
    """A greedy LZF encoder (literal runs of up to 32 bytes, back
    references of 3-264 bytes up to 8192 back), the format PCD's
    binary_compressed payloads use."""
    out, lit, table, i = bytearray(), bytearray(), {}, 0

    def flush():
        for k in range(0, len(lit), 32):
            out.append(len(lit[k:k + 32]) - 1)
            out.extend(lit[k:k + 32])
        lit.clear()

    while i < len(data):
        key = data[i:i + 3]
        j = table.get(key) if len(key) == 3 else None
        if len(key) == 3:
            table[key] = i
        if j is not None and i - j <= 8192:
            n = 3
            while i + n < len(data) and n < 264 and data[j + n] == data[i + n]:
                n += 1
            flush()
            off = i - j - 1
            if n - 2 < 7:
                out.append(((n - 2) << 5) | (off >> 8))
            else:
                out += bytes([(7 << 5) | (off >> 8), n - 2 - 7])
            out.append(off & 0xFF)
            i += n
        else:
            lit.append(data[i])
            i += 1
    flush()
    return bytes(out)


def pcd_header(n, mode):
    return (
        "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
        "FIELDS x y z intensity rgb\nSIZE 4 4 4 2 1\nTYPE F F F U U\n"
        f"COUNT 1 1 1 1 3\nWIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\nDATA {mode}\n"
    ).encode()


def cloud(rng, n):
    """x, y, z on a coarse lattice (repeated bytes: LZF back references),
    a uint16 intensity and three uint8 colours a point."""
    xyz = (rng.integers(0, 8, (n, 3)) * 0.25).astype(np.float32)
    xyz[::5] = rng.normal(size=(len(xyz[::5]), 3)).astype(np.float32)
    inten = rng.integers(0, 4000, n).astype(np.uint16)
    rgb = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    return xyz, inten, rgb


@pytest.mark.parametrize("mode", ["ascii", "binary", "binary_compressed"])
def test_load_pcd_matches_jax(tmp_path, mode):
    rng = np.random.default_rng(7)
    n = 3000
    xyz, inten, rgb = cloud(rng, n)
    path = str(tmp_path / f"c_{mode}.pcd")
    with open(path, "wb") as f:
        f.write(pcd_header(n, mode))
        if mode == "ascii":
            for p, i, c in zip(xyz, inten, rgb):
                f.write((" ".join(f"{v:.9g}" for v in (*p, i, *c)) + "\n").encode())
        elif mode == "binary":
            rec = np.zeros(n, [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                               ("intensity", "<u2"), ("rgb", "u1", (3,))])
            rec["x"], rec["y"], rec["z"] = xyz.T
            rec["intensity"], rec["rgb"] = inten, rgb
            f.write(rec.tobytes())
        else:  # column-major: all x, then all y, ...
            raw = (xyz[:, 0].tobytes() + xyz[:, 1].tobytes()
                   + xyz[:, 2].tobytes() + inten.tobytes() + rgb.tobytes())
            comp = lzf_compress(raw)
            assert len(comp) < 0.9 * len(raw)  # back references were used
            f.write(np.array([len(comp), len(raw)], "<u4").tobytes() + comp)
    for fields in (("x", "y", "z"), ("z", "intensity", "x")):
        got = tpcl.load_pcd(path, fields)
        want = jpcl.load_pcd(path, fields)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tpcl.load_pcd(path), xyz)


def test_lzf_decoder_matches_jax():
    rng = np.random.default_rng(3)
    data = bytes(rng.integers(0, 4, 20000, dtype=np.uint8)) + bytes(300) * 3
    comp = lzf_compress(data)
    assert tpcl._decompress_lzf(comp, len(data)) == data
    assert jpcl._decompress_lzf(comp, len(data)) == data


@pytest.mark.parametrize("binary", [True, False])
def test_save_pcd_writes_the_same_bytes(tmp_path, binary):
    xyz = np.random.default_rng(1).normal(size=(500, 3))
    a, b = str(tmp_path / "a" / "c.pcd"), str(tmp_path / "b" / "c.pcd")
    tpcl.save_pcd(a, xyz, binary=binary)
    jpcl.save_pcd(b, xyz, binary=binary)
    assert open(a, "rb").read() == open(b, "rb").read()
    np.testing.assert_array_equal(tpcl.load_pcd(a), jpcl.load_pcd(b))


def test_pcl_loader_lists_times_and_loads(tmp_path):
    rng = np.random.default_rng(2)
    for t in ("12.5", "3.25", "7.0"):
        jpcl.save_pcd(str(tmp_path / "lidars" / f"{t}.pcd"), rng.normal(size=(9, 3)))
    tl, jl = tpcl.PCLLoader(str(tmp_path)), jpcl.PCLLoader(str(tmp_path))
    (tt, tf), (jt, jf) = tl.get_times("lidars"), jl.get_times("lidars")
    np.testing.assert_array_equal(tt, jt)
    assert tf == jf
    np.testing.assert_array_equal(tl.load_pcl("lidars/" + tf[0]),
                                  jl.load_pcl("lidars/" + jf[0]))


def test_rotations_and_se3_match_jax():
    rng = np.random.default_rng(4)
    for _ in range(20):
        q = rng.normal(size=4)
        R = tpcl.quat_to_matrix(q)
        np.testing.assert_allclose(R, jpcl.quat_to_matrix(q), rtol=0, atol=1e-12)
        np.testing.assert_allclose(tpcl.matrix_to_quat(R), jpcl.matrix_to_quat(R),
                                   rtol=0, atol=1e-12)
        # a rotation by ~180 degrees takes Shepperd's other branch
        Rf = R @ np.diag([1.0, -1.0, -1.0])
        np.testing.assert_allclose(tpcl.matrix_to_quat(Rf),
                                   jpcl.matrix_to_quat(Rf), rtol=0, atol=1e-12)
        ang = rng.uniform(-np.pi, np.pi, 3)
        for seq in ("xyz", "zyx", "XYZ"):
            np.testing.assert_allclose(tpcl.euler_to_matrix(ang, seq),
                                       jpcl.euler_to_matrix(ang, seq),
                                       rtol=0, atol=1e-12)
    t = rng.normal(size=3)
    a, b = tpcl.SE3(t=t, q=q), jpcl.SE3(t=t, q=q)
    pts = rng.normal(size=(50, 3))
    np.testing.assert_allclose(a.apply(pts), b.apply(pts), rtol=0, atol=1e-12)
    np.testing.assert_allclose(a.inverse().matrix(), b.inverse().matrix(),
                               rtol=0, atol=1e-12)
    c = tpcl.SE3(t=-t, euler_angles=ang)
    d = jpcl.SE3(t=-t, euler_angles=ang)
    np.testing.assert_allclose(a.compose(c).matrix(), b.compose(d).matrix(),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(a.compose(c, False).matrix(),
                               b.compose(d, False).matrix(), rtol=0, atol=1e-12)
    for x, y in zip(a.quaternion(), b.quaternion()):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-12)


def test_meas2depth_match_jax():
    rng = np.random.default_rng(5)
    uss = np.concatenate([rng.uniform(0, 60000, 200), [50000.0, 49999.0, 0.0]])
    np.testing.assert_allclose(tpcl.uss_meas2depth(uss), jpcl.uss_meas2depth(uss),
                               rtol=0, atol=1e-12)
    tof = rng.uniform(0, 4000, (7, 64))
    tof[:, ::9] = 50.0  # <= 0.1 m: invalid (NaN)
    for frames in (tof, tof[0]):
        got, want = tpcl.tof_meas2depth(frames), jpcl.tof_meas2depth(frames)
        assert got.shape == want.shape == frames.shape[:-1] + (8, 8)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
