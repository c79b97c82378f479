"""Point-cloud I/O, SE(3) transforms, and raw-measurement conversion.

Frozen copy of ``virus_nerf_tpu_torch/data/pcl.py`` for the benchmark's
plain reference and rooms: it is never edited, so a later change to the
program cannot move the yardstick.

Counterpart of the reference's pcl_tools subpackage — the only part of the
ROS tree that is a runtime dependency of training
(reference: ETHZ_experiments/catkin_ws/src/sensors/src/pcl_tools/
pcl_loader.py:9-103, pcl_transformer.py:6-160, pcl_creator.py:133-202).
Self-contained: the PCD parser replaces the pypcd4 dependency and handles
the ascii / binary / binary_compressed variants of PCD v0.7.

The port's copy of ``virus_nerf_tpu/data/pcl.py``.  The JAX package hands
x/y/z loads to its C++ parser (``native/pcd_io.cpp``) when that is built;
the port keeps the numpy reader, which the JAX module holds as the golden
reference of that parser.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

_PCD_TYPE_MAP = {
    ("F", 4): np.float32,
    ("F", 8): np.float64,
    ("I", 1): np.int8,
    ("I", 2): np.int16,
    ("I", 4): np.int32,
    ("U", 1): np.uint8,
    ("U", 2): np.uint16,
    ("U", 4): np.uint32,
}


def _decompress_lzf(data: bytes, expected_size: int) -> bytes:
    """Pure-python LZF decompression (PCD binary_compressed payloads)."""
    out = bytearray()
    i = 0
    n = len(data)
    while i < n and len(out) < expected_size:
        ctrl = data[i]
        i += 1
        if ctrl < 32:  # literal run of ctrl+1 bytes
            run = ctrl + 1
            out += data[i : i + run]
            i += run
        else:  # back reference
            length = ctrl >> 5
            if length == 7:
                length += data[i]
                i += 1
            ref = len(out) - ((ctrl & 0x1F) << 8) - data[i] - 1
            i += 1
            for _ in range(length + 2):
                out.append(out[ref])
                ref += 1
    return bytes(out)


def load_pcd(
    path: str, fields: Tuple[str, ...] = ("x", "y", "z")
) -> np.ndarray:
    """Load a PCD v0.7 file and return the requested fields as (N, len(fields))
    float32 (reference: pcl_loader.py:69-86 via pypcd4)."""
    with open(path, "rb") as f:
        header: Dict[str, List[str]] = {}
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if line.startswith("#") or not line:
                continue
            key, *vals = line.split()
            header[key.upper()] = vals
            if key.upper() == "DATA":
                break
        payload = f.read()

    names = header["FIELDS"]
    sizes = [int(s) for s in header["SIZE"]]
    types = [t for t in header["TYPE"]]
    counts = [int(c) for c in header.get("COUNT", ["1"] * len(names))]
    n_points = int(header["POINTS"][0])
    mode = header["DATA"][0].lower()

    dtype_fields = []
    for name, size, typ, count in zip(names, sizes, types, counts):
        base = _PCD_TYPE_MAP[(typ, size)]
        if count == 1:
            dtype_fields.append((name, base))
        else:
            dtype_fields.append((name, base, (count,)))
    dtype = np.dtype(dtype_fields)

    if mode == "ascii":
        rows = np.loadtxt(
            payload.decode("ascii").splitlines(), dtype=np.float64, ndmin=2
        )
        out = np.stack(
            [rows[:, names.index(f)] for f in fields], axis=1
        ).astype(np.float32)
        return out
    if mode == "binary":
        arr = np.frombuffer(payload[: n_points * dtype.itemsize], dtype=dtype)
    elif mode == "binary_compressed":
        comp_size, uncomp_size = struct.unpack("<II", payload[:8])
        raw = _decompress_lzf(payload[8 : 8 + comp_size], uncomp_size)
        # binary_compressed stores data column-major: all x, then all y, ...
        arr = np.empty(n_points, dtype=dtype)
        off = 0
        for name, size, typ, count in zip(names, sizes, types, counts):
            base = np.dtype(_PCD_TYPE_MAP[(typ, size)])
            nbytes = n_points * base.itemsize * count
            col = np.frombuffer(raw[off : off + nbytes], dtype=base)
            if count > 1:
                col = col.reshape(n_points, count)
            arr[name] = col
            off += nbytes
    else:
        raise ValueError(f"unsupported PCD DATA mode {mode}")

    return np.stack([arr[f] for f in fields], axis=1).astype(np.float32)


def save_pcd(path: str, xyz: np.ndarray, binary: bool = True) -> None:
    """Save an (N, 3) cloud as PCD v0.7 x/y/z float32
    (reference: pcl_loader.py:88-103)."""
    xyz = np.ascontiguousarray(np.asarray(xyz, np.float32))
    n = xyz.shape[0]
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        "FIELDS x y z\n"
        "SIZE 4 4 4\n"
        "TYPE F F F\n"
        "COUNT 1 1 1\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(xyz.tobytes())
        else:
            np.savetxt(f, xyz, fmt="%.8g")


class PCLLoader:
    """Directory-scoped PCD loading (reference: pcl_loader.py:9-103)."""

    def __init__(self, data_dir: str):
        self.data_dir = data_dir

    def get_files(self, pcl_dir: str) -> List[str]:
        d = os.path.join(self.data_dir, pcl_dir)
        return sorted(
            f for f in os.listdir(d) if os.path.isfile(os.path.join(d, f))
        )

    def get_times(self, pcl_dir: str) -> Tuple[np.ndarray, List[str]]:
        """Times parsed from '<time>.pcd' filenames
        (reference: pcl_loader.py:30-48,105-127)."""
        files = self.get_files(pcl_dir)
        times = np.array([float(os.path.splitext(f)[0]) for f in files])
        return times, files

    def load_pcl(self, filename: str) -> np.ndarray:
        return load_pcd(os.path.join(self.data_dir, filename))

    def save_pcl(self, filename: str, xyz: np.ndarray) -> None:
        save_pcd(os.path.join(self.data_dir, filename), xyz)


class SE3:
    """Rigid transform from any of matrix / translation+quaternion /
    rotation / euler (reference: pcl_transformer.py:6-160).

    Quaternions use the [x, y, z, w] convention (scipy/ROS order).
    """

    def __init__(
        self,
        T: Optional[np.ndarray] = None,
        t: Optional[np.ndarray] = None,
        q: Optional[np.ndarray] = None,
        R: Optional[np.ndarray] = None,
        euler_angles: Optional[np.ndarray] = None,
        euler_seq: str = "xyz",
    ):
        if T is not None:
            T = np.asarray(T, np.float64)
            self.R = T[:3, :3].copy()
            self.t = T[:3, 3].copy()
        elif t is not None and q is not None:
            self.R = quat_to_matrix(np.asarray(q, np.float64))
            self.t = np.asarray(t, np.float64).copy()
        elif t is not None and R is not None:
            self.R = np.asarray(R, np.float64).copy()
            self.t = np.asarray(t, np.float64).copy()
        elif t is not None and euler_angles is not None:
            self.R = euler_to_matrix(
                np.asarray(euler_angles, np.float64), euler_seq
            )
            self.t = np.asarray(t, np.float64).copy()
        else:
            raise ValueError("incomplete transform specification")

    def matrix(self) -> np.ndarray:
        T = np.eye(4)
        T[:3, :3] = self.R
        T[:3, 3] = self.t
        return T

    def quaternion(self) -> Tuple[np.ndarray, np.ndarray]:
        return matrix_to_quat(self.R), self.t.copy()

    def inverse(self) -> "SE3":
        R_inv = self.R.T
        return SE3(t=-R_inv @ self.t, R=R_inv)

    def compose(self, other: "SE3", apply_first_other: bool = True) -> "SE3":
        """self ∘ other (apply ``other`` first) or other ∘ self
        (reference: pcl_transformer.py:112-138)."""
        if apply_first_other:
            return SE3(T=self.matrix() @ other.matrix())
        return SE3(T=other.matrix() @ self.matrix())

    def apply(self, xyz: np.ndarray) -> np.ndarray:
        """Transform an (N, 3) cloud (reference: pcl_transformer.py:140-160)."""
        return np.asarray(xyz, np.float64) @ self.R.T + self.t


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """[x, y, z, w] quaternion -> rotation matrix."""
    x, y, z, w = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def matrix_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> [x, y, z, w] quaternion (Shepperd's method)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        qv = np.zeros(3)
        qv[i] = 0.25 * s
        qv[j] = (R[j, i] + R[i, j]) / s
        qv[k] = (R[k, i] + R[i, k]) / s
        w = (R[k, j] - R[j, k]) / s
        x, y, z = qv
    return np.array([x, y, z, w])


def euler_to_matrix(angles: np.ndarray, seq: str = "xyz") -> np.ndarray:
    """Intrinsic-axis euler angles -> rotation matrix (matches
    scipy Rotation.from_euler for lowercase = extrinsic... the reference uses
    uppercase sequences rarely; ETHZ/RH use quaternions and 'xyz')."""
    def rot(axis: str, a: float) -> np.ndarray:
        c, s = np.cos(a), np.sin(a)
        if axis == "x":
            return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
        if axis == "y":
            return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    R = np.eye(3)
    for axis, a in zip(seq.lower(), np.asarray(angles, np.float64)):
        # lowercase scipy seq = extrinsic: successive rotations premultiply
        R = rot(axis, a) @ R
    return R


# -------------------------------------------------- raw-measurement decoding
def uss_meas2depth(meas) -> np.ndarray:
    """Raw USS reading -> meters: >= 50000 is 'no echo' (invalid -> 0),
    else counts / 5000 (reference: pcl_creator.py:149-163)."""
    meas = np.asarray(meas, np.float64)
    return np.where(meas >= 50000, 0.0, meas / 5000.0)


def tof_meas2depth(meas, depth_min: float = 0.1) -> np.ndarray:
    """Raw 64-zone ToF frame (mm) -> (8, 8) meters in the camera pixel
    orientation: mm -> m, <= depth_min invalid (NaN), then the fixed
    flip/transpose chain aligning the VL53L5CX zone order with the image
    (reference: pcl_creator.py:182-202)."""
    meas = np.asarray(meas, np.float64)
    shape = meas.shape[:-1]
    depth = 0.001 * meas.reshape(*shape, 64)
    depth = np.where(depth <= depth_min, np.nan, depth)
    depth = depth.reshape(*shape, 8, 8)
    depth = np.flip(depth, axis=-1)  # [:, ::-1]
    depth = np.swapaxes(depth, -1, -2)  # .T
    depth = np.flip(np.flip(depth, axis=-1), axis=-2)  # [::-1, ::-1]
    return depth
