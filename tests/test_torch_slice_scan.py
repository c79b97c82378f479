"""E1, the evaluator's ground-truth slice scan (``csrc/slice_scan.cu``),
emulated in numpy on its own scheme, against its plain version
``slice_scan_plain``, and ``Scene.get_slice_scan`` against the JAX
package's ``Scene.get_slice_scan`` (virus_nerf_tpu/data/scene.py:101), all
three outputs bit for bit.

The kernel cannot run without a card; this emulation follows it step for
step on the host inputs ``Scene.scan_depths`` hands to ``slice_scan``: the
raster as 32-bit words
with one OR a band point, then one warp a ray, the samples in chunks of 32
(one lane each), every product and sum rounded on its own, the cell by
``rint`` (half to even) and a clamp, the chunk's ballot of the occupied
lanes and its lowest set bit as the first hit.

Cases: rasters of 128 and 512 cells a side; origins whose samples lie on
exact half-cell ties; origins in occupied cells (a hit at the first
sample); rays that leave the cube without a hit; an empty height band; a
cloud of 800,000 points; the angles from ``angular_range`` where no
directions are given; origins in world coordinates.  And an evaluator on
the CPU, which scans on the host with the plain version, and the set-up a
scene keeps.
"""

import numpy as np
import pytest
import torch

from virus_nerf_tpu.data.scene import Scene as JScene
from virus_nerf_tpu_torch.configs.config import Config
from virus_nerf_tpu_torch.data import scene as scene_module
from virus_nerf_tpu_torch.data.scene import CUBE_MIN, Scene
from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
from virus_nerf_tpu_torch.evaluation.evaluator import Evaluator
from virus_nerf_tpu_torch.evaluation.geometry import create_scan_rays
from virus_nerf_tpu_torch.ops.slice_scan import (
    SPAN,
    slice_scan,
    slice_scan_plain,
)
from virus_nerf_tpu_torch.training.trainer import Trainer
from virus_nerf_tpu_torch.utils import tracing

torch.set_num_threads(1)

WARP = 32
ROOM_MIN = np.array([-3.0, -3.0, -0.4])  # ETHZ commonroom's bounds
ROOM_MAX = np.array([15.0, 9.0, 1.2])
TOL = 0.1
CUBE = {"rays_o_in_world_coord": False}  # get_slice_scan's origins in cube units


# ----------------------------------------------------------- the emulation
def _cell(p, res):
    """E1's ``slice_cell``: one rounding an operation, rint, NaN to 0, a
    clamp."""
    t = np.multiply(float(res - 1), np.subtract(p, CUBE_MIN))
    if SPAN != 1.0:
        t = np.divide(t, SPAN)
    t = np.rint(t)
    return np.clip(np.where(np.isnan(t), 0.0, t).astype(np.int64), 0, res - 1)


def emulate_e1(cells, band, res, rays, radii):
    """(hit cell or -1, index of the first hit sample or -1) of each ray,
    on E1's scheme."""
    lo, hi = band
    words = np.zeros((res * res + 31) // 32, np.uint32)
    c = cells[lo:hi].astype(np.int64)
    np.bitwise_or.at(words, c >> 5, (np.uint32(1) << (c & 31)).astype(np.uint32))
    n, m = rays.shape[0], radii.shape[0]
    hit = np.full(n, -1, np.int64)
    first = np.full(n, -1, np.int64)
    walking = np.ones(n, bool)
    lanes = np.arange(WARP)
    for base in range(0, m, WARP):
        k = base + lanes
        inside = k < m
        r = radii[np.minimum(k, m - 1)]
        x = np.add(rays[:, 0:1], np.multiply(r[None, :], rays[:, 2:3]))
        y = np.add(rays[:, 1:2], np.multiply(r[None, :], rays[:, 3:4]))
        lin = _cell(x, res) * res + _cell(y, res)
        occupied = ((words[lin >> 5] >> (lin & 31)) & 1).astype(bool)
        occupied &= inside[None, :]
        ballot = (occupied.astype(np.uint64) << lanes.astype(np.uint64)).sum(1)
        now = walking & (ballot != 0)
        lane = np.argmax(occupied, axis=1)  # __ffs(ballot) - 1
        rows = np.flatnonzero(now)
        hit[rows] = lin[rows, lane[rows]]
        first[rows] = base + lane[rows]
        walking &= ~now
        if not walking.any():
            break
    return hit, first


# ---------------------------------------------------------------- the cases
def _room_cloud(rng, n):
    """Four walls and clutter inside the room's bounds, float32 as a PCD."""
    q = n // 5
    lo, hi = ROOM_MIN, ROOM_MAX
    z = lambda k: rng.uniform(lo[2], hi[2], k)  # noqa: E731
    walls = [
        np.c_[rng.uniform(lo[0], hi[0], q), np.full(q, lo[1] + 0.2), z(q)],
        np.c_[rng.uniform(lo[0], hi[0], q), np.full(q, hi[1] - 0.2), z(q)],
        np.c_[np.full(q, lo[0] + 0.2), rng.uniform(lo[1], hi[1], q), z(q)],
        np.c_[np.full(q, hi[0] - 0.2), rng.uniform(lo[1], hi[1], q), z(q)],
    ]
    clutter = rng.uniform(lo, hi, (n - 4 * q, 3))
    return np.concatenate(walls + [clutter]).astype(np.float32)


def _points_at(scene, cells, res, z):
    """World points at the centres of slice cells ``cells`` (K, 2), at
    world height ``z``; each maps back to its cell."""
    xy = scene.idx2w(np.asarray(cells), res)
    assert np.array_equal(scene.w2idx(xy, res), cells)
    return np.c_[xy, np.full(len(xy), z)]


def _tie(j, res):
    """A cube coordinate y with ``(res - 1) * (y - CUBE_MIN)`` exactly
    ``j + 0.5``."""
    y0 = (j + 0.5) / (res - 1) + CUBE_MIN
    for d in range(129):
        for sign in (np.inf, -np.inf):
            y = y0
            for _ in range(d):
                y = np.nextafter(y, sign)
            if (res - 1) * (y - CUBE_MIN) / SPAN == j + 0.5:
                return y
    raise AssertionError(f"no tie for row {j} at res {res}")


def case_room(res, n_points=40_000, seed=0):
    rng = np.random.default_rng(seed)
    scene = Scene(_room_cloud(rng, n_points), ROOM_MIN, ROOM_MAX)
    origins = scene.w2c(rng.uniform([0, 0, 0.2], [12, 6, 0.6], (4, 3)))
    return scene, *create_scan_rays(origins, 128), res, CUBE


def case_ties(res):
    """Rays along +x at heights y on exact ties between rows j and j + 1:
    a wall on the row ``rint`` picks (the even one) and a decoy, further
    on, on the other."""
    scene = Scene(_room_cloud(np.random.default_rng(1), 2000), ROOM_MIN, ROOM_MAX)
    z = float(scene.shift[2])  # the cube's z = 0 plane
    ix0 = res // 8
    origins, walls = [], []
    for i in range(8):
        j = res // 2 + 10 + 3 * i
        y = _tie(j, res)
        even = j if j % 2 == 0 else j + 1
        odd = j + 1 if j % 2 == 0 else j
        origins.append([scene.idx2c(ix0, res), y, 0.0])
        walls += [[ix0 + 8, even], [ix0 + 16, odd]]
    pts = np.concatenate([scene.point_cloud, _points_at(scene, walls, res, z)])
    scene = Scene(pts, ROOM_MIN, ROOM_MAX)
    rays_o = np.asarray(origins, np.float64)
    rays_d = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (len(origins), 1))
    return scene, rays_o, rays_d, res, CUBE


def case_origin_occupied(res):
    """Every origin in an occupied cell: each ray's first sample hits."""
    rng = np.random.default_rng(2)
    scene = Scene(_room_cloud(rng, 4000), ROOM_MIN, ROOM_MAX)
    cells = np.array([[res // 3, res // 4], [res // 2, res // 2 + 3],
                      [2 * res // 3, res // 5]])
    pts = np.concatenate([scene.point_cloud,
                          _points_at(scene, cells, res, float(scene.shift[2]))])
    scene = Scene(pts, ROOM_MIN, ROOM_MAX)
    origins = np.c_[scene.idx2c(cells, res), np.zeros(len(cells))]
    return scene, *create_scan_rays(origins, 64), res, CUBE


def case_leave_the_cube(res):
    """A small cluster on one side: most rays cross the cube, no hit."""
    rng = np.random.default_rng(3)
    pts = np.c_[rng.uniform(10.0, 11.0, (500, 2)), rng.uniform(0.3, 0.5, 500)]
    scene = Scene(pts.astype(np.float32), ROOM_MIN, ROOM_MAX)
    origins = scene.w2c(np.array([[4.0, 3.0, 0.4], [5.0, 2.0, 0.4]]))
    return scene, *create_scan_rays(origins, 128), res, CUBE


def case_empty_band(res):
    """Origins far above the cloud: no point in the band."""
    scene = Scene(_room_cloud(np.random.default_rng(4), 4000), ROOM_MIN, ROOM_MAX)
    origins = np.array([[0.0, 0.0, 0.45], [0.1, -0.05, 0.45]])
    return scene, *create_scan_rays(origins, 64), res, CUBE


def case_cloud_800k(res):
    return case_room(res, n_points=800_000, seed=5)


def case_no_directions(res, angular_range=None):
    """No ``rays_d``: the angles are a linspace over ``angular_range`` (the
    default's where None), one sweep across every origin's rays."""
    scene, rays_o, _, res, kw = case_room(res, seed=6)
    if angular_range is not None:
        kw = dict(kw, angular_range=angular_range)
    return scene, rays_o, None, res, kw


def case_world_origins(res, directions=True):
    """Origins in world coordinates (``rays_o_in_world_coord``, the
    default), with directions or with the angles of ``angular_range``."""
    rng = np.random.default_rng(7)
    scene = Scene(_room_cloud(rng, 40_000), ROOM_MIN, ROOM_MAX)
    rays_o, rays_d = create_scan_rays(
        rng.uniform([0, 0, 0.2], [12, 6, 0.6], (4, 3)), 128)
    if directions:
        return scene, rays_o, rays_d, res, {}
    return scene, rays_o, None, res, {"angular_range": (0.0, np.pi)}


CASES = {
    "room-128": lambda: case_room(128),
    "room-512": lambda: case_room(512),
    "ties-128": lambda: case_ties(128),
    "ties-512": lambda: case_ties(512),
    "origin-occupied": lambda: case_origin_occupied(128),
    "leave-the-cube": lambda: case_leave_the_cube(128),
    "empty-band": lambda: case_empty_band(128),
    "cloud-800k": lambda: case_cloud_800k(512),
    "no-directions": lambda: case_no_directions(128),
    "angular-range": lambda: case_no_directions(128, (-np.pi / 3, 2.0)),
    "world-origins": lambda: case_world_origins(128),
    "world-origins-no-directions-512": lambda: case_world_origins(512, False),
}


@pytest.mark.parametrize("name", list(CASES))
def test_e1_scheme_matches_get_slice_scan_and_jax(name, monkeypatch):
    scene, rays_o, rays_d, res, kw = CASES[name]()
    j_scene = JScene(scene.point_cloud, scene.xyz_min, scene.xyz_max)
    j_want = j_scene.get_slice_scan(res, rays_o, rays_d, TOL, **kw)

    walks = []  # the scene's one walk: its inputs and the hit cells

    def recorded(*args):  # on the CPU slice_scan is its plain version
        walks.append((args, slice_scan_plain(*args)))
        return walks[-1][1]

    monkeypatch.setattr(scene_module, "slice_scan", recorded)
    want = scene.get_slice_scan(res, rays_o, rays_d, TOL, **kw)
    # the scan map, the depths and the angles: the JAX package's march's
    assert len(want) == len(j_want) == 3
    for a, b in zip(want, j_want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b, equal_nan=True)

    ((cells, band, walk_res, rays, radii), plain), = walks
    assert walk_res == res
    rays = rays.numpy()
    hit, first = emulate_e1(cells.numpy(), band, res, rays, radii.numpy())
    assert plain.dtype == torch.int32
    assert np.array_equal(plain.numpy(), hit)
    got = want[1]
    assert got.dtype == np.float64

    # each case has what it is named for
    if name.startswith("ties"):
        y = rays[:, 1]
        assert ((res - 1) * (y - CUBE_MIN) % 1.0 == 0.5).all()
        rows = hit % res
        assert (hit >= 0).all() and (rows % 2 == 0).all()
        assert (first > 0).all()
    elif name == "origin-occupied":
        assert (first == 0).all()
    elif name == "leave-the-cube":
        assert np.isnan(got).mean() > 0.5 and (~np.isnan(got)).any()
        assert (first[hit < 0] == -1).all()
    elif name == "empty-band":
        assert band[0] == band[1] and np.isnan(got).all()
    else:
        assert 0 < band[1] - band[0] < scene.point_cloud.shape[0]
        assert (hit >= 0).mean() > 0.9
    if name == "cloud-800k":
        assert scene.point_cloud.shape[0] == 800_000 and res == 512
    if rays_d is None:  # the angles of angular_range
        lo, hi = kw.get("angular_range", (-np.pi, np.pi))
        assert np.array_equal(
            want[2], np.linspace(lo, hi, len(rays_o), endpoint=False))
    if kw.get("rays_o_in_world_coord", True):
        assert np.abs(rays_o).max() > 1.0  # metres, not cube units


def test_plain_scan_is_the_raster_of_the_band():
    # the band selects the raster: cells outside [lo, hi) are not there
    res = 16
    cells = torch.tensor([5 * res + 9, 5 * res + 12, 5 * res + 14],
                         dtype=torch.int32)
    rays = torch.tensor([[-0.5 + 5 / 15, -0.5, 0.0, 1.0]], dtype=torch.float64)
    radii = torch.linspace(0.0, 1.0, 23, dtype=torch.float64)
    for band, want in (((0, 3), 5 * res + 9), ((1, 3), 5 * res + 12),
                       ((2, 2), -1)):
        got = int(slice_scan(cells, band, res, rays, radii)[0])
        assert got == want, band
        h, _ = emulate_e1(cells.numpy(), band, res, rays.numpy(), radii.numpy())
        assert int(h[0]) == want


def test_slice_scan_rejects_bad_arguments():
    cells = torch.zeros(4, dtype=torch.int32)
    rays = torch.zeros((2, 4), dtype=torch.float64)
    radii = torch.linspace(0.0, 1.0, 8, dtype=torch.float64)
    with pytest.raises(TypeError):
        slice_scan(cells.long(), (0, 4), 8, rays, radii)
    with pytest.raises(TypeError):
        slice_scan(cells, (0, 4), 8, rays.float(), radii)
    with pytest.raises(TypeError):
        slice_scan(cells, (0, 4), 8, rays[:, :3].contiguous(), radii)
    with pytest.raises(ValueError):
        slice_scan(cells, (2, 5), 8, rays, radii)
    with pytest.raises(ValueError):
        slice_scan(cells, (3, 2), 8, rays, radii)
    with pytest.raises(ValueError):
        slice_scan(cells, (0, 4), 0, rays, radii)
    with pytest.raises(ValueError):
        Scene(xyz_min=ROOM_MIN, xyz_max=ROOM_MAX).slice_scan_setup(64, "cpu")


def _same(a, b):
    """Exactly equal nested metrics: dicts key for key, arrays and floats
    bit for bit (NaN equal to NaN)."""
    if isinstance(a, (dict, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for k in (a if isinstance(a, dict) else range(len(a))):
            _same(a[k], b[k])
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


def test_cpu_evaluator_scans_on_the_host():
    # an evaluator on the CPU walks the rays with the plain version: no
    # launch, and the metrics of Scene.get_slice_scan's GT scan exactly
    ds, scene, info = make_synthetic_dataset(device="cpu", n_images=4,
                                             img_wh=(32, 24), n_gt_points=2000)
    cfg = Config()
    m, t, ev = cfg.model, cfg.training, cfg.evaluation
    m.hash_levels, m.hash_log2_T, m.hash_max_res, m.grid_size = 4, 12, 64, 32
    t.batch_size, t.max_samples_per_ray = 128, 32
    t.march_candidates = t.march_resolution = 256
    ev.res_angular, ev.res_map = 64, 64
    ev.batch_size, ev.max_samples_per_ray = 64, 32
    state = Trainer(cfg, ds, scene=scene, device="cpu").init_state(0)
    evaluator = Evaluator(cfg, ds, scene, img_wh=info["img_wh"], device="cpu")
    idxs = np.arange(3)
    launches = slice_scan.launches
    tracing.enable()
    tracing.reset()
    try:
        got = evaluator.evaluate_depth(state.model, state.grid.occ_bool, idxs,
                                       sensors=("NeRF",))
        snap = tracing.snapshot()
    finally:
        tracing.enable(False)
        tracing.reset()
    assert snap["span.evaluator.gt_scan.n"] == 1
    assert slice_scan.launches == launches

    def numpy_gt(img_idxs):
        rays_o, rays_d = create_scan_rays(evaluator._scan_origins(img_idxs),
                                          ev.res_angular)
        depths = scene.get_slice_scan(res=ev.res_map, rays_o=rays_o,
                                      rays_d=rays_d,
                                      height_tolerance=ev.height_tolerance,
                                      rays_o_in_world_coord=False)[1]
        return (scene.c2w(rays_o), rays_d,
                scene.c2w(depths, only_scale=True))

    evaluator._get_gt_data = numpy_gt
    want = evaluator.evaluate_depth(state.model, state.grid.occ_bool, idxs,
                                    sensors=("NeRF",))
    _same(got, want)
    assert np.isfinite(got[1]["GT"]["depths"]).any()


def test_scans_are_kept_a_scene():
    # the evaluators of one scene share one set-up a raster size and
    # device; a replaced cloud is set up anew; the set-up goes with its
    # scene
    import gc
    import weakref

    rng = np.random.default_rng(3)
    scene = Scene(rng.uniform(ROOM_MIN, ROOM_MAX, (5000, 3)), ROOM_MIN,
                  ROOM_MAX)
    a = scene.slice_scan_setup(64, "cpu")
    assert scene.slice_scan_setup(64, torch.device("cpu")) is a
    b = scene.slice_scan_setup(128, "cpu")
    assert b is not a and scene.slice_scan_setup(128, "cpu") is b
    assert scene.slice_scan_setup(64, "cpu") is a
    assert a.cells.shape == b.cells.shape == (5000,)
    assert int(b.cells.max()) >= 64 * 64  # its own raster's cells
    # an evaluation reads the set-up it is given
    rays_o, rays_d = create_scan_rays(np.zeros((1, 3)), 16)
    scene.scan_depths(64, rays_o, rays_d)
    assert scene.slice_scan_setup(64, "cpu") is a
    scene.point_cloud = rng.uniform(ROOM_MIN, ROOM_MAX, (3000, 3))
    c = scene.slice_scan_setup(64, "cpu")
    assert c is not a and c.cloud is scene.point_cloud
    assert c.cells.shape == (3000,)
    assert scene.slice_scan_setup(64, "cpu") is c
    gone = weakref.ref(scene)
    cells = weakref.ref(c.cells)
    del scene, a, b, c
    gc.collect()
    assert gone() is None and cells() is None
