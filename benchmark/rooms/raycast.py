"""The raycaster and the surface sampler the room writers call.

Frozen copy of ``_raycast`` and ``_sample_surfaces`` of
``virus_nerf_tpu_torch/data/synthetic.py``, so that a later change to the
program cannot move the rooms the benchmark writes.
"""

from __future__ import annotations

import numpy as np

# default room: 6m x 6m x 3m centered at origin
_ROOM_MIN = np.array([-3.0, -3.0, -1.5])
_ROOM_MAX = np.array([3.0, 3.0, 1.5])

_WALL_COLORS = np.array(
    [
        [0.9, 0.3, 0.3],  # +x wall
        [0.3, 0.9, 0.3],  # -x wall
        [0.3, 0.3, 0.9],  # +y wall
        [0.9, 0.9, 0.3],  # -y wall
        [0.8, 0.8, 0.8],  # ceiling
        [0.4, 0.4, 0.4],  # floor
    ]
)


def _raycast(rays_o, rays_d, boxes, box_colors, room_min=None, room_max=None):
    """Exact depth (N,) + color (N, 3) of rays from inside the room
    (default: the synthetic room): min(room-wall exit, nearest obstacle
    entry).  The JAX package's arithmetic, element for element, laid out
    axis-major (3, N) so that the reductions over the axes run on rows."""
    room_min = _ROOM_MIN if room_min is None else np.asarray(room_min)
    room_max = _ROOM_MAX if room_max is None else np.asarray(room_max)
    n = rays_o.shape[0]
    inv = 1.0 / np.where(np.abs(rays_d) < 1e-12, 1e-12, rays_d)
    inv, o = np.ascontiguousarray(inv.T), np.ascontiguousarray(np.asarray(rays_o).T)
    t_exit_per_axis = np.maximum(
        (room_min[:, None] - o) * inv, (room_max[:, None] - o) * inv
    )  # (3, N)
    axis = np.argmin(t_exit_per_axis, axis=0)
    depth = t_exit_per_axis[axis, np.arange(n)]
    sign_pos = rays_d[np.arange(n), axis] > 0
    color = axis * 2 + (~sign_pos).astype(int)  # row of the palette
    for b in range(boxes.shape[0]):
        bt_lo = (boxes[b, 0][:, None] - o) * inv
        bt_hi = (boxes[b, 1][:, None] - o) * inv
        t1 = np.maximum.reduce(np.minimum(bt_lo, bt_hi))
        t2 = np.minimum.reduce(np.maximum(bt_lo, bt_hi))
        hit = (t2 > t1) & (t1 > 1e-6) & (t1 < depth)
        depth = np.where(hit, t1, depth)
        color = np.where(hit, len(_WALL_COLORS) + b, color)
    return depth, np.concatenate([_WALL_COLORS, box_colors])[color]


def _sample_surfaces(rng, boxes: np.ndarray, n_points: int,
                     room_min=None, room_max=None) -> np.ndarray:
    """Points uniform by area on the room walls + box faces (the GT map;
    default room: the synthetic one)."""
    room_min = _ROOM_MIN if room_min is None else np.asarray(room_min)
    room_max = _ROOM_MAX if room_max is None else np.asarray(room_max)
    aabbs = np.concatenate(
        [np.stack([room_min, room_max])[None], boxes], axis=0
    )
    faces = []
    for b in range(aabbs.shape[0]):
        ext = aabbs[b, 1] - aabbs[b, 0]
        for axis in range(3):
            area = ext[(axis + 1) % 3] * ext[(axis + 2) % 3]
            for side in range(2):
                faces.append((axis, side, b, area))
    areas = np.array([f[3] for f in faces])
    counts = rng.multinomial(n_points, areas / areas.sum())
    pts = []
    for (axis, side, b, _), c in zip(faces, counts):
        if c == 0:
            continue
        p = rng.uniform(aabbs[b, 0], aabbs[b, 1], size=(c, 3))
        p[:, axis] = aabbs[b, side, axis]
        pts.append(p)
    return np.concatenate(pts, axis=0)
