"""E2, the evaluator's nearest-neighbour search (``csrc/nn_search.cu``),
and its plain version.

``nn_metrics`` (``evaluation/metrics.py``) matches two 2-D scans image by
image: for each query point of an image, the nearest point of the same
image's reference scan, by ``find_nearest_neighbour`` (``evaluation/
geometry.py``) with NaN rows ignored.  :func:`nn_search` does the whole
call's images at once: on the card with E2, one launch, on the CPU with
:func:`nn_search_plain`, the per-image loop over ``find_nearest_neighbour``.
Both give the same indices and distances bit for bit (the kernel's source
says how).
"""

from __future__ import annotations

import numpy as np
import torch

from virus_nerf_tpu_torch.evaluation.geometry import find_nearest_neighbour
from virus_nerf_tpu_torch.ops import _build
from virus_nerf_tpu_torch.ops.launch_counts import register


def nn_search_plain(pos, pos_ref, num_points: int):
    """Plain version of :func:`nn_search`: ``find_nearest_neighbour(...,
    ignore_nan=True)`` on each image in turn, in numpy."""
    n = int(num_points)
    pos = pos.numpy().reshape(n, -1, 2)
    pos_ref = pos_ref.numpy().reshape(n, -1, 2)
    idxs = np.empty(pos.shape[:2], np.int32)
    dists = np.empty(pos.shape[:2], np.float32)
    for i in range(n):
        idxs[i], dists[i] = find_nearest_neighbour(pos[i], pos_ref[i],
                                                   ignore_nan=True)
    return torch.from_numpy(idxs), torch.from_numpy(dists)


def nn_search(pos, pos_ref, num_points: int):
    """Each query point's nearest reference point, image by image.

    ``pos`` holds N images of K query points, ``pos_ref`` N images of M
    reference points, image after image.  A row with a NaN coordinate is
    no point: a NaN query gets index -1 and distance NaN, and so does
    every query of an image with no valid reference point.  Ties go to
    the lowest index.  CUDA tensors launch E2 (or raise); CPU tensors
    take :func:`nn_search_plain`.  ``.launches`` counts the calls that
    launched E2.

    Args:
        pos: (N*K, 2) float32.
        pos_ref: (N*M, 2) float32, on the device of ``pos``.
        num_points: N images.
    Returns:
        (N, K) int32 indices within each image's M reference points, and
        (N, K) float32 distances, on the device of ``pos``.
    """
    n = int(num_points)
    for name, t in (("pos", pos), ("pos_ref", pos_ref)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != 2:
            raise TypeError(f"nn_search: want (rows, 2) float32 {name}, got "
                            f"{tuple(t.shape)} {t.dtype}")
    if not 1 <= n <= 65535:  # the grid's images
        raise ValueError(f"nn_search: {n} images outside [1, 65535]")
    if pos.shape[0] % n or pos_ref.shape[0] % n:
        raise ValueError(f"nn_search: {pos.shape[0]} queries and "
                         f"{pos_ref.shape[0]} references over {n} images")
    if pos.device != pos_ref.device:
        raise ValueError(f"nn_search: pos on {pos.device}, pos_ref on "
                         f"{pos_ref.device}")
    if pos.device.type == "cpu":
        return nn_search_plain(pos, pos_ref, n)
    if not pos.is_cuda:
        raise ValueError(f"nn_search: unsupported device {pos.device}")
    if not (pos.is_contiguous() and pos_ref.is_contiguous()
            and pos.data_ptr() % 8 == 0 and pos_ref.data_ptr() % 8 == 0):
        raise ValueError("nn_search: pos and pos_ref must be contiguous and "
                         "8-byte aligned")
    k, m = pos.shape[0] // n, pos_ref.shape[0] // n
    if max(k, m) >= 2**31:
        raise ValueError(f"nn_search: {k} queries or {m} references an image "
                         f"overflow int32")
    idx = torch.empty((n, k), dtype=torch.int32, device=pos.device)
    dist = torch.empty((n, k), dtype=torch.float32, device=pos.device)
    err = _build.library().vn_nn_search(
        pos.data_ptr(), k, pos_ref.data_ptr(), m, n, idx.data_ptr(),
        dist.data_ptr(), torch.cuda.current_stream(pos.device).cuda_stream,
    )
    _build.check(err, "vn_nn_search")
    nn_search.launches += 1
    return idx, dist


nn_search.launches = 0
register(nn_search)
