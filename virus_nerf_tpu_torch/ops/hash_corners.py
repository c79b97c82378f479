"""H1, the additive hash encoder's ``corners`` forward in one launch
(``csrc/hash_corners.cu``): the binding.

The plain ``corners`` forward (``hash_corners_plain`` in
``ops/hash_encoder.py``) computes the base rows and trilinear weights of
every (sample, level), gathers the 8 corner rows and combines them, each
step an (L, 8, N) tensor.  H1 does the whole forward in one launch that
keeps the corners in registers and writes the embedding, and the base rows
and weights only where the table gradient needs them.  It gives the plain
code's base rows and weights on the card bit for bit, and its embedding in
the order cuBLAS combines the einsum (the kernel's source says how).
``ops/hash_encoder.py`` sends every ``corners`` encode on the card here
and builds the per-level words (``h1_level_words``); a layout H1 does not
hold is refused, never run another way on the card.
"""

from __future__ import annotations

import torch

from virus_nerf_tpu_torch.ops import _build
from virus_nerf_tpu_torch.ops.launch_counts import register

H1_FEATS = (1, 2, 4, 8)  # the feature widths H1 is built for
H1_MAX_LEVELS = 32  # levels it takes by value (kMaxLevels in the source)


def check_layout(feat_dim: int, level_words) -> None:
    """Raise ValueError unless H1 holds the layout: F in :data:`H1_FEATS`,
    1 to :data:`H1_MAX_LEVELS` levels, every corner offset in int32."""
    levels = level_words.shape[0]
    if feat_dim not in H1_FEATS or not 1 <= levels <= H1_MAX_LEVELS:
        raise ValueError(
            f"hash_corners: H1 holds F in {H1_FEATS} and 1 to "
            f"{H1_MAX_LEVELS} levels, got F = {feat_dim}, {levels} levels")
    if level_words[:, 4:12].max() >= 2**31:
        raise ValueError("hash_corners: H1 holds levels of fewer than 2^31 "
                         "rows")


def hash_corners(table, xyz, level_words, scales, keep: bool = True):
    """The ``corners`` forward of the additive hash on the card, by H1.
    ``.launches`` counts the launches.

    Args:
        table: (total_rows, F) float32 or bf16 on a CUDA device, contiguous.
        xyz: (N, 3) float32 positions, [0, 1] for the cube, contiguous on
            the table's device.
        level_words: (L, 13) int64 host array, a level's first row, size,
            stride_y, stride_z, 8 corner offsets and bf16 rounding flag.
        scales: (L,) float32 host array, the levels' scales.
        keep: write the base rows and weights the table gradient reads.
    Returns:
        out (N, L * F) float32, and base (L, N) int64 and w (L, 8, N)
        float32, or None and None without ``keep``.
    """
    if table.dim() != 2 or table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"hash_corners: want a 2-D float32 or bf16 table, got "
                        f"{tuple(table.shape)} {table.dtype}")
    if xyz.dtype != torch.float32 or xyz.dim() != 2 or xyz.shape[1] != 3:
        raise TypeError(f"hash_corners: want (N, 3) float32 positions, got "
                        f"{tuple(xyz.shape)} {xyz.dtype}")
    F, L = table.shape[1], level_words.shape[0]
    check_layout(F, level_words)
    if int((level_words[:, 0] + level_words[:, 1]).max()) > table.shape[0]:
        raise ValueError(f"hash_corners: the levels reach past the table's "
                         f"{table.shape[0]} rows")
    if xyz.device != table.device or not table.is_cuda:
        raise ValueError(f"hash_corners: want both on one CUDA device, got "
                         f"xyz on {xyz.device}, table on {table.device}")
    row_bytes = F * table.element_size()
    if not (table.is_contiguous() and xyz.is_contiguous()
            and table.data_ptr() % min(row_bytes, 16) == 0):
        raise ValueError("hash_corners: table and xyz must be contiguous, "
                         "the table aligned to its row's vector")
    n, dev = xyz.shape[0], table.device
    out = torch.empty((n, L * F), dtype=torch.float32, device=dev)
    base = w = None
    if keep:
        base = torch.empty((L, n), dtype=torch.long, device=dev)
        w = torch.empty((L, 8, n), dtype=torch.float32, device=dev)
    err = _build.library().vn_hash_corners(
        xyz.data_ptr(), n, table.data_ptr(), int(table.dtype == torch.bfloat16),
        F, L, level_words.ctypes.data, scales.ctypes.data, out.data_ptr(),
        base.data_ptr() if keep else None, w.data_ptr() if keep else None,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "vn_hash_corners")
    hash_corners.launches += 1
    return out, base, w


hash_corners.launches = 0
register(hash_corners)
