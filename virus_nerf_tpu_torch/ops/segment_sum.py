"""Dense segment sums over key-sorted streams.

Three forms of the value stream, each with its CUDA kernel (design, bound
and the deliberate differences from the TPU kernel are in each source) and
its plain PyTorch version, one ``index_add_``:

- transposed (G, VF, K): ``segment_sum_sorted``, counterpart of
  ``group_segment_sum_ts_sorted`` (virus_nerf_tpu/ops/segment_sum_pallas.py
  :607), TPU kernel ``_ts_kernel`` (:231), CUDA ``csrc/segment_sum.cu``;
  the additive hash encoder's backward;
- row-major (G, K, F): ``group_segment_sum_t_sorted``, counterpart of the
  function of that name (:725), TPU kernel ``_t_kernel`` (:101), CUDA
  ``csrc/segment_sum_rows.cu``; with ``group_segment_sum_t`` (:748, sorts
  first) and ``windowed_segment_sum`` (:769, one stream); the XOR hash
  encoder's backward.  Its sums are stored as (G, n_rows, F) rows, the
  table's layout, and returned as the transposed view; ``out=`` takes the
  block of a larger table gradient;
- fused factors (G, 8+F, K): ``group_segment_sum_tsf_sorted``, counterpart
  of the function of that name (:504), TPU kernel ``_tsf_kernel`` (:333),
  CUDA ``csrc/segment_sum_factors.cu``; the values ``w[c] * g[f]`` are
  formed from the sorted corner weights and gradients inside the kernel;
  the additive hash encoder's ``factors`` backward.

All three kernels share the row-tile core ``csrc/segment_tiles.cuh``: a
first launch finds each tile's window of the stream and leaves per-run
partials of every ``TILE_CHUNK``-entry chunk that a long window reaches;
then one CTA owns a tile of rows, sums its window (at most a short-window
cut of entries) by warp scans into shared memory, or joins the partials
of a longer one, and stores its tile once.  The transposed and factor
kernels take :func:`tile_rows` rows and ``SHORT_WINDOW``; the row-major
kernel :func:`row_tile_rows` (of two sizes, by :func:`row_tiles_dense`)
and ``ROW_SHORT_WINDOW``.  The constants are
below (the C side reports its own: ``vn_segment_tiles_rows``,
``vn_segment_rows_tile_rows`` and the like); the wrappers allocate the
scratch (:func:`_tile_scratch`).
"""

from __future__ import annotations

import torch

from virus_nerf_tpu_torch.ops import _build
from virus_nerf_tpu_torch.ops.launch_counts import register

# VF values the kernel is instantiated for (csrc/segment_sum.cu)
KERNEL_WIDTHS = (1, 2, 4, 8, 16, 32, 64)
# F values the row-major kernel is instantiated for (csrc/segment_sum_rows.cu)
ROW_KERNEL_WIDTHS = (1, 2, 4, 8)
# F values the factor-stream kernel is instantiated for
# (csrc/segment_sum_factors.cu): those of ``fuse_applicable``
# (segment_sum_pallas.py:448-451)
FACTOR_KERNEL_FEATS = (1, 2, 4, 8)
# the row-tile core (csrc/segment_tiles.cuh): the longest window a CTA
# scans itself, stream entries per chunk partial, planes per CTA, planes
# per warp scan, and the accumulator floats and most rows of a CTA
SHORT_WINDOW = 2048
TILE_CHUNK = 512
TILE_PLANES = 32
SCAN_PLANES = 8
TILE_FLOATS = 8192
MAX_TILE_ROWS = 512
# the row-major kernel's tiles (csrc/segment_sum_rows.cu): the rows of a
# sparse stream's tiles and of a dense stream's, and the short-window cut
ROW_SPARSE_ROWS = 1024
ROW_DENSE_ROWS = 128
ROW_SHORT_WINDOW = 8192


def tile_rows(V: int) -> int:
    """Output rows a CTA of the transposed or factor kernel owns for V
    planes."""
    return min(MAX_TILE_ROWS, TILE_FLOATS // min(V, TILE_PLANES))


def row_tile_rows(F: int, dense: bool) -> int:
    """Output rows a CTA of the row-major kernel owns at F features:
    ``ROW_DENSE_ROWS`` or ``ROW_SPARSE_ROWS`` at most, and the largest
    power of two whose accumulator (F floats a row) and row bounds (8
    bytes a row) fit ``TILE_FLOATS`` floats."""
    fit = TILE_FLOATS // (F + 2)
    cap = ROW_DENSE_ROWS if dense else ROW_SPARSE_ROWS
    return min(cap, 1 << (fit.bit_length() - 1))


def row_tiles_dense(F: int, K: int, n_rows: int) -> bool:
    """Does a stream of K entries a group over n_rows rows take the dense
    tiles?  Where a sparse tile's window would hold more than
    ``ROW_SHORT_WINDOW`` entries on average, every tile would join chunk
    partials; smaller tiles spread that work over more CTAs."""
    return K * row_tile_rows(F, False) > ROW_SHORT_WINDOW * n_rows


def _tile_scratch(G: int, K: int, V: int, n_rows: int, R: int, device):
    """Scratch of the row-tile core at tiles of R rows: the chunk partials
    (G, K, V) float32, read only where the first launch wrote them, and
    each tile's first stream entry (G, n_tiles + 1) int64."""
    n_tiles = -(-n_rows // R)
    return (torch.empty((G, K, V), dtype=torch.float32, device=device),
            torch.empty((G, n_tiles + 1), dtype=torch.int64, device=device))


def segment_sum_sorted_plain(vals, keys, n_rows: int):
    """Plain PyTorch version: one ``index_add_`` over the flattened groups.

    Args:
        vals: (G, VF, K) float32 values, samples last.
        keys: (G, K) int32 row ids in [0, n_rows), sorted per group.
    Returns:
        (G, VF, n_rows) float32 sums.
    """
    G, VF, K = vals.shape
    idx = keys.long() + n_rows * torch.arange(
        G, device=keys.device, dtype=torch.long
    )[:, None]
    out = vals.new_zeros(G * n_rows, VF)
    out.index_add_(0, idx.reshape(-1), vals.transpose(1, 2).reshape(G * K, VF))
    return out.view(G, n_rows, VF).transpose(1, 2)


def _check_args(vals, keys, n_rows: int):
    if vals.dtype != torch.float32 or keys.dtype != torch.int32:
        raise TypeError(
            f"segment_sum_sorted: want float32 vals and int32 keys, got "
            f"{vals.dtype} and {keys.dtype}"
        )
    if vals.dim() != 3 or keys.dim() != 2:
        raise ValueError(
            f"segment_sum_sorted: want vals (G, VF, K) and keys (G, K), got "
            f"{tuple(vals.shape)} and {tuple(keys.shape)}"
        )
    G, _, K = vals.shape
    if tuple(keys.shape) != (G, K):
        raise ValueError(
            f"segment_sum_sorted: keys {tuple(keys.shape)} do not match "
            f"vals {tuple(vals.shape)}"
        )
    if vals.device != keys.device:
        raise ValueError(
            f"segment_sum_sorted: vals on {vals.device}, keys on {keys.device}"
        )
    if not 0 <= n_rows < 2**31 - 1:
        raise ValueError(f"segment_sum_sorted: bad n_rows {n_rows}")


def _segment_sum_sorted_cuda(vals, keys, n_rows: int):
    G, VF, K = vals.shape
    if VF not in KERNEL_WIDTHS:
        raise ValueError(
            f"segment_sum_sorted: VF={VF} has no kernel (have {KERNEL_WIDTHS})"
        )
    if not (vals.is_contiguous() and keys.is_contiguous()):
        raise ValueError("segment_sum_sorted: vals and keys must be contiguous")
    out = torch.empty((G, VF, n_rows), dtype=torch.float32, device=vals.device)
    part, starts = _tile_scratch(G, K, VF, n_rows, tile_rows(VF), vals.device)
    err = _build.library().vn_segment_sum_sorted(
        vals.data_ptr(), keys.data_ptr(), out.data_ptr(), part.data_ptr(),
        starts.data_ptr(), G, VF, K, n_rows,
        torch.cuda.current_stream(vals.device).cuda_stream,
    )
    _build.check(err, "vn_segment_sum_sorted")
    segment_sum_sorted.launches += 1
    return out


def segment_sum_sorted(vals, keys, n_rows: int):
    """``out[g, f, r] = sum_{i: keys[g, i] == r} vals[g, f, i]``.

    A CUDA tensor launches ``csrc/segment_sum.cu`` (or raises); a CPU
    tensor takes :func:`segment_sum_sorted_plain`.  ``.launches`` counts
    the calls that launched the kernel (two launches each).

    Args:
        vals: (G, VF, K) float32, each group sorted by its key.
        keys: (G, K) int32 sorted row ids in [0, n_rows).
    Returns:
        (G, VF, n_rows) float32 sums.
    """
    _check_args(vals, keys, n_rows)
    if vals.is_cuda:
        return _segment_sum_sorted_cuda(vals, keys, n_rows)
    if vals.device.type == "cpu":
        return segment_sum_sorted_plain(vals, keys, n_rows)
    raise ValueError(f"segment_sum_sorted: unsupported device {vals.device}")


segment_sum_sorted.launches = 0
register(segment_sum_sorted)


# ------------------------------------------------------- row-major streams
def group_segment_sum_t_sorted_plain(sv, sk, n_rows: int, out=None):
    """Plain PyTorch version: one ``index_add_`` over the flattened groups.

    Args:
        sv: (G, K, F) float32 values, each group sorted by its key.
        sk: (G, K) int32 row ids in [0, n_rows), sorted per group.
        out: optional contiguous (G, n_rows, F) float32 storage, zeroed and
            summed into.
    Returns:
        (G, F, n_rows) float32 sums: the transposed view of (G, n_rows, F)
        storage (``out`` where given).
    """
    G, K, F = sv.shape
    idx = sk.long() + n_rows * torch.arange(
        G, device=sk.device, dtype=torch.long
    )[:, None]
    if out is None:
        out = sv.new_zeros(G, n_rows, F)
    else:
        out.zero_()
    out.view(G * n_rows, F).index_add_(0, idx.reshape(-1), sv.reshape(G * K, F))
    return out.transpose(1, 2)


def _check_rows_args(sv, sk, n_rows: int, out):
    name = "group_segment_sum_t_sorted"
    if sv.dtype != torch.float32 or sk.dtype != torch.int32:
        raise TypeError(
            f"{name}: want float32 values and int32 keys, got {sv.dtype} and "
            f"{sk.dtype}"
        )
    if sv.dim() != 3 or sk.dim() != 2 or tuple(sk.shape) != tuple(sv.shape[:2]):
        raise ValueError(
            f"{name}: want values (G, K, F) and keys (G, K), got "
            f"{tuple(sv.shape)} and {tuple(sk.shape)}"
        )
    if sv.device != sk.device:
        raise ValueError(f"{name}: values on {sv.device}, keys on {sk.device}")
    if not 0 <= n_rows < 2**31 - 1:
        raise ValueError(f"{name}: bad n_rows {n_rows}")
    if out is not None:
        G, _, F = sv.shape
        if (out.dtype != torch.float32 or tuple(out.shape) != (G, n_rows, F)
                or not out.is_contiguous() or out.device != sv.device):
            raise ValueError(
                f"{name}: out must be contiguous float32 ({G}, {n_rows}, {F}) "
                f"on {sv.device}, got {out.dtype} {tuple(out.shape)} on "
                f"{out.device}"
            )


def _group_segment_sum_t_sorted_cuda(sv, sk, n_rows: int, out):
    G, K, F = sv.shape
    if F not in ROW_KERNEL_WIDTHS:
        raise ValueError(
            f"group_segment_sum_t_sorted: F={F} has no kernel (have "
            f"{ROW_KERNEL_WIDTHS})"
        )
    if not (sv.is_contiguous() and sk.is_contiguous()):
        raise ValueError("group_segment_sum_t_sorted: values and keys must be "
                         "contiguous")
    if sv.data_ptr() % (4 * F):
        sv = sv.clone()  # the loader reads an entry's F floats as one vector
    dev, lib = sv.device, _build.library()
    if out is None:
        out = torch.empty((G, n_rows, F), dtype=torch.float32, device=dev)
    dense = row_tiles_dense(F, K, n_rows)
    # the tile rows of the library that runs (row_tile_rows for the port's
    # own; a card test compares them)
    part, starts = _tile_scratch(G, K, F, n_rows,
                                 lib.vn_segment_rows_tile_rows(F, dense), dev)
    err = lib.vn_segment_sum_rows(
        sv.data_ptr(), sk.data_ptr(), out.data_ptr(), part.data_ptr(),
        starts.data_ptr(), G, F, K, n_rows, int(dense),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "vn_segment_sum_rows")
    group_segment_sum_t_sorted.launches += 1
    return out.transpose(1, 2)


def group_segment_sum_t_sorted(sv, sk, n_rows: int, out=None):
    """``out[g, f, r] = sum_{i: sk[g, i] == r} sv[g, i, f]``.

    A CUDA tensor launches ``csrc/segment_sum_rows.cu`` (or raises); a CPU
    tensor takes :func:`group_segment_sum_t_sorted_plain`.  ``.launches``
    counts the calls that launched the kernel (two launches each).

    Args:
        sv: (G, K, F) float32 values, each group sorted by its key.
        sk: (G, K) int32 sorted row ids in [0, n_rows).
        out: optional contiguous (G, n_rows, F) float32 storage to write
            (every element is written), e.g. a block of a table gradient.
    Returns:
        (G, F, n_rows) float32 sums, the table axis last as in JAX: the
        transposed view of (G, n_rows, F) storage (``out`` where given).
    """
    _check_rows_args(sv, sk, n_rows, out)
    if sv.is_cuda:
        return _group_segment_sum_t_sorted_cuda(sv, sk, n_rows, out)
    if sv.device.type == "cpu":
        return group_segment_sum_t_sorted_plain(sv, sk, n_rows, out)
    raise ValueError(f"group_segment_sum_t_sorted: unsupported device {sv.device}")


group_segment_sum_t_sorted.launches = 0
register(group_segment_sum_t_sorted)


def group_segment_sum_t(vals, keys, n_rows: int):
    """Dense per-row sums of a group of unsorted streams, transposed.

    Sorts each group's keys (a stable sort: equal keys keep their order, so
    the sums are deterministic), permutes the values into key order and
    calls :func:`group_segment_sum_t_sorted`.

    Args:
        vals: (G, K, F) float32 values.
        keys: (G, K) int32 row ids in [0, n_rows).
    Returns:
        (G, F, n_rows) float32 sums.
    """
    sk, perm = torch.sort(keys, dim=1, stable=True)
    sv = torch.take_along_dim(vals, perm[:, :, None], dim=1)
    return group_segment_sum_t_sorted(sv.contiguous(), sk.contiguous(), n_rows)


def windowed_segment_sum(sv, sk, n_rows: int):
    """Dense per-row sums of one key-sorted stream.

    Args:
        sv: (K, F) float32 values, sorted by key.
        sk: (K,) int32 sorted row ids in [0, n_rows).
    Returns:
        (n_rows, F) float32 sums.
    """
    return group_segment_sum_t_sorted(sv[None], sk[None], n_rows)[0].t()


# ------------------------------------------------------ fused factor streams
def factor_products(wgt, feat_dim: int):
    """The (G, 8F, K) values of a factor stream in F-major row order,
    ``V[f*8 + c] = w[c] * g[f]``, multiplied in the factors' dtype (a bf16
    product is rounded to bf16, as the JAX fallback's is,
    segment_sum_pallas.py:524-530)."""
    w = wgt[:, :8]
    return torch.cat([w * wgt[:, 8 + f:9 + f] for f in range(feat_dim)], dim=1)


def group_segment_sum_tsf_sorted_plain(wgt, sk, n_rows: int, feat_dim: int):
    """Plain PyTorch version: the products, then one ``index_add_`` in
    float32 (:func:`segment_sum_sorted_plain`).

    Args:
        wgt: (G, 8 + F, K) float32 or bf16 factors, each group sorted by
            its key: rows 0..7 corner weights, rows 8..8+F gradients.
        sk: (G, K) int32 row ids in [0, n_rows), sorted per group.
    Returns:
        (G, 8F, n_rows) float32 sums, F-major rows (row f*8 + c).
    """
    return segment_sum_sorted_plain(
        factor_products(wgt, feat_dim).float(), sk, n_rows
    )


def _check_factor_args(wgt, sk, n_rows: int, feat_dim: int):
    name = "group_segment_sum_tsf_sorted"
    if wgt.dtype not in (torch.float32, torch.bfloat16) or sk.dtype != torch.int32:
        raise TypeError(
            f"{name}: want float32 or bf16 factors and int32 keys, got "
            f"{wgt.dtype} and {sk.dtype}"
        )
    if (wgt.dim() != 3 or sk.dim() != 2 or wgt.shape[1] != 8 + feat_dim
            or tuple(sk.shape) != (wgt.shape[0], wgt.shape[2])):
        raise ValueError(
            f"{name}: want factors (G, 8 + {feat_dim}, K) and keys (G, K), "
            f"got {tuple(wgt.shape)} and {tuple(sk.shape)}"
        )
    if wgt.device != sk.device:
        raise ValueError(f"{name}: factors on {wgt.device}, keys on {sk.device}")
    if not 0 <= n_rows < 2**31 - 1:
        raise ValueError(f"{name}: bad n_rows {n_rows}")


def _group_segment_sum_tsf_sorted_cuda(wgt, sk, n_rows: int, feat_dim: int):
    G, _, K = wgt.shape
    if feat_dim not in FACTOR_KERNEL_FEATS:
        raise ValueError(
            f"group_segment_sum_tsf_sorted: F={feat_dim} has no kernel (have "
            f"{FACTOR_KERNEL_FEATS})"
        )
    if not (wgt.is_contiguous() and sk.is_contiguous()):
        raise ValueError("group_segment_sum_tsf_sorted: factors and keys must "
                         "be contiguous")
    dev, V = wgt.device, 8 * feat_dim
    out = torch.empty((G, V, n_rows), dtype=torch.float32, device=dev)
    part, starts = _tile_scratch(G, K, V, n_rows, tile_rows(V), dev)
    err = _build.library().vn_segment_sum_factors(
        wgt.data_ptr(), int(wgt.dtype == torch.bfloat16), sk.data_ptr(),
        out.data_ptr(), part.data_ptr(), starts.data_ptr(), G, feat_dim, K,
        n_rows, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "vn_segment_sum_factors")
    group_segment_sum_tsf_sorted.launches += 1
    return out


def group_segment_sum_tsf_sorted(wgt, sk, n_rows: int, feat_dim: int):
    """``out[g, f*8 + c, r] = sum_{i: sk[g, i] == r} w[g, c, i] * g[g, f, i]``
    over a sorted factor stream ``wgt = [w (8 rows); g (F rows)]``.

    A CUDA tensor launches ``csrc/segment_sum_factors.cu`` (or raises); a
    CPU tensor takes :func:`group_segment_sum_tsf_sorted_plain`.
    ``.launches`` counts the calls that launched the kernel (two launches
    each).

    Args:
        wgt: (G, 8 + F, K) float32 or bf16 factors, each group sorted by
            its key.
        sk: (G, K) int32 sorted row ids in [0, n_rows).
    Returns:
        (G, 8F, n_rows) float32 sums, F-major rows (row f*8 + c).
    """
    _check_factor_args(wgt, sk, n_rows, feat_dim)
    if wgt.is_cuda:
        return _group_segment_sum_tsf_sorted_cuda(wgt, sk, n_rows, feat_dim)
    if wgt.device.type == "cpu":
        return group_segment_sum_tsf_sorted_plain(wgt, sk, n_rows, feat_dim)
    raise ValueError(
        f"group_segment_sum_tsf_sorted: unsupported device {wgt.device}"
    )


group_segment_sum_tsf_sorted.launches = 0
register(group_segment_sum_tsf_sorted)
