"""The collectives of a data-parallel step over a ``torch.distributed``
process group.

Counterparts of the ``jax.lax`` collectives the JAX package threads
through its step bodies under an ``axis_name`` (training/trainer.py:277-322,
grids/occupancy_grid.py:229-231, 313-316).  Every function takes the
``group`` (None: one process, and then does nothing) and works on the
gloo (CPU tensors) and NCCL (CUDA tensors) backends.  A sum over a group
leaves the same value on every rank, so replicated state stays
bit-identical.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch
import torch.distributed as dist

# metrics summed over the ranks (sample counts); every other one is
# averaged (trainer.py:294-299)
SUMMED_METRICS = ("rm_samples", "vr_samples", "overflow")


def world_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_sum_(t: torch.Tensor, group) -> torch.Tensor:
    """``psum``, in place."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_reduce_mean_(t: torch.Tensor, group) -> torch.Tensor:
    """``pmean``, in place: the sum over the ranks over their number."""
    n = world_size(group)
    all_reduce_sum_(t, group)
    if n > 1:
        t.div_(n)
    return t


def all_reduce_grads_mean_(params: Iterable[torch.Tensor], group) -> None:
    """Every parameter's gradient to its mean over the ranks, in place.  A
    bf16 gradient (the ``bfloat16`` mode's table) is reduced in float32 and
    rounded back once."""
    if group is None:
        return
    for p in params:
        if p.grad is None:
            continue
        if p.grad.dtype == torch.float32:
            all_reduce_mean_(p.grad, group)
        else:
            p.grad.copy_(all_reduce_mean_(p.grad.float(), group))


def reduce_metrics(metrics: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """One all-reduce of a step's 0-dim metrics (in float64, which holds
    every float32 value and count exactly): sums for the sample counts,
    means for the rest, each back in its own dtype."""
    if group is None:
        return metrics
    keys = list(metrics)
    vals = torch.stack([metrics[k].double() for k in keys])
    all_reduce_sum_(vals, group)
    n = world_size(group)
    return {k: (v if k in SUMMED_METRICS else v / n).to(metrics[k].dtype)
            for k, v in zip(keys, vals)}


def all_gather_cat(t: torch.Tensor, group) -> torch.Tensor:
    """``all_gather(..., tiled=True)``: every rank's tensor, concatenated
    along the first axis in rank order."""
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)
