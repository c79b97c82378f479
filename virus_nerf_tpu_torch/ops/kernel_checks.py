"""The kernels held against their plain versions on the card, once each at
one shape: the counterpart of ``bench.py:43-280`` (``check_kernels``, the
JAX package's on-chip kernel CI), which the port's bench reports as
``kernels_ok``.

B1 (``segment_sum_sorted``), B3 (``group_segment_sum_t_sorted``) and B4
(``group_segment_sum_tsf_sorted``) on bench.py's windowed-sum case (two
groups of 8,192 sorted keys over 2^14 rows, the second skewed into 900
rows) within bench.py's 1e-3; B5 (``widen_slabs_group``) on its
widen-pack case and L1 (``march_select``) on a bench-shaped march, bit for
bit; B2 (``adam_update_leaves_``) on a 2^21-element leaf within 1e-6.
Inputs come from a seeded generator on the card.
"""

from __future__ import annotations

import torch

from virus_nerf_tpu_torch.ops.fused_adam import (
    adam_hyper,
    adam_scal,
    adam_update_leaves_,
    adam_update_leaves_plain_,
)
from virus_nerf_tpu_torch.ops.intersection import ray_aabb_intersect
from virus_nerf_tpu_torch.ops.ray_march import march_select, march_select_plain
from virus_nerf_tpu_torch.ops.segment_sum import (
    group_segment_sum_t_sorted,
    group_segment_sum_t_sorted_plain,
    group_segment_sum_tsf_sorted,
    group_segment_sum_tsf_sorted_plain,
    segment_sum_sorted,
    segment_sum_sorted_plain,
)
from virus_nerf_tpu_torch.ops.widen import (
    widen_slabs_group,
    widen_slabs_group_plain,
)


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_kernels(device="cuda", log=print) -> bool:
    """Every kernel of the port against its plain version on ``device`` (a
    card: on the CPU the wrappers are their plain versions); ``log``
    gets a line for each mismatch.  True when all agree."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"check_kernels: the kernels run on a card, not {device}")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    results = {}

    # the windowed segment sum's case (bench.py:143-150)
    G, K, R = 2, 8192, 2**14
    keys = torch.randint(0, R, (G, K), generator=gen, device=device)
    keys[1] = torch.randint(1000, 1900, (K,), generator=gen, device=device)
    keys = keys.sort(dim=1).values.to(torch.int32)
    vals = torch.randn((G, 16, K), generator=gen, device=device)
    results["B1 segment_sum_sorted"] = _max_err(
        segment_sum_sorted(vals, keys, R), segment_sum_sorted_plain(vals, keys, R)
    ) <= 1e-3
    rows = torch.randn((G, K, 8), generator=gen, device=device)
    results["B3 group_segment_sum_t_sorted"] = _max_err(
        group_segment_sum_t_sorted(rows, keys, R),
        group_segment_sum_t_sorted_plain(rows, keys, R),
    ) <= 1e-3
    wgt = torch.randn((G, 10, K), generator=gen, device=device).to(torch.bfloat16)
    results["B4 group_segment_sum_tsf_sorted"] = _max_err(
        group_segment_sum_tsf_sorted(wgt, keys, R, 2),
        group_segment_sum_tsf_sorted_plain(wgt, keys, R, 2),
    ) <= 1e-3

    # the widen-pack case (bench.py:224-262), bit for bit
    size, groups, offs = 2 * 8192, 2, (0, 1, 37, 38, 1369, 1370, 1406, 1407)
    table = torch.randn((64 + groups * size + 16, 2), generator=gen,
                        device=device)
    results["B5 widen_slabs_group"] = torch.equal(
        widen_slabs_group(table, 64, size, groups, offs),
        widen_slabs_group_plain(table, 64, size, groups, offs),
    )

    # fused Adam on one 2^21 leaf (bench.py:265-278)
    n = 1 << 21
    leaf = (torch.randn(n, generator=gen, device=device),
            torch.randn(n, generator=gen, device=device),
            torch.randn(n, generator=gen, device=device) * 0.1,
            torch.rand(n, generator=gen, device=device) * 0.01)
    scal = adam_scal(torch.ones((), dtype=torch.int32, device=device),
                     adam_hyper(1e-2, 0.9, 0.999, device))
    got, want = ([tuple(x.clone() for x in leaf)] for _ in range(2))
    adam_update_leaves_(got, scal, 0.9, 0.999, 1e-15)
    adam_update_leaves_plain_(want, scal, 0.9, 0.999, 1e-15)
    results["B2 adam_update_leaves_"] = max(
        _max_err(a, b) for a, b in zip(got[0], want[0])) <= 1e-6

    # the fused march on the bench's shapes: 4096 rays from inside the
    # cube, K = 1024 candidates, S = 128, a 128^3 grid a quarter occupied
    n_rays, scale = 4096, 0.5
    rays_o = (torch.rand((n_rays, 3), generator=gen, device=device) - 0.5) * 0.5
    rays_d = torch.nn.functional.normalize(
        torch.randn((n_rays, 3), generator=gen, device=device), dim=-1)
    hits = ray_aabb_intersect(rays_o, rays_d, scale)
    t1, t2 = hits.t().contiguous()
    noise = torch.rand(n_rays, generator=gen, device=device)
    grid = torch.rand((1, 128**3), generator=gen, device=device) < 0.25
    kw = dict(cascades=1, grid_size=128, scale=scale, exp_step_factor=0.0,
              max_samples=128, n_candidates=1024)
    results["L1 march_select"] = all(
        torch.equal(a, b) for a, b in zip(
            march_select(rays_o, rays_d, t1, t2, noise, grid, **kw),
            march_select_plain(rays_o, rays_d, t1, t2, noise, grid, **kw)))
    torch.cuda.synchronize(device)
    for name, ok in results.items():
        if not ok:
            log(f"# {name} disagrees with its plain version")
    return all(results.values())
