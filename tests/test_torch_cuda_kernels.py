"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  This
file imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from virus_nerf_tpu_torch.ops.fused_adam import (
    ADAM_CHUNK,
    ADAM_MAX_LEAVES,
    FusedAdam,
    adam_hyper,
    adam_scal,
    adam_update_,
    adam_update_leaves_,
    adam_update_plain_,
)
from virus_nerf_tpu_torch.ops import _build, hash_encoder, widen
from virus_nerf_tpu_torch.ops import ray_march
from virus_nerf_tpu_torch.ops.intersection import ray_aabb_intersect
from virus_nerf_tpu_torch.ops.ray_march import (
    march_lattice,
    march_lattice_plain,
    march_rays_train,
    march_select,
    march_select_plain,
)
from virus_nerf_tpu_torch.ops import segment_sum as tss
from virus_nerf_tpu_torch.ops.segment_sum import (
    factor_products,
    group_segment_sum_t_sorted,
    group_segment_sum_t_sorted_plain,
    group_segment_sum_tsf_sorted,
    group_segment_sum_tsf_sorted_plain,
    segment_sum_sorted,
    segment_sum_sorted_plain,
)


def _scal(count, device):
    """The fused Adam's (3,) scal at a step count, on the card."""
    return adam_scal(torch.tensor(count, dtype=torch.int32, device=device),
                     adam_hyper(1e-2, 0.9, 0.999, device))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _one_row_keys(gen, dev, K=917504, hot=700000, R=524288):
    """(1, K) sorted keys of which ``hot`` fall on one row."""
    k = torch.randint(0, R, (1, K), generator=gen, device=dev)
    k[0, :hot] = R // 3
    return torch.sort(k, dim=1).values


def _out_of_range_keys(gen, dev, R):
    """(2, 30000) sorted keys, none in [0, R)."""
    k = torch.cat([torch.randint(-5000, 0, (2, 10000), generator=gen, device=dev),
                   torch.randint(R, R + 900, (2, 20000), generator=gen, device=dev)],
                  dim=1)
    return torch.sort(k, dim=1).values


def _segment_case(name, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)

    def keys(G, K, lo, hi):
        return torch.sort(torch.randint(lo, hi, (G, K), generator=gen,
                                        device=dev), dim=1).values

    if name == "skewed":  # empty rows around one dense band
        k, R = keys(2, 8192, 1000, 1900), 2**14
    elif name == "padded_rows":
        k, R = keys(1, 4096, 0, 9264), 9264
    elif name == "odd_blocks":
        k, R = keys(3, 16384, 0, 3 * 2048), 3 * 2048
    elif name == "one_row":  # one row holds 700,000 of 917,504 entries
        k, R = _one_row_keys(gen, dev), 524288
    elif name == "out_of_range":  # every key outside [0, n_rows)
        k, R = _out_of_range_keys(gen, dev, 4096), 4096
    elif name == "windowed":  # bench.py's case: the second group in 900 rows
        k = torch.cat([keys(1, 8192, 0, 2**14), keys(1, 8192, 1000, 1900)])
        R = 2**14
    else:  # hashed group at the bench slice's shape
        k, R = keys(5, 114688, 0, 524288), 524288
    VF = {"hashed_group": 32, "one_row": 32, "out_of_range": 64}.get(name, 16)
    vals = torch.randn((k.shape[0], VF, k.shape[1]), generator=gen, device=dev)
    return vals, k.to(torch.int32).contiguous(), R


def _row_tolerance(terms, keys, R):
    """float64 sums of the (G, V, K) terms and the per-row float32 bound
    4 * eps32 * sqrt(n) * sum|v| (chip_smoke's), over the keys in range."""
    ok = (keys >= 0) & (keys < R)
    k = torch.where(ok, keys, 0)
    t = terms.double() * ok[:, None]
    exact = segment_sum_sorted_plain(t, k, R)
    mag = segment_sum_sorted_plain(t.abs(), k, R)
    counts = torch.stack([torch.bincount(k[g][ok[g]].long(), minlength=R)
                          for g in range(keys.shape[0])]).double()
    return exact, 4 * torch.finfo(torch.float32).eps * counts.sqrt()[:, None] * mag, mag


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["skewed", "padded_rows", "odd_blocks",
                                  "hashed_group", "one_row", "out_of_range",
                                  "windowed"])
def test_segment_sum_kernel_matches_plain(cuda_device, name):
    vals, keys, R = _segment_case(name, cuda_device)
    before = segment_sum_sorted.launches
    got = segment_sum_sorted(vals, keys, R)
    torch.cuda.synchronize()
    assert segment_sum_sorted.launches == before + 1
    exact, tol, mag = _row_tolerance(vals, keys, R)
    assert got.shape == exact.shape
    assert bool(((got.double() - exact).abs() <= tol).all())
    if name == "one_row":
        want = segment_sum_sorted_plain(vals, keys, R)
        assert bool(((want.double() - exact).abs() <= tol).all())
    elif name != "out_of_range":  # the plain index_add_ takes keys in range
        want = segment_sum_sorted_plain(vals, keys, R)
        # float32 sums of a few N(0,1) values per row, in another order
        # (the plain index_add_ accumulates with atomics on the card)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=0, atol=1e-5)
    assert bool((got[mag == 0] == 0).all())  # rows no key hits are 0
    # deterministic: no atomics
    assert torch.equal(got, segment_sum_sorted(vals, keys, R))


@pytest.mark.cuda
def test_segment_tiles_constants_match_the_kernels(cuda_device):
    lib = _build.library()
    assert (lib.vn_segment_tiles_short_window(), lib.vn_segment_tiles_chunk(),
            lib.vn_segment_tiles_planes(), lib.vn_segment_tiles_scan_planes()
            ) == (tss.SHORT_WINDOW, tss.TILE_CHUNK, tss.TILE_PLANES,
                  tss.SCAN_PLANES)
    widths = set(tss.KERNEL_WIDTHS) | {8 * F for F in tss.FACTOR_KERNEL_FEATS}
    for V in sorted(widths):
        assert lib.vn_segment_tiles_rows(V) == tss.tile_rows(V)


@pytest.mark.cuda
def test_segment_sum_kernel_rejects_unsupported_width(cuda_device):
    vals = torch.zeros((1, 12, 8), device=cuda_device)
    keys = torch.zeros((1, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        segment_sum_sorted(vals, keys, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1 << 21, 11195232])
def test_fused_adam_kernel_matches_plain(cuda_device, n):
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(2)
    p, g = (torch.randn(n, generator=gen, device=cuda_device) for _ in range(2))
    mu = torch.randn(n, generator=gen, device=cuda_device) * 0.1
    nu = torch.rand(n, generator=gen, device=cuda_device) * 0.01
    args = (_scal(5, cuda_device), 0.9, 0.999, 1e-15)
    a = [x.clone() for x in (p, mu, nu)]
    b = [x.clone() for x in (p, mu, nu)]
    before = adam_update_leaves_.launches
    adam_update_(a[0], g, a[1], a[2], *args)
    adam_update_plain_(b[0], g, b[1], b[2], *args)
    torch.cuda.synchronize()
    assert adam_update_leaves_.launches == before + 1
    for x, y in zip(a, b):
        # the same float32 operations in the same order on the same scal
        # tensor; 1e-6 is the bench's gate for the TPU kernel (bench.py:276)
        np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(),
                                   rtol=0, atol=1e-6)


def _rows_case(name, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)

    def keys(G, K, lo, hi):
        return torch.sort(torch.randint(lo, hi, (G, K), generator=gen,
                                        device=dev), dim=1).values

    if name == "uniform":
        k, R = keys(2, 50000, 0, 20000), 20000
    elif name == "skewed":  # one row holds most of the stream
        k = keys(1, 100000, 0, 4096)
        k[0, 1000:90000] = 17
        k, R = torch.sort(k, dim=1).values, 4096
    elif name == "padded_rows":  # trailing rows no key hits
        k, R = keys(1, 7777, 0, 4096), 4920
    elif name == "odd_groups":
        k, R = keys(3, 1001, 0, 300), 300
    elif name == "windowed":  # bench.py's case: the second group in 900 rows
        k = torch.cat([keys(1, 8192, 0, 2**14), keys(1, 8192, 1000, 1900)])
        R = 2**14
    else:  # the XOR path's hashed group
        k, R = keys(10, 917504, 0, 524288), 524288
    width = 8 if name == "windowed" else 2
    vals = torch.randn((k.shape[0], k.shape[1], width), generator=gen,
                       device=dev)
    return vals, k.to(torch.int32).contiguous(), R


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["uniform", "skewed", "padded_rows",
                                  "odd_groups", "hashed_group", "windowed"])
def test_segment_sum_rows_kernel_matches_plain(cuda_device, name):
    vals, keys, R = _rows_case(name, cuda_device)
    before = group_segment_sum_t_sorted.launches
    got = group_segment_sum_t_sorted(vals, keys, R)
    want = group_segment_sum_t_sorted_plain(vals, keys, R)
    exact = group_segment_sum_t_sorted_plain(vals.double(), keys, R)
    torch.cuda.synchronize()
    assert group_segment_sum_t_sorted.launches == before + 1
    assert got.shape == want.shape
    # float32 sums in another order (the plain index_add_ accumulates with
    # atomics): within 4 * eps32 * sqrt(n) * sum|v| of the float64 sum
    counts = torch.stack([torch.bincount(keys[g].long(), minlength=R)
                          for g in range(keys.shape[0])]).double()
    mag = group_segment_sum_t_sorted_plain(vals.abs().double(), keys, R)
    tol = 4 * torch.finfo(torch.float32).eps * counts.sqrt()[:, None] * mag
    assert bool(((got.double() - exact).abs() <= tol).all())
    assert bool(((want.double() - exact).abs() <= tol).all())
    assert bool((got[mag == 0] == 0).all())  # rows no key hits are 0
    # deterministic: no atomics
    assert torch.equal(got, group_segment_sum_t_sorted(vals, keys, R))


@pytest.mark.cuda
def test_segment_rows_constants_match_the_kernel(cuda_device):
    lib = _build.library()
    assert lib.vn_segment_rows_short_window() == tss.ROW_SHORT_WINDOW
    for F in tss.ROW_KERNEL_WIDTHS:
        for dense in (False, True):
            assert lib.vn_segment_rows_tile_rows(F, int(dense)) == tss.row_tile_rows(F, dense)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [1, 2, 4, 8])
@pytest.mark.parametrize("lead", [0, 1])
@pytest.mark.parametrize("dense", [False, True])
def test_segment_sum_rows_kernel_writes_its_out_block(cuda_device, F, lead, dense):
    # the block of a larger buffer, after `lead` rows (lead 1 at F = 1 puts
    # it off a 16-byte boundary); two groups over a ragged last tile, with
    # a long window on one row and rows no key hits; sparse or dense tiles
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(13)
    G, R = 2, 2 * tss.row_tile_rows(F, dense) + 37
    K = 40000 if dense else 400
    assert tss.row_tiles_dense(F, K, R) == dense
    k = torch.randint(0, R - 50, (G, K), generator=gen, device=cuda_device)
    k[1, :K // 2] = 5
    keys = torch.sort(k, dim=1).values.to(torch.int32).contiguous()
    vals = torch.randn((G, K, F), generator=gen, device=cuda_device)
    buf = torch.full((lead + G * R + 3, F), float("nan"), device=cuda_device)
    block = buf[lead:lead + G * R].view(G, R, F)
    before = group_segment_sum_t_sorted.launches
    got = group_segment_sum_t_sorted(vals, keys, R, out=block)
    want = group_segment_sum_t_sorted(vals, keys, R)
    torch.cuda.synchronize()
    assert group_segment_sum_t_sorted.launches == before + 2
    # the result is the block itself, seen as (G, F, R)
    assert got.data_ptr() == block.data_ptr() and got.stride() == (R * F, 1, F)
    assert torch.equal(got, want)  # deterministic, whatever the alignment
    assert bool(buf[:lead].isnan().all()) and bool(buf[lead + G * R:].isnan().all())
    exact = group_segment_sum_t_sorted_plain(vals.double(), keys, R)
    counts = torch.stack([torch.bincount(keys[g].long(), minlength=R)
                          for g in range(G)]).double()
    mag = group_segment_sum_t_sorted_plain(vals.abs().double(), keys, R)
    tol = 4 * torch.finfo(torch.float32).eps * counts.sqrt()[:, None] * mag
    assert bool(((got.double() - exact).abs() <= tol).all())
    assert bool((got[mag == 0] == 0).all())  # rows no key hits are 0


@pytest.mark.cuda
def test_segment_sum_rows_kernel_rejects_unsupported_width(cuda_device):
    vals = torch.zeros((1, 8, 3), device=cuda_device)
    keys = torch.zeros((1, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        group_segment_sum_t_sorted(vals, keys, 4)


@pytest.mark.cuda
def test_xor_hash_encode_on_card_matches_cpu(cuda_device):
    spec = hash_encoder.HashGridSpec.create(levels=16, feat_dim=2,
                                            max_res=1024, max_params=2**14)
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.random((spec.total_rows, 2), np.float32))
    xyz = torch.from_numpy(rng.uniform(-0.03, 1.03, (4096, 3)).astype(np.float32))
    gout = torch.from_numpy(rng.standard_normal((4096, 32)).astype(np.float32))
    outs = []
    for dev in ("cpu", cuda_device):
        t = table.to(dev).detach().requires_grad_(True)
        out = hash_encoder.hash_encode_xor(t, xyz.to(dev), spec)
        out.backward(gout.to(dev))
        outs.append((out.detach().cpu(), t.grad.cpu()))
    # the same rows; float32 combines and row sums in another order
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["uniform", "skewed", "padded_rows",
                                  "odd_groups", "hashed_group", "one_row",
                                  "out_of_range", "windowed"])
def test_segment_sum_factors_kernel_matches_plain(cuda_device, name, dtype):
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(13)
    if name == "one_row":  # one row holds 700,000 of 917,504 entries
        keys, R = _one_row_keys(gen, cuda_device).to(torch.int32), 524288
    elif name == "out_of_range":  # every key outside [0, n_rows)
        keys, R = _out_of_range_keys(gen, cuda_device, 4096).to(torch.int32), 4096
    else:
        _, keys, R = _rows_case(name, cuda_device)
    G, K = keys.shape
    wgt = torch.cat([torch.rand((G, 8, K), generator=gen, device=cuda_device),
                     torch.randn((G, 2, K), generator=gen, device=cuda_device)],
                    dim=1).to(dtype)
    before = group_segment_sum_tsf_sorted.launches
    got = group_segment_sum_tsf_sorted(wgt, keys, R, 2)
    V = factor_products(wgt, 2)  # the products as the factor dtype rounds them
    torch.cuda.synchronize()
    assert group_segment_sum_tsf_sorted.launches == before + 1
    assert got.shape == (G, 16, R)
    # float32 sums of the same products in another order: within
    # 4 * eps32 * sqrt(n) * sum|v| of the float64 sum of those products
    exact, tol, mag = _row_tolerance(V, keys, R)
    assert bool(((got.double() - exact).abs() <= tol).all())
    if name != "out_of_range":  # the plain index_add_ takes keys in range
        want = group_segment_sum_tsf_sorted_plain(wgt, keys, R, 2)
        assert bool(((want.double() - exact).abs() <= tol).all())
    assert bool((got[mag == 0] == 0).all())  # rows no key hits are 0
    assert torch.equal(got, group_segment_sum_tsf_sorted(wgt, keys, R, 2))


@pytest.mark.cuda
def test_segment_sum_factors_kernel_rejects_unsupported_features(cuda_device):
    wgt = torch.zeros((1, 11, 8), device=cuda_device)
    keys = torch.zeros((1, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        group_segment_sum_tsf_sorted(wgt, keys, 4, 3)


# (rows a level, levels, first row, rows past the group, corner offsets)
WIDEN_GROUPS = {
    # a group of 10 levels of 2^16 rows at hashed-level corner offsets
    "levels": (1 << 16, 10, 4920, 77,
               [0, 1, 40503, 40504, 12437, 12438, 52940, 52941]),
    # bench.py's widen-pack case (:224-262)
    "pack": (2 * 8192, 2, 64, 16, [0, 1, 37, 38, 1369, 1370, 1406, 1407]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [1, 2, 4, 8])
@pytest.mark.parametrize("group", list(WIDEN_GROUPS))
def test_widen_slabs_kernel_is_bit_exact(cuda_device, group, F, dtype):
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(14)
    size, G, row0, tail, offs = WIDEN_GROUPS[group]
    table = (torch.randn((row0 + G * size + tail, F), generator=gen,
                         device=cuda_device) * 100).to(dtype)
    before = widen.widen_slabs_group.launches
    got = widen.widen_slabs_group(table, row0, size, G, offs)
    want = widen.widen_slabs_group_plain(table, row0, size, G, offs)
    torch.cuda.synchronize()
    assert widen.widen_slabs_group.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (G, size, 8, F)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
def test_fused_adam_kernel_on_bf16_parameters(cuda_device):
    n = 11420064  # the 16 x 2 table
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(15)
    p = torch.randn(n, generator=gen, device=cuda_device).to(torch.bfloat16)
    g = torch.randn(n, generator=gen, device=cuda_device)
    mu = torch.randn(n, generator=gen, device=cuda_device) * 0.1
    nu = torch.rand(n, generator=gen, device=cuda_device) * 0.01
    args = (_scal(5, cuda_device), 0.9, 0.999, 1e-15)
    a = [x.clone() for x in (p, mu, nu)]
    b = [x.clone() for x in (p, mu, nu)]
    before = adam_update_leaves_.launches
    adam_update_(a[0], g, a[1], a[2], *args)
    adam_update_plain_(b[0], g, b[1], b[2], *args)
    torch.cuda.synchronize()
    assert adam_update_leaves_.launches == before + 1
    assert a[0].dtype == torch.bfloat16
    # the moments as for float32; p rounds a float32 sum that may be an ulp
    # apart to bf16, so the two may be neighbouring bf16 values, no further
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(), rtol=0,
                                   atol=1e-6)

    assert _bf16_ulps(a[0], b[0]) <= 1


def _bf16_ulps(a, b):
    """The most bf16 values between a and b, elementwise."""
    def ordered(x):  # bf16 bit patterns in the order of the values
        i = x.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_leaves", [9, ADAM_MAX_LEAVES + 2])
def test_fused_adam_leaves_in_one_launch(cuda_device, n_leaves):
    # lengths 1, 3, 4, 1023, 2^20 + 5 and more; bf16 and float32 p in one
    # launch; leaves viewed from a misaligned start (scalar head), and one
    # whose arrays are out of phase (scalar chunks); one launch per
    # ADAM_MAX_LEAVES leaves
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(16)
    lengths = [1, 3, 4, 1023, (1 << 20) + 5, 2 * ADAM_CHUNK + 3, 5000, 4099, 64]
    lengths = (lengths * 3)[:n_leaves]

    def arr(n, start=0, scale=1.0, dtype=torch.float32):
        x = torch.randn(n + start, generator=gen, device=cuda_device) * scale
        return x.to(dtype)[start:]

    leaves = []
    for k, n in enumerate(lengths):
        start = 1 if k % 3 == 1 else 0  # a view one element in
        p = arr(n, start, dtype=torch.bfloat16 if k % 2 else torch.float32)
        # leaf 7: mu one element further in than the rest
        mu = arr(n, start + (k == 7), 0.1)
        leaves.append((p, arr(n, start), mu, arr(n, start).abs() * 0.01))
    want = [tuple(x.clone() for x in leaf) for leaf in leaves]
    args = (_scal(4, cuda_device), 0.9, 0.999, 1e-15)
    before = adam_update_leaves_.launches
    adam_update_leaves_(leaves, *args)
    for p, g, mu, nu in want:
        adam_update_plain_(p, g, mu, nu, *args)
    torch.cuda.synchronize()
    assert adam_update_leaves_.launches == before + -(-n_leaves // ADAM_MAX_LEAVES)
    for (p, _, mu, nu), (wp, _, wmu, wnu) in zip(leaves, want):
        # moments and a float32 p within 1e-6 (an ulp); a bf16 p within one
        # bf16 ulp (it rounds a float32 sum that may be an ulp apart)
        for x, y in ((mu, wmu), (nu, wnu)):
            np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(), rtol=0, atol=1e-6)
        if p.dtype == torch.float32:
            np.testing.assert_allclose(p.cpu().numpy(), wp.cpu().numpy(), rtol=0, atol=1e-6)
        else:
            assert _bf16_ulps(p, wp) <= 1


@pytest.mark.cuda
def test_fused_adam_step_is_one_launch(cuda_device):
    # FusedAdam on the card: one launch a step for a table and small
    # weights, each within the tolerances of the plain version
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(17)
    shapes = [(5000, 2), (64, 32), (16, 64), (3, 64)]
    ps = [torch.nn.Parameter(torch.randn(s, generator=gen, device=cuda_device))
          for s in shapes]
    ref = [p.detach().clone() for p in ps]
    mus = [torch.zeros_like(p) for p in ref]
    nus = [torch.zeros_like(p) for p in ref]
    opt = FusedAdam(ps, lr=1e-2, eps=1e-15)
    before = adam_update_leaves_.launches
    for step in range(1, 4):
        grads = [torch.randn(s, generator=gen, device=cuda_device) for s in shapes]
        for p, g in zip(ps, grads):
            p.grad = g
        opt.step()
        args = (_scal(step, cuda_device), 0.9, 0.999, 1e-15)
        for r, g, m, v in zip(ref, grads, mus, nus):
            adam_update_plain_(r, g, m, v, *args)
    torch.cuda.synchronize()
    assert adam_update_leaves_.launches == before + 3
    for p, r in zip(ps, ref):
        np.testing.assert_allclose(p.detach().cpu().numpy(), r.cpu().numpy(),
                                   rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_fused_adam_and_widen_constants_match_the_kernels(cuda_device):
    lib = _build.library()
    assert (lib.vn_fused_adam_max_leaves(), lib.vn_fused_adam_chunk()) == (
        ADAM_MAX_LEAVES, ADAM_CHUNK)
    assert lib.vn_widen_plane() == widen.WIDEN_PLANE
    for F in widen.WIDEN_KERNEL_FEATS:
        assert lib.vn_widen_tile_rows(F) == widen.widen_tile_rows(F)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_widen_slabs_kernel_ragged_tiles_and_wrap(cuda_device, F, dtype):
    # a size that is not a multiple of the tile rows, offsets that wrap, and
    # tables viewed from a row that leaves the 16-byte phase off 0
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(18)
    size, G, row0 = 3 * widen.widen_tile_rows(F) + 37, 3, 11
    offs = [(1 * (c & 1) + (size // 3 + 1) * (c >> 1 & 1) + (size - 2) * (c >> 2 & 1))
            % size for c in range(8)]
    base = (torch.randn((row0 + G * size + 8, F), generator=gen, device=cuda_device)
            * 100).to(dtype)
    tables = [base, base[1:], base[3:]]  # row views: other 16-byte phases
    if F > 1:  # a view one element in: not a multiple of F (copied first)
        flat = base.reshape(-1)
        tables.append(flat[1:1 + (base.shape[0] - 1) * F].view(-1, F))
    for skip, table in enumerate(tables):
        before = widen.widen_slabs_group.launches
        got = widen.widen_slabs_group(table, row0, size, G, offs)
        want = widen.widen_slabs_group_plain(table, row0, size, G, offs)
        torch.cuda.synchronize()
        assert widen.widen_slabs_group.launches == before + 1
        assert got.shape == (G, size, 8, F)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16)), skip


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slabs_factors_hash_encode_on_card_matches_cpu(cuda_device, dtype):
    spec = hash_encoder.HashGridSpec.create(levels=16, feat_dim=2,
                                            max_res=1024, max_params=2**17)
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.random((spec.total_rows, 2), np.float32))
    xyz = torch.from_numpy(rng.uniform(-0.03, 1.03, (4096, 3)).astype(np.float32))
    gout = torch.from_numpy(rng.standard_normal((4096, 32)).astype(np.float32))
    outs = []
    for dev in ("cpu", cuda_device):
        t = table.to(dev, dtype).detach().requires_grad_(True)
        out = hash_encoder.hash_encode(t, xyz.to(dev), spec, forward="slabs",
                                       backward="factors")
        out.backward(gout.to(dev))
        outs.append((out.detach().cpu(), t.grad.float().cpu()))
    # the same features; float32 combines and row sums in another order
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=0, atol=1e-6)
    tol = 1e-4 if dtype == torch.float32 else 2**-7
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=tol, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n, K, esf, gs, scale, res", [
    (4096, 1024, 1 / 256, 128, 1.0, 1024),  # the scale-1.0 bench march
    (77, 33, 0.01, 64, 2.0, 1024),  # ragged: a partial warp, a partial tile
    (300, 256, 0.003, 16, 0.75, 256),
])
def test_march_lattice_kernel_is_bit_exact(cuda_device, n, K, esf, gs, scale, res):
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(n)
    t1 = torch.rand(n, generator=gen, device=cuda_device) * 3.5 - 1.0
    t1[:3] = -1.0  # miss rays
    noise = torch.rand(n, generator=gen, device=cuda_device)
    before = march_lattice.launches
    ts, dts = march_lattice(t1, noise, esf, gs, scale, K, res)
    want_ts, want_dts = march_lattice_plain(t1, noise, esf, gs, scale, K, res)
    torch.cuda.synchronize()
    assert march_lattice.launches == before + 1
    assert torch.equal(ts, want_ts) and torch.equal(dts, want_dts)
    # and the CPU's plain version gives the same bits
    cpu_ts, cpu_dts = march_lattice_plain(t1.cpu(), noise.cpu(), esf, gs, scale,
                                          K, res)
    assert torch.equal(ts.cpu(), cpu_ts) and torch.equal(dts.cpu(), cpu_dts)


def _march_case(seed, scale, rows, fill, n, gs, dev):
    """Rays inside and outside the cube (misses among them), their hits,
    noise and a (rows, gs^3) grid with ``fill`` of its cells occupied."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.9 * scale, 0.9 * scale, (n, 3)).astype(np.float32)
    o[: n // 8] = rng.uniform(1.2 * scale, 1.8 * scale, (n // 8, 3))
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[: n // 16] = np.abs(d[: n // 16])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    hits = ray_aabb_intersect(o, d, scale)
    noise = torch.from_numpy(rng.random(n).astype(np.float32)).to(dev)
    grid = torch.from_numpy(rng.random((rows, gs**3)) < fill).to(dev)
    t1, t2 = hits.t().contiguous()
    return o, d, t1, t2, noise, grid


# (constant or exponential step, grid rows): scale and cascades
MARCH_LATTICES = {
    ("constant", 1): (0.5, 1, 0.0),
    ("constant", 2): (1.0, 2, 0.0),
    ("exponential", 1): (1.0, 2, 1 / 256),  # the VIRUS grid read past its end
    ("exponential", 2): (1.0, 2, 1 / 256),  # the NGP grid
}


# rays a march: the bench's S = 128, K = 1024 march at its 4096 rays, the
# rest a ragged 777 (a partial warp)
MARCH_RAYS = {(128, 1024): 4096}


@pytest.mark.cuda
@pytest.mark.parametrize("S, K", [(256, 1024), (512, 1024), (24, 256), (300, 256),
                                  (128, 1024)])
@pytest.mark.parametrize("fill", [0.0, 0.25, 0.5, 1.0])
@pytest.mark.parametrize("lattice, rows", list(MARCH_LATTICES))
def test_march_select_kernel_is_bit_exact(cuda_device, lattice, rows, fill, S, K):
    scale, cascades, esf = MARCH_LATTICES[lattice, rows]
    args = _march_case(S + K + rows, scale, rows, fill,
                       MARCH_RAYS.get((S, K), 777), 128, cuda_device)
    kw = dict(cascades=cascades, grid_size=128, scale=scale,
              exp_step_factor=esf, max_samples=S, n_candidates=K,
              march_resolution=min(K, 1024))
    before = march_select.launches
    got = march_select(*args, **kw)
    want = march_select_plain(*args, **kw)
    torch.cuda.synchronize()
    assert march_select.launches == before + 1
    for name, a, b in zip(("ts", "deltas", "valid", "n_kept"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        as_bits = torch.uint8 if a.dtype == torch.bool else torch.int32
        assert torch.equal(a.view(as_bits), b.view(as_bits)), name
    # and the CPU's plain version gives the same bits
    cpu = march_select_plain(*(x.cpu() for x in args), **kw)
    for a, b in zip(got, cpu):
        assert torch.equal(a.cpu(), b)
    n_kept = got[3]
    if fill == 1.0 and S < K:
        assert int(n_kept.max()) == S  # overflowing rays
    if fill == 0.0:
        assert int(n_kept.max()) == 0


@pytest.mark.cuda
def test_march_constants_match_the_kernel(cuda_device):
    lib = _build.library()
    assert lib.vn_march_chunk() == ray_march.MARCH_CHUNK
    assert lib.vn_march_max_candidates() == ray_march.MARCH_MAX_CANDIDATES
    assert lib.vn_march_max_samples() == ray_march.MARCH_MAX_SAMPLES
    assert lib.vn_march_rays_per_block() >= 1


@pytest.mark.cuda
def test_march_select_kernel_rejects_bad_arguments(cuda_device):
    o, d, t1, t2, noise, grid = _march_case(1, 0.5, 1, 0.5, 64, 32, cuda_device)
    kw = dict(cascades=1, grid_size=32, scale=0.5, exp_step_factor=0.0,
              max_samples=16, n_candidates=64)
    before = march_select.launches
    with pytest.raises(ValueError, match="grid on cpu"):
        march_select(o, d, t1, t2, noise, grid.cpu(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        march_select(o.t().contiguous().t(), d, t1, t2, noise, grid, **kw)
    with pytest.raises(ValueError, match="K <= 1024"):
        march_select(o, d, t1, t2, noise, grid, **dict(kw, n_candidates=2048))
    with pytest.raises(TypeError, match="float32 t1"):
        march_select(o, d, t1.double(), t2, noise, grid, **kw)
    assert march_select.launches == before
    # no rays: nothing to launch, empty outputs
    empty = march_select(o[:0], d[:0], t1[:0], t2[:0], noise[:0], grid, **kw)
    assert [tuple(x.shape) for x in empty] == [(0, 16), (0, 16), (0, 16), (0,)]


@pytest.mark.cuda
def test_exponential_march_on_card_matches_cpu(cuda_device):
    gen = torch.Generator()
    gen.manual_seed(3)
    n, gs = 512, 32
    o = torch.rand((n, 3), generator=gen) * 1.8 - 0.9
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen), dim=1)
    hits = torch.stack([torch.zeros(n), torch.full((n,), 2.0)], dim=1)
    noise = torch.rand(n, generator=gen)
    kw = dict(cascades=2, grid_size=gs, scale=1.0, exp_step_factor=1 / 256,
              max_samples=64, n_candidates=1024)
    for rows in (2, 1):  # the NGP grid, and the one-row VIRUS grid
        occ = torch.rand((rows, gs**3), generator=gen) < 0.3
        cpu = march_rays_train(o, d, hits, occ, noise, **kw)
        card = march_rays_train(*(x.to(cuda_device) for x in (o, d, hits, occ, noise)),
                                **kw)
        torch.cuda.synchronize()
        for k in ("valid", "n_samples", "ts", "deltas"):
            assert torch.equal(getattr(card, k).cpu(), getattr(cpu, k)), k


@pytest.mark.cuda
def test_ethz_step_on_card_matches_cpu(cuda_device, tmp_path):
    # one grid update + train step of the ETHZ path (two cameras, stacks
    # {1, 3}, the additive 16 x 2 hash of 2^16 rows a level) on the card and
    # on the CPU from the same weights and draws
    from virus_nerf_tpu_torch.configs.config import Config
    from virus_nerf_tpu_torch.data import make_dataset
    from virus_nerf_tpu_torch.data.dataset import Batch, sample_batch
    from virus_nerf_tpu_torch.data.ethz_fixture import generate_ethz_fixture
    from virus_nerf_tpu_torch.training.trainer import Trainer

    cfg = Config()
    cfg.dataset.name = "ETHZ"
    cfg.ethz.dataset_dir = generate_ethz_fixture(
        str(tmp_path / "ethz"), n_images=8, img_wh=(64, 48), n_gt_points=20_000)
    m, t = cfg.model, cfg.training
    m.hash_log2_T, m.hash_max_res, m.grid_size = 16, 256, 32
    t.batch_size, t.max_samples_per_ray = 512, 32
    t.march_candidates = t.march_resolution = 256
    cfg.occ_grid.batch_size = 128
    runs = []
    for dev in ("cpu", cuda_device):
        ds, scene, _ = make_dataset(cfg, "train", device=dev)
        runs.append((Trainer(cfg, ds, scene=scene, device=dev), ds))
    (tc, dsc), (tg, _) = runs
    sc, sg = tc.init_state(0), tg.init_state(0)
    sg.model.load_state_dict({k: v.to(cuda_device)
                              for k, v in sc.model.state_dict().items()})
    gen = torch.Generator()
    gen.manual_seed(5)
    ray_b = sample_batch(dsc, gen, tc.b_ray, {"imgs": "all", "pixs": "valid_tof"})
    nerf_b = sample_batch(dsc, gen, tc.b_nerf, {"imgs": "all", "pixs": "valid_uss"})
    pos_noise = torch.rand((tc.b_nerf, 32, 3), generator=gen) * 2 - 1
    batch = sample_batch(dsc, gen, t.batch_size, t.sampling_strategy)
    noise = torch.rand((t.batch_size,), generator=gen)
    assert set(dsc.cam_idx[batch.img_idxs].tolist()) == {0, 1}

    def to(b):
        return Batch(*[{k: v.to(cuda_device) for k, v in x.items()}
                       if isinstance(x, dict) else x.to(cuda_device) for x in b])

    sg.grid = type(sc.grid)(*(x.to(cuda_device) if torch.is_tensor(x) else x
                              for x in sc.grid))
    tc.grid_update_on(sc, ray_b, nerf_b, pos_noise)
    tg.grid_update_on(sg, to(ray_b), to(nerf_b), pos_noise.to(cuda_device))
    assert float((sg.grid.occ_3d_grid.cpu() - sc.grid.occ_3d_grid).abs().max()) <= 1e-5
    sg.grid = type(sc.grid)(*(x.to(cuda_device) if torch.is_tensor(x) else x
                              for x in sc.grid))
    mc = tc.train_step_on(sc, batch, noise)
    mg = tg.train_step_on(sg, to(batch), noise.to(cuda_device))
    torch.cuda.synchronize()
    # float32 in another op order on each device (chip_smoke's tolerances)
    assert abs(float(mg["loss"]) - float(mc["loss"])) <= 1e-4 * abs(float(mc["loss"]))
    assert int(mg["rm_samples"]) == int(mc["rm_samples"])
    diff = (sg.model.pos_table.detach().cpu() - sc.model.pos_table.detach()).abs()
    assert float((diff > 1e-6).float().mean()) <= 2e-3
    assert float(diff.max()) <= 2 * t.lr * (1 + 1e-5)


@pytest.mark.cuda
def test_rh2_step_on_card_matches_cpu(cuda_device, tmp_path):
    # one grid update + train step of the RH2 path at scale 1.0 (two
    # cascades, exponential stepping: the lattice kernel on the card; the
    # additive 16 x 2 hash of 2^16 rows a level) on the card and on the CPU
    # from the same weights and draws
    from virus_nerf_tpu_torch.configs.config import Config
    from virus_nerf_tpu_torch.data import make_dataset
    from virus_nerf_tpu_torch.data.dataset import Batch, sample_batch
    from virus_nerf_tpu_torch.data.rh_fixture import make_fixture
    from virus_nerf_tpu_torch.training.trainer import Trainer

    cfg = Config()
    cfg.dataset.name = "RH2"
    cfg.rh2.dataset_dir = str(tmp_path / "rh")
    make_fixture(cfg.rh2.dataset_dir, n_times=10, img_wh=(64, 48), seed=3)
    m, t = cfg.model, cfg.training
    m.scale = 1.0
    m.hash_log2_T, m.hash_max_res, m.grid_size = 16, 256, 32
    t.batch_size, t.max_samples_per_ray = 512, 32
    t.march_candidates = t.march_resolution = 256
    cfg.occ_grid.batch_size = 128
    runs = []
    for dev in ("cpu", cuda_device):
        ds, scene, _ = make_dataset(cfg, "train", device=dev)
        runs.append((Trainer(cfg, ds, scene=scene, device=dev), ds))
    (tc, dsc), (tg, _) = runs
    assert tc.sample_budget is None and cfg.cascades == 2
    sc, sg = tc.init_state(0), tg.init_state(0)
    sg.model.load_state_dict({k: v.to(cuda_device)
                              for k, v in sc.model.state_dict().items()})
    gen = torch.Generator()
    gen.manual_seed(5)
    ray_b = sample_batch(dsc, gen, tc.b_ray, {"imgs": "all", "pixs": "valid_tof"})
    nerf_b = sample_batch(dsc, gen, tc.b_nerf, {"imgs": "all", "pixs": "valid_uss"})
    pos_noise = torch.rand((tc.b_nerf, 32, 3), generator=gen) * 2 - 1
    batch = sample_batch(dsc, gen, t.batch_size, t.sampling_strategy)
    noise = torch.rand((t.batch_size,), generator=gen)

    def to(b):
        return Batch(*[{k: v.to(cuda_device) for k, v in x.items()}
                       if isinstance(x, dict) else x.to(cuda_device) for x in b])

    def grid_to_card():
        return type(sc.grid)(*(x.to(cuda_device) if torch.is_tensor(x) else x
                               for x in sc.grid))

    sg.grid = grid_to_card()
    tc.grid_update_on(sc, ray_b, nerf_b, pos_noise)
    tg.grid_update_on(sg, to(ray_b), to(nerf_b), pos_noise.to(cuda_device))
    assert float((sg.grid.occ_3d_grid.cpu() - sc.grid.occ_3d_grid).abs().max()) <= 1e-5
    sg.grid = grid_to_card()
    mc = tc.train_step_on(sc, batch, noise)
    mg = tg.train_step_on(sg, to(batch), noise.to(cuda_device))
    torch.cuda.synchronize()
    # float32 in another op order on each device (chip_smoke's tolerances);
    # the march is exact
    assert abs(float(mg["loss"]) - float(mc["loss"])) <= 1e-4 * abs(float(mc["loss"]))
    assert int(mg["rm_samples"]) == int(mc["rm_samples"]) > 0
    assert int(mg["vr_samples"]) == int(mc["vr_samples"])
    diff = (sg.model.pos_table.detach().cpu() - sc.model.pos_table.detach()).abs()
    assert float((diff > 1e-6).float().mean()) <= 2e-3
    assert float(diff.max()) <= 2 * t.lr * (1 + 1e-5)


# ------------------------------------------------ E1, the GT slice scan
def _slice_room(seed, n_points, room_min, room_max, dtype):
    """Walls and clutter inside a room's bounds."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(room_min, float), np.asarray(room_max, float)
    q = n_points // 5
    pts = [rng.uniform(lo, hi, (n_points - 4 * q, 3))]
    for axis, side in ((0, lo), (0, hi), (1, lo), (1, hi)):
        w = rng.uniform(lo, hi, (q, 3))
        w[:, 1 - axis] = side[1 - axis] + (0.2 if side is lo else -0.2)
        pts.append(w)
    return np.concatenate(pts).astype(dtype)


def _slice_cases():
    """ETHZ's size (800,000 float32 points in fixed bounds) and an RH2-sized
    room (400,000 float64 points, bounds from the cloud), 16 origins x 512
    scan rays at res 512."""
    from virus_nerf_tpu_torch.data.scene import Scene

    ethz_min, ethz_max = [-3.0, -3.0, -0.4], [15.0, 9.0, 1.2]
    ethz = Scene(_slice_room(7, 800_000, ethz_min, ethz_max, np.float32),
                 np.array(ethz_min), np.array(ethz_max))
    rh_pts = _slice_room(8, 400_000, [0.0, 0.0, 0.0], [7.2, 5.4, 2.6],
                         np.float64)
    rh2 = Scene(rh_pts)
    rng = np.random.default_rng(9)
    return {
        "ethz": (ethz, rng.uniform([0, 0, 0.2], [12, 6, 0.6], (16, 3)), 0.05),
        "rh2": (rh2, rng.uniform([1, 1, 1.0], [6, 4, 1.4], (16, 3)), 0.05),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("room", ["ethz", "rh2"])
def test_slice_scan_kernel_is_bit_exact(cuda_device, room, monkeypatch):
    from virus_nerf_tpu_torch.data import scene as scene_module
    from virus_nerf_tpu_torch.evaluation.geometry import create_scan_rays
    from virus_nerf_tpu_torch.ops.slice_scan import slice_scan, slice_scan_plain

    scene, origins_w, tol = _slice_cases()[room]
    res = 512
    rays_o, rays_d = create_scan_rays(scene.w2c(origins_w), 512)
    assert rays_o.shape[0] == 8192
    walks = []  # the scene's walk on the card: its inputs and hit cells

    def recorded(*args):
        walks.append((args, slice_scan(*args)))
        return walks[-1][1]

    monkeypatch.setattr(scene_module, "slice_scan", recorded)
    depths, hits, _ = scene.scan_depths(res, rays_o, rays_d, tol,
                                        device=cuda_device)
    ((cells, band, _, rays, radii), got), = walks
    assert 0 < band[1] - band[0] < scene.point_cloud.shape[0]
    assert cells.is_cuda and rays.is_cuda and radii.is_cuda
    want = slice_scan_plain(cells.cpu(), band, res, rays.cpu(), radii.cpu())
    assert got.dtype == torch.int32 and got.is_cuda
    assert torch.equal(got.cpu(), want)
    assert np.array_equal(hits, want.numpy())
    assert float((want >= 0).float().mean()) > 0.9
    numpy_depths = scene.get_slice_scan(res, rays_o, rays_d, tol,
                                        rays_o_in_world_coord=False)[1]
    assert np.array_equal(depths, numpy_depths, equal_nan=True)


def _card_evaluator(cuda_device):
    from virus_nerf_tpu_torch.configs.config import Config
    from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from virus_nerf_tpu_torch.evaluation.evaluator import Evaluator
    from virus_nerf_tpu_torch.training.trainer import Trainer

    ds, scene, info = make_synthetic_dataset(
        device=cuda_device, n_images=6, img_wh=(32, 24), n_gt_points=200_000)
    cfg = Config()
    m, t, ev = cfg.model, cfg.training, cfg.evaluation
    m.hash_levels, m.hash_log2_T, m.hash_max_res, m.grid_size = 4, 12, 64, 32
    t.batch_size, t.max_samples_per_ray = 128, 32
    t.march_candidates = t.march_resolution = 256
    ev.res_angular, ev.res_map, ev.height_tolerance = 256, 512, 0.1
    ev.batch_size, ev.max_samples_per_ray = 512, 32
    tr = Trainer(cfg, ds, scene=scene, device=cuda_device)
    state = tr.init_state(0)
    tr.run_steps(state, 8)
    return Evaluator(cfg, ds, scene, img_wh=info["img_wh"],
                     device=cuda_device), state


@pytest.mark.cuda
def test_evaluate_depth_on_card_scans_as_the_numpy_path(cuda_device,
                                                         monkeypatch):
    from virus_nerf_tpu_torch.evaluation.geometry import create_scan_rays

    evaluator, state = _card_evaluator(cuda_device)
    cfg, scene = evaluator.cfg, evaluator.scene
    ev = cfg.evaluation
    idxs = np.array([0, 2, 3, 5])
    renders = []
    render = evaluator.render_batched

    def render_once(*args, **kwargs):  # one render for both paths
        if not renders:
            renders.append(render(*args, **kwargs))
        return renders[0]

    monkeypatch.setattr(evaluator, "render_batched", render_once)
    got = evaluator.evaluate_depth(state.model, state.grid.occ_bool, idxs,
                                   sensors=("NeRF",))
    # the evaluation's set-up, kept by the scene
    assert list(scene._slice_scans) == [(ev.res_map, evaluator.device)]

    def numpy_gt(img_idxs):
        rays_o, rays_d = create_scan_rays(evaluator._scan_origins(img_idxs),
                                          ev.res_angular)
        depths = scene.get_slice_scan(res=ev.res_map, rays_o=rays_o,
                                      rays_d=rays_d,
                                      height_tolerance=ev.height_tolerance,
                                      rays_o_in_world_coord=False)[1]
        return (scene.c2w(rays_o), rays_d,
                scene.c2w(depths, only_scale=True))

    monkeypatch.setattr(evaluator, "_get_gt_data", numpy_gt)
    want = evaluator.evaluate_depth(state.model, state.grid.occ_bool, idxs,
                                    sensors=("NeRF",))
    assert np.isfinite(want[1]["GT"]["depths"]).mean() > 0.5
    for a, b in ((got[0], want[0]), (got[1], want[1])):
        assert set(a) == set(b)
        for sensor in a:
            assert set(a[sensor]) == set(b[sensor])
            for key in a[sensor]:
                x, y = a[sensor][key], b[sensor][key]
                if isinstance(x, dict):
                    assert x.keys() == y.keys()
                    x, y = list(x.values()), list(y.values())
                assert np.array_equal(np.asarray(x), np.asarray(y),
                                      equal_nan=True), (sensor, key)


@pytest.mark.cuda
def test_slice_scan_launches_once_a_call(cuda_device):
    from virus_nerf_tpu_torch.ops.slice_scan import slice_scan
    from virus_nerf_tpu_torch.utils import tracing

    evaluator, state = _card_evaluator(cuda_device)
    before = slice_scan.launches
    tracing.enable()
    tracing.reset()
    try:
        for idxs in ([0, 1], [2, 4, 5], [3]):
            evaluator.evaluate_depth(state.model, state.grid.occ_bool,
                                     np.array(idxs), sensors=("NeRF",))
        snap = tracing.snapshot()
    finally:
        tracing.enable(False)
        tracing.reset()
    assert slice_scan.launches - before == 3
    assert snap["span.evaluator.gt_scan.n"] == 3


def _nn_bit_exact(got, want, nan_bits=True):
    """E2's (indices, distances) against the plain search's: indices
    equal, distances bit for bit (with ``nan_bits`` False, any NaN equal to
    any NaN: a NaN the card computes from inf - inf has its own bits)."""
    import nn_search_cases as C

    idx, dist = (t.cpu() for t in got)
    assert idx.dtype == torch.int32 and dist.dtype == torch.float32
    assert torch.equal(idx, want[0])
    if nan_bits:
        assert torch.equal(dist.view(torch.int32), want[1].view(torch.int32))
    else:
        assert C.same_f32(dist.numpy(), want[1].numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("k, m", [(512, 512), (512, 8229)])
def test_nn_search_kernel_is_bit_exact(cuda_device, k, m):
    # 16 room scans with planted exact ties, NaN rows, an image without a
    # valid reference, and points whose distance an FMA-contracted d^2
    # would change; at the evaluator's 512 x 512 and at a LiDAR scan's
    # width (over 8 tiles of references, the last one ragged)
    import nn_search_cases as C
    from virus_nerf_tpu_torch.ops.nn_search import nn_search, nn_search_plain

    pos, pos_ref, n = C.scans(4000000241 + m, n=16, k=k, m=m)
    p, r = torch.from_numpy(pos), torch.from_numpy(pos_ref)
    got = nn_search(p.to(cuda_device), r.to(cuda_device), n)
    with np.errstate(invalid="ignore"):
        want = nn_search_plain(p, r, n)
    assert got[0].shape == (n, k) and got[0].is_cuda
    assert 0.5 < float((want[0] >= 0).float().mean()) < 1.0
    _nn_bit_exact(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["random", "float64_inputs", "nan_rows",
                                  "empty_images", "duplicate_ties",
                                  "mirror_ties", "fma", "lidar", "uss", "inf",
                                  "n1_512", "n16_512"])
def test_nn_search_kernel_on_the_cpu_cases(cuda_device, name):
    import nn_search_cases as C
    from virus_nerf_tpu_torch.ops.nn_search import nn_search, nn_search_plain

    pos, pos_ref, n = C.case(name)
    p = torch.from_numpy(np.array(pos, np.float32))
    r = torch.from_numpy(np.array(pos_ref, np.float32))
    got = nn_search(p.to(cuda_device), r.to(cuda_device), n)
    with np.errstate(invalid="ignore"):
        want = nn_search_plain(p, r, n)
    _nn_bit_exact(got, want, nan_bits=name != "inf")


@pytest.mark.cuda
def test_evaluate_depth_on_card_searches_as_the_numpy_path(cuda_device,
                                                           monkeypatch):
    # the same call with the search forced onto the host: every metric
    # and distance equal
    from virus_nerf_tpu_torch.evaluation import metrics

    evaluator, state = _card_evaluator(cuda_device)
    idxs = np.array([0, 2, 3, 5])
    renders = []
    render = evaluator.render_batched

    def render_once(*args, **kwargs):  # one render for both paths
        if not renders:
            renders.append(render(*args, **kwargs))
        return renders[0]

    monkeypatch.setattr(evaluator, "render_batched", render_once)
    got = evaluator.evaluate_depth(state.model, state.grid.occ_bool, idxs,
                                   sensors=("NeRF",))
    nn_metrics = metrics.nn_metrics

    def on_host(*args, device, **kwargs):
        assert device == evaluator.device
        return nn_metrics(*args, device="cpu", **kwargs)

    monkeypatch.setattr(metrics, "nn_metrics", on_host)
    want = evaluator.evaluate_depth(state.model, state.grid.occ_bool, idxs,
                                    sensors=("NeRF",))
    assert np.isfinite(want[0]["NeRF"]["nn_mean"]["zone3"])
    assert set(got[0]["NeRF"]) == set(want[0]["NeRF"])
    for key, value in want[0]["NeRF"].items():
        if key.startswith("nn_dists"):
            np.testing.assert_array_equal(got[0]["NeRF"][key], value)
        else:
            assert repr(got[0]["NeRF"][key]) == repr(value), key


@pytest.mark.cuda
def test_nn_search_launches_once_an_nn_metrics_call(cuda_device):
    from virus_nerf_tpu_torch.ops.nn_search import nn_search
    from virus_nerf_tpu_torch.utils import tracing

    evaluator, state = _card_evaluator(cuda_device)
    before = nn_search.launches
    tracing.enable()
    tracing.reset()
    try:
        for idxs in ([0, 1], [2, 4, 5], [3]):
            evaluator.evaluate_depth(state.model, state.grid.occ_bool,
                                     np.array(idxs), sensors=("NeRF",))
        snap = tracing.snapshot()
    finally:
        tracing.enable(False)
        tracing.reset()
    # three directions a sensor, one launch each
    assert nn_search.launches - before == 9
    assert snap["span.evaluator.nnd.n"] == 9
