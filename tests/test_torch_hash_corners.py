"""H1, the hash encoder's ``corners`` forward in one launch
(``csrc/hash_corners.cu``, bound in ``ops/hash_corners.py``, dispatched by
``ops/hash_encoder.py``).

On the card (``cuda`` marker; skipped without one) H1 is held to the plain
code on the card: base rows and weights bit for bit, the embedding bit for
bit, at the benchmark cells' sample counts, for float32 and bf16 tables,
F in {1, 2, 4, 8}, dense, hashed and bf16-rounded levels, ragged and empty
N, non-finite and out-of-cube positions, under ``no_grad`` (no base or
weights allocated), inside a CUDA graph, and through the table gradient; a
layout H1 does not hold is refused on the card, by the encode and by the
model at load.
This file imports no jax:

    python -m pytest --noconftest -q -m cuda tests/test_torch_hash_corners.py

On the CPU a torch emulation of H1's arithmetic for one (sample, level),
in the kernel's operation order, is held to ``hash_base_rows`` and
``_corner_gather_combine``, and the binding's checks and the encoder's CPU
route are tested.
"""

import numpy as np
import pytest
import torch

from virus_nerf_tpu_torch.models.ngp import NGPModel
from virus_nerf_tpu_torch.ops import launch_counts
from virus_nerf_tpu_torch.ops.hash_corners import (
    H1_MAX_LEVELS,
    check_layout,
    hash_corners,
)
from virus_nerf_tpu_torch.ops.hash_encoder import (
    HashGridSpec,
    _encode_forward,
    _SpecTensors,
    _table_grad,
    bf16_rounded_levels,
    h1_level_words,
    hash_corners_plain,
    hash_encode,
)

# the benchmark's 16 x 2 layout of 2^19 rows (both configurations)
CELL_SPEC = dict(levels=16, feat_dim=2, base_res=16.0, max_res=1024.0,
                 max_params=2**19)


def _mixed_spec(F):
    """Dense, hashed and bf16-rounded levels (2^17-row hashed levels)."""
    return HashGridSpec.create(levels=8, feat_dim=F, base_res=16.0,
                               max_res=512.0, max_params=2**17)


def _positions(n, seed, device, lo=-0.03, hi=1.03):
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand((n, 3), generator=gen) * (hi - lo) + lo).to(device)


def _table(spec, seed, device, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return torch.rand((spec.total_rows, spec.feat_dim),
                      generator=gen).to(device, dtype)


def _h1(table, xyz, spec, keep=True):
    return hash_corners(table, xyz, *h1_level_words(spec), keep=keep)


def _edge_positions(device):
    """Non-finite, negative, beyond the cube and exact lattice positions."""
    v = [float("nan"), float("inf"), -float("inf"), -0.0, 0.0, 1.0, 0.5,
         -0.25, -3.0, 1.5, 7.0, 1e30, -1e30, 3e9, 1e-40]
    grid = torch.tensor(v, dtype=torch.float32)
    xyz = torch.cartesian_prod(grid, grid, grid)  # every mix on each axis
    return xyz.to(device)


def _same(a, b):
    """Equal values and equal NaN places (-0 equals 0)."""
    if a.dtype.is_floating_point:
        return (torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(torch.nan_to_num(a, nan=0.0),
                                torch.nan_to_num(b, nan=0.0)))
    return torch.equal(a, b)


def _check_against_plain(table, xyz, spec, exact=True):
    """H1 against the plain code on the card: base rows and weights bit for
    bit, the embedding bit for bit where ``exact``, else (cuBLAS's other
    combine order, below) within the bound of a reordered sum of 8 terms.
    Returns the embedding's largest gap in float32 ulps."""
    c = _SpecTensors(spec, xyz.device)
    before = hash_corners.launches
    out, base, w = _h1(table, xyz, spec)
    want, want_base, want_w = hash_corners_plain(table, xyz, spec, c)
    torch.cuda.synchronize()
    assert hash_corners.launches == before + 1
    for name, g, h in (("out", out, want), ("base", base, want_base),
                       ("w", w, want_w)):
        assert g.shape == h.shape and g.dtype == h.dtype, name
    assert torch.equal(base, want_base)
    assert _same(w, want_w)
    assert torch.equal(torch.isnan(out), torch.isnan(want))
    ok = ~torch.isnan(out)
    gap = (out[ok].view(torch.int32).long()
           - want[ok].view(torch.int32).long()).abs()
    if exact:
        assert _same(out, want), f"out: {int(gap.max()) if gap.numel() else 0} ulps"
    else:
        # sum_c |f_c| |w_c|, by the plain code on |table| and |w|
        terms = hash_corners_plain(table.abs(), xyz.nan_to_num(), spec, c)[0]
        bound = 16 * 2.0**-24 * terms[ok]
        assert bool(((out[ok] - want[ok]).abs() <= bound).all())
    return int(gap.max()) if gap.numel() else 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


# ------------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.parametrize("n", [131072, 1048576, 4194304])
def test_h1_matches_plain_at_the_cells_sample_counts(cuda_device, n):
    """ETHZ's budget, RH2's dense step, the evaluation's 8,192 x 512
    chunk."""
    spec = HashGridSpec.create(**CELL_SPEC)
    _check_against_plain(_table(spec, 1, cuda_device), _positions(n, n, cuda_device), spec)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [65536, 70001])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [1, 2, 4, 8])
def test_h1_matches_plain_for_every_width_and_level_kind(cuda_device, F, dtype, n):
    """At 70,001 samples (8 levels) cuBLAS's batched GEMV takes its
    one-kernel path, whose combine order H1 does not follow: the
    embedding is held to the reordering bound there, bit for bit at
    65,536."""
    spec = _mixed_spec(F)
    assert 0 < spec.begin_fast_hash_level < spec.levels
    assert bf16_rounded_levels(spec)
    gap = _check_against_plain(_table(spec, F, cuda_device, dtype),
                               _positions(n, F, cuda_device), spec,
                               exact=n == 65536)
    print(f"F={F} {dtype} n={n}: largest embedding gap {gap} ulps")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_h1_matches_plain_on_edge_positions(cuda_device, dtype):
    spec = _mixed_spec(2)
    xyz = _edge_positions(cuda_device)
    _check_against_plain(_table(spec, 3, cuda_device, dtype), xyz, spec,
                         exact=False)
    # every base row inside its level, so every corner row inside the table
    _, base, _ = _h1(_table(spec, 3, cuda_device, dtype), xyz, spec)
    sizes = torch.tensor(spec.sizes, device=cuda_device)[:, None]
    assert bool(((base >= 0) & (base < sizes)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 127, 129])
def test_h1_matches_plain_on_small_and_ragged_n(cuda_device, n):
    spec = HashGridSpec.create(**CELL_SPEC)
    _check_against_plain(_table(spec, 1, cuda_device), _positions(n, 7, cuda_device), spec)


@pytest.mark.cuda
def test_h1_writes_no_base_or_weights_without_a_gradient(cuda_device):
    spec = HashGridSpec.create(**CELL_SPEC)
    table = _table(spec, 1, cuda_device).requires_grad_(True)
    xyz = _positions(262144, 2, cuda_device)
    consts = _SpecTensors(spec, cuda_device)
    want = hash_corners_plain(table.detach(), xyz, spec, consts)[0]
    out, base, w = _h1(table.detach(), xyz, spec, keep=False)
    assert base is None and w is None and _same(out, want)
    del out
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    launched = hash_corners.launches
    with torch.no_grad():
        out = hash_encode(table, xyz, spec, consts)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    assert hash_corners.launches == launched + 1
    assert out.grad_fn is None and _same(out, want)
    # the embedding alone: no (L, N) base rows (33.5 MB), no (L, 8, N)
    # weights (134 MB)
    assert peak <= out.numel() * 4 + 2**20


@pytest.mark.cuda
def test_h1_inside_a_cuda_graph(cuda_device):
    spec = HashGridSpec.create(**CELL_SPEC)
    table = _table(spec, 1, cuda_device)
    consts = _SpecTensors(spec, cuda_device)
    xyz = _positions(131072, 3, cuda_device)
    _h1(table, xyz, spec)  # warm-up outside the capture
    torch.cuda.synchronize()
    graph, record = torch.cuda.CUDAGraph(), launch_counts.GraphLaunches()
    launch_counts.register(hash_corners)
    with record.capture(), torch.cuda.graph(graph):
        got = _h1(table, xyz, spec)
    assert record.held == {hash_corners: 1}
    for seed in (4, 5, 6):
        xyz.copy_(_positions(131072, seed, cuda_device))
        graph.replay()
        want = hash_corners_plain(table, xyz, spec, consts)
        torch.cuda.synchronize()
        for name, g, w in zip(("out", "base", "w"), got, want):
            assert _same(g, w), (seed, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_h1_table_gradient_equals_the_plain_routes(cuda_device, dtype):
    spec = HashGridSpec.create(**CELL_SPEC)
    table = _table(spec, 1, cuda_device, dtype).requires_grad_(True)
    xyz = _positions(131072, 8, cuda_device)
    gen = torch.Generator().manual_seed(9)
    g = torch.randn((131072, spec.out_dim), generator=gen).to(cuda_device)
    consts = _SpecTensors(spec, cuda_device)
    launched = hash_corners.launches
    out = hash_encode(table, xyz, spec, consts)
    out.backward(g)
    assert hash_corners.launches == launched + 1
    plain, base, w = hash_corners_plain(table.detach(), xyz, spec, consts)
    want = _table_grad(spec, base, w, g).to(dtype)
    torch.cuda.synchronize()
    assert _same(out.detach(), plain)
    assert table.grad.dtype == dtype and _same(table.grad, want)


@pytest.mark.cuda
def test_h1_launches_once_an_encode_and_no_gemv(cuda_device):
    spec = HashGridSpec.create(**CELL_SPEC)
    table = _table(spec, 1, cuda_device).requires_grad_(True)
    xyz = _positions(131072, 10, cuda_device)
    consts = _SpecTensors(spec, cuda_device)
    hash_encode(table, xyz, spec, consts)
    torch.cuda.synchronize()
    launched = hash_corners.launches
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        hash_encode(table, xyz, spec, consts)
        with torch.no_grad():
            hash_encode(table, xyz, spec, consts)
        torch.cuda.synchronize()
    assert hash_corners.launches == launched + 2
    names = [e.key for e in prof.key_averages()]
    assert any("hash_corners_kernel" in k for k in names), names
    assert not any("gemv" in k for k in names), names
    # the slabs route does not launch it
    hash_encode(table, xyz, spec, consts, forward="slabs")
    assert hash_corners.launches == launched + 2


@pytest.mark.cuda
def test_h1_refuses_what_it_cannot_hold_on_the_card(cuda_device):
    """F = 3 and 33 levels: the binding, the encode and the model at load
    raise; nothing runs them another way on the card."""
    spec3 = HashGridSpec.create(levels=4, feat_dim=3, max_res=64,
                                max_params=2**12)
    xyz = _positions(100, 1, cuda_device)
    table = _table(spec3, 1, cuda_device)
    launched = hash_corners.launches
    with pytest.raises(ValueError, match="F in"):
        _h1(table, xyz, spec3)
    for grad in (False, True):
        with pytest.raises(ValueError, match="F in"):
            hash_encode(table.requires_grad_(grad), xyz, spec3)
    deep = HashGridSpec.create(levels=H1_MAX_LEVELS + 1, feat_dim=2,
                               max_res=4096.0, max_params=2**12)
    with pytest.raises(ValueError, match="levels"):
        hash_encode(_table(deep, 1, cuda_device), xyz, deep)
    assert hash_corners.launches == launched
    with pytest.raises(ValueError, match="F in"):
        NGPModel(levels=4, feature_per_level=3, log2_T=12, max_res=64,
                 device=cuda_device)
    spec = HashGridSpec.create(**CELL_SPEC)
    wide = torch.zeros((spec.total_rows, 4), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        _h1(wide[:, 1:3], _positions(10, 1, cuda_device), spec)


# ------------------------------------------------------------- on the CPU
INT64_MAX = 2**63 - 1


def _fma32(a, b, c):
    """float32 ``a * b + c`` rounded once, as ``__fmaf_rn``: the product
    (exact) and the sum in float64, the sum's error kept (TwoSum), and the
    rounding to float32 corrected where float64 left it on a tie."""
    a, b, c = (t.double() for t in torch.broadcast_tensors(a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)  # s + e == p + c exactly
    r = s.float()
    d = s - r.double()
    toward = torch.where(d > 0, torch.tensor(float("inf")),
                         torch.tensor(-float("inf")))
    nb = torch.nextafter(r, toward)
    tie = (d != 0) & (s == (r.double() + nb.double()) / 2)
    fix = tie & (e != 0) & (torch.sign(e) == torch.sign(d))
    return torch.where(fix & torch.isfinite(s), nb, r)


def _to_int64(x):
    """float -> int64 as the card converts (PTX ``cvt.rzi.s64.f32``): NaN
    to 0, saturated at the int64 range."""
    big = x >= 2.0**63
    x = torch.where(torch.isnan(x) | big, torch.zeros_like(x), x)
    return torch.where(big, torch.full_like(x, INT64_MAX, dtype=torch.long),
                       x.long())


def emulate_h1(table, xyz, spec):
    """H1's arithmetic, (sample, level) by (sample, level) in the kernel's
    operation order, vectorised over both: (out, base, w)."""
    words = np.zeros((spec.levels, 4), np.int64)
    words[:] = np.stack([spec.offsets, spec.sizes, spec.stride_y,
                         spec.stride_z], 1)
    offset, size, sy, sz = (torch.from_numpy(words[:, k])[:, None]
                            for k in range(4))
    scale = torch.tensor(spec.scales, dtype=torch.float32)[:, None]
    corner = torch.from_numpy(spec.corner_offsets)  # (L, 8)
    rounded = torch.zeros(spec.levels, dtype=torch.bool)
    rounded[bf16_rounded_levels(spec)] = True
    g, fr, om = [], [], []
    for d in range(3):
        pos = _fma32(xyz[None, :, d], scale, torch.tensor(0.5))  # (L, N)
        fl = torch.floor(pos)
        fr.append(pos - fl)
        om.append(1.0 - fr[-1])
        g.append(_to_int64(torch.where(torch.isnan(fl), fl, fl.clamp(min=0.0))))
    h = g[0] + g[1] * sy + g[2] * sz  # int64, wrapping
    base = torch.fmod(h, size)  # C's %: the sign of h
    base = torch.where(base < 0, base + size, base)
    w = []
    for c in range(8):
        s = [fr[d] if (c >> d) & 1 else om[d] for d in range(3)]
        w.append((s[0] * s[1]) * s[2])
    w = torch.stack(w, 1)  # (L, 8, N)
    r = base[:, None, :] + corner[:, :, None]
    rows = offset[:, :, None] + torch.where(r >= size[:, :, None],
                                            r - size[:, :, None], r)
    feats = table[rows].float()  # (L, 8, N, F)
    if table.dtype == torch.float32:
        feats = torch.where(rounded[:, None, None, None],
                            feats.to(torch.bfloat16).float(), feats)
    halves = []
    for cs in (range(0, 4), range(4, 8)):
        acc = torch.zeros_like(feats[:, 0])
        for c in cs:
            acc = _fma32(feats[:, c], w[:, c, :, None], acc)
        halves.append(acc)
    out = (halves[0] + halves[1]).permute(1, 0, 2)  # (N, L, F)
    return out.reshape(xyz.shape[0], spec.out_dim), base, w, feats


def _cpu_positions(n, seed):
    xyz = _positions(n, seed, "cpu")
    xyz[:6] = torch.tensor([0.0, 0.5, 1.0])  # lattice-aligned corners
    xyz[6:12] = torch.tensor([-3.0, 1.5, 7.0])  # beyond the cube
    xyz[12] = torch.tensor([1e15, -1e15, 2e-40])  # floor below 2^63
    return xyz


def test_fma32_rounds_once():
    """The test's FMA against exact rational arithmetic."""
    from fractions import Fraction

    gen = torch.Generator().manual_seed(0)
    a = torch.rand(3000, generator=gen) * 2 - 1
    b = torch.rand(3000, generator=gen) * 1e-3
    c = torch.rand(3000, generator=gen) * 8
    # 2^-70 below a float32 tie that float64 rounds onto the tie, whose
    # even neighbour lies above: the correction's case
    a[:500], b[:500] = 1.0 + 2.0**-23, 2.0**-24 - 2.0**-47
    c[:500] = 1.0 + 2.0**-23
    assert _fma32(a[:1], b[:1], c[:1]).item() == 1.0 + 2.0**-23
    assert (a[:1].double() * b[:1].double() + c[:1].double()).float().item() == 1.0 + 2.0**-22
    got = _fma32(a, b, c)
    for i in range(3000):
        exact = Fraction(a[i].item()) * Fraction(b[i].item()) + Fraction(c[i].item())
        lo = torch.tensor(float(exact), dtype=torch.float32)
        cands = [lo, torch.nextafter(lo, torch.tensor(float("inf"))),
                 torch.nextafter(lo, torch.tensor(-float("inf")))]
        best = min(cands, key=lambda v: (abs(Fraction(v.item()) - exact),
                                         v.view(torch.int32).item() & 1))
        assert got[i].item() == best.item(), i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["cell_small", "mixed_1", "mixed_2",
                                    "mixed_4", "mixed_8"])
def test_emulated_h1_matches_the_plain_code(layout, dtype):
    """Base rows and weights bit for bit; the embedding within the bound
    of a reordered sum of 8 terms (the CPU combines in another order than
    cuBLAS and H1)."""
    if layout == "cell_small":
        spec = HashGridSpec.create(levels=16, feat_dim=2, max_res=1024.0,
                                   max_params=2**12)
    else:
        spec = _mixed_spec(int(layout.split("_")[1]))
    table = _table(spec, 5, "cpu", dtype)
    xyz = _cpu_positions(3001, 6)
    out, base, w, feats = emulate_h1(table, xyz, spec)
    want_out, want_base, want_w = hash_corners_plain(table, xyz, spec)
    assert torch.equal(base, want_base)
    assert torch.equal(w.view(torch.int32), want_w.view(torch.int32))
    terms = (feats.abs() * w[..., None].abs()).sum(1).permute(1, 0, 2)
    bound = 16 * 2.0**-24 * terms.reshape(out.shape)
    assert bool(((out - want_out).abs() <= bound).all())
    assert bool((base >= 0).all()) and bool(
        (base < torch.tensor(spec.sizes)[:, None]).all())


def test_emulated_h1_on_non_finite_positions():
    """Where the CPU's own conversion differs from the card's (NaN and inf
    to int64), the emulation keeps the card's: every row in its level."""
    spec = _mixed_spec(2)
    v = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e30, 0.3])
    xyz = torch.cartesian_prod(v, v, v)
    out, base, w, _ = emulate_h1(_table(spec, 5, "cpu"), xyz, spec)
    assert bool((base >= 0).all()) and bool(
        (base < torch.tensor(spec.sizes)[:, None]).all())
    nan_pos = torch.isnan(xyz).any(1) | torch.isinf(xyz).any(1)
    # floor(+-inf) - +-inf is NaN: every weight of such a sample is NaN
    assert bool(torch.isnan(w[:, :, nan_pos]).all())
    assert bool(torch.isfinite(out[~nan_pos]).all())
    # all three axes NaN: g = 0, the level's row 0
    assert bool((base[:, 0] == 0).all())


def test_cpu_tensors_take_the_plain_code():
    spec = _mixed_spec(4)
    table, xyz = _table(spec, 2, "cpu"), _cpu_positions(500, 3)
    c = _SpecTensors(spec, "cpu")
    launched = hash_corners.launches
    want = hash_corners_plain(table, xyz, spec, c)
    for keep in (True, False):
        got = _encode_forward(table, xyz, spec, c, "corners", keep)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    with torch.no_grad():
        free = hash_encode(table.requires_grad_(True), xyz, spec)
    tracked = hash_encode(table, xyz, spec)
    assert free.grad_fn is None and tracked.grad_fn is not None
    assert torch.equal(free, tracked.detach())
    assert torch.equal(free, want[0])
    assert hash_corners.launches == launched


def test_the_cpu_keeps_every_width():
    """A layout H1 does not hold runs by the plain code on the CPU, and the
    model takes it there."""
    spec3 = HashGridSpec.create(levels=4, feat_dim=3, max_res=64,
                                max_params=2**12)
    table, xyz = _table(spec3, 1, "cpu"), _cpu_positions(50, 2)
    out = hash_encode(table, xyz, spec3)
    assert torch.equal(out, hash_corners_plain(table, xyz, spec3)[0])
    model = NGPModel(levels=4, feature_per_level=3, log2_T=12, max_res=64,
                     device="cpu")
    assert model.hash_spec.feat_dim == 3


@pytest.mark.parametrize("case", ["table_dtype", "table_shape", "xyz_dtype",
                                  "xyz_shape", "devices", "device", "cpu",
                                  "width", "levels"])
def test_the_wrapper_refuses_what_it_cannot_hold(case):
    spec = _mixed_spec(2)
    table, xyz = _table(spec, 1, "cpu"), _cpu_positions(20, 1)
    err, match = ValueError, "CUDA device"
    if case == "table_dtype":
        table, err, match = table.double(), TypeError, "table"
    elif case == "table_shape":
        table, match = table[:spec.offsets[-1] + spec.sizes[-1] - 1], "past"
    elif case == "xyz_dtype":
        xyz, err, match = xyz.double(), TypeError, "positions"
    elif case == "xyz_shape":
        xyz, err, match = xyz[:, :2], TypeError, "positions"
    elif case == "devices":
        xyz = xyz.to("meta")
    elif case == "device":
        table, xyz = table.to("meta"), xyz.to("meta")
    elif case == "width":
        table, match = torch.zeros((spec.total_rows, 3)), "F in"
    elif case == "levels":
        spec = HashGridSpec.create(levels=H1_MAX_LEVELS + 1, feat_dim=2,
                                   max_res=4096.0, max_params=2**12)
        table, match = _table(spec, 1, "cpu"), "levels"
    with pytest.raises(err, match=match):
        _h1(table, xyz, spec)


def test_h1_holds_the_widths_and_levels_it_is_built_for():
    for F in (1, 2, 4, 8):
        check_layout(F, h1_level_words(_mixed_spec(F))[0])
    check_layout(2, h1_level_words(HashGridSpec.create(**CELL_SPEC))[0])
    check_layout(2, h1_level_words(HashGridSpec.create(
        levels=H1_MAX_LEVELS, feat_dim=2, max_res=4096.0,
        max_params=2**12))[0])
    with pytest.raises(ValueError, match="F in"):
        check_layout(3, h1_level_words(HashGridSpec.create(
            levels=4, feat_dim=3, max_res=64, max_params=2**12))[0])
    with pytest.raises(ValueError, match="levels"):
        check_layout(2, h1_level_words(HashGridSpec.create(
            levels=H1_MAX_LEVELS + 1, feat_dim=2, max_res=4096.0,
            max_params=2**12))[0])
    with pytest.raises(ValueError, match="levels"):
        check_layout(2, np.zeros((0, 13), np.int64))
    words = h1_level_words(_mixed_spec(2))[0].copy()
    words[-1, 5] = 2**31
    with pytest.raises(ValueError, match=r"2\^31"):
        check_layout(2, words)


def test_level_words_are_the_specs_constants():
    spec = _mixed_spec(2)
    words, scales = h1_level_words(spec)
    c = _SpecTensors(spec, "cpu")
    assert words.shape == (spec.levels, 13) and words.dtype == np.int64
    assert np.array_equal(words[:, 0], c.offsets[:, 0].numpy())
    assert np.array_equal(words[:, 1], c.sizes[:, 0].numpy())
    assert np.array_equal(words[:, 2], c.stride_y[:, 0].numpy())
    assert np.array_equal(words[:, 3], c.stride_z[:, 0].numpy())
    assert np.array_equal(words[:, 4:12], c.corner_offsets.numpy())
    assert np.array_equal(words[:, 12].astype(bool), c.bf16_levels.numpy())
    assert np.array_equal(scales, c.scales.reshape(-1).numpy())
    assert 0 < words[:, 12].sum() < spec.levels
