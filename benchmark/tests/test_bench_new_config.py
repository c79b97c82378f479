"""A configuration whose encoder is a new file: the reference finds it by
name, the roofline takes the encoder's width and leaves from its
``shapes``, and the configuration's own ``published`` block holds it to its
source's widths.  The counts of the two configurations of the published
ETHZ run stay as they were."""

from __future__ import annotations

import copy
import importlib
import sys
import time

import pytest

from benchmark.harness import manifest as mf
from benchmark.harness import roofline as rf
from benchmark.harness.main import run_cell
from benchmark.reference import encoders
from benchmark.tests.tiny import tiny_cell

MAN = mf.load_manifest()

# the XOR hash of upstream's encoder (hash_variant "xor"), written plainly
# after the port's ``xor_corner_rows``: the corner rows x + y res + z res^2
# on the dense levels, (x ^ y P2 ^ z P3) mod size in uint32 on the hashed
# ones, and a trilinear sum of the float32 rows
XOR_PLUG = '''
import torch

from benchmark.reference.encoders.hash_additive import HashGridSpec

_MASK32, _PRIME_Y, _PRIME_Z = 0xFFFFFFFF, 2654435761, 805459861
CALLS = []


def _spec(model):
    return HashGridSpec.create(model.hash_levels, model.hash_features_per_level,
                               model.hash_base_res, model.hash_max_res,
                               2**model.hash_log2_T)


def shapes(model):
    spec = _spec(model)
    CALLS.append(spec.out_dim)
    return spec.out_dim, [(spec.total_rows, spec.feat_dim)]


class Encoder:
    def __init__(self, model, generator, device):
        self.spec = _spec(model)
        self.out_dim = self.spec.out_dim
        self.names = ["pos_table"]
        self.leaves = [torch.rand((self.spec.total_rows, self.spec.feat_dim),
                                  generator=generator, device=device,
                                  dtype=torch.float32)]

    def encode(self, leaves, x_unit):
        s, dev = self.spec, x_unit.device

        def col(values, dtype):
            return torch.tensor(values, dtype=dtype, device=dev)[:, None]

        scales = torch.tensor(s.scales, dtype=torch.float32, device=dev)[:, None, None]
        pos = torch.addcmul(torch.tensor(0.5, device=dev), x_unit.t().float()[None],
                            scales)
        pg = torch.floor(pos)
        frac = pos - pg
        pg = pg.clamp(min=0.0).long()
        res, sizes = col(s.resolutions, torch.long), col(s.sizes, torch.long)
        offs = col(s.offsets, torch.long)
        dense = col([r**3 <= n for r, n in zip(s.resolutions, s.sizes)], torch.bool)
        rows, ws = [], []
        for corner in range(8):
            sel = [(corner >> d) & 1 for d in range(3)]
            cx, cy, cz = (pg[:, d] + sel[d] for d in range(3))
            under = (cx + cy * res + cz * res * res) & _MASK32
            fast = cx ^ ((cy * _PRIME_Y) & _MASK32) ^ ((cz * _PRIME_Z) & _MASK32)
            rows.append(offs + torch.where(dense, under, fast) % sizes)
            w = torch.ones_like(frac[:, 0])
            for d in range(3):
                w = w * (frac[:, d] if sel[d] else 1.0 - frac[:, d])
            ws.append(w)
        rows, ws = torch.stack(rows, dim=1), torch.stack(ws, dim=1)
        n = x_unit.shape[0]
        return torch.cat([
            torch.einsum("cnf,cn->nf", leaves[0][rows[lvl].reshape(-1)].reshape(
                8, n, s.feat_dim).float(), ws[lvl]) for lvl in range(s.levels)], dim=1)
'''

# an encoder of another kind, for the counts alone
PLANES_PLUG = '''
def shapes(model):
    return 24, [(3, 512, 512, 8)]
'''


def _plug_first(monkeypatch, tmp_path, name, source):
    """``source`` as ``encoders/<name>.py`` from a folder searched before
    the tree's own, so that a file of that name in the tree does not stand
    in for it."""
    folder = tmp_path / "encoders"
    folder.mkdir(exist_ok=True)
    (folder / f"{name}.py").write_text(source)
    monkeypatch.setattr(encoders, "__path__", [str(folder)] + list(encoders.__path__))
    monkeypatch.setitem(sys.modules, f"{encoders.__name__}.{name}", None)
    monkeypatch.delitem(sys.modules, f"{encoders.__name__}.{name}")
    importlib.invalidate_caches()
    return importlib.import_module(f"{encoders.__name__}.{name}")


def _mlp_flops(enc: int) -> int:
    # xyz: enc -> 64 -> 16; rgb: 16 SH + 16 features -> 64 -> 64 -> 3
    return 2 * (enc * 64 + 64 * 16 + 32 * 64 + 64 * 64 + 64 * 3)


def test_a_configuration_with_a_new_encoder_file_runs_to_correct(monkeypatch, tmp_path):
    plug = _plug_first(monkeypatch, tmp_path, "hash_xor", XOR_PLUG)
    man, conf, traffic = tiny_cell("ethz.train")
    conf = copy.deepcopy(conf)
    model = conf["config"]["model"]
    model["hash_variant"] = "xor"
    conf["published"] = {"model": {k: model[k] for k in (
        "hash_levels", "hash_features_per_level", "hash_log2_T", "xyz_net_width",
        "dtype")}}
    assert mf.published_departures(conf) == []
    res = run_cell("ethz.train", 4_000_000_021, 0.5, True, "cpu", time.perf_counter(),
                   manifest=man, conf=conf, traffic=traffic)
    assert res["correct"], res["checks"]
    assert plug.CALLS and set(plug.CALLS) == {32}  # 16 levels x 2 features
    mfu = res["metrics"]["mfu_pct.train"]["value"]
    want = (100.0 * 3 * res["counters"]["vr_samples"] * _mlp_flops(32)
            / res["window_s"] / rf.FP32_FLOPS)
    assert mfu == pytest.approx(want, rel=1e-12)


def test_the_roofline_counts_the_encoder_a_file_brings(monkeypatch, tmp_path):
    _plug_first(monkeypatch, tmp_path, "plug_planes", PLANES_PLUG)
    model = dict(mf.config_file(MAN, "virus_ethz_commonroom")["config"]["model"],
                 encoder_type="plug_planes")
    assert rf.mlp_layers(model)[0] == (24, 64)
    assert rf.mlp_forward_flops(model) == _mlp_flops(24)
    assert rf.n_params(model) == 3 * 512 * 512 * 8 + _mlp_flops(24) // 2


def test_a_departure_from_the_published_block_shows_unless_reduced():
    conf = copy.deepcopy(mf.config_file(MAN, "virus_ethz_commonroom"))
    conf["config"]["model"]["hash_log2_T"] = 14
    assert mf.published_departures(conf) == ["model.hash_log2_T"]
    conf["reduced"] = ["hash_log2_T"]
    assert mf.published_departures(conf) == []


@pytest.mark.parametrize("name", ["virus_ethz_commonroom", "virus_rh2_livingroom"])
def test_the_published_runs_counts_stay_as_they_were(name):
    """The MLP operations a sample and B2's bytes a step, as the counts
    were before the encoder's width came from its file, so that
    ``mfu_pct.train`` and ``b2_adam_roofline`` do not move."""
    cfg = mf.config_file(MAN, name)["config"]
    assert rf.mlp_forward_flops(cfg["model"]) == 18_816
    assert rf.n_params(cfg["model"]) == 5_710_032 * 2 + 9_408
    assert rf.b2_bytes_per_step(cfg) == 28 * (5_710_032 * 2 + 9_408) == 320_025_216
