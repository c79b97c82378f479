"""The operation and byte counts against hand counts at the two
configurations' shapes."""

from __future__ import annotations

import pytest

from benchmark.harness import manifest as mf
from benchmark.harness import roofline as rf

MAN = mf.load_manifest()


def _cfg(name):
    return mf.config_file(MAN, name)["config"]


def test_mlp_operations_by_hand():
    # xyz: 32 -> 64 -> 16; rgb: 16 SH + 16 features -> 64 -> 64 -> 3
    macs = 32 * 64 + 64 * 16 + 32 * 64 + 64 * 64 + 64 * 3
    assert macs == 9408
    for name in ("virus_ethz_commonroom", "virus_rh2_livingroom"):
        assert rf.mlp_forward_flops(_cfg(name)["model"]) == 2 * macs
        assert 3 * rf.mlp_forward_flops(_cfg(name)["model"]) == 56448


def test_table_and_parameters_by_hand():
    model = _cfg("virus_ethz_commonroom")["model"]
    spec = rf.hash_spec(model)
    # 16 levels from 16 to 1024: the dense levels hold res^3 rows rounded
    # up to 8, the hashed ones 2^19
    dense = [-(-r**3 // 8) * 8 for r in spec.resolutions if r**3 <= 2**19]
    hashed = sum(1 for r in spec.resolutions if -(-r**3 // 8) * 8 > 2**19)
    assert spec.total_rows == sum(dense) + hashed * 2**19 == 5_710_032
    assert rf.n_params(model) == 5_710_032 * 2 + 9408


@pytest.mark.parametrize("name,samples,b1_bytes", [
    # 4096 rays x 32 samples; 4 L N (8F + 1) + 32 F T
    ("virus_ethz_commonroom", 131_072, 4 * 16 * 131_072 * 17 + 64 * 5_710_032),
    # dense: 4096 rays x 256 slots
    ("virus_rh2_livingroom", 1_048_576, 4 * 16 * 1_048_576 * 17 + 64 * 5_710_032),
])
def test_step_bytes_by_hand(name, samples, b1_bytes):
    cfg = _cfg(name)
    assert rf.model_samples_per_step(cfg) == samples
    assert rf.b1_bytes_per_step(cfg) == b1_bytes
    # p and g read, two moments read and written, p written: 7 float32
    assert rf.b2_bytes_per_step(cfg) == 28 * (5_710_032 * 2 + 9408)


def test_bounds_in_milliseconds():
    ethz, rh2 = _cfg("virus_ethz_commonroom"), _cfg("virus_rh2_livingroom")
    ms = lambda b: b / rf.HBM_BYTES_PER_S * 1e3  # noqa: E731
    assert ms(rf.b1_bytes_per_step(ethz)) == pytest.approx(0.15166, rel=1e-4)
    assert ms(rf.b1_bytes_per_step(rh2)) == pytest.approx(0.44964, rel=1e-4)
    assert ms(rf.b2_bytes_per_step(ethz)) == pytest.approx(0.09553, rel=1e-4)
