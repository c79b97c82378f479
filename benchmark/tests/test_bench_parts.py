"""The reference's encoder and grid found by name (``reference/parts.py``):
a new file is enough to add one, an unknown name says which file to add,
and a grid part reads the port's grid state."""

from __future__ import annotations

import importlib
import sys
from types import SimpleNamespace

import pytest
import torch

from benchmark.reference import encoders, grids, parts
from benchmark.reference.model import PlainNGP

MODEL = dict(encoder_type="hash", hash_variant="additive", hash_levels=4,
             hash_features_per_level=2, hash_base_res=16, hash_max_res=64,
             hash_log2_T=10, scale=0.5, grid_size=16, xyz_net_width=16,
             xyz_net_depth=1, xyz_net_out_dim=16, rgb_net_width=16, rgb_net_depth=1)


def _cfg(**model):
    return SimpleNamespace(model=SimpleNamespace(**dict(MODEL, **model)))


def _plug(monkeypatch, tmp_path, package, name, source):
    """``source`` as ``<package>/<name>.py`` from a folder of the package's
    own outside the tree."""
    folder = tmp_path / package.__name__.rsplit(".", 1)[-1]
    folder.mkdir(exist_ok=True)
    (folder / f"{name}.py").write_text(source)
    monkeypatch.setattr(package, "__path__", list(package.__path__) + [str(folder)])
    # absent before the import and again after the test
    monkeypatch.setitem(sys.modules, f"{package.__name__}.{name}", None)
    monkeypatch.delitem(sys.modules, f"{package.__name__}.{name}")
    importlib.invalidate_caches()


@pytest.mark.parametrize("model,name", [
    ({}, "hash_additive"), ({"hash_variant": "xor"}, "hash_xor"),
    ({"encoder_type": "triplane"}, "triplane")])
def test_the_encoder_name_follows_the_configuration(model, name):
    assert parts.encoder_name(_cfg(**model).model) == name


def test_a_new_encoder_file_is_found_by_name(monkeypatch, tmp_path):
    """An encoder written as a file beside the others (here: the additive
    hash again, under the hash variant ``plug``) is the model's encoder,
    with no other change."""
    _plug(monkeypatch, tmp_path, encoders, "hash_plug",
          "from benchmark.reference.encoders.hash_additive import Encoder  # noqa: F401\n")
    x = torch.rand((64, 3), generator=torch.Generator().manual_seed(1)) - 0.5
    models = [PlainNGP(_cfg(hash_variant=v), torch.Generator().manual_seed(7), "cpu")
              for v in ("additive", "plug")]
    assert type(models[1].encoder).__module__ == "benchmark.reference.encoders.hash_additive"
    assert models[1].names == models[0].names
    assert all(torch.equal(a, b) for a, b in zip(models[0].params, models[1].params))
    assert torch.equal(models[0].density(x), models[1].density(x))


def test_a_new_grid_file_is_found_by_name(monkeypatch, tmp_path):
    _plug(monkeypatch, tmp_path, grids, "plug",
          "def program_values(state):\n    return state.plug_values\n")
    state = SimpleNamespace(plug_values=torch.ones(2))
    assert parts.grid("plug").program_values(state) is state.plug_values


@pytest.mark.parametrize("find,file", [
    (lambda: parts.encoder(_cfg(encoder_type="no_such_encoder").model),
     "benchmark/reference/encoders/no_such_encoder.py"),
    (lambda: PlainNGP(_cfg(hash_variant="no_such_hash"), torch.Generator(), "cpu"),
     "benchmark/reference/encoders/hash_no_such_hash.py"),
    (lambda: parts.grid("no_such_grid"), "benchmark/reference/grids/no_such_grid.py")])
def test_an_unknown_part_names_the_file_to_add(find, file):
    """Names that no configuration brings, so that adding a real part
    (``encoders/hash_xor.py``, ``encoders/triplane.py``, ``grids/ngp.py``)
    leaves this test as it is."""
    with pytest.raises(ValueError, match=file):
        find()


def test_program_values_reads_the_ports_virus_grid():
    from virus_nerf_tpu_torch.grids.occupancy_grid import OccGridHParams, occ_grid_init

    state = occ_grid_init(OccGridHParams(grid_size=8, scale=0.5),
                          generator=torch.Generator().manual_seed(3))
    assert parts.grid("occ").program_values(state) is state.occ_3d_grid
