"""The reference's encoder and grid, found by name, as the harness finds
kinds and metric readers: a configuration whose encoder or grid the
reference lacks brings it as a new file, and nothing here changes.

- ``benchmark/reference/encoders/<name>.py``, ``<name>`` from the model's
  configuration (:func:`encoder_name`), has ``Encoder(model, generator,
  device)``: it draws its leaves from the generator first, in the port's
  order, and has ``leaves``, their program ``names``, ``out_dim`` and
  ``encode(leaves, x_unit) -> (N, out_dim)``; the module function
  ``shapes(model) -> (out_dim, [leaf shape, ...])`` gives the same sizes
  without drawing a leaf (the roofline's counts, ``harness/roofline.py``);
- ``benchmark/reference/grids/<grid_type>.py`` has ``Grid(cfg, dataset,
  scene, generator)``, which draws its initial state after the model's
  leaves, with ``due(step)``, ``update(density, step)`` (making its own
  draws; the step, which the VIRUS grid ignores, is there for grids whose
  update has a warm-up, as the NGP grid's), ``occ_bool``, ``values()``
  (the tensor ``grid_gap`` compares), and the module function
  ``program_values(state)``: the same tensor read from the port's grid
  state, by its attributes alone.
"""

from __future__ import annotations

import importlib
import importlib.util


def encoder_name(model) -> str:
    """``hash_<hash_variant>`` for the hash encoders (``hash_additive``,
    ``hash_xor``), the ``encoder_type`` otherwise (``triplane``)."""
    if model.encoder_type == "hash":
        return f"hash_{model.hash_variant}"
    return model.encoder_type


def _find(folder: str, name: str):
    module = f"{__package__}.{folder}.{name}"
    if importlib.util.find_spec(module) is None:
        raise ValueError(f"the reference has no {folder[:-1]} {name!r}: add "
                         f"benchmark/reference/{folder}/{name}.py")
    return importlib.import_module(module)


def encoder(model):
    """The encoder module of the model's configuration."""
    return _find("encoders", encoder_name(model))


def grid(grid_type: str):
    """The grid module of ``model.grid_type``."""
    return _find("grids", grid_type)
