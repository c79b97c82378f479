"""Peaks of the card and the operations and bytes of the measured work.

Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense
rates: 67 TFLOP/s in float32 outside the tensor cores (the configurations
run float32 with TF32 off), 3.35 TB/s of HBM3.

The byte counts are frozen copies of ``chip_smoke.py``'s roofline
arithmetic (each input read once, each output written once):

- B1, the sorted segment sum of the hash table's gradient
  (``chip_smoke.py:642-646``): per call the (G, 8F, K) float32 values and
  the (G, K) int32 keys read, the (G, 8F, R) float32 sums written.  Over
  one backward the calls hold one key per (sample, level) and one output
  row per table row, so a step moves ``4 L N (8F + 1) + 32 F T`` bytes for
  N samples through the model, L levels of F features and T table rows;
- B2, Adam over every leaf in one launch (``chip_smoke.py:802``): each
  float32 element's parameter and gradient read, its two moments read and
  written, the parameter written: 28 bytes an element.

The MLP operations: a sample's forward pass through the xyz and rgb
layers is ``2 sum(d_in d_out)`` operations; forward and backward, three
times that.  The encoder's width (the xyz net's input) and its leaves'
sizes come from the configuration's reference encoder
(``reference/parts.py``: ``encoders/<name>.py``'s ``shapes``), so a new
encoder brings its own counts.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

from benchmark.reference import parts
from benchmark.reference.encoders.hash_additive import HashGridSpec

FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def hash_spec(model: dict) -> HashGridSpec:
    return HashGridSpec.create(model["hash_levels"], model["hash_features_per_level"],
                               model["hash_base_res"], model["hash_max_res"],
                               2 ** model["hash_log2_T"])


def encoder_shapes(model: dict):
    """``(out_dim, leaf shapes)`` of the model's encoder, by its reference
    part's ``shapes``."""
    m = SimpleNamespace(**model)
    return parts.encoder(m).shapes(m)


def mlp_layers(model: dict):
    """The (d_in, d_out) of every MLP layer, xyz net then rgb net."""
    enc = encoder_shapes(model)[0]
    xyz = [enc] + [model["xyz_net_width"]] * model["xyz_net_depth"] + [model["xyz_net_out_dim"]]
    rgb = ([16 + model["xyz_net_out_dim"]] + [model["rgb_net_width"]] * model["rgb_net_depth"]
           + [3])
    return list(zip(xyz[:-1], xyz[1:])) + list(zip(rgb[:-1], rgb[1:]))


def mlp_forward_flops(model: dict) -> int:
    """Operations of one sample's forward pass through both MLPs."""
    return 2 * sum(a * b for a, b in mlp_layers(model))


def n_params(model: dict) -> int:
    leaves = encoder_shapes(model)[1]
    return (sum(math.prod(s) for s in leaves)
            + sum(a * b for a, b in mlp_layers(model)))


def model_samples_per_step(cfg: dict) -> int:
    """Samples a training step runs the model on: the compacted budget
    (the port's automatic 32 a ray at constant dt), or the dense layout
    (exponential steps, or a budget of 0)."""
    t = cfg["training"]
    dense = t["batch_size"] * t["max_samples_per_ray"]
    budget = t["sample_budget"]
    if budget is None:
        budget = 0 if cfg["model"]["scale"] > 0.5 else t["batch_size"] * min(
            32, t["max_samples_per_ray"])
    return budget if budget > 0 else dense


def b1_bytes_per_step(cfg: dict) -> float:
    spec = hash_spec(cfg["model"])
    n = model_samples_per_step(cfg)
    L, F = spec.levels, spec.feat_dim
    return 4.0 * L * n * (8 * F + 1) + 32.0 * F * spec.total_rows


def b2_bytes_per_step(cfg: dict) -> float:
    return 28.0 * n_params(cfg["model"])
