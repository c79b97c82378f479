"""Typed experiment configuration.

Mirrors the reference JSON schema (reference: args/args.py:16-163,
args/h_params.py:3-191, README.md:86-154) so the reference's ``args/*.json``
experiment files load verbatim, but as plain frozen dataclasses instead of
reflection-populated attribute groups.  Derived quantities
(``exp_step_factor``, cascades) follow args/args.py:84 and
modules/networks.py:65-66.

The port's own copy of ``virus_nerf_tpu/configs/config.py``: the schema,
the defaults and the loaders are the JAX package's, so one JSON file
configures both.  The module is numpy only; importing it from the JAX
package would run ``virus_nerf_tpu/__init__.py``, which imports jax.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

logger = logging.getLogger("virus_nerf_tpu_torch")


@dataclass
class DatasetConfig:
    name: str = "synthetic"  # "ETHZ" | "RH2" | "synthetic"
    split_ratio: Dict[str, float] = field(
        default_factory=lambda: {"train": 0.8, "val": 0.1, "test": 0.1}
    )
    keep_N_observations: Union[str, int] = "all"
    keep_sensor: str = "all"
    sensors: List[str] = field(default_factory=lambda: ["RGBD", "USS", "ToF"])


@dataclass
class ModelConfig:
    ckpt_path: Union[bool, str] = False
    scale: float = 0.5
    encoder_type: str = "hash"  # "hash" | "triplane"
    hash_levels: int = 16
    hash_max_res: int = 1024
    hash_base_res: int = 16
    hash_log2_T: int = 19
    hash_features_per_level: int = 2
    # "additive" (fused-corner production hash) | "xor" (reference
    # bit-parity variant, used by the quality ablation)
    hash_variant: str = "additive"
    grid_type: str = "occ"  # "occ" (VIRUS grid) | "ngp"
    grid_size: int = 128
    xyz_net_width: int = 64
    xyz_net_depth: int = 1
    xyz_net_out_dim: int = 16
    rgb_net_width: int = 64
    rgb_net_depth: int = 2
    save: bool = True
    # TPU additions: compute dtype for encoder/MLP matmuls.  "mixed" keeps
    # f32 params with bf16 compute — the TPU equivalent of the reference's
    # fp16-autocast training (training/trainer.py:104).
    dtype: str = "float32"  # "float32" | "bfloat16" | "mixed"


@dataclass
class TrainingConfig:
    batch_size: int = 4096
    sampling_strategy: Dict[str, Any] = field(
        default_factory=lambda: {"imgs": "all", "pixs": "random"}
    )
    sensors: List[str] = field(default_factory=lambda: ["USS", "ToF"])
    max_steps: int = 500
    max_time: float = 45.0
    lr: float = 5e-3
    rgbd_loss_w: float = 100.0
    tof_loss_w: float = 50.0
    uss_loss_w: float = 50.0
    color_loss_w: float = 1.0
    debug_mode: bool = False
    real_time_simulation: bool = False
    # TPU additions -----------------------------------------------------
    # Per-ray sample budget of the static-shape ray march (train path).
    # The reference marches up to 1024 samples/ray (modules/rendering.py:8);
    # on TPU the sample chain is a static (n_rays, max_samples_per_ray)
    # layout; overflowing rays are stride-subsampled (see ops/ray_march.py).
    max_samples_per_ray: int = 256
    # Candidate lattice length for the occupancy-masked march.
    march_candidates: int = 1024
    # Marching quadrature: min step dt = sqrt(3)/march_resolution.  1024 is
    # bit-exact reference parity (MAX_SAMPLES, modules/rendering.py:8);
    # lower values coarsen dt proportionally — set march_candidates to the
    # same value so the lattice still spans the cube diagonal.
    march_resolution: int = 1024
    # Global compacted-sample budget per batch: the model runs only on this
    # many (valid-first) samples of the (batch_size, max_samples_per_ray)
    # layout.  None = "auto": batch_size * min(32, max_samples_per_ray) for
    # constant-dt configs (quality-validated vs the exact dense path,
    # BASELINE.md knob table), dense for exponential-stepping configs
    # (cutting their ~100+-sample rays redistributes mapping accuracy —
    # RH2 sweep, BASELINE.md round 5).  0 disables compaction explicitly.
    sample_budget: Optional[int] = None
    distortion_loss_w: float = 0.0
    # Profile the second training chunk and the evaluation after it into
    # this directory (None disables): the tracer (utils/tracing.py) is on
    # for the first two chunks, and their torch.profiler Chrome trace and
    # the tracer's phase and span readings are written there
    # (Trainer._train_chunks) — the counterpart
    # of the reference's CUDA_LAUNCH_BLOCKING debugging hooks (reference:
    # run.py:2).
    profile_dir: Optional[str] = None


@dataclass
class EvaluationConfig:
    batch_size: int = 8192
    res_map: int = 512
    res_angular: int = 512
    eval_every_n_steps: int = 25
    num_color_pts: Union[str, int] = 8
    num_depth_pts: Union[str, int] = "all"
    num_depth_pts_per_step: int = 16
    num_plot_pts: int = 8
    height_tolerance: float = 0.05
    density_map_thr: float = 10.0
    inlier_threshold: float = 0.1
    zones: Dict[str, List[float]] = field(
        default_factory=lambda: {"zone1": [0, 1], "zone2": [0, 2], "zone3": [0, 100]}
    )
    sensors: List[str] = field(
        default_factory=lambda: ["GT", "USS", "ToF", "LiDAR", "NeRF"]
    )
    plot_results: bool = False
    save_nerf_pointclouds: bool = False
    # TPU addition: per-ray sample budget at test time.
    max_samples_per_ray: int = 512
    # TPU addition: compacted-sample budget for TEST renders (same
    # semantics as training.sample_budget; None = dense parity path).
    # With a covering budget the compacted render is exact
    # (tests/test_compaction.py equivalences) and cuts the dense
    # (batch, S) model cost ~S/spr x — the mid-train eval cadence and
    # final evaluation dominate e2e wall clock (BASELINE.md round 5).
    sample_budget: Optional[int] = None


@dataclass
class NGPGridConfig:
    update_interval: int = 16
    warmup_steps: int = 256


@dataclass
class OccGridConfig:
    batch_size: int = 1024
    update_interval: int = 8
    decay_warmup_steps: int = 80
    batch_ratio_ray_update: float = 0.5
    false_detection_prob_every_m: float = 0.3
    std_every_m: float = 0.2
    nerf_pos_noise_every_m: float = 0.2
    nerf_threshold_max: float = 5.91
    nerf_threshold_slope: float = 0.01


@dataclass
class EthzConfig:
    dataset_dir: str = ""
    room: str = "commonroom"
    cam_ids: List[str] = field(default_factory=lambda: ["CAM1", "CAM3"])
    use_optimized_poses: bool = True


@dataclass
class RH2Config:
    dataset_dir: str = ""
    session: str = "session_2"
    home: str = "anto"
    room: str = "livingroom1"
    subsession: str = "subsession_1"
    home_session: str = "s1"


@dataclass
class RGBDConfig:
    angle_of_view: List[float] = field(default_factory=lambda: [90.0, 65.0])


@dataclass
class USSConfig:
    angle_of_view: List[float] = field(default_factory=lambda: [55.0, 35.0])


@dataclass
class ToFConfig:
    angle_of_view: List[float] = field(default_factory=lambda: [45.0, 45.0])
    matrix: List[int] = field(default_factory=lambda: [8, 8])
    tof_pix_size: int = 1
    sensor_calibration_error: float = 0.0
    sensor_random_error: float = 0.0


@dataclass
class LidarConfig:
    angle_min_max: Dict[str, List[float]] = field(
        default_factory=lambda: {
            "office": [-120, 120],
            "office2": [-80, 80],
            "commonroom": [-140, 60],
            "commonroom2": [-90, 45],
            "corridor": [-80, 80],
        }
    )


# JSON group name -> (attr name, dataclass)
_GROUPS = {
    "dataset": ("dataset", DatasetConfig),
    "model": ("model", ModelConfig),
    "training": ("training", TrainingConfig),
    "evaluation": ("evaluation", EvaluationConfig),
    "ngp_grid": ("ngp_grid", NGPGridConfig),
    "occ_grid": ("occ_grid", OccGridConfig),
    "ethz": ("ethz", EthzConfig),
    "RH2": ("rh2", RH2Config),
    "RGBD": ("rgbd", RGBDConfig),
    "USS": ("uss", USSConfig),
    "ToF": ("tof", ToFConfig),
    "LiDAR": ("lidar", LidarConfig),
}


@dataclass
class Config:
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    evaluation: EvaluationConfig = field(default_factory=EvaluationConfig)
    ngp_grid: NGPGridConfig = field(default_factory=NGPGridConfig)
    occ_grid: OccGridConfig = field(default_factory=OccGridConfig)
    ethz: EthzConfig = field(default_factory=EthzConfig)
    rh2: RH2Config = field(default_factory=RH2Config)
    rgbd: RGBDConfig = field(default_factory=RGBDConfig)
    uss: USSConfig = field(default_factory=USSConfig)
    tof: ToFConfig = field(default_factory=ToFConfig)
    lidar: LidarConfig = field(default_factory=LidarConfig)
    seed: int = 21  # reference seeds everything with 21 (args/args.py:71)
    save_dir: Optional[str] = None

    # ---------------------------------------------------------------- derived
    @property
    def exp_step_factor(self) -> float:
        """Exponential stepping factor (args/args.py:84)."""
        return 1.0 / 256.0 if self.model.scale > 0.5 else 0.0

    @property
    def cascades(self) -> int:
        """Number of multi-scale occupancy cascades (modules/networks.py:65)."""
        return max(1 + int(np.ceil(np.log2(2.0 * self.model.scale))), 1)

    # ---------------------------------------------------------------- io
    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for json_name, (attr, _) in _GROUPS.items():
            out[json_name] = dataclasses.asdict(getattr(self, attr))
        out["seed"] = self.seed
        return out

    def save_json(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=4)

    def make_save_dir(self, base: str = "results") -> str:
        if self.save_dir is None:
            stamp = time.strftime("%Y%m%d_%H%M%S")
            self.save_dir = os.path.join(base, self.dataset.name, stamp)
        os.makedirs(self.save_dir, exist_ok=True)
        return self.save_dir

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)


def _fill(dc_cls, data: Dict[str, Any]):
    """Build a dataclass from a dict, ignoring unknown keys (forward compat
    with reference JSONs) but warning about them."""
    known = {f.name for f in dataclasses.fields(dc_cls)}
    kwargs = {}
    for k, v in data.items():
        if k in known:
            kwargs[k] = v
        else:
            logger.debug("config: ignoring unknown key %s.%s", dc_cls.__name__, k)
    return dc_cls(**kwargs)


def load_config(path_or_dict: Union[str, Dict[str, Any]], **overrides) -> Config:
    """Load a config from a reference-style JSON file or a dict.

    Accepts the reference's ``args/*.json`` schema verbatim
    (e.g. /root/reference/args/ethz_usstof_not_optimized_gpu.json).
    """
    if isinstance(path_or_dict, str):
        with open(path_or_dict) as f:
            data = json.load(f)
    else:
        data = dict(path_or_dict)

    kwargs: Dict[str, Any] = {}
    for json_name, (attr, dc_cls) in _GROUPS.items():
        if json_name in data:
            kwargs[attr] = _fill(dc_cls, data[json_name])
    if "seed" in data:
        kwargs["seed"] = data["seed"]
    cfg = Config(**kwargs)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


def apply_cli_overrides(cfg: Config, overrides: List[str]) -> Config:
    """Apply ``GROUP.KEY=VALUE`` CLI override strings in place (values are
    parsed as JSON when possible, kept as strings otherwise).  Shared by
    the run / run_ablation / run_optimization entry points."""
    for ov in overrides:
        key, _, val = ov.partition("=")
        group, _, fld = key.partition(".")
        try:
            val = json.loads(val)
        except (ValueError, json.JSONDecodeError):
            pass  # keep as string
        if fld and not hasattr(cfg, group):
            raise SystemExit(f"unknown config group: {group}")
        tgt = getattr(cfg, group) if fld else cfg
        name = fld or group
        if not hasattr(tgt, name):
            raise SystemExit(f"unknown config field: {key}")
        setattr(tgt, name, val)
    return cfg
