"""Experiment configuration (the port's copy of the JAX package's schema)."""

from virus_nerf_tpu_torch.configs.config import (  # noqa: F401
    Config,
    apply_cli_overrides,
    load_config,
)
