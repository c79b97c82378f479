"""Synthetic PSO objectives — the optimization layer's test double.

The port's copy of ``virus_nerf_tpu/optimization/metric.py`` (numpy only;
importing it from the JAX package would run its ``__init__``, which
imports jax).  Counterpart of the reference's fake objectives
(reference: optimization/metric.py:6-180): noisy multimodal functions with
parameters persisted to disk, so a crashed-and-relaunched optimization run
keeps optimizing the *same* objective (the property the crash/resume test
exercises, test_scripts/optimization/test_particle_swarm_optimization.py).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np


class SyntheticMetric:
    """gauss / cos / rand objectives over the hyper-parameter box."""

    def __init__(
        self,
        metric_name: str,
        hparams_lims: np.ndarray,
        rng: np.random.Generator,
        save_dir: str,
    ):
        if metric_name not in ("gauss", "cos", "rand"):
            raise ValueError(f"unknown metric {metric_name}")
        self.name = metric_name
        self.rng = rng
        path = os.path.join(save_dir, "metric_params.json")
        if os.path.exists(path):
            with open(path) as f:
                d = json.load(f)
            self.centre = np.asarray(d["centre"])
            self.std = np.asarray(d["std"])
            self.freq = np.asarray(d["freq"])
            self.rand_std = float(d["rand_std"])
        else:
            lims = np.asarray(hparams_lims, np.float64)
            delta = lims[:, 1] - lims[:, 0]
            self.centre = rng.uniform(lims[:, 0], lims[:, 1])
            self.std = rng.uniform(delta / 6, delta / 3)
            self.freq = rng.uniform(delta / 6, delta)
            self.rand_std = 0.1
            os.makedirs(save_dir, exist_ok=True)
            with open(path, "w") as f:
                json.dump(
                    {
                        "centre": self.centre.tolist(),
                        "std": self.std.tolist(),
                        "freq": self.freq.tolist(),
                        "rand_std": self.rand_std,
                    },
                    f,
                )

    def __call__(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float64)
        if self.name == "gauss":
            return self.gauss(X)
        if self.name == "cos":
            return self.cos(X)
        return self.rand(X)

    def gauss(self, X):
        """1 - Gaussian bump around the hidden centre (minimum = 0 there)."""
        return 1.0 - np.exp(
            -np.sum((X - self.centre) ** 2 / self.std**2, axis=-1)
        )

    def cos(self, X):
        """Multimodal: Gaussian envelope x cosine comb."""
        comb = 1.0 - np.prod(
            (np.cos(2 * np.pi * self.freq * (X - self.centre)) + 1) / 2,
            axis=-1,
        )
        return comb * self.gauss(X)

    def rand(self, X):
        """cos objective + Gaussian evaluation noise, clipped to [0, 1]."""
        noise = self.rng.normal(0.0, self.rand_std, size=np.shape(self.cos(X)))
        return np.clip(self.cos(X) + noise, 0.0, 1.0)
