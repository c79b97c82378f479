"""The port trainer's automatic sample budget (``Trainer._sample_budget``)
against the JAX trainer's (virus_nerf_tpu/training/trainer.py:222-243):
left unset, a constant-dt config (``exp_step_factor == 0``, scale 0.5)
compacts to ``batch * min(32, S)`` samples and an exponential-stepping one
(scale 1.0) stays dense; an explicit 0 is dense and an explicit n is n.
The port's ``Trainer`` still refuses ``exp_step_factor > 0``, so the
method is called on the config alone; the JAX side's budget is the one
its train-step body closes over."""

import types

import pytest

from virus_nerf_tpu.configs.config import Config as JConfig
from virus_nerf_tpu.data import make_synthetic_dataset as j_make_dataset
from virus_nerf_tpu.training import Trainer as JTrainer
from virus_nerf_tpu_torch.configs.config import Config
from virus_nerf_tpu_torch.training.trainer import Trainer

BATCH, SAMPLES = 128, 48


def _small(cfg, scale):
    cfg.model.scale = scale
    cfg.model.hash_levels, cfg.model.hash_features_per_level = 8, 4
    cfg.model.hash_log2_T, cfg.model.hash_max_res, cfg.model.grid_size = 12, 64, 32
    cfg.training.batch_size = BATCH
    cfg.training.max_samples_per_ray = SAMPLES
    return cfg


@pytest.fixture(scope="module")
def jax_trainers():
    """One JAX trainer per scale, on a tiny synthetic scene."""
    ds, scene, _ = j_make_dataset(n_images=2, img_wh=(16, 12), n_gt_points=200)
    return {s: JTrainer(_small(JConfig(), s), ds, scene=scene) for s in (0.5, 1.0)}


def _jax_budget(trainer, budget):
    trainer.cfg.training.sample_budget = budget
    body = trainer._make_train_body()
    free = dict(zip(body.__code__.co_freevars, body.__closure__))
    return free["sample_budget"].cell_contents


@pytest.mark.parametrize("budget", [None, 0, 1000])
@pytest.mark.parametrize("scale", [0.5, 1.0])
def test_sample_budget_follows_the_jax_rule(jax_trainers, scale, budget):
    cfg = _small(Config(), scale)
    cfg.training.sample_budget = budget
    assert cfg.exp_step_factor == (0.0 if scale == 0.5 else 1.0 / 256.0)
    got = Trainer._sample_budget(types.SimpleNamespace(cfg=cfg))
    want = {None: BATCH * 32 if scale == 0.5 else None, 0: None, 1000: 1000}[budget]
    assert got == want
    assert got == _jax_budget(jax_trainers[scale], budget)
