"""The port's two PSO population evaluators against the JAX package's.

``parallel/population.py`` (a Trainer a particle, hyper-parameters through
``apply_hparams``): the particles' configs and seeds field for field
against the JAX ``make_population_eval``'s, each particle's score equal to
the port's serial run of its config, and a 2-iteration
``run_optimization(batch_eval=...)``.  ``optimization/parallel_eval.py``
(the loss weights of one Trainer a particle): the scores against the JAX
``batch_eval`` when the port's trainer is given each seed's JAX initial
state and draws (the key splits of the JAX chunk body, as
``test_torch_slice.py``), the padding to a multiple of the devices and the
refusals.  Small: 4 x F = 2 hash levels of 2^12 rows, a 32^3 grid, 128
rays, 6-8 steps a particle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from virus_nerf_tpu.data import make_synthetic_dataset as j_make_dataset
from virus_nerf_tpu.data.dataset import sample_batch as j_sample_batch
from virus_nerf_tpu.optimization.parallel_eval import (
    make_population_eval as j_weights_eval,
)
from virus_nerf_tpu.optimization.pso import HParamSpace as JHParamSpace
from virus_nerf_tpu.parallel import population as j_population
from virus_nerf_tpu.training import Trainer as JTrainer
from virus_nerf_tpu_torch.configs.config import Config
from virus_nerf_tpu_torch.convert import (
    adam_state_from_jax,
    grid_from_jax,
    params_from_jax,
)
from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
from virus_nerf_tpu_torch.evaluation.evaluator import Evaluator
from virus_nerf_tpu_torch.optimization import HParamSpace, run_optimization
from virus_nerf_tpu_torch.optimization.parallel_eval import make_population_eval
from virus_nerf_tpu_torch.optimization.runner import score_from_metrics
from virus_nerf_tpu_torch.parallel import population
from virus_nerf_tpu_torch.training.loss import weights_tensor
from virus_nerf_tpu_torch.training.trainer import Trainer

from test_torch_slice import _np, _port_batch

torch.set_num_threads(1)

DATA_KW = dict(n_images=4, img_wh=(32, 24), n_gt_points=2000)
LIMS = {
    "training": {"pixs_valid_uss": [0.2, 0.6], "pixs_valid_tof": [0.2, 0.6]},
    "occ_grid": {"update_interval": [2, 6]},
}
# swarm positions of the loss-weight evaluator: (color, rgbd, tof, uss)
WEIGHTS = np.array([[1.0, 1.0, 1.0, 1.0], [1.0, 1.0, 8.0, 8.0],
                    [0.2, 1.0, 1.0, 1.0], [1.0, 1.0, 0.1, 0.1]], np.float32)


def pop_config(cls=Config):
    cfg = cls()
    m, t, ev = cfg.model, cfg.training, cfg.evaluation
    m.grid_type, m.grid_size = "occ", 32
    m.hash_levels, m.hash_features_per_level = 4, 2
    m.hash_log2_T, m.hash_max_res = 12, 64
    t.batch_size, t.max_samples_per_ray = 128, 32
    t.march_candidates = t.march_resolution = 128
    t.sample_budget = 128 * 12
    t.sampling_strategy = {"imgs": "all",
                           "pixs": {"valid_uss": 0.4, "valid_tof": 0.4}}
    t.sensors = ["USS", "ToF"]
    t.max_steps, t.max_time = 6, 1e9
    cfg.occ_grid.batch_size, cfg.occ_grid.update_interval = 64, 4
    ev.eval_every_n_steps = 3
    ev.res_angular, ev.res_map, ev.batch_size, ev.max_samples_per_ray = (
        32, 64, 512, 32)
    return cfg


@pytest.fixture(scope="module")
def data():
    return make_synthetic_dataset(device="cpu", **DATA_KW)


def test_particle_configs_and_seeds_match_jax(monkeypatch):
    # the JAX evaluator with a stand-in Trainer that records each particle's
    # config and trains nothing (a NaN loss: every score inf, no evaluation)
    from virus_nerf_tpu.configs.config import Config as JConfig

    seen = []

    class Recorder:
        def __init__(self, cfg, ds, scene=None):
            seen.append(cfg.to_dict())

        def init_state(self):
            return jnp.zeros(())

        def _make_chunk_body(self, chunk_steps):
            return lambda s, d, e: (s, {"loss": jnp.full((chunk_steps,), jnp.nan)})

    monkeypatch.setattr("virus_nerf_tpu.training.trainer.Trainer", Recorder)
    jds = j_make_dataset(**DATA_KW)
    jbase = pop_config(JConfig)
    jbase.seed = 7
    be = j_population.make_population_eval(
        jbase, JHParamSpace(LIMS), (jds, jds), devices=jax.devices("cpu")[:2])
    base = pop_config()
    base.seed = 7
    space = HParamSpace(LIMS)
    rng = np.random.default_rng(3)
    for call in (1, 2):
        pos = rng.random((5, space.num_dimensions))
        seen.clear()
        assert np.all(np.isinf(be(pos)))
        got = [c.to_dict() for c in population.particle_configs(base, space, pos,
                                                                call)]
        assert got == seen
        assert [c["seed"] for c in got] == [7 + 1000 * call + i for i in range(5)]
        assert len({c["occ_grid"]["update_interval"] for c in got}) > 1


def _serial_score(cfg, data):
    ds, scene, info = data
    tr = Trainer(cfg, ds, scene=scene, device="cpu")
    st = tr.train()
    ev = Evaluator(cfg, ds, scene, img_wh=info["img_wh"], device="cpu")
    metrics, _ = ev.evaluate_depth(st.model, st.grid.occ_bool,
                                   np.arange(ds.n_images), sensors=("NeRF",))
    return score_from_metrics(metrics)


def test_each_particle_scores_as_its_serial_run(data):
    base = pop_config()
    space = HParamSpace(LIMS)
    pos = np.random.default_rng(4).random((3, space.num_dimensions))
    be = population.make_population_eval(base, space, (data, data),
                                         devices=["cpu", "cpu"])
    scores = be(pos)
    assert np.all(np.isfinite(scores))
    cfgs = population.particle_configs(base, space, pos, 1)
    for cfg, score in zip(cfgs, scores):
        assert score == _serial_score(cfg, data)


def test_two_pso_iterations_through_run_optimization(data, tmp_path):
    base = pop_config()
    base.training.max_steps = 4
    be = population.make_population_eval(base, HParamSpace(LIMS), (data, data),
                                         devices=["cpu"])
    pso = run_optimization(base, LIMS, str(tmp_path / "pso"),
                           train_and_eval=None, T=1e9, termination_by_time=False,
                           max_iters=2, rng=np.random.default_rng(0),
                           batch_eval=be)
    assert pso.pso.state.t == 2 * 5  # two whole iterations of 5 particles
    assert np.isfinite(pso.best_score)
    assert np.all(np.isfinite(pso.pso.state.best_score))
    assert (tmp_path / "pso" / "pso_state.json").exists()  # resumable


# --------------------------------------------- the loss-weight evaluator
class JaxDraws:
    """Each seed's JAX initial state and draws, handed to a port trainer
    through its own ``init_state`` / ``grid_update`` / ``train_step``: the
    key chain of the JAX chunk body (trainer.py:373-385, 249-253).  A batch
    is drawn when the port asks for it, with the elapse time the port
    hands its step (under ``real_time_simulation`` the image filter's, as
    the JAX body's ``use_time``)."""

    def __init__(self, cfg, steps, seeds):
        self.jds, jscene, _ = j_make_dataset(**DATA_KW)
        self.jt = JTrainer(cfg, self.jds, scene=jscene)
        self.cfg, self.init, self.keys = cfg, {}, {}
        interval = cfg.occ_grid.update_interval
        self._draw = jax.jit(lambda k, n, strategy, et: j_sample_batch(
            self.jds, k, n, {"imgs": "all", "pixs": strategy}, et),
            static_argnums=(1, 2))
        for seed in seeds:
            js = self.jt.init_state(seed)
            self.init[seed] = js
            key, occ, train = js.key, {}, {}
            for step in range(steps):
                if step % interval == 0:
                    key, k1, k2, k3 = jax.random.split(key, 4)
                    noise = jax.random.uniform(jax.random.split(k3)[1],
                                               (32, 32, 3), jnp.float32)
                    occ[step] = (k1, k2, torch.from_numpy(
                        np.array(noise * 2.0 - 1.0)))
                key, kb, kr = jax.random.split(key, 3)
                train[step] = (kb, torch.from_numpy(np.array(
                    jax.random.uniform(kr, (cfg.training.batch_size,)))))
            self.keys[seed] = (occ, train)

    def batch(self, key, n, pixs, et):
        et = None if et is None else jnp.float32(float(et))
        if isinstance(pixs, dict):  # unhashable: not a static argument
            return _port_batch(j_sample_batch(
                self.jds, key, n, {"imgs": "all", "pixs": pixs}, et))
        return _port_batch(self._draw(key, n, pixs, et))

    def install(self, pt):
        # a state's draws by its generator's seed (the evaluator resets one
        # state in place for each particle: its generator takes the seed)
        t = self.cfg.training

        def init_state(seed=None):
            js = self.init[seed]
            ps = Trainer.init_state(pt, seed)
            ps.model.load_state_dict(params_from_jax(_np(js.params), device="cpu"))
            count, mu, nu = adam_state_from_jax(_np(js.opt_state), device="cpu")
            ps.optimizer.load_moments(ps.model.named_parameters(), count, mu, nu)
            ps.grid = grid_from_jax(_np(js.grid), device="cpu")
            return ps

        def grid_update(state, elapse_time=None, group=None):
            k1, k2, noise = self.keys[state.generator.initial_seed()][0][
                state.step]
            et = pt._elapse(elapse_time)
            pt.grid_update_on(state, self.batch(k1, 32, "valid_tof", et),
                              self.batch(k2, 32, "valid_uss", et), noise)

        def train_step(state, elapse_time=None, group=None):
            kb, noise = self.keys[state.generator.initial_seed()][1][state.step]
            batch = self.batch(kb, t.batch_size, t.sampling_strategy["pixs"],
                               pt._elapse(elapse_time))
            return pt.train_step_on(state, batch, noise)

        pt.init_state, pt.grid_update, pt.train_step = (
            init_state, grid_update, train_step)


def test_weights_eval_matches_jax_given_its_init_and_draws(data):
    # 4 particles x 8 steps; each seed's JAX initial state and draws on the
    # port's side, so the scores differ by float32 op order and the Adam
    # steps of near-zero gradients alone (ROADMAP C8): within 1e-4
    cfg = pop_config()
    jdraws = JaxDraws(cfg, 8, range(4))
    want = j_weights_eval(jdraws.jt, jdraws.jds, steps=8)(WEIGHTS)
    ds, scene, _ = data
    pt = Trainer(cfg, ds, scene=scene, device="cpu")
    jdraws.install(pt)
    got = make_population_eval(pt, steps=8)(WEIGHTS)
    assert got.shape == (4,) and got.dtype == np.float64
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # the weights steer the score: up-weighted depth sensors raise the loss
    assert got[1] > got[3]
    assert pt.loss_weights == Trainer(cfg, ds, scene=scene,
                                      device="cpu").loss_weights
    # the particles' weights went through the trainer's device tensor,
    # which holds the trainer's own again
    assert torch.equal(pt.device_loss_weights,
                       weights_tensor(pt.loss_weights, "cpu"))


def test_weights_eval_in_real_time_matches_jax_given_its_init_and_draws(data):
    # under real-time simulation the JAX swarm trains every particle at an
    # elapse time of 0 s, so only the images taken by then are drawn; the
    # port's steps must draw at the same time (a step given no time draws
    # from every image and scores apart).  4 particles x 8 steps, within
    # 1e-4 as above
    cfg = pop_config()
    cfg.training.real_time_simulation = True
    jdraws = JaxDraws(cfg, 8, range(4))
    want = j_weights_eval(jdraws.jt, jdraws.jds, steps=8)(WEIGHTS)
    ds, scene, _ = data
    pt = Trainer(cfg, ds, scene=scene, device="cpu")
    jdraws.install(pt)
    got = make_population_eval(pt, steps=8)(WEIGHTS)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_weights_eval_restores_the_weights_when_a_particle_fails(data):
    ds, scene, _ = data
    pt = Trainer(pop_config(), ds, scene=scene, device="cpu")
    base = pt.loss_weights
    train_step, calls = pt.train_step, []

    def failing(state, elapse_time=None, group=None):
        calls.append(state.step)
        if len(calls) == 6:  # particle 1's second step
            raise RuntimeError("a failing step")
        return train_step(state, elapse_time, group)

    pt.train_step = failing
    with pytest.raises(RuntimeError, match="a failing step"):
        make_population_eval(pt, steps=4)(WEIGHTS)
    # the trainer's own weights, on the host and in device memory
    assert pt.loss_weights == base
    assert torch.equal(pt.device_loss_weights, weights_tensor(base, "cpu"))


def test_weights_eval_pads_to_the_devices_and_refuses_bad_shapes(data):
    ds, scene, _ = data
    cfg = pop_config()
    pt = Trainer(cfg, ds, scene=scene, device="cpu")
    be = make_population_eval(pt, steps=4, devices=["cpu", "cpu"],
                              score_tail=2)
    full = be(WEIGHTS)
    part = be(WEIGHTS[:3])  # padded to 4 particles, trimmed to 3
    assert part.shape == (3,)
    np.testing.assert_array_equal(part, full[:3])
    # a device's particles take turns on one state, reset in place: each
    # score is its particle's run alone from a fresh state, bit for bit
    alone = Trainer(cfg, ds, scene=scene, device="cpu")
    alone.loss_weights = alone.loss_weights._replace(
        **dict(zip(("color", "rgbd", "tof", "uss"), map(float, WEIGHTS[3]))))
    _, keys, m = alone.make_train_chunk(4)(alone.init_state(seed=3))
    assert float(m[-2:, keys.index("loss")].mean()) == full[3]
    with pytest.raises(ValueError, match="positions"):
        be(WEIGHTS[:, :3])
    with pytest.raises(ValueError, match="positions"):
        be(WEIGHTS[0])
    # distortion gates a branch: it is no particle's weight
    with pytest.raises(ValueError, match="weight_fields"):
        make_population_eval(pt, weight_fields=("color", "distortion"))
    # a 2-D (pop, data) nesting needs a process group of pop * data ranks
    # (tests/test_torch_parallel.py runs one on four gloo ranks)
    with pytest.raises(ValueError, match="process group"):
        make_population_eval(pt, devices=[["cpu", "cpu"], ["cpu", "cpu"]])
