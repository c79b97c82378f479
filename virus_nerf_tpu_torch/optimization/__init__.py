"""Hyper-parameter optimization: PSO over whole training runs.

Counterpart of ``virus_nerf_tpu/optimization/`` (reference:
optimization/particle_swarm_optimization.py,
particle_swarm_optimization_wrapper.py, metric.py, run_optimization.py):
the swarm, its search space, the synthetic objectives, the runners,
``parallel_eval`` (the loss weights of a swarm's particles trained
together) and the PSO plots (``plots``: matplotlib, imported when a plot
is drawn).
"""

from virus_nerf_tpu_torch.optimization.metric import SyntheticMetric  # noqa: F401
from virus_nerf_tpu_torch.optimization.pso import (  # noqa: F401
    DEFAULT_PSO_PARAMS,
    HParamSpace,
    Lease,
    MultiWorkerPSO,
    ParticleSwarmOptimization,
    PSOState,
    PSOWrapper,
)
from virus_nerf_tpu_torch.optimization.plots import (  # noqa: F401
    load_history,
    plot_all,
    plot_convergence,
    plot_hparam_scores,
    plot_hparam_trajectories,
    plot_metric_landscape,
    plot_pso_results,
    summarize_pso,
)
from virus_nerf_tpu_torch.optimization.parallel_eval import (  # noqa: F401
    make_population_eval,
)
from virus_nerf_tpu_torch.optimization.runner import (  # noqa: F401
    apply_hparams,
    run_optimization,
    run_worker,
    score_from_metrics,
)
