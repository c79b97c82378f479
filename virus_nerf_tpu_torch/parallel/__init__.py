"""Data parallelism over ``torch.distributed`` and population parallelism
for PSO (counterpart of ``virus_nerf_tpu/parallel/``)."""

from virus_nerf_tpu_torch.parallel.data_parallel import (  # noqa: F401
    Mesh,
    dryrun_multichip,
    make_dp_occ_update,
    make_dp_train_chunk,
    make_dp_train_step,
    make_mesh,
    replica_mismatches,
    shard_state,
    spawn_ranks,
)
from virus_nerf_tpu_torch.parallel.population import (  # noqa: F401
    make_population_eval,
    particle_configs,
    population_devices,
)
