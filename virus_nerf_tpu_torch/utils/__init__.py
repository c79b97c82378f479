"""Utilities (counterpart of ``virus_nerf_tpu/utils/``): numeric, plotting
and system helpers, deployment export and logging."""

from virus_nerf_tpu_torch.utils.deployment import (  # noqa: F401
    infer_density_map,
    save_deployment_model,
)
from virus_nerf_tpu_torch.utils.helpers import (  # noqa: F401
    TURBO,
    check_device_memory,
    combine_imgs,
    convolve_ignore_nans,
    data_converged,
    depth2img,
    downsample_data,
    lin_interpolate_array,
    lin_interpolate_nans,
    sensor_id2name,
    sensor_name2id,
    smooth_ignore_nans,
    turbo,
)
from virus_nerf_tpu_torch.utils.logging import make_logger  # noqa: F401
