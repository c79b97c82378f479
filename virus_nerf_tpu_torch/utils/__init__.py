"""Host utilities (counterpart of ``virus_nerf_tpu/utils/``): the turbo
colormap, depth images and the device-memory watchdog."""

from virus_nerf_tpu_torch.utils.helpers import (  # noqa: F401
    TURBO,
    check_device_memory,
    depth2img,
    turbo,
)
