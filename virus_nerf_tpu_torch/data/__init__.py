"""Datasets and batch sampling."""


def make_dataset(cfg, split: str = "train", scene=None, device="cuda"):
    """Dataset factory by config name, "synthetic" | "ETHZ" | "RH2"
    (counterpart of ``virus_nerf_tpu/data/__init__.py:make_dataset``;
    reference: training/trainer_base.py:42-65).

    Returns (DeviceDataset, Scene, info) on ``device``.
    """
    name = cfg.dataset.name
    if name == "synthetic":
        from virus_nerf_tpu_torch.data.synthetic import make_synthetic_dataset

        return make_synthetic_dataset(device=device)
    if name == "ETHZ":
        from virus_nerf_tpu_torch.data.ethz import load_ethz_dataset

        return load_ethz_dataset(cfg, split=split, scene=scene, device=device)
    if name == "RH2":
        from virus_nerf_tpu_torch.data.rh import load_rh_dataset

        return load_rh_dataset(cfg, split=split, scene=scene, device=device)
    raise ValueError(f"unknown dataset {name}")
