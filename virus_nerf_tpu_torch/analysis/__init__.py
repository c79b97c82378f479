"""Offline result/experiment analysis (no training dependencies).

Counterpart of ``virus_nerf_tpu/analysis/`` and of the reference's
``plotting/`` tree
(reference: plotting/{datasets,training,USS_experiments,optimization}):

- :mod:`.uss_experiments` — lab bench characterization of the ultrasonic
  sensors (polar error fans, cross-sensor comparison, tilted-object study)
  from the experiment CSV layout.
- :mod:`.result_plots` — result-directory analyses: calibration-error bar
  charts and NeRF point-cloud scatter maps.

PSO result-directory analyses live in
:mod:`virus_nerf_tpu_torch.optimization.plots`
(reference: optimization/plotter_ethz.py, plotting/optimization/).
matplotlib is imported when a figure is drawn, so the package imports
where it is missing (a figure then raises ImportError naming it).
"""

from virus_nerf_tpu_torch.analysis.result_plots import plot_calibration_error, plot_pointclouds
from virus_nerf_tpu_torch.analysis.uss_experiments import (
    USSExperimentData,
    load_experiment_csv,
    plot_angular_characterization,
    plot_sensor_comparison,
    plot_tilted_object,
)

__all__ = [
    "USSExperimentData",
    "load_experiment_csv",
    "plot_angular_characterization",
    "plot_sensor_comparison",
    "plot_tilted_object",
    "plot_calibration_error",
    "plot_pointclouds",
]
