"""virus_nerf_tpu_torch — the PyTorch / CUDA port of virus_nerf_tpu.

The JAX package ``virus_nerf_tpu`` stays the reference; this package
mirrors its layout (``ops/``, ``models/``, ``grids/``, ``data/``,
``training/``) so each module's counterpart is easy to find.  It imports
``torch`` and numpy, never ``jax`` and nothing of the JAX package: the
numpy-only modules it needs from there (the config schema, the scene, the
sensor models, the evaluation geometry and metrics) are copies.

Plain tensor code is PyTorch.  The TPU's Pallas kernels on the training
path are hand-written CUDA C++ for Hopper (``csrc/``), built at first use
(``ops/_build.py``).  Entry points (datasets, converters, the evaluator,
``run``, ``run_ablation``, ``quality_run``) put their tensors on ``cuda``
unless the caller passes another device; without a card they raise.  A kernel wrapper given a CPU
tensor runs the plain PyTorch version of the same function; given a CUDA
tensor it launches the kernel or raises.
"""

__version__ = "0.1.0"
