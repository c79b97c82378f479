"""Run one cell of the benchmark of ``virus_nerf_tpu_torch`` once.

    python3 benchmark/run.py --workload ethz.train --seed 7 --seconds 30 --trace 0

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``benchmark/configs/<config>.json``) and a traffic mix
(``benchmark/traffic/<traffic>.json``), whose ``kind`` names the loop
that drives it (``benchmark/kinds/<kind>.py``); the per-layer metrics of
a ``--trace 1`` run are read by ``benchmark/metrics/<metric>.py``.  The run
sets up (the room from its cache, the weights from ``--seed`` on the card,
the warm-up that builds and captures everything the window uses), measures
for ``--seconds`` seconds, then checks what the window's path produced
against the plain reference in ``benchmark/reference/``.  The last line of
standard output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``), with the
numbers compared beside their limits under ``checks``; the same numbers are
the last lines of standard error.

It needs a CUDA card: without one, or with fewer than the cell asks for,
it exits with code 2 and prints no result.  Caches (the rooms, Triton's and
PyTorch's extension directories) live in fixed folders inside the checkout;
the program's kernels build into ``build/``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "benchmark", ".cache")
# the program's and the libraries' build caches at fixed paths in the
# checkout, and few host threads (one process drives one card)
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(CACHE, "inductor")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")
os.environ["USE_FLAX"] = "0"
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "4"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
