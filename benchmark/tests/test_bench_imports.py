"""What the harness and the reference load, in a fresh interpreter: no
top-level ``jax``, ``jaxlib``, ``flax`` or ``virus_nerf_tpu`` (names
compared whole), and the reference nothing of ``virus_nerf_tpu_torch``."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from benchmark.harness import manifest as mf

REFERENCE = sorted(
    os.path.relpath(os.path.join(d, f), os.path.join(mf.BENCH_DIR, "reference"))[:-3]
    .replace(os.sep, ".")
    for d, _, files in os.walk(os.path.join(mf.BENCH_DIR, "reference"))
    for f in files if f.endswith(".py"))
ROOMS = sorted(f[:-3] for f in os.listdir(os.path.join(mf.BENCH_DIR, "rooms"))
               if f.endswith(".py"))


def _top_level_after(imports):
    code = ("import json, sys\n" + "".join(f"import {m}\n" for m in imports)
            + "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=mf.ROOT, check=True,
                         capture_output=True, text=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_and_rooms_load_nothing_of_the_program():
    mods = ([f"benchmark.reference.{m}" for m in REFERENCE]
            + [f"benchmark.rooms.{m}" for m in ROOMS])
    loaded = _top_level_after(mods)
    assert not loaded & {"jax", "jaxlib", "flax", "virus_nerf_tpu",
                         "virus_nerf_tpu_torch"}


def test_harness_and_program_load_no_jax():
    mods = ["benchmark.harness.main", "benchmark.harness.readings",
            "benchmark.kinds.train", "benchmark.kinds.eval",
            "virus_nerf_tpu_torch.training.trainer",
            "virus_nerf_tpu_torch.evaluation.evaluator",
            "virus_nerf_tpu_torch.data.ethz", "virus_nerf_tpu_torch.data.rh"]
    loaded = _top_level_after(mods)
    assert "virus_nerf_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "virus_nerf_tpu"}


def test_the_module_check_compares_whole_names(monkeypatch):
    from benchmark.harness.main import forbidden_modules

    monkeypatch.setitem(sys.modules, "virus_nerf_tpu_torch_x", sys)
    assert "virus_nerf_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "virus_nerf_tpu.ops", sys)
    assert forbidden_modules() == ["virus_nerf_tpu"]
