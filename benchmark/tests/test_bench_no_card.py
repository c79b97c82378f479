"""The command refuses to measure without a card: exit code 2 and no
result, from the checkout and from a folder that holds only
``BENCHMARK.json`` and the benchmark's own files."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

from benchmark.harness import manifest as mf

ARGS = ["--workload", "ethz.train", "--seed", "4000000001", "--seconds", "1",
        "--trace", "0"]


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *mf.load_manifest()["command"][1:], *ARGS],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_refuses_without_a_card():
    out = _run(mf.ROOT)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_refuses_beside_nothing_but_the_benchmark(tmp_path):
    shutil.copy(os.path.join(mf.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(mf.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
