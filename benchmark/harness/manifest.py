"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads``) names a configuration, whose ``file`` is
``benchmark/configs/<config>.json`` (the run configuration under
``config``, the sizes its source publishes under ``published``), and a traffic mix,
``benchmark/traffic/<traffic>.json``: data, whose ``kind`` names the loop
that reads it, ``benchmark/kinds/<kind>.py`` (its set-up, window, check,
control and faults).  The cell's limits are
``benchmark/checks/<cell>.json``; a per-layer metric is read by
``benchmark/metrics/<metric>.py``.  Adding any of them is adding files and
entries: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                   f"{[w['name'] for w in manifest['workloads']]})")


def config_file(manifest: dict, config: str, root: str = ROOT) -> dict:
    for c in manifest["configs"]:
        if c["name"] == config:
            return _read_json(os.path.join(root, c["file"]))
    raise KeyError(f"no config {config!r} in BENCHMARK.json")


def published_departures(conf: dict) -> List[str]:
    """The keys of a configuration file's ``published`` block (``{group:
    {key: value}}``: the sizes its source publishes) from which the run
    configuration departs, leaving out those that ``reduced`` names (as
    ``key`` or ``group.key``)."""
    reduced = set(conf["reduced"])
    return [f"{group}.{k}" for group, keys in conf["published"].items()
            for k, v in keys.items()
            if k not in reduced and f"{group}.{k}" not in reduced
            and conf["config"][group].get(k) != v]


def traffic_file(traffic: str) -> dict:
    return _read_json(os.path.join(BENCH_DIR, "traffic", f"{traffic}.json"))


def limits_file(cell: str) -> Dict[str, float]:
    return _read_json(os.path.join(BENCH_DIR, "checks", f"{cell}.json"))


def end_to_end(manifest: dict, cell: str) -> List[dict]:
    """The cell's end-to-end metrics: those without ``workloads`` and
    those that list it."""
    return [m for m in manifest["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer(manifest: dict, cell: str) -> List[dict]:
    """The cell's per-layer metrics: those that list it, and those without
    ``workloads`` where the cell reports their ``moves`` metric."""
    reported = {m["name"] for m in end_to_end(manifest, cell)}
    return [m for m in manifest["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


_MODULES: Dict[str, object] = {}


def _module(folder: str, name: str):
    """``benchmark/<folder>/<name>.py``, loaded once."""
    key = f"benchmark_{folder}_" + name.replace(".", "_").replace("-", "_")
    if key not in _MODULES:
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(BENCH_DIR, folder, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


def metric_reader(name: str):
    """The ``read(ctx)`` function of ``benchmark/metrics/<name>.py``."""
    return _module("metrics", name).read


def kind_module(kind: str):
    """``benchmark/kinds/<kind>.py``: the loop a traffic mix of that kind
    drives (``run``, ``check``, ``NUMBERS``, ``short``, ``control``,
    ``FAULTS``)."""
    return _module("kinds", kind)
