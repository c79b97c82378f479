"""``BENCHMARK.json`` against the contract's rules of form, and every name
in it resolved to its file by the harness."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark.harness import manifest as mf

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
MAN = mf.load_manifest()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_size():
    assert set(MAN) == TOP_KEYS
    assert os.path.getsize(os.path.join(mf.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(mf.ROOT, p))
    assert 1 <= len(MAN["command"]) <= 32
    for word in MAN["command"]:
        assert _line(word) and not word.startswith("/") and ".." not in word


def test_command_names_only_files_under_paths():
    for word in MAN["command"][1:]:
        if os.path.exists(os.path.join(mf.ROOT, word)):
            assert any(word == p or word.startswith(p.rstrip("/") + "/")
                       for p in MAN["paths"])


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(group):
    entries = MAN[group]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
    }[group]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        assert set(e) <= allowed, set(e) - allowed
        if group in ("end_to_end", "per_layer"):
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        if group == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace")
            assert 0.01 <= e["bound"] <= 0.25
        if group == "per_layer":
            assert e["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert _line(e["layer"])
        if group in ("configs", "workloads"):
            assert _line(e["why"])
        if group == "workloads":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])
            assert e["chips"] in (1, 4)
        if group == "configs":
            assert _line(e["source"]) and len(e["reduced"]) <= 16
            assert all(NAME.match(k) for k in e["reduced"])


def test_every_cell_reports_what_the_contract_asks():
    names = {m["name"] for m in MAN["end_to_end"]}
    assert "setup_s" in names
    setup = next(m for m in MAN["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25
    pairs = set()
    for w in MAN["workloads"]:
        e2e = [m["name"] for m in mf.end_to_end(MAN, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert mf.per_layer(MAN, w["name"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(MAN["workloads"])
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


def test_per_layer_moves_a_metric_every_listed_cell_reports():
    for m in MAN["per_layer"]:
        for cell in m["workloads"]:
            reported = {e["name"] for e in mf.end_to_end(MAN, cell)}
            assert m["moves"] in reported, (m["name"], cell)
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for m in MAN["per_layer"]:
        if m["unit"] == "%" and ("roofline" in m["name"]):
            assert m["name"].endswith("_roofline")


def test_every_name_resolves_to_its_file():
    for c in MAN["configs"]:
        assert c["file"].startswith("benchmark/")
        conf = mf.config_file(MAN, c["name"])
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert os.path.isfile(os.path.join(
            mf.BENCH_DIR, "rooms", conf["room"]["writer"] + ".py"))
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for w in MAN["workloads"]:
        kind = mf.kind_module(mf.traffic_file(w["traffic"])["kind"])
        for part in ("run", "check", "short", "control"):
            assert callable(getattr(kind, part))
        assert set(mf.limits_file(w["name"])) == set(kind.NUMBERS)
    for m in MAN["per_layer"]:
        assert callable(mf.metric_reader(m["name"]))


def test_a_reader_that_finds_nothing_returns_nothing():
    class Empty:
        trace = None
        counters = {}
        cfg = mf.config_file(MAN, MAN["configs"][0]["name"])["config"]
        from benchmark.harness import roofline

    for m in MAN["per_layer"]:
        assert mf.metric_reader(m["name"])(Empty()) is None, m["name"]


def test_configs_keep_the_published_widths():
    """Each configuration keeps the sizes its own source publishes (its
    file's ``published`` block; a key that ``reduced`` names is exempt),
    and the two files of the published ETHZ run state, and run, its ten
    widths and float32."""
    widths = ("hash_levels", "hash_features_per_level", "hash_log2_T",
              "hash_max_res", "xyz_net_width", "xyz_net_depth",
              "xyz_net_out_dim", "rgb_net_width", "rgb_net_depth", "grid_size")
    want = {"hash_levels": 16, "hash_features_per_level": 2, "hash_log2_T": 19,
            "hash_max_res": 1024, "xyz_net_width": 64, "xyz_net_depth": 1,
            "xyz_net_out_dim": 16, "rgb_net_width": 64, "rgb_net_depth": 2,
            "grid_size": 128}
    for c in MAN["configs"]:
        conf = mf.config_file(MAN, c["name"])
        assert conf["published"].get("model"), c["name"]
        assert mf.published_departures(conf) == [], c["name"]
        if c["name"] in ("virus_ethz_commonroom", "virus_rh2_livingroom"):
            for model in (conf["config"]["model"], conf["published"]["model"]):
                assert {k: model[k] for k in widths} == want
                assert model["dtype"] == "float32"


def test_manifest_is_plain_json():
    with open(os.path.join(mf.ROOT, "BENCHMARK.json")) as f:
        assert json.load(f) == MAN
