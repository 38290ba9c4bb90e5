"""BENCHMARK.json against the benchmark's contract, and every file it names."""
import json
import re

import pytest

from perfbench import harness

M = harness.load_manifest()
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
NAMES = [m["name"] for m in M["end_to_end"]] + [m["name"] for m in M["per_layer"]] + \
    [w["name"] for w in M["workloads"]] + [c["name"] for c in M["configs"]]


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "perfbench/run.py"] and M["paths"] == ["perfbench"]
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert len(json.dumps(M)) < 64 * 1024


@pytest.mark.parametrize("name", NAMES)
def test_name_characters(name):
    assert NAME_RE.match(name), name


@pytest.mark.parametrize("metric", M["end_to_end"] + M["per_layer"], ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT_RE.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    keys = {"name", "unit", "better", "source", "workloads"}
    if metric in M["end_to_end"]:
        assert set(metric) <= keys | {"bound"} and "bound" in metric
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert set(metric) <= keys | {"layer", "moves"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert metric["moves"] in {m["name"] for m in M["end_to_end"]}
        assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]
        assert (harness.HERE / "metrics" / f"{metric['name']}.py").exists()
    if re.search(r"_roofline|mfu", metric["name"]):
        assert metric["unit"] == "%"
    cells = {w["name"] for w in M["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


@pytest.mark.parametrize("cell", M["workloads"], ids=lambda w: w["name"])
def test_cells_find_their_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    traffic = harness.traffic_of(cell)
    assert (harness.HERE / "drivers" / f"{traffic['driver']}.py").exists()
    assert harness.config_of(M, cell)
    reported = harness.metrics_for(M, cell, False)
    assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
    assert harness.metrics_for(M, cell, True)
    limits = traffic["limits"]
    assert limits and all(v >= 0 for v in limits.values())


@pytest.mark.parametrize("config", M["configs"], ids=lambda c: c["name"])
def test_configs(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith("perfbench/") and (harness.ROOT / config["file"]).exists()
    assert config["source"].startswith("https://") and len(config["reduced"]) <= 16
    assert any(w["config"] == config["name"] for w in M["workloads"])
    assert json.loads((harness.ROOT / config["file"]).read_text())["reduced"] == config["reduced"]


def test_unique_names_and_pairs():
    for group in ("end_to_end", "per_layer", "workloads", "configs"):
        names = [x["name"] for x in M[group]]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)


def test_check_budget_fits():
    """2 + 14 x cells runs at run_seconds + 60, and 2 x 90 a cell, in 43200 - 1200 s, at 24 cells."""
    cells = 24
    total = (2 + 14 * cells) * (M["run_seconds"] + 60) + cells * 2 * 90
    assert total <= 43200 - 1200
