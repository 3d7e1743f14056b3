"""BENCHMARK.json against the benchmark's contract, and the harness
finding each cell's configuration, traffic, limits and metric readers by
name."""

import json
import os
import re

import pytest
import yaml

from benchmark.harness import spec

REPO = spec.REPO
BENCH = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(m["name"] for m in BENCH["end_to_end"]
                   + BENCH["per_layer"])) == len(BENCH["end_to_end"]) + len(
        BENCH["per_layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_configs_files():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/")
        f = json.load(open(os.path.join(REPO, c["file"])))
        assert f["source"] == c["source"] and f["reduced"] == c["reduced"]
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not re.search(r"(_dim|_rank|hidden|channels|width)$", key)


@pytest.mark.parametrize("name", sorted(
    f[:-5] for f in os.listdir(os.path.join(REPO, "benchmark", "configs"))))
def test_config_is_the_yaml_with_its_overrides(name):
    """The frozen configuration is the YAML it names with the overrides it
    lists, as they stood when the cell was defined."""
    f = json.load(open(os.path.join(REPO, "benchmark", "configs",
                                    name + ".json")))
    base = yaml.safe_load(open(os.path.join(REPO, f["yaml"])))
    assert spec.apply_overrides(base, f["overrides"]) == f["config"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    c = spec.Cell(cell, BENCH)
    w = c.workload
    assert w["chips"] == 1 and len(w["why"]) <= 200
    assert w["name"] == f"{w['config']}.{w['traffic']}"
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(spec.reader(m["name"]))
    limits = json.load(open(os.path.join(REPO, "benchmark", "limits",
                                         cell + ".json")))
    assert limits["limits"] and limits["readings"]
    assert c.traffic["kind"] in ("train", "request")


def test_every_metric_has_a_reader_and_a_cell():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert os.path.isfile(os.path.join(REPO, "benchmark", "metrics",
                                           m["name"] + ".py"))
        assert set(m["workloads"]) <= cells
        moves = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moves.get("workloads", cells))
