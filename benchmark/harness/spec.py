"""A cell as `BENCHMARK.json` names it, and the files the harness finds by
its names: `configs/<config>.json` (the configuration as it is run),
`traffic/<traffic>.json` (the traffic mix, whose `kind` names the loop
that drives it), `limits/<cell>.json` (the limits of `correct`) and
`metrics/<metric>.py` (one reader a per-layer metric)."""

from __future__ import annotations

import copy
import importlib.util
import json
import os

import yaml

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)


def _json(path):
    with open(path) as f:
        return json.load(f)


def apply_overrides(cfg, args):
    """`--a.b=value` arguments (YAML-typed values) onto a copy of `cfg`;
    a key the configuration does not have raises."""
    cfg = copy.deepcopy(cfg)
    for arg in args:
        key, value = arg[2:].split("=", 1)
        *parents, last = key.split(".")
        node = cfg
        for k in parents:
            node = node[k]
        if last not in node:
            raise KeyError(f"{key} is not a key of the configuration")
        node[last] = yaml.safe_load(value)
    return cfg


class Cell:
    def __init__(self, name, bench=None):
        bench = bench or _json(os.path.join(REPO, "BENCHMARK.json"))
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = found[0]
        self.chips = int(self.workload["chips"])
        self.config = _json(os.path.join(
            REPO, next(c["file"] for c in bench["configs"]
                       if c["name"] == self.workload["config"])))
        self.traffic = _json(os.path.join(
            BENCH_DIR, "traffic", self.workload["traffic"] + ".json"))
        self.cfg = apply_overrides(self.config["config"],
                                   self.traffic.get("overrides", []))
        limits_path = os.path.join(BENCH_DIR, "limits", name + ".json")
        self.limits = _json(limits_path)["limits"]
        self.end_to_end = [m for m in bench["end_to_end"] if self._in(m)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if self._in(m) and m["moves"] in reported]

    def _in(self, metric):
        return "workloads" not in metric or self.name in metric["workloads"]


def reader(name):
    """The `read(summary)` function of `metrics/<name>.py`."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
