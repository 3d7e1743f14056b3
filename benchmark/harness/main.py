"""One run of one cell: the traffic kind's loop, the metrics of the run
(end to end with --trace 0, per layer with --trace 1) and the result's
JSON object."""

from __future__ import annotations

import importlib
import sys

from . import check, spec

KINDS = {"train": "train", "request": "infer"}


def run(cell_name, seed, seconds, trace, device, t_start, hooks=None):
    cell = spec.Cell(cell_name)
    kind = importlib.import_module(
        f"benchmark.harness.{KINDS[cell.traffic['kind']]}")
    out = kind.run(cell, seed, seconds, trace, device, t_start, hooks)
    correct, checks = check.judge(out["numbers"], cell.limits)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = spec.reader(m["name"])(out["summary"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": device_info(device, cell.chips, out["peak_bytes"])}
    if trace:
        s = out["summary"]
        result["device"].update(busy_s=s.busy_s, window_s=s.window_s)
        result["breakdown"] = s.breakdown()
    result["numbers"] = {k: v for k, v in out["numbers"].items()
                         if k not in checks}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    return result


def device_info(device, chips, peak):
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": peak}
