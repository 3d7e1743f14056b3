"""What the readers of the program's own ranges share. While a profiler
records, the program opens a range `sc.<name>` around each stage of its
request and step paths, and one `sc.sync.<site>` around each host
synchronisation (`shapeclipper_torch/utils/trace.py`); its set-up keeps
host seconds by name (`trace.seconds()`). Each helper returns None where
the trace or the process holds none of them, as a program without them
does (the harness then leaves the metric out)."""

from __future__ import annotations

PREFIX = "sc."


def _host_ranges(t, prefix):
    """The host ranges inside the window whose name starts with `prefix`,
    on any thread."""
    return [e for e in t.events if e["dev"] == "cpu" and e["kind"] == "op"
            and e["name"].startswith(prefix)
            and t.t0 <= e["ts"] < t.t1]


def range_count(t, prefix):
    """Host ranges a unit whose name starts with `prefix`: 0 where the
    program opens `sc.*` ranges but none of these, None where it opens
    none."""
    if not _host_ranges(t, PREFIX):
        return None
    return len(_host_ranges(t, prefix)) / t.units


def idle_ms(t, name):
    """Device-idle ms a unit inside the host ranges `name`: each range's
    length, clipped to the window, less the union of the device's kernels
    and copies clipped to it (the profiler's copies of host ranges on the
    device's timeline are not work)."""
    ranges = [e for e in _host_ranges(t, name) if e["name"] == name]
    if not ranges:
        return None
    busy = t.busy_intervals()
    idle = 0
    for r in ranges:
        a, b = r["ts"], min(r["ts"] + r["dur"], t.t1)
        covered = sum(max(0, min(y, b) - max(x, a)) for x, y in busy)
        idle += (b - a) - covered
    return idle * 1e-6 / t.units


def setup_seconds(name):
    """The program's host seconds in its `timed(name)` blocks over this
    process, or None where the program keeps none."""
    try:
        from shapeclipper_torch.utils import trace
    except ImportError:
        return None
    return trace.seconds().get(name)
