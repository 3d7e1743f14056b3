"""The traced part of a run: `torch.profiler` (CPU and CUDA) over a short
window of steps or requests, reduced in memory to a plain list of events
that the per-layer readers, `busy_s` / `window_s` and the breakdown read.

An event is a dict: `name`, `dev` ('cuda' or 'cpu'), `kind` ('kernel',
'memcpy', 'memset' or 'annotation' on the device; 'op' or 'runtime' on
the host), `ts` and `dur` in ns on the profiler's clock, `corr` (its
correlation id), `link` (a kernel's or a runtime call's linked host op)
and `tid` (the host thread). A device 'annotation' is the profiler's copy
of a host range on the device's timeline, not work."""

from __future__ import annotations

import contextlib
import re

WINDOW = "bench.window"


def function_name(name):
    """A kernel's function name: 'void f<true>(float const*)' -> 'f'."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^(void|__global__)\s+", "", name.strip())
    name = re.split(r"[<(]", name, maxsplit=1)[0]
    return name.split("::")[-1].strip()


# host events of the CUDA runtime and of the profiler itself, not ops
RUNTIME_PREFIXES = ("cuda", "cu", "Runtime Triggered", "Lazy Function",
                    "Activity Buffer", "Buffer Flush")


def _kind(dev, name, link, host_ranges, corr):
    if dev == "cpu":
        return ("runtime" if link or name.startswith(RUNTIME_PREFIXES)
                else "op")
    if (name, corr) in host_ranges:
        return "annotation"
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def events_of(prof):
    """The profiler's events as plain dicts."""
    raw = []
    for e in prof.profiler.kineto_results.events():
        dev = "cuda" if "CUDA" in str(e.device_type()).upper() else "cpu"
        raw.append((e.name(), dev, int(e.start_ns()), int(e.duration_ns()),
                    int(e.correlation_id()), int(e.linked_correlation_id()),
                    int(e.start_thread_id())))
    host_ranges = {(r[0], r[4]) for r in raw if r[1] == "cpu"}
    return [dict(name=name, dev=dev,
                 kind=_kind(dev, name, link, host_ranges, corr), ts=ts,
                 dur=dur, corr=corr, link=link, tid=tid)
            for name, dev, ts, dur, corr, link, tid in raw]


@contextlib.contextmanager
def profiled(sync):
    """Profile the block, which runs between two `sync()` calls inside the
    range WINDOW; -> a list that holds the events once the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = []
    with profile(activities=acts) as prof:
        sync()
        with record_function(WINDOW):
            yield out
            sync()
    out.extend(events_of(prof))


class Summary:
    """A traced window's events and what the harness knows of its work
    (`info`: units profiled, shapes, FLOPs, the measured window), with
    the helpers the per-layer readers share."""

    def __init__(self, events, info, spans=None):
        self.events = events
        self.info = info
        self.spans = spans or {}
        win = [e for e in events if e["dev"] == "cpu" and e["name"] == WINDOW]
        if not win:
            raise ValueError(f"no {WINDOW} range in the trace")
        self.t0 = win[0]["ts"]
        self.t1 = win[0]["ts"] + win[0]["dur"]
        self.main_tid = win[0]["tid"]
        self.units = info["units"]

    @property
    def window_s(self):
        return (self.t1 - self.t0) * 1e-9

    def device(self, kinds=("kernel", "memcpy", "memset")):
        return [e for e in self.events if e["dev"] == "cuda"
                and e["kind"] in kinds and e["ts"] < self.t1
                and e["ts"] + e["dur"] > self.t0]

    def kernels(self):
        return self.device(("kernel",))

    def busy_intervals(self):
        """The union of the device events' intervals inside the window."""
        spans = sorted((max(e["ts"], self.t0), min(e["ts"] + e["dur"], self.t1))
                       for e in self.device())
        merged = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            elif b > a:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self):
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def host_ops(self, tid=None):
        tid = self.main_tid if tid is None else tid
        return [e for e in self.events if e["kind"] == "op"
                and e["tid"] == tid and e["name"] != WINDOW]

    def host_op_at(self, t, ops):
        """The innermost host range on the main thread around time t."""
        best = None
        for e in ops:
            if e["ts"] <= t < e["ts"] + e["dur"] and (
                    best is None or e["dur"] < best["dur"]):
                best = e
        return best["name"] if best else "(host outside any range)"

    def kernel_time_s(self, names):
        """Device seconds of the kernels whose function name is in
        `names`, and their launch counts by name."""
        t, counts = 0.0, {}
        for e in self.kernels():
            f = function_name(e["name"])
            if f in names:
                t += e["dur"] * 1e-9
                counts[f] = counts.get(f, 0) + 1
        return t, counts

    def breakdown(self, n=10):
        """{'device_ops': the n kernels and copies with most device time,
        'idle_gaps': the n longest idle gaps, each named by the host range
        it falls in}."""
        by_name = {}
        for e in self.device():
            k = function_name(e["name"]) if e["kind"] == "kernel" else e["name"]
            by_name[k] = by_name.get(k, 0) + e["dur"] * 1e-9
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        busy = self.busy_intervals()
        edges = [self.t0] + [x for ab in busy for x in ab] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        ops = self.host_ops()
        named = [[self.host_op_at((a + b) // 2, ops), (b - a) * 1e-9]
                 for a, b in gaps]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": named}


def shared_time_s(t, own, shared):
    """Device seconds of the kernels `own` plus, for each kernel of
    `shared` {name: [owner kernels]}, its time split over its owners by
    their launch counts, the share of the owners in `own`."""
    total, counts = t.kernel_time_s(set(own))
    for name, owners in shared.items():
        s, _ = t.kernel_time_s({name})
        _, oc = t.kernel_time_s(set(owners))
        n_all = sum(oc.values())
        if n_all:
            total += s * sum(oc.get(o, 0) for o in own) / n_all
    return total, counts
