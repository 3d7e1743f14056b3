"""What the per-layer readers (`benchmark/metrics/<name>.py`) share: each
takes a `trace.Summary` and returns a number, or None when the trace holds
nothing for it to read (the harness then leaves the metric out)."""

from __future__ import annotations

from ..work import PEAK_BF16, SdfShape, sdf_bound_s
from .trace import shared_time_s

SDF_KINDS = {"fwd": "grad", "bwd": "vjp", "grid": "nograd"}


def device_idle(t):
    """% of the traced window in which no kernel or copy ran."""
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s > 0 else None


def peak_mem_gib(t):
    """torch.cuda.max_memory_allocated over the measured window, GiB."""
    peak = t.info.get("peak_mem_bytes")
    return None if peak is None else peak / 2 ** 30


def mfu(t):
    """% of the dense bf16 peak: the model's FLOPs a unit (work/) times the
    units finished in the measured window, over the window."""
    i = t.info
    if not i.get("window_s"):
        return None
    return 100.0 * i["flop_per_unit"] * i["window_units"] / (
        i["window_s"] * PEAK_BF16)


def roofline(t, part, kernels):
    """% of the bound: the least time the SDF MLP calls `part` of a unit
    need (work/), over the device time a unit of the kernels that
    `kernels[route]` names ({'own': [...], 'shared': {kernel: owners}})."""
    sdf = t.info.get("sdf")
    if not sdf or not sdf.get(part):
        return None
    sel = kernels.get(sdf["route"])
    if not sel:
        return None
    time_s, counts = shared_time_s(t, sel["own"], sel.get("shared", {}))
    if not counts or time_s <= 0:
        return None
    mm = sdf["mm_grid"] if part == "grid" else sdf["mm"]
    bound = sdf_bound_s(SdfShape(*sdf["shape"]), sdf[part], SDF_KINDS[part],
                        mm)
    return 100.0 * bound * t.units / time_s


def launches(t):
    """Kernel launches a unit."""
    n = len(t.kernels())
    return n / t.units if n else None


def kernel_ms(t, patterns):
    """Device ms a unit of the kernels whose name holds one of
    `patterns` (lower case)."""
    total = sum(e["dur"] for e in t.kernels()
                if any(p in e["name"].lower() for p in patterns))
    return total * 1e-6 / t.units if total else None


def range_kernel_ms(t, prefix):
    """Device ms a unit of the kernels launched inside host ranges whose
    name starts with `prefix`: a kernel's host op (its linked correlation
    id), or else its runtime call (its own), lies in such a range on the
    same thread."""
    ranges = [e for e in t.events if e["kind"] == "op"
              and e["name"].startswith(prefix)]
    if not ranges:
        return None
    ops, calls = {}, {}
    for e in t.events:
        if e["kind"] == "op":
            ops.setdefault(e["corr"], e)
        elif e["kind"] == "runtime":
            calls.setdefault(e["corr"], e)
    total = 0
    for k in t.kernels():
        h = (k["link"] and ops.get(k["link"])) or calls.get(k["corr"])
        if h and any(r["tid"] == h["tid"] and r["ts"] <= h["ts"]
                     < r["ts"] + r["dur"] for r in ranges):
            total += k["dur"]
    return total * 1e-6 / t.units if total else None


def memcpy_ms(t, direction):
    """Device ms a unit of the copies whose name holds `direction`."""
    total = sum(e["dur"] for e in t.device(("memcpy",))
                if direction in e["name"])
    return total * 1e-6 / t.units if total else None


def span_ms(t, name):
    """Host ms a unit inside the benchmark's span `name`."""
    times = t.spans.get(name)
    return sum(times) / t.units if times else None
