"""The readers of the program's own ranges (`harness/program_spans.py`) on
a canned trace, against the answer worked out by hand, and on a trace of a
program without them."""

import sys

import pytest

from benchmark.harness import spec
from benchmark.harness.trace import Summary

MS = 1_000_000     # ns


def ev(name, ts, dur, dev="cuda", kind="kernel", corr=0, link=0, tid=7):
    return dict(name=name, dev=dev, kind=kind, ts=ts, dur=dur, corr=corr,
                link=link, tid=tid)


def host(name, ts, dur, corr=0):
    return ev(name, ts * MS, dur * MS, dev="cpu", kind="op", corr=corr)


def canned():
    """A 100 ms window of 2 units. `sc.vis.rotate` 40-90 ms, which the
    device works in for 40-50 (a kernel from 30 ms), 60-65 (a kernel launched
    in `sc.render.composite`), 70-75 (a copy) and 85-90 ms (a kernel to 95
    ms), with its annotation on the device; 3 `sc.sync.view` ranges in the
    window and one after it; `sc.sdf.prepare` 10-20 ms, whose op at 12 ms
    and runtime call at 15 ms launch kernels of 2 and 4 ms."""
    events = [
        host("bench.window", 0, 100),
        ev("bench.window", 0, 100 * MS, kind="annotation", corr=1),
        host("sc.vis.rotate", 40, 50, corr=2),
        ev("sc.vis.rotate", 40 * MS, 50 * MS, kind="annotation", corr=2),
        ev("elementwise_kernel", 30 * MS, 20 * MS, corr=91, link=90),
        host("aten::add", 31, 1, corr=90),
        host("sc.render.composite", 50, 8, corr=3),
        host("aten::mul", 52, 1, corr=70),
        ev("vectorized_elementwise_kernel", 60 * MS, 5 * MS, corr=71,
           link=70),
        ev("Memcpy DtoH (Device -> Pageable)", 70 * MS, 5 * MS,
           kind="memcpy"),
        ev("reduce_kernel", 85 * MS, 10 * MS, corr=81, link=80),
        host("aten::sum", 84, 1, corr=80),
        host("sc.sync.view", 70, 5), host("sc.sync.view", 76, 1),
        host("sc.sync.view", 78, 1), host("sc.sync.view", 120, 1),
        host("sc.vis.view", 41, 20),
        host("sc.sdf.prepare", 10, 10, corr=4),
        host("aten::mm", 12, 1, corr=50),
        ev("gemm_kernel", 22 * MS, 2 * MS, corr=51, link=50),
        ev("cudaLaunchKernel", 15 * MS, 1 * MS, dev="cpu", kind="runtime",
           corr=61),
        ev("cat_kernel", 24 * MS, 4 * MS, corr=61),
    ]
    return Summary(events, dict(units=2))


def read(name, t):
    return spec.reader(name)(t)


def test_sync_count():
    # 3 in the window over 2 units; the fourth is after it
    assert read("host_syncs.infer", canned()) == pytest.approx(1.5)


def test_idle_clipped_to_the_range():
    # 50 ms of range, 25 of it busy (40-50, 60-65, 70-75, 85-90) / 2 units
    assert read("turntable_idle_ms.infer", canned()) == pytest.approx(12.5)


def test_kernels_linked_into_a_range():
    # an op's kernel (2 ms) and a runtime call's (4 ms) / 2 units
    assert read("sdf_wrap_ms.infer", canned()) == pytest.approx(3.0)
    assert read("composite_ms.infer", canned()) == pytest.approx(2.5)


def test_setup_seconds(monkeypatch):
    from shapeclipper_torch.utils import trace
    monkeypatch.setattr(trace, "_SECONDS", {"setup.networks": 3.5})
    assert read("setup_networks_s.infer", canned()) == 3.5


def test_a_program_without_ranges(monkeypatch):
    import shapeclipper_torch.utils
    from shapeclipper_torch.utils import trace
    monkeypatch.setattr(trace, "_SECONDS", {"setup.networks": 3.5})
    t = Summary([host("bench.window", 0, 10),
                 ev("kernel", 1 * MS, 1 * MS)], dict(units=1))
    # a program without `utils/trace.py`: its import fails
    monkeypatch.delattr(shapeclipper_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "shapeclipper_torch.utils.trace", None)
    for name in ("host_syncs.infer", "turntable_idle_ms.infer",
                 "sdf_wrap_ms.infer", "composite_ms.infer",
                 "setup_networks_s.infer"):
        assert read(name, t) is None, name
