"""Each per-layer reader on a canned trace, against the answer worked out
by hand."""

import pytest

from benchmark import work
from benchmark.harness import spec
from benchmark.harness.trace import Summary, function_name

MS = 1_000_000     # ns


def ev(name, ts, dur, dev="cuda", kind="kernel", corr=0, link=0, tid=7):
    return dict(name=name, dev=dev, kind=kind, ts=ts, dur=dur, corr=corr,
                link=link, tid=tid)


def canned(info_extra=None):
    """A 100 ms window of 2 units: device busy 0-10 (a copy, then a kernel),
    20-50 (two kernels overlapping), 60-70 ms; an Adam range 55-75 ms holding the launch of
    the 60-70 ms kernel; a 5 ms host-to-device copy at 0-5 ms."""
    events = [
        ev("bench.window", 0, 100 * MS, dev="cpu", kind="op", tid=7),
        ev("Memcpy HtoD (Pageable -> Device)", 0, 5 * MS, kind="memcpy"),
        ev("void sdf_generic_fwd_bf16_kernel<true>(float const*)", 5 * MS,
           5 * MS),
        ev("void sdf_generic_bwd_bf16_kernel(float const*)", 20 * MS,
           20 * MS),
        ev("void sdf_generic_pack_bf16_kernel(float const*)", 30 * MS,
           20 * MS),
        ev("sm90_xmma_fprop_implicit_gemm_bf16", 60 * MS, 10 * MS, corr=41,
           link=40),
        ev("bench.window", 0, 100 * MS, kind="annotation", corr=1),
        ev("cudaLaunchKernel", 58 * MS, 1 * MS, dev="cpu", kind="runtime",
           corr=41, link=40),
        ev("aten::_foreach_add_", 58 * MS, 1 * MS, dev="cpu", kind="op",
           corr=40, tid=7),
        ev("Optimizer.step#Adam.step", 55 * MS, 20 * MS, dev="cpu",
           kind="op", corr=39, tid=7),
        ev("aten::batch_norm", 12 * MS, 6 * MS, dev="cpu", kind="op",
           corr=30, tid=7),
    ]
    shape = work.SdfShape(6, (4,), 8, 256)
    info = dict(units=2, window_units=10, window_s=2.0, flop_per_unit=1e12,
                peak_mem_bytes=3 * 2 ** 30,
                sdf=dict(shape=tuple(shape), route="generic", mm="bfloat16",
                         mm_grid="float32", fwd=[(24, 32768)],
                         bwd=[(24, 32768)], grid=[(1, 274625)]))
    info.update(info_extra or {})
    return Summary(events, info, spans={"marching_cubes_world": [3.0, 5.0]})


def read(name, t):
    return spec.reader(name)(t)


def test_function_name():
    assert function_name("void f_kernel<true>(float const*, int)") == \
        "f_kernel"
    assert function_name("ns::g_kernel(int)") == "g_kernel"


def test_device_window_and_breakdown():
    t = canned()
    assert t.window_s == pytest.approx(0.1)
    assert t.busy_s == pytest.approx(0.05)    # 0-10, 20-50, 60-70 ms
    assert read("device_idle.train", t) == pytest.approx(50.0)
    assert read("device_idle.infer", t) == pytest.approx(50.0)
    b = t.breakdown()
    assert b["device_ops"][0] == ["sdf_generic_bwd_bf16_kernel",
                                  pytest.approx(0.02)]
    gaps = dict((round(s, 6), n) for n, s in b["idle_gaps"])
    assert gaps[0.03] == "(host outside any range)"      # 70-100 ms
    assert gaps[0.01] in ("aten::batch_norm",            # 10-20 ms, at 15
                          "Optimizer.step#Adam.step")    # 50-60 ms, at 55
    assert sorted(n for n, s in b["idle_gaps"]) == [
        "(host outside any range)", "Optimizer.step#Adam.step",
        "aten::batch_norm"]


def test_counts_and_times():
    t = canned()
    assert read("launches.train", t) == 2.0               # 4 kernels / 2
    assert read("conv_ms.train", t) == pytest.approx(5.0)
    assert read("adam_ms.train", t) == pytest.approx(5.0)
    assert read("h2d_ms.train", t) == pytest.approx(2.5)
    assert read("mesh_ms.infer", t) == pytest.approx(4.0)
    assert read("peak_mem.train", t) == pytest.approx(3.0)
    # 1e12 FLOPs x 10 units over 2 s, against 989e12
    assert read("mfu.train", t) == pytest.approx(100 * 5e12 / 989e12)


def test_rooflines():
    t = canned()
    shape = work.SdfShape(6, (4,), 8, 256)
    fwd = work.sdf_bound_s(shape, [(24, 32768)], "grad", "bfloat16")
    bwd = work.sdf_bound_s(shape, [(24, 32768)], "vjp", "bfloat16")
    # the pack (20 ms) splits by launch counts: one forward, one backward
    assert read("sdf_fwd_roofline.train", t) == pytest.approx(
        100 * fwd * 2 / (0.005 + 0.010))
    assert read("sdf_bwd_roofline.train", t) == pytest.approx(
        100 * bwd * 2 / (0.020 + 0.010))
    # no K8-nograd in the trace: the grid's share is left out
    assert read("sdf_grid_roofline.infer", t) is None


def test_nothing_to_read():
    t = Summary([ev("bench.window", 0, 10 * MS, dev="cpu", kind="op")],
                dict(units=1))
    for name in ("launches.train", "conv_ms.train", "adam_ms.train",
                 "h2d_ms.train", "sdf_fwd_roofline.train", "mesh_ms.infer"):
        assert read(name, t) is None
