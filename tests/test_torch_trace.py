"""The port's profiler ranges (`shapeclipper_torch/utils/trace.py`) on the
CPU: none is entered, and no clock is read, while no profiler records; under
a CPU `torch.profiler`, a request at a small size (32x32 input, 8x8 eval
render with 8 samples per ray, vox 8 grid, two turntable views) yields the
`sc.*` ranges of the request path, each inside the one it belongs to, with
one `sc.sync.*` range per host synchronisation; `timed` adds to
`seconds()`."""

import os
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from shapeclipper_torch.config import options
from shapeclipper_torch.eval3d import isosurface
from shapeclipper_torch.train.trainer import Runner
from shapeclipper_torch.utils import trace
from shapeclipper_torch.utils.easydict import EasyDict as edict
from tests.torch_tmp import kept_if_failed

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_VIEWS = 2

# (range, the innermost `sc.*` range around it) of one request on the CPU,
# where every SDF evaluation takes the fused kernel's plain version
REQUEST_NESTING = {
    ("sc.graph.encode", None), ("sc.graph.pose", None),
    ("sc.render", None), ("sc.render", "sc.vis.view"),
    ("sc.render.rays", "sc.render"), ("sc.render.rgb", "sc.render"),
    ("sc.render.composite", "sc.render"),
    ("sc.eval3d.grid", None), ("sc.eval3d.mesh", None),
    ("sc.vis.rotate", None), ("sc.vis.view", "sc.vis.rotate"),
    ("sc.sync.view", "sc.vis.view"), ("sc.sync.inv", "sc.render.rays"),
    ("sc.sync.const", "sc.graph.pose"), ("sc.sync.const", "sc.vis.rotate"),
}


@pytest.fixture(scope="module")
def runner(tmp_path_factory, request):
    opt = options.load_options(os.path.join(REPO, "options", "pix3d",
                                            "config.yaml"))
    opt.image_size = [32, 32]
    opt.H, opt.W = 32, 32
    opt.eval.image_size = [8, 8]
    opt.eval.vox_res = 8
    opt.render.n_samples_uniform = 8
    opt.arch.enc_pretrained = False
    opt.tpu.encoder_dtype = "float32"
    opt.tpu.implicit_dtype = "float32"
    opt.resume, opt.load = False, None
    with kept_if_failed(request, tmp_path_factory.mktemp("trace")) as path:
        opt.output_path = str(path)
        r = Runner(opt, "cpu")
        r.build_networks(opt)
        r.graph.eval()
        yield r


def _request(runner):
    """The serving request: forward and grid, the host mesh, the
    turntable."""
    image = np.random.RandomState(1).uniform(0, 1, (1, 32, 32, 3))
    var = edict(idx=np.array([0]),
                rgb_input_map=torch.from_numpy(image.astype(np.float32)))
    var, level = runner.eval_forward_and_grid(var)
    lo, hi = runner.opt.eval.range
    isosurface.marching_cubes_world(level[0].numpy(), lo, hi)
    return runner.vis_rotate(runner.opt, var, n_views=N_VIEWS)


@pytest.fixture(scope="module")
def traced(runner):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _request(runner)
    return [e for e in prof.events() if e.name.startswith(trace.PREFIX)]


def _enclosing(event):
    parent = event.cpu_parent
    while parent is not None and not parent.name.startswith(trace.PREFIX):
        parent = parent.cpu_parent
    return None if parent is None else parent.name


def test_no_range_and_no_clock_without_a_profiler(runner, monkeypatch):
    entered, clock = [], []
    real = trace.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    def perf_counter():
        clock.append(1)
        return time.perf_counter()

    monkeypatch.setattr(trace, "record_function", counting)
    monkeypatch.setattr(trace, "time",
                        types.SimpleNamespace(perf_counter=perf_counter))
    _request(runner)
    assert entered == [] and clock == []
    # the same request under a profiler enters the patched ranges
    with profile(activities=[ProfilerActivity.CPU]):
        _request(runner)
    assert "sc.vis.rotate" in entered and clock == []


def test_request_ranges_nest_as_the_request_path(traced):
    assert {(e.name, _enclosing(e)) for e in traced} == REQUEST_NESTING
    names = [e.name for e in traced]
    assert names.count("sc.vis.view") == N_VIEWS
    assert names.count("sc.render") == 1 + N_VIEWS
    assert names.count("sc.render.composite") == 1 + N_VIEWS


def test_one_sync_range_per_host_copy(traced):
    """3 copies a view; on CUDA besides, the intrinsics' inverse of every
    render reads its error flags on the host, and 3 host constants are
    copied to the card (the estimator's pose, the turntable's two)."""
    syncs = [e.name for e in traced if e.name.startswith("sc.sync.")]
    assert syncs.count("sc.sync.view") == 3 * N_VIEWS
    assert syncs.count("sc.sync.inv") == 1 + N_VIEWS
    assert syncs.count("sc.sync.const") == 3
    assert len(syncs) == 4 * N_VIEWS + 4


def test_timed_adds_to_the_process_total(runner):
    assert trace.seconds()["setup.networks"] > 0
    before = trace.seconds().get("test.block", 0.0)
    with trace.timed("test.block"):
        time.sleep(0.01)

    @trace.timed("test.block")
    def block():
        time.sleep(0.01)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        block()
    assert trace.seconds()["test.block"] >= before + 0.02
    assert "sc.test.block" in {e.name for e in prof.events()}
