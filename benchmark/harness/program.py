"""The program under test, `shapeclipper_torch`, as a cell drives it: its
Runner built on the configuration as run, with the benchmark's weights
loaded, and host spans around calls into it (each call timed on the host
clock and marked as a profiler range `bench.<name>`)."""

from __future__ import annotations

import os
import statistics
import sys
import time

from . import weights as W
from .spec import REPO


def build_runner(cfg, cell_name, seed, device):
    """A Runner on `device` with networks and both optimizers, its
    parameters and BatchNorm buffers the benchmark's weights from `seed`;
    -> (runner, opt, weights, buffers), the benchmark's copies of the
    weights and buffers on the host, so that they take no device memory
    while the program runs."""
    from shapeclipper_torch.train.trainer import Runner
    from shapeclipper_torch.utils.easydict import EasyDict
    opt = EasyDict(cfg)
    opt.H, opt.W = opt.image_size
    opt.seed = int(seed)
    opt.output_path = os.path.join(REPO, "build", "bench", cell_name)
    opt.resume, opt.load = False, None
    runner = Runner(opt, device)
    runner.build_networks(opt)
    runner.setup_optimizer(opt)
    runner.restore_checkpoint(opt)
    weights, buffers = W.make(cfg, seed, device)
    W.load_into(runner.graph, weights, buffers)
    return (runner, opt, {k: v.cpu() for k, v in weights.items()},
            {k: v.cpu() for k, v in buffers.items()})


def report_pace(unit, marks):
    """The quartiles and the largest of the host's time between units
    returned in the window, on standard error: a window that holds a stall
    shows it here."""
    gaps = sorted((b - a) * 1e3 for a, b in zip(marks, marks[1:]))
    if len(gaps) >= 2:
        q = statistics.quantiles(gaps, n=4)
        print(f"{unit} ms: quartiles {q[0]:.2f} {q[1]:.2f} {q[2]:.2f}, "
              f"max {gaps[-1]:.2f}, n {len(gaps)}", file=sys.stderr)


class Spans:
    """Host milliseconds of each call of a wrapped function, by span name,
    each call also a profiler range `bench.<name>`."""

    def __init__(self):
        self.ms = {}

    def wrap(self, name):
        from torch.profiler import record_function

        def deco(fn):
            def timed(*args, **kwargs):
                t = time.perf_counter()
                with record_function("bench." + name):
                    out = fn(*args, **kwargs)
                self.ms.setdefault(name, []).append(
                    (time.perf_counter() - t) * 1e3)
                return out
            return timed
        return deco
