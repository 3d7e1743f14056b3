"""The port's profiler ranges and its set-up seconds.

  * `span(name)`: a context manager and decorator. While a torch profiler
    records (`torch.autograd.profiler._is_profiler_enabled`, torch's own
    flag) it opens `torch.profiler.record_function("sc." + name)`, a range
    on the profiler's clock, which the CUDA activity is aligned to: a gap in
    the device's work falls inside the innermost range the host was in.
    Otherwise it reads that flag and nothing else: no clock, no allocation
    (entering a `record_function` costs ~15 us of host time even with no
    profiler).
  * `timed(name)`: a `span` that also adds its host seconds to the
    process's total `seconds()[name]`. For set-up only, never on the
    request or step path, which reads no clock.
  * `to_host(tensor, site)`: `tensor.cpu()` inside `span("sync." + site)`.
    Every device-to-host copy or blocking read of the request and step
    paths goes through it (or sits in a `span("sync.<site>")`), so that a
    trace holds one `sc.sync.*` range per synchronisation: the count of
    host synchronisations for any window.

Every range's name and the metric or operator use that reads it: PERF.md,
section 3.
"""

from __future__ import annotations

import contextlib
import functools
import time

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

PREFIX = "sc."

_SECONDS = {}   # timed name -> host seconds over the process's life


class _Span:
    """`span(name)`'s context while no profiler records (one per name,
    shared): enters nothing. As a decorator, each call of the function
    runs inside `span(name)`, decided at the call."""

    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned


class _Recording(_Span):
    """`span(name)`'s context while a profiler records: the range
    `sc.<name>`."""

    __slots__ = ("_range",)

    def __enter__(self):
        self._range = record_function(PREFIX + self.name)
        return self._range.__enter__()

    def __exit__(self, *exc):
        return self._range.__exit__(*exc)


_IDLE = {}   # name -> its shared _Span


def span(name):
    """The profiler range `sc.<name>` around a block (`with span(name):`)
    or around every call of a function (`@span(name)`) while a torch
    profiler records; otherwise nothing."""
    if _profiler._is_profiler_enabled:
        return _Recording(name)
    idle = _IDLE.get(name)
    if idle is None:
        idle = _IDLE[name] = _Span(name)
    return idle


@contextlib.contextmanager
def timed(name):
    """`span(name)`, its host seconds added to `seconds()[name]`. A
    decorator too. Set-up only."""
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        _SECONDS[name] = _SECONDS.get(name, 0.0) + time.perf_counter() - t0


def seconds():
    """{timed name: host seconds spent in it by this process}."""
    return dict(_SECONDS)


def to_host(tensor, site):
    """`tensor.cpu()`, a synchronisation when `tensor` is on the device,
    inside the range `sc.sync.<site>` while a profiler records."""
    if not _profiler._is_profiler_enabled:
        return tensor.cpu()
    with record_function(PREFIX + "sync." + site):
        return tensor.cpu()
