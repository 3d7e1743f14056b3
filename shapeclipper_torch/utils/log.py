"""Colored console logger + EMA iteration timer.

Parity with the reference console UX (reference `utils/util.py:31-70`):
train/eval loss lines, elapsed/ETA from an exponentially-averaged per-iteration
wall time.
"""

from __future__ import annotations

import sys
import time


_COLORS = dict(
    grey="\033[90m", red="\033[91m", green="\033[92m", yellow="\033[93m",
    blue="\033[94m", magenta="\033[95m", cyan="\033[96m",
)
_BOLD = "\033[1m"
_UNDER = "\033[4m"
_END = "\033[0m"


def _c(msg, color, bold=False, underline=False):
    if not sys.stdout.isatty():
        return str(msg)
    prefix = _COLORS.get(color, "")
    if bold:
        prefix += _BOLD
    if underline:
        prefix += _UNDER
    return f"{prefix}{msg}{_END}"


def get_time(sec):
    d = int(sec // (24 * 60 * 60))
    h = int(sec // (60 * 60) % 24)
    m = int((sec // 60) % 60)
    s = int(sec % 60)
    return d, h, m, s


class Log:
    def process(self, pid):
        print(_c(f"Process ID: {pid}", "grey", bold=True))

    def title(self, message):
        print(_c(message, "yellow", bold=True, underline=True))

    def info(self, message):
        print(_c(message, "magenta", bold=True))

    def warn(self, message):
        print(_c(message, "red", bold=True))

    def options(self, opt, level=0):
        for key, value in sorted(opt.items()):
            if isinstance(value, dict):
                print("   " * level + _c("* ", "cyan") + _c(key, "green") + ":")
                self.options(value, level + 1)
            else:
                print("   " * level + _c("* ", "cyan") + _c(key, "green") + ":",
                      _c(value, "yellow"))

    def loss_train(self, opt, ep, lr, loss_all, timer):
        message = _c("[train] ", "grey", bold=True)
        message += "epoch {}/{}".format(_c(ep, "cyan", bold=True), opt.max_epoch)
        message += ", lr:{}".format(_c(f"{lr:.2e}", "yellow", bold=True))
        message += ", loss:{}".format(_c(f"{float(loss_all):.3e}", "red", bold=True))
        message += ", time:{}".format(
            _c("{0}-{1:02d}:{2:02d}:{3:02d}".format(*get_time(timer.elapsed)), "blue", bold=True))
        message += " (ETA:{})".format(
            _c("{0}-{1:02d}:{2:02d}:{3:02d}".format(*get_time(timer.arrival)), "blue"))
        print(message)

    def loss_eval(self, opt, loss=None, chamfer=None):
        message = _c("[eval] ", "grey", bold=True)
        if loss is not None:
            message += "loss:{}".format(_c(f"{float(loss):.3e}", "red", bold=True))
        if chamfer is not None:
            message += " chamfer:{}|{}|{}".format(
                _c(f"{chamfer[0]:.4f}", "green", bold=True),
                _c(f"{chamfer[1]:.4f}", "green", bold=True),
                _c(f"{(chamfer[0] + chamfer[1]) / 2:.4f}", "green", bold=True))
        print(message)


log = Log()


class Timer:
    """EMA per-iteration timer with ETA (reference `utils/util.py:64-70`)."""

    def __init__(self):
        self.start = time.time()
        self.it_mean = None
        self.it_start = None
        self.it_end = None
        self.elapsed = 0.0
        self.arrival = 0.0

    def begin_iter(self):
        self.it_start = time.time()

    def end_iter(self, max_epoch, ep, it_per_ep, momentum=0.99):
        self.it_end = time.time()
        self.elapsed = time.time() - self.start
        it = self.it_end - self.it_start
        self.it_mean = (self.it_mean * momentum + it * (1 - momentum)
                        if self.it_mean is not None else it)
        self.arrival = self.it_mean * it_per_ep * (max_epoch - ep)

    @property
    def it_per_sec(self):
        if not self.it_mean:
            return 0.0
        return 1.0 / self.it_mean

