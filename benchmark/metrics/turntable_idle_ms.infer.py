"""turntable_idle_ms.infer: device-idle ms a request inside the program's
`sc.vis.rotate` range (train/trainer.py::Runner.vis_rotate): the range less
the union of the kernels and copies that fall in it, both clipped to it.
The turntable's renders, launches and host copies. Moves infer_ms."""

from benchmark.harness.program_spans import idle_ms


def read(t):
    return idle_ms(t, "sc.vis.rotate")
