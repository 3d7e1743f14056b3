"""composite_ms.infer: device ms a request of the kernels launched inside
the program's `sc.render.composite` ranges (render/renderer.py::render:
density, volume weights, normals and the rendered outputs of every eval
and turntable render). Moves infer_ms."""

from benchmark.harness.readers import range_kernel_ms


def read(t):
    return range_kernel_ms(t, "sc.render.composite")
