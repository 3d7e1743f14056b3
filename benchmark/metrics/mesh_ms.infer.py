"""mesh_ms.infer: host ms a request inside eval3d/isosurface.py::
marching_cubes_world (the benchmark's span around the call). Moves
infer_ms."""

from benchmark.harness.readers import span_ms


def read(t):
    return span_ms(t, "marching_cubes_world")
