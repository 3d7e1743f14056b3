"""launches.infer: CUDA kernel launches a request (eval forward, grid,
turntable), counted in the profiler trace. Moves infer_ms."""

from benchmark.harness.readers import launches as read  # noqa: F401
