"""sdf_wrap_ms.infer: device ms a request of the kernels launched inside
the program's `sc.sdf.prepare` ranges (ops/fused_sdf.py: the input checks,
the latent folded into per-sample biases and the weights concatenated
before every fused SDF launch, 54 calls a request). Moves infer_ms."""

from benchmark.harness.readers import range_kernel_ms


def read(t):
    return range_kernel_ms(t, "sc.sdf.prepare")
