"""mfu.infer: a request's share of the dense bf16 peak (989 TFLOP/s, H100
SXM): the model's FLOPs a request (benchmark/work: request_flop, the
encoders, the eval render and the turntable renders with tangents, the SDF
grid) times the requests of the measured window, over the window. Cannot
pass 100% for correct work. Moves infer_ms."""

from benchmark.harness.readers import mfu as read  # noqa: F401
