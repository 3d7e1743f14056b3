"""device_idle.infer: % of a traced window of requests in which no kernel or
copy ran on the card (profiler trace). Moves infer_ms."""

from benchmark.harness.readers import device_idle as read  # noqa: F401
