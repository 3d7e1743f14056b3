"""peak_mem.infer: torch.cuda.max_memory_allocated over the measured window
of requests, GiB. Moves infer_ms."""

from benchmark.harness.readers import peak_mem_gib as read  # noqa: F401
