"""peak_mem.train: torch.cuda.max_memory_allocated over the measured window
of training steps, GiB. Moves train_img_per_s (a larger batch needs it)."""

from benchmark.harness.readers import peak_mem_gib as read  # noqa: F401
