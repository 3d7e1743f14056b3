"""launches.train: CUDA kernel launches a full training step, counted in the
profiler trace (host dispatch of Runner.train_iteration). Moves
train_img_per_s."""

from benchmark.harness.readers import launches as read  # noqa: F401
