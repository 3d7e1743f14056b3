"""device_idle.train: % of a traced window of full training steps in which
no kernel or copy ran on the card (profiler trace). Moves train_img_per_s."""

from benchmark.harness.readers import device_idle as read  # noqa: F401
