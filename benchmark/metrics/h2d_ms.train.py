"""h2d_ms.train: device ms a training step of host-to-device copies (the
batch that batch_to_var copies), from the profiler trace. Moves
train_img_per_s."""

from benchmark.harness.readers import memcpy_ms


def read(t):
    return memcpy_ms(t, "HtoD")
