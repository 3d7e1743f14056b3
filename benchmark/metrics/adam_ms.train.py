"""adam_ms.train: device ms a training step of the kernels launched inside
torch.optim.Adam.step (the profiler's "Optimizer.step#Adam.step" range).
Moves train_img_per_s."""

from benchmark.harness.readers import range_kernel_ms


def read(t):
    return range_kernel_ms(t, "Optimizer.step#Adam.step")
