"""conv_ms.train: device ms a training step of the convolution kernels
(cuDNN, forward and both backward directions; models/resnet.py), from the
profiler trace. Moves train_img_per_s."""

from benchmark.harness.readers import kernel_ms

PATTERNS = ("conv", "fprop", "dgrad", "wgrad", "cudnn", "implicit_gemm",
            "nchwtonhwc", "nhwctonchw")


def read(t):
    return kernel_ms(t, PATTERNS)
