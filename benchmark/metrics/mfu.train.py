"""mfu.train: the whole training step's share of the dense bf16 peak (989
TFLOP/s, H100 SXM): the model's FLOPs a step (benchmark/work:
train_step_flop, every product of the encoders, estimator, projections and
RGB MLP forward once and backward twice, the SDF MLP's forward with tangents
and its VJP without recompute) times the steps of the measured window, over
the window. Cannot pass 100% for correct work. Moves train_img_per_s."""

from benchmark.harness.readers import mfu as read  # noqa: F401
