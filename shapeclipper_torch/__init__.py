"""ShapeClipper on PyTorch + CUDA (NVIDIA Hopper).

The second package of this repository, beside the JAX reference
`shapeclipper_tpu/`. It imports torch and never jax, and nothing from
`shapeclipper_tpu` (whose package init imports jax). Module names follow the
JAX package so each counterpart is easy to find.

The five entry points of the JAX package, each `python -m` with the same
YAML files and flags plus `--device=cuda|cpu` (cuda by default):

  * `shapeclipper_torch.pretrain`: sphere pretraining
    (`models/pretrain_graph.py`, `train/pretrainer.py`);
  * `shapeclipper_torch.clip_anno`: CLIP nearest-neighbour annotation
    (`clipnn/`);
  * `shapeclipper_torch.train`: the epoch loop, training steps and the
    periodic evaluation (`train/`);
  * `shapeclipper_torch.evaluate`: Chamfer-L1 and F-scores;
  * `shapeclipper_torch.infer`: single-image serving.

Every SDF evaluation of the render and the grid on CUDA goes through the
hand-written Hopper kernels `csrc/fused_sdf_fwd.cu` (K1 / K3) and
`csrc/fused_sdf_bwd.cu` (K2) for the flagship's SDF MLP, and
`csrc/fused_sdf_generic.cu` (K8 / K9) for any other (`ops/fused_sdf.py::
sdf_route`), every nearest-neighbour
sweep of the metrics through `csrc/chamfer.cu` (K4 / K5, `ops/chamfer.py`).
`bridge.py` carries the JAX package's weights and optax Adam states
across. `parallel/` makes the training data parallel over DDP ranks
(`torchrun ... -m shapeclipper_torch.train --distributed`) and splits an
evaluation's test batches over ranks (`... -m shapeclipper_torch.evaluate
--distributed`).
"""

__version__ = "0.1.0"
