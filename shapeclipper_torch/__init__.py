"""ShapeClipper on PyTorch + CUDA (NVIDIA Hopper).

The second package of this repository, beside the JAX reference
`shapeclipper_tpu/`. It imports torch and never jax, and nothing from
`shapeclipper_tpu` (whose package init imports jax). Module names follow the
JAX package so each counterpart is easy to find.

Ported so far: the single-image serving path (`python -m
shapeclipper_torch.infer`): ResNet34 encoder + latent projections, ResNet18
viewpoint estimator, the eval-mode VolSDF render, the dense SDF grid, host
marching tetrahedra and the turntable. Every SDF evaluation on CUDA goes
through the hand-written Hopper kernel `csrc/fused_sdf_fwd.cu`
(`ops/fused_sdf.py`).
"""

__version__ = "0.1.0"
