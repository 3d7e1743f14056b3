"""sdf_fwd_roofline.train: % of its roofline that the training step's fused
SDF forward with tangents reaches (ops/fused_sdf.py: K1-bf16 on the
flagship's MLP, csrc/fused_sdf_fwd.cu; K8-bf16 on any other,
csrc/fused_sdf_generic_bf16.cu; each with its weight pack).

Work: the mathematics at the cell's shapes, the merged render's
(1 + V) B x R S points and the eikonal's B x 2R (benchmark/work:
sdf_bound_s 'grad'): bf16 products at 989 TFLOP/s, float32 ones at the TF32
peak of 495, elementwise FLOPs at 67, or each input and output once at
3.35 TB/s, whichever is larger. Time: the device time of the kernels named
below, a pack shared with the backward split by launch counts. A rename
shows as a missing metric. Moves train_img_per_s."""

from benchmark.harness.readers import roofline

KERNELS = {
    "flagship": {"own": ["fused_sdf_fwd_bf16_kernel", "fused_sdf_fwd_kernel",
                         "pack_bf16_kernel"]},
    "generic": {"own": ["sdf_generic_fwd_bf16_kernel",
                        "sdf_generic_fwd_tf32_kernel"],
                "shared": {"sdf_generic_pack_bf16_kernel": [
                               "sdf_generic_fwd_bf16_kernel",
                               "sdf_generic_bwd_bf16_kernel"],
                           "sdf_generic_pack_tf32_kernel": [
                               "sdf_generic_fwd_tf32_kernel",
                               "sdf_generic_bwd_tf32_kernel"]}},
}


def read(t):
    return roofline(t, "fwd", KERNELS)
