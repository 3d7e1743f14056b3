"""sdf_bwd_roofline.train: % of its roofline that the training step's fused
SDF backward reaches (K2-bf16, csrc/fused_sdf_bwd_bf16.cu, with its partial
sums; K9-bf16 with sum_partials_kernel, csrc/fused_sdf_generic_bf16.cu,
and its share of the weight pack).

Work: the VJP of the forward with tangents, twice its multiply-adds and no
recompute, on the merged render's and the eikonal's points
(benchmark/work: sdf_bound_s 'vjp'), against the same peaks as the
forward's share; cotangents, point gradient, weights and their gradients
once. A kernel that stashes instead of recomputing cannot read over 100%.
Moves train_img_per_s."""

from benchmark.harness.readers import roofline

KERNELS = {
    "flagship": {"own": ["fused_sdf_bwd_bf16_kernel", "fused_sdf_bwd_kernel",
                         "reduce_partials_kernel"]},
    "generic": {"own": ["sdf_generic_bwd_bf16_kernel",
                        "sdf_generic_bwd_tf32_kernel", "sum_partials_kernel"],
                "shared": {"sdf_generic_pack_bf16_kernel": [
                               "sdf_generic_fwd_bf16_kernel",
                               "sdf_generic_bwd_bf16_kernel"],
                           "sdf_generic_pack_tf32_kernel": [
                               "sdf_generic_fwd_tf32_kernel",
                               "sdf_generic_bwd_tf32_kernel"]}},
}


def read(t):
    return roofline(t, "bwd", KERNELS)
