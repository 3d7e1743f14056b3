"""sdf_fwd_roofline.infer: % of its roofline that a request's fused SDF
forward with tangents reaches: the eval render and every turntable render
at eval.image_size x n_samples points (K1-bf16 on the flagship's MLP,
K8-bf16 on any other, with the bf16 weight pack).

Work: benchmark/work sdf_bound_s 'grad' on (1 + views) renders of
H W S points; bf16 products at 989 TFLOP/s, elementwise at 67, or the
bytes at 3.35 TB/s, whichever is larger. Moves infer_ms."""

from benchmark.harness.readers import roofline

KERNELS = {
    "flagship": {"own": ["fused_sdf_fwd_bf16_kernel", "pack_bf16_kernel"]},
    "generic": {"own": ["sdf_generic_fwd_bf16_kernel"],
                "shared": {"sdf_generic_pack_bf16_kernel": [
                    "sdf_generic_fwd_bf16_kernel",
                    "sdf_generic_bwd_bf16_kernel"]}},
}


def read(t):
    return roofline(t, "fwd", KERNELS)
