"""sdf_grid_roofline.infer: % of its roofline that a request's SDF grid
reaches, (eval.vox_res + 1)^3 points without tangents in float32 (K3 on the
flagship's MLP, csrc/fused_sdf_fwd.cu; K8-nograd, 3xTF32, on any other,
csrc/fused_sdf_generic.cu, with the tf32 weight pack).

Work: benchmark/work sdf_bound_s 'nograd': float32 products at the TF32 peak
of 495 TFLOP/s (no float32-accurate form runs faster), elementwise at 67,
or the bytes at 3.35 TB/s, whichever is larger. Moves infer_ms."""

from benchmark.harness.readers import roofline

KERNELS = {
    "flagship": {"own": ["fused_sdf_fwd_kernel"]},
    "generic": {"own": ["sdf_generic_fwd_tf32_kernel"],
                "shared": {"sdf_generic_pack_tf32_kernel": [
                    "sdf_generic_fwd_tf32_kernel",
                    "sdf_generic_bwd_tf32_kernel"]}},
}


def read(t):
    return roofline(t, "grid", KERNELS)
