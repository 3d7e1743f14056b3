"""The yardstick's arithmetic against hand counts at the flagship's and
VolSDF's widths."""

from benchmark import work
from benchmark.work import FLAGSHIP, SdfShape

VOLSDF = SdfShape(6, (4,), 8, 256)


def test_flagship_counts():
    # chip_smoke.py's MAC_TANGENT, NUM_WEIGHTS and BIAS_WIDTH
    assert work.sdf_mac(FLAGSHIP, "grad") == (3 * (39 + 3 * 13) * 64
                                             + 4 * 4 * 4096 + 64 * 65
                                             + 3 * 64) == 84864
    assert work.sdf_mac(FLAGSHIP, "nograd") == FLAGSHIP.num_weights == 28032
    assert FLAGSHIP.bias_width == 385
    # the VJP without recompute: twice the forward with tangents
    assert work.sdf_mac(FLAGSHIP, "vjp") == 2 * 84864
    # chip_smoke.py's ELEM_K3, ELEM_K1 (and ELEM_K2 less K1's recompute)
    assert work.sdf_elementwise(FLAGSHIP, "nograd") == 3639
    assert work.sdf_elementwise(FLAGSHIP, "grad") == 4671
    assert work.sdf_elementwise(FLAGSHIP, "vjp") == 9536 - 4671


def test_volsdf_counts():
    pe, w = 39, 256
    weights = pe * w + 3 * w * w + (w + pe) * w + 3 * w * w + w * (w + 1)
    assert VOLSDF.num_weights == weights == 544512
    assert VOLSDF.bias_width == 8 * 256 + 257
    grad = (2 * pe * w                       # layer 0, posenc
            + 7 * 4 * w * w                  # hidden products, 4 rows
            + 2 * pe * w                     # the skip layer's posenc
            + w * (w + 1) + 3 * w)           # output: tangents' sdf column
    assert work.sdf_mac(VOLSDF, "grad") == grad


def test_bound_takes_the_larger_side():
    B, N = 24, 32768
    flop = 2 * work.sdf_mac(VOLSDF, "grad") * B * N
    t = work.sdf_bound_s(VOLSDF, [(B, N)], "grad", "bfloat16")
    t_ops = (flop / work.PEAK_BF16
             + work.sdf_elementwise(VOLSDF, "grad") * B * N / work.PEAK_FP32)
    t_bytes = work.sdf_bytes(VOLSDF, B, N, "grad") / work.PEAK_BYTES
    assert t == max(t_ops, t_bytes)
    # float32 products at the TF32 peak, never at a slower one
    t32 = work.sdf_bound_s(VOLSDF, [(B, N)], "grad", "float32")
    assert t32 >= t and t32 <= t_ops + flop / work.PEAK_TF32


def test_resnet_flops():
    # ResNet-34 / ResNet-18 at 224^2: 3.6 / 1.8 GMACs (He et al. 2016)
    assert abs(work.resnet_flop((3, 4, 6, 3), 224, 224) / 2e9 - 3.66) < 0.05
    assert abs(work.resnet_flop((2, 2, 2, 2), 224, 224) / 2e9 - 1.81) < 0.05
