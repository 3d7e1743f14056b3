"""The benchmark's yardstick of work: the operations and bytes that the
mathematics of each measured call needs at the cell's shapes, and the
published peaks of one NVIDIA H100 SXM that a share is taken against.

Copied from `chip_smoke.py` (`bound`, `forward_bound`, `MAC_TANGENT`,
`ELEM_K*`, `k2_bytes`, `generic_flop`, `generic_bound`) and written from the
architecture's sizes alone, so that nothing here reads the program under
test. One change from the copy: the backward of the SDF MLP (K2, K9) is
counted as the mathematics of a VJP, twice the forward with tangents, with
no recompute, so that a kernel that stashes instead of recomputing cannot
read over its roofline.
"""

from __future__ import annotations

from typing import NamedTuple

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


class SdfShape(NamedTuple):
    """An SDF MLP as the fused pair computes it: posenc frequencies, skip
    layers, hidden layers and their width. The latent is folded into
    per-sample biases, so its width enters only `bias_width`."""
    n_freqs: int
    skips: tuple
    n_hidden: int
    width: int

    @property
    def pe_dim(self):
        return 3 + 6 * self.n_freqs

    def layers(self):
        """[(hidden rows, posenc rows, out)] of each layer's products."""
        out = []
        for l in range(self.n_hidden + 1):
            o = self.width + 1 if l == self.n_hidden else self.width
            h = 0 if l == 0 else self.width
            pe = self.pe_dim if (l == 0 or l in self.skips) else 0
            out.append((h, pe, o))
        return out

    @property
    def num_weights(self):
        return sum((h + pe) * o for h, pe, o in self.layers())

    @property
    def bias_width(self):
        return self.n_hidden * self.width + self.width + 1


FLAGSHIP = SdfShape(6, (1, 2), 5, 64)


def sdf_shape(arch):
    """The SdfShape of a config's `arch.impl_sdf` dict."""
    return SdfShape(int(arch["pos_enc"]), tuple(arch["skip_connection"]),
                    int(arch["n_hidden_layers"]), int(arch["n_channels"]))


def sdf_mac(shape, kind):
    """Multiply-adds a point needs: 'nograd' every weight once; 'grad' the
    forward with its three tangent rows, their zeros not counted (a posenc
    tangent row is non-zero at a third of its features, the output layer's
    tangent rows need its sdf column alone); 'vjp' twice 'grad' (the input
    cotangent and the weight gradient of each product, no recompute)."""
    if kind == "nograd":
        return shape.num_weights
    mac = 0
    for l, (h, pe, o) in enumerate(shape.layers()):
        last = l == shape.n_hidden
        if h:
            mac += h * o + 3 * h if last else 4 * h * o
        if pe:
            mac += pe * o + pe if last else 2 * pe * o
    return mac * (2 if kind == "vjp" else 1)


def sdf_elementwise(shape, kind):
    """Elementwise FLOPs a point needs, a transcendental counted as one
    (`chip_smoke.py`'s ELEM_K* for any architecture): the activation pair
    and bias of each hidden value and the posenc; with tangents their
    scaling; the VJP the activation's backward and the bias sums alone."""
    L, W, F = shape.n_hidden, shape.width, shape.n_freqs
    fwd = L * W * 11 + 9 * F + W + 1
    if kind == "nograd":
        return fwd
    grad = fwd + L * W * 3 + 12 * F
    if kind == "grad":
        return grad
    return L * W * 14 + shape.bias_width


def sdf_bytes(shape, B, N, kind):
    """Bytes each input and output of the call moves once: points and
    outputs a point (sdf, feature, tangents; the VJP reads the cotangents
    and writes the point gradient), the float32 weights and per-sample
    biases (the VJP writes their gradients too)."""
    per_point = dict(nograd=4 + shape.width, grad=7 + shape.width,
                     vjp=10 + shape.width)[kind]
    params = (shape.num_weights + B * shape.bias_width) * (
        2 if kind == "vjp" else 1)
    return 4 * (B * N * per_point + params)


def bound_s(bf16_flop=0.0, tf32_flop=0.0, fp32_flop=0.0, nbytes=0.0):
    """Least seconds on the card: products in bf16 at the bf16 peak, float32
    products at the TF32 peak (no float32-accurate form runs faster), the
    elementwise FLOPs at the fp32 peak, or the bytes at the memory rate,
    whichever is larger."""
    t_op = bf16_flop / PEAK_BF16 + tf32_flop / PEAK_TF32 + fp32_flop / PEAK_FP32
    return max(t_op, nbytes / PEAK_BYTES)


def sdf_bound_s(shape, calls, kind, mm_dtype):
    """Least seconds of the SDF MLP calls `calls` [(B, N), ...] of `kind`
    ('grad', 'nograd' or 'vjp') with products in `mm_dtype`."""
    t = 0.0
    for B, N in calls:
        flop = 2 * sdf_mac(shape, kind) * B * N
        elem = sdf_elementwise(shape, kind) * B * N
        prod = dict(bf16_flop=flop) if mm_dtype == "bfloat16" else \
            dict(tf32_flop=flop)
        t += bound_s(fp32_flop=elem, nbytes=sdf_bytes(shape, B, N, kind),
                     **prod)
    return t


# --------------------------------------------------------------- whole model

def conv_flop(c_in, c_out, k, h_out, w_out):
    return 2 * c_in * c_out * k * k * h_out * w_out


def resnet_flop(stages, H, W, fc_out=None):
    """Forward FLOPs of a BasicBlock ResNet on one H x W image: every
    convolution's products (7x7/2 stem, 3x3/2 max-pool, stages of 64 x 2^i
    filters, 1x1 downsample), and the fc."""
    h, w = (H + 1) // 2, (W + 1) // 2              # stem, stride 2
    flop = conv_flop(3, 64, 7, h, w)
    h, w = (h + 1) // 2, (w + 1) // 2              # max-pool, stride 2
    c = 64
    for i, count in enumerate(stages):
        f = 64 * 2 ** i
        for j in range(count):
            stride = 2 if (i > 0 and j == 0) else 1
            if stride == 2:
                h, w = (h + 1) // 2, (w + 1) // 2
            flop += conv_flop(c, f, 3, h, w) + conv_flop(f, f, 3, h, w)
            if c != f or stride != 1:
                flop += conv_flop(c, f, 1, h, w)
            c = f
    if fc_out:
        flop += 2 * c * fc_out
    return flop


RESNET_STAGES = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}


def rgb_mac(arch_rgb, sdf_width):
    """Multiply-adds a point of the RGB MLP."""
    pe = 3 + 6 * int(arch_rgb["pos_enc"])
    w = int(arch_rgb["n_channels"])
    d0 = pe + int(arch_rgb["proj_latent_dim"]) + sdf_width
    return d0 * w + (int(arch_rgb["n_hidden_layers"]) - 1) * w * w + w * 3


def encoder_flop(cfg, H, W):
    """(encoder, estimator) forward FLOPs of one H x W image."""
    arch = cfg["arch"]
    enc = resnet_flop(RESNET_STAGES[arch["enc_network"]], H, W,
                      fc_out=arch["latent_dim_shape"] + arch["latent_dim_rgb"])
    return enc, resnet_flop(RESNET_STAGES["resnet18"], H, W)


def proj_flop(latent):
    """Forward FLOPs a sample of a latent projection: two bottleneck blocks
    of two square products each, then the 64-wide projection."""
    return 2 * (4 * latent * latent + latent * 64)


def estimator_heads_flop():
    """Forward FLOPs a sample of the estimator's three heads (a bottleneck
    block and an fc each, 6 + 1 + 1 outputs)."""
    return 2 * (3 * 2 * 512 * 512 + 512 * 8)


def train_step_flop(cfg, B, V):
    """Model FLOPs of one full training step at batch B with V neighbour
    views: every product of the forward once and of the backward twice
    (encoders, estimator, projections, RGB MLP), the SDF MLP's forward with
    tangents once and its VJP, on the merged render's (1 + V) B R S points
    and the eikonal's B 2R."""
    arch = cfg["arch"]
    H, W = cfg["image_size"]
    R, S = cfg["render"]["rand_sample"], cfg["render"]["n_samples_uniform"]
    shape = sdf_shape(arch["impl_sdf"])
    enc, est = encoder_flop(cfg, H, W)
    dense = ((1 + V) * B * enc + (2 + V) * B * est
             + B * proj_flop(arch["latent_dim_shape"])
             + (1 + V) * B * proj_flop(arch["latent_dim_rgb"])
             + (2 + V) * B * estimator_heads_flop())
    points = (1 + V) * B * R * S
    rgb = 2 * rgb_mac(arch["impl_rgb"], shape.width) * points
    sdf = 2 * (sdf_mac(shape, "grad") + sdf_mac(shape, "vjp")) * (
        points + B * 2 * R)
    return 3 * (dense + rgb) + sdf


def request_flop(cfg, views):
    """Model FLOPs of one request: the encoders on one image, the eval
    render and `views` turntable renders at eval.image_size (SDF with
    tangents, RGB MLP), and the SDF grid at eval.vox_res (no tangents)."""
    arch = cfg["arch"]
    H, W = cfg["image_size"]
    He, We = cfg["eval"]["image_size"]
    S = cfg["render"]["n_samples_uniform"]
    shape = sdf_shape(arch["impl_sdf"])
    enc, est = encoder_flop(cfg, H, W)
    dense = (enc + est + proj_flop(arch["latent_dim_shape"])
             + proj_flop(arch["latent_dim_rgb"]) + estimator_heads_flop())
    points = (1 + views) * He * We * S
    render = 2 * (sdf_mac(shape, "grad")
                  + rgb_mac(arch["impl_rgb"], shape.width)) * points
    grid = 2 * sdf_mac(shape, "nograd") * (cfg["eval"]["vox_res"] + 1) ** 3
    return dense + render + grid
