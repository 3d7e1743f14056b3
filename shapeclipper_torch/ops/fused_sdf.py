"""Fused SDF-MLP forward (+ forward-mode point gradient) and its backward:
the plain PyTorch version and the wrappers of the Hopper kernels
`csrc/fused_sdf_fwd.cu` (K1 / K3) and `csrc/fused_sdf_bwd.cu` (K2), whose
library also links `csrc/fused_sdf_bwd_bf16.cu` (K2-bf16), written for the
flagship architecture (`FLAGSHIP`), and of the architecture-generic pair
`csrc/fused_sdf_generic.cu` (K8 forward, K8-nograd, K9 backward, their
float32 products as 3xTF32 on the tensor cores, which read the weights'
tf32 pack) for every other SDF MLP inside `ENVELOPE`. `sdf_route` picks
the pair from the network's architecture: a dispatch, never a fallback (a
flagship whose kernels fail raises).

Counterpart of `shapeclipper_tpu/ops/fused_sdf.py` (forward half):
  * `prepare_fused_params`: the latent folded into per-sample biases and the
    skip kernels pre-scaled by 1/sqrt(2) -- a small matmul outside the
    kernel, as in JAX.
  * `fused_sdf_forward_reference`: `sdf_fwdmode_xla` in plain torch (rows =
    [primal; t_x; t_y; t_z] through the same products), with the kernel's
    activation formulation (`_act_pair`).
  * `fused_sdf_forward` (no gradients; serving): CPU tensors take the plain
    version; CUDA tensors launch the kernel (K1 / K8 with `compute_grad`,
    K3 / K8-nograd without) or raise.
  * `fused_sdf_train` (training): CPU tensors take plain autograd through
    the plain version; CUDA tensors run K1 forward and K2 backward (K8 and
    K9 off the flagship) in one `torch.autograd.Function`, or raise.
There is no fallback from CUDA to the plain version.

`mm_dtype` is the JAX package's `_mm_cast` switch: "float32", or
"bfloat16", where every product inside the pair rounds both of its operands
to bfloat16 and accumulates in float32 while everything elementwise stays
float32. The forward kernel has an instantiation for each, the backward a
float32 kernel and a tensor-core one for bf16; the plain version takes its
bf16 products from `_CastProduct`, whose backward rounds the cotangent and
the saved operands before each product, as K2-bf16 does. The bf16 forward
reads the weights as mma.sync B fragments, which one pack launch writes
beside K2-bf16's plain bf16 copy (`FusedSdfKernel.pack_bf16`; its plain
version `pack_bf16_reference` gathers by `bf16_fragment_index`).

Each library builds at first use from this package's own source into
`build/` at the repository root (`ops/cuda_lib.py`: `nvcc`, plain C
interface, loaded with ctypes); `cuda_lib.build_kernels` runs every
compilation of the port at once.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..utils.trace import span
from .cuda_lib import BUILD_DIR, CSRC_DIR, CudaLibrary

INV_SQRT2 = 0.7071067811865476

_SOURCE = os.path.join(CSRC_DIR, "fused_sdf_fwd.cu")
_SOURCE_BWD = os.path.join(CSRC_DIR, "fused_sdf_bwd.cu")
_SOURCE_BWD_BF16 = os.path.join(CSRC_DIR, "fused_sdf_bwd_bf16.cu")
_SOURCE_GENERIC = os.path.join(CSRC_DIR, "fused_sdf_generic.cu")
_SOURCE_GENERIC_BF16 = os.path.join(CSRC_DIR, "fused_sdf_generic_bf16.cu")
_HEADER_GENERIC = os.path.join(CSRC_DIR, "fused_sdf_generic.cuh")

# the packed sizes of `FLAGSHIP`, the architecture K1 / K3 / K2 are written
# for
NUM_WEIGHTS = 28032
BIAS_WIDTH = 5 * 64 + 65
# what K8 / K9 take (`csrc/fused_sdf_generic.cu`): inclusive ranges, and
# skip layers anywhere in 1 .. n_hidden
ENVELOPE = dict(width=(1, 512), n_hidden=(1, 16), n_freqs=(0, 16))
# the kernels of each route: forward with tangents, without, backward
ROUTES = {"flagship": ("K1", "K3", "K2"),
          "generic": ("K8", "K8-nograd", "K9")}
# K1's and K3's tile in points (`csrc/fused_sdf_fwd.cu`: Smem::kPoints), and
# a warp's tile of their bf16 instantiations (Bf16Tile::kPoints)
FWD_TILE_POINTS = {"grad": 64, "nograd": 256}
FWD_TILE_POINTS_BF16 = {"grad": 8, "nograd": 16}
# K1-bf16 / K3-bf16 read the weights as bf16 mma.sync B fragments in
# fragment order (`csrc/fused_sdf_fwd.cu::frag_source`: 236 fragments of 32
# lanes x 4 elements, padding zero), which `FusedSdfKernel.pack_bf16` writes
# in one launch beside the plain bf16 copy that K2-bf16 reads
BF16_FRAG_ELEMS = 236 * 32 * 4
# K2's tile (`csrc/fused_sdf_bwd.cu`: kPoints) and the floats of its
# per-block pre-activation stash (5 hidden layers x 128 rows x 64); K2-bf16's
# tile (`csrc/fused_sdf_bwd_bf16.cu`: kPoints, 8 warps of 8 points) and its
# per-block stash (8 warps x 4 layers x 18 words of 16 bytes x 32 lanes)
BWD_TILE_POINTS = 32
BWD_STASH_FLOATS = 5 * 4 * BWD_TILE_POINTS * 64
BWD_TILE_POINTS_BF16 = 64
BWD_STASH_FLOATS_BF16 = 8 * 4 * 18 * 32 * 4
# the products' operand types of the pair (`_mm_cast` in the JAX package)
MM_DTYPES = ("float32", "bfloat16")
# the profiler range (`utils/trace.py`) of a launch with its weight pack,
# named as PERF.md's kernel table names the kernel: (route, 'grad' |
# 'nograd' | 'bwd', mm_dtype) -> 'sdf.K8-bf16', ...
LAUNCH_SPANS = {(route, kind, m): f"sdf.{name}"
                + ("-bf16" if m == "bfloat16" else "")
                for route, names in ROUTES.items()
                for kind, name in zip(("grad", "nograd", "bwd"), names)
                for m in MM_DTYPES}


def _coord_masks(n_freqs, device=None):
    """[3, 3 + 6F] 0/1 rows: which posenc features depend on coordinate d."""
    eye = torch.eye(3, device=device)
    return torch.cat([eye] + [eye, eye] * n_freqs, dim=1)


def _arch(sdf_network):
    """(n_freqs, skip_in, n_hidden): `_forward_plain`'s arguments."""
    return sdf_arch(sdf_network)[:3]


class SdfArch(NamedTuple):
    """An SDF MLP's shape as the fused pair sees it: posenc frequencies,
    skip layers, hidden layers and their width (the latent is folded into
    the biases, so its width does not enter)."""
    n_freqs: int
    skip_in: tuple
    n_hidden: int
    width: int

    @property
    def pe_dim(self):
        return 3 + 6 * self.n_freqs

    @property
    def skip_mask(self):
        return sum(1 << l for l in self.skip_in)

    def layer_shapes(self):
        """[(Ka [in, out], Kb [pe, out] or None)] as `prepare_fused_params`
        returns them: layer 0 reads the posenc, a skip layer h and posenc."""
        W, D = self.width, self.pe_dim
        shapes = []
        for l in range(self.n_hidden + 1):
            out = W + 1 if l == self.n_hidden else W
            if l == 0:
                shapes.append(((D, out), None))
            else:
                shapes.append(((W, out), (D, out) if l in self.skip_in
                               else None))
        return shapes

    @property
    def num_weights(self):
        return sum(a[0] * a[1] + (b[0] * b[1] if b else 0)
                   for a, b in self.layer_shapes())

    @property
    def bias_width(self):
        return self.n_hidden * self.width + self.width + 1

    def describe(self):
        return (f"posenc {self.n_freqs}, skips {self.skip_in}, "
                f"{self.n_hidden} hidden x {self.width}")


# the SDF MLP of options/pix3d/config.yaml, which K1 / K3 / K2 are written
# for
FLAGSHIP = SdfArch(6, (1, 2), 5, 64)


def sdf_arch(sdf_network):
    return SdfArch(sdf_network.posenc_res, tuple(sdf_network.skip_in),
                   sdf_network.n_hidden, sdf_network.n_channels)


def arch_from_opt(opt):
    """The SdfArch that `SDFNetwork.from_opt(opt)` builds."""
    a = opt.arch.impl_sdf
    return SdfArch(a.pos_enc, tuple(a.skip_connection), a.n_hidden_layers,
                   a.n_channels)


def sdf_route(arch):
    """'flagship' (K1 / K3 + K2 and their bf16 forms) for `FLAGSHIP`,
    'generic' (K8 / K8-nograd + K9) for every other architecture inside
    `ENVELOPE`; a ValueError naming the envelope outside it. `arch` is an
    SdfArch or an SDFNetwork."""
    if not isinstance(arch, SdfArch):
        arch = sdf_arch(arch)
    if arch == FLAGSHIP:
        return "flagship"
    inside = all(lo <= getattr(arch, k) <= hi
                 for k, (lo, hi) in ENVELOPE.items())
    if not inside or any(not 1 <= l <= arch.n_hidden for l in arch.skip_in):
        e = ENVELOPE
        raise ValueError(
            "the fused SDF kernels run SDF MLPs with n_channels "
            f"{e['width'][0]}-{e['width'][1]}, n_hidden_layers "
            f"{e['n_hidden'][0]}-{e['n_hidden'][1]}, pos_enc "
            f"{e['n_freqs'][0]}-{e['n_freqs'][1]} and skip_connection within "
            f"{{1 .. n_hidden_layers}}; got {arch.describe()}")
    return "generic"


def route_note(arch):
    """What the CUDA path runs for `arch`, for a log line."""
    try:
        route = sdf_route(arch)
    except ValueError:
        return (f"SDF MLP {arch.describe()} lies outside the fused kernels' "
                "envelope (CUDA raises)")
    fwd, nograd, bwd = ROUTES[route]
    name = "the flagship's kernels" if route == "flagship" else \
        "the generic pair"
    return (f"SDF MLP {arch.describe()} through {name} ({fwd} / {nograd} "
            f"+ {bwd})")


def prepare_fused_params(sdf_network, latent):
    """-> (kernels, biases): kernels a list of (Ka, Kb or None), each [in, out]
    (the flax layout); biases a list of [B, out] with the latent folded in."""
    n_freqs, skip_in, n_hidden = _arch(sdf_network)
    pe_dim = 3 + 6 * n_freqs
    kernels, biases = [], []
    for l in range(n_hidden + 1):
        lin = getattr(sdf_network, f"lin{l}")
        K = lin.weight.t()
        b = lin.bias
        if l == 0:
            Kpe, Klat = K[:pe_dim], K[pe_dim:]
            kernels.append((Kpe, None))
            biases.append(b[None] + latent @ Klat)
        elif l in skip_in:
            C = K.shape[0] - pe_dim - latent.shape[-1]
            Kh = K[:C] * INV_SQRT2
            Kpe = K[C:C + pe_dim] * INV_SQRT2
            Klat = K[C + pe_dim:] * INV_SQRT2
            kernels.append((Kh, Kpe))
            biases.append(b[None] + latent @ Klat)
        else:
            kernels.append((K, None))
            biases.append(b[None].expand(latent.shape[0], b.shape[0]))
    return kernels, biases


def _arch_of_kernels(kernels):
    """The SdfArch that `prepare_fused_params`'s kernels were made for."""
    D, W = kernels[0][0].shape
    return SdfArch((D - 3) // 6, tuple(l for l in range(1, len(kernels))
                                       if kernels[l][1] is not None),
                   len(kernels) - 1, W)


def pack_fused_params(kernels, biases):
    """-> (weights [arch.num_weights], biases [B, arch.bias_width]): the
    kernels' packed layout (`csrc/fused_sdf_fwd.cu` for the flagship's 28,032
    and 385, `csrc/fused_sdf_generic.cu` for any), every layer kernel
    [in, out] row-major, a skip layer's h rows before its posenc rows."""
    arch = _arch_of_kernels(kernels)
    shapes = [(tuple(a.shape), None if b is None else tuple(b.shape))
              for a, b in kernels]
    assert shapes == arch.layer_shapes(), (shapes, arch)
    weights = torch.cat([k.reshape(-1) for pair in kernels for k in pair
                         if k is not None]).contiguous()
    bias = torch.cat(biases, dim=1).contiguous()
    assert weights.numel() == arch.num_weights \
        and bias.shape[1] == arch.bias_width, (weights.shape, bias.shape)
    return weights, bias


def _check_mm_dtype(mm_dtype):
    if mm_dtype not in MM_DTYPES:
        raise ValueError(f"mm_dtype must be one of {MM_DTYPES}, got "
                         f"{mm_dtype!r}")


def _round_bf16(x):
    """x rounded to bfloat16 (nearest even) and held in float32."""
    return x.to(torch.bfloat16).to(x.dtype)


class _CastProduct(torch.autograd.Function):
    """a [..., K] @ w [K, M] with both operands rounded to bfloat16 and the
    product taken in float32: the bf16 form of every product of K1 / K3.
    Its backward is K2's: the cotangent and the saved operands are rounded
    before each product (autograd through `.to(bfloat16)` casts would round
    after the product instead)."""

    @staticmethod
    def forward(ctx, a, w):
        a16, w16 = _round_bf16(a), _round_bf16(w)
        ctx.save_for_backward(a16, w16)
        return a16 @ w16

    @staticmethod
    def backward(ctx, g):
        a16, w16 = ctx.saved_tensors
        g16 = _round_bf16(g)
        da = g16 @ w16.t() if ctx.needs_input_grad[0] else None
        dw = None
        if ctx.needs_input_grad[1]:
            dw = (a16.reshape(-1, a16.shape[-1]).t()
                  @ g16.reshape(-1, g16.shape[-1]))
        return da, dw


@functools.lru_cache(maxsize=1)
def bf16_fragment_index():
    """[BF16_FRAG_ELEMS] int64 (read-only): the packed float32 weight that
    each bf16 element of K1-bf16 / K3-bf16's fragment-order weights holds,
    or -1 for the padding. The fragments are (k16 step kk, n8 tile j) of
    K0 [39 -> 48 rows][64], K1h, K1pe, K2h, K2pe, K3, K4 [64][64] and K5
    [64][65 -> 72] (the 64 feature columns, then the sdf column in tile 8),
    in that order; element 4 l + 2 r + e of a fragment (lane l, register r,
    half e) holds column 8 j + l // 4 and row 16 kk + 2 (l % 4) + 8 r + e,
    but in K0, K1pe and K2pe the posenc feature of slot s = 4 kk + 2 r + e
    of lane l % 4: the coordinate l % 4 itself in slot 0, then the sin and
    cos of the lane's (coordinate, frequency) pairs p = l % 4 + 4 i < 18
    (coordinate p % 3, frequency 2^(p // 3)) in slots 1 + 2 i, 2 + 2 i."""
    pe_rows, w, pairs = 39, 64, 18
    lane = np.arange(32)[:, None, None]
    reg = np.arange(2)[None, :, None]
    half = np.arange(2)[None, None, :]
    t = np.broadcast_to(lane % 4, (32, 2, 2))
    row = 2 * t + 8 * reg + half                           # [32, 2, 2]
    col = np.broadcast_to(lane // 4, row.shape)
    out, off = [], 0
    for rows in (pe_rows, w, pe_rows, w, pe_rows, w, w):   # K0 .. K4
        for kk in range(-(-rows // 16)):
            if rows == pe_rows:
                slot = 4 * kk + 2 * reg + half
                p = t + 4 * ((slot - 1) // 2)
                k = np.where(slot == 0, np.where(t < 3, t, -1), np.where(
                    p < pairs, 3 + 6 * (p // 3) + 3 * ((slot - 1) % 2)
                    + p % 3, -1))
            else:
                k = 16 * kk + row
            for j in range(w // 8):
                out.append(np.where(k >= 0, off + k * w + 8 * j + col, -1))
        off += rows * w
    for kk in range(w // 16):                              # K5
        for j in range(w // 8 + 1):
            k, n = 16 * kk + row, 8 * j + col
            out.append(np.where(n < w, off + k * (w + 1) + 1 + n,
                                np.where(n == w, off + k * (w + 1), -1)))
    idx = np.concatenate([o.reshape(-1) for o in out]).astype(np.int64)
    assert idx.size == BF16_FRAG_ELEMS and idx.max() == NUM_WEIGHTS - 1
    idx.setflags(write=False)
    return idx


def pack_bf16_reference(weights):
    """The plain version of `FusedSdfKernel.pack_bf16`: float32 weights
    [28032] -> (their bf16 fragments [BF16_FRAG_ELEMS], their plain bf16
    copy [28032]), both rounded to nearest even."""
    plain = weights.to(torch.bfloat16)
    idx = torch.tensor(bf16_fragment_index(), device=weights.device)
    frags = torch.where(idx >= 0, plain[idx.clamp(min=0)],
                        torch.zeros((), dtype=torch.bfloat16,
                                    device=weights.device))
    return frags, plain


def _padded_widths(arch, multiple):
    """(wp, dp, op): the width, 3 + 6 F and width + 1 rounded up to
    `multiple` (16 in the bf16 pack, 8 in the tf32 one)."""
    return tuple(-(-x // multiple) * multiple
                 for x in (arch.width, arch.pe_dim, arch.width + 1))


def _padded_elems(arch, multiple):
    wp, dp, op = _padded_widths(arch, multiple)
    return sum(((wp if l else 0) + (dp if l == 0 or l in arch.skip_in
                                    else 0)) * (op if l == arch.n_hidden
                                                else wp)
               for l in range(arch.n_hidden + 1))


def _padded_layers(weights, arch, multiple):
    """The packed float32 weights [arch.num_weights] as the generic packs
    lay them out, float32: each layer a zero-padded [kp][np] matrix, its
    rows the h rows padded to wp then (layer 0 and the skip layers) the
    posenc rows padded to dp, its columns padded to wp (the output layer:
    op, `_padded_widths`); the layers back to back."""
    wp, dp, op = _padded_widths(arch, multiple)
    kernels, _ = unpack_fused_params(
        weights, weights.new_zeros(1, arch.bias_width), arch)
    parts = []
    for l, (ka, kb) in enumerate(kernels):
        n = op if l == arch.n_hidden else wp
        pe = ka if l == 0 else kb
        blocks = [] if l == 0 else [(ka, wp)]
        if pe is not None:
            blocks.append((pe, dp))
        for k, rows in blocks:
            m = weights.new_zeros(rows, n)
            m[:k.shape[0], :k.shape[1]] = k
            parts.append(m.reshape(-1))
    return torch.cat(parts)


def generic_packed_bf16(arch):
    """bf16 elements of `generic_pack_bf16_reference`'s pack."""
    return _padded_elems(arch, 16)


def generic_pack_bf16_reference(weights, arch):
    """The plain version of `GenericSdfKernel.pack_bf16`: the packed
    float32 weights [arch.num_weights] -> K8-bf16 / K9-bf16's weights, bf16
    (nearest even), in `_padded_layers`'s layout with widths padded to 16."""
    return _padded_layers(weights, arch, 16).to(torch.bfloat16)


def tf32_rna(x):
    """float32 -> each element rounded to tf32 as `cvt.rna.tf32.f32` rounds
    it (10 mantissa bits, nearest, ties away from zero; the low 13 bits
    zero), float32; NaN as it is."""
    u = x.contiguous().view(torch.int32)
    r = torch.bitwise_and(u + 0x1000, -0x2000)
    return torch.where((u & 0x7fffffff) > 0x7f800000, u, r).view(
        torch.float32)


def generic_packed_tf32(arch):
    """float32 elements of `generic_pack_tf32_reference`'s pack."""
    return 2 * _padded_elems(arch, 8)


def generic_pack_tf32_reference(weights, arch):
    """The plain version of `GenericSdfKernel.pack_tf32`: the packed
    float32 weights [arch.num_weights] -> K8 / K9's weights, in
    `_padded_layers`'s layout with widths padded to 8, each element x as
    its pair (hi, lo) of tf32 halves, hi = `tf32_rna(x)`, lo =
    `tf32_rna(x - hi)`: [generic_packed_tf32(arch)] float32."""
    x = _padded_layers(weights, arch, 8)
    hi = tf32_rna(x)
    return torch.stack([hi, tf32_rna(x - hi)], dim=1).reshape(-1)


def _product(mm_dtype):
    return torch.matmul if mm_dtype == "float32" else _CastProduct.apply


def _act_pair(prim):
    """(softplus(100x)/100, sigmoid(100x)) sharing one exp, as the kernel."""
    z = 100.0 * prim
    e = torch.exp(-z.abs())
    inv = 1.0 / (1.0 + e)
    sig = torch.where(z >= 0, inv, 1.0 - inv)
    act = (torch.clamp(z, min=0.0) + torch.log1p(e)) / 100.0
    return act, sig


def _forward_plain(kernels, biases, points, n_freqs, skip_in, n_hidden,
                   compute_grad, force_symmetry, mm_dtype="float32"):
    _check_mm_dtype(mm_dtype)
    mm = _product(mm_dtype)
    x = points
    if force_symmetry:
        # |x0| as x0 * sign0: the JAX package's d|x|/dx at 0 is 1, torch's 0
        sign0 = torch.where(x[..., :1] < 0, -1.0, 1.0)
        x = torch.cat([x[..., :1] * sign0, x[..., 1:]], dim=-1)
    pe_parts = [x]
    dpe_parts = [torch.ones_like(x)] if compute_grad else None
    for k in range(n_freqs):
        f = 2.0 ** k
        xf = x * f
        s, c = torch.sin(xf), torch.cos(xf)
        pe_parts += [s, c]
        if compute_grad:
            dpe_parts += [f * c, -f * s]
    pe = torch.cat(pe_parts, dim=-1)                           # [B,N,D]
    if compute_grad:
        dpe = torch.cat(dpe_parts, dim=-1)
        m = _coord_masks(n_freqs, pe.device).to(pe.dtype)      # [3,D]
        tangents = dpe[:, None] * m[None, :, None]             # [B,3,N,D]
        rows = torch.cat([pe[:, None], tangents], dim=1)       # [B,4,N,D]
    else:
        rows = pe[:, None]                                     # [B,1,N,D]

    h = out = prim = None
    for l in range(n_hidden + 1):
        Ka, Kb = kernels[l]
        if l == 0:
            out = mm(rows, Ka)                                 # [B,R,N,W]
        elif l in skip_in:
            out = mm(h, Ka) + mm(rows, Kb)
        else:
            out = mm(h, Ka)
        prim = out[:, 0] + biases[l][:, None]                  # [B,N,W]
        if l < n_hidden:
            act, sig = _act_pair(prim)
            if compute_grad:
                h = torch.cat([act[:, None], out[:, 1:] * sig[:, None]], dim=1)
            else:
                h = act[:, None]

    sdf, feat = prim[..., :1], prim[..., 1:]
    grad = None
    if compute_grad:
        g = out[:, 1:, :, 0].movedim(1, -1)                    # [B,N,3]
        if force_symmetry:
            g = torch.cat([g[..., :1] * sign0, g[..., 1:]], dim=-1)
        grad = g
    return sdf, feat, grad


def fused_sdf_forward_reference(sdf_network, points, latent,
                                compute_grad=False, mm_dtype="float32"):
    """Plain torch version of the kernel, on any device. points [B, N, 3],
    latent [B, C] -> (sdf [B,N,1], feat [B,N,C'], grad [B,N,3] or None)."""
    n_freqs, skip_in, n_hidden = _arch(sdf_network)
    kernels, biases = prepare_fused_params(sdf_network, latent)
    return _forward_plain(kernels, biases, points, n_freqs, skip_in,
                          n_hidden, compute_grad, sdf_network.force_symmetry,
                          mm_dtype)


def unpack_fused_params(weights, bias, arch):
    """The inverse of `pack_fused_params` for `arch`: (kernels, biases) as
    views of `weights` [arch.num_weights] and `bias` [B, arch.bias_width]."""
    kernels, off = [], 0
    for shapes in arch.layer_shapes():
        pair = []
        for shape in shapes:
            if shape is None:
                pair.append(None)
                continue
            n = shape[0] * shape[1]
            pair.append(weights[off:off + n].view(shape))
            off += n
        kernels.append(tuple(pair))
    widths = [arch.width] * arch.n_hidden + [arch.width + 1]
    return kernels, list(torch.split(bias, widths, dim=1))


def generic_forward_reference(points, weights, bias, arch, compute_grad,
                              force_symmetry, mm_dtype="float32"):
    """The plain version of `GenericSdfKernel.forward` (K8 / K8-nograd), in
    the dtype of its inputs: -> (sdf [B,N], feat [B,N,W], grad or None)."""
    kernels, biases = unpack_fused_params(weights, bias, arch)
    sdf, feat, grad = _forward_plain(kernels, biases, points, arch.n_freqs,
                                     arch.skip_in, arch.n_hidden,
                                     compute_grad, force_symmetry, mm_dtype)
    return sdf[..., 0], feat, grad


def generic_backward_reference(points, weights, bias, arch, sbar, fbar, gbar,
                               force_symmetry, mm_dtype="float32"):
    """The plain version of `GenericSdfKernel.backward` (K9): autograd of
    the plain forward with tangents, in the dtype of its inputs -> (d
    weights, d biases, d points)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True)
                  for t in (points, weights, bias)]
        outs = generic_forward_reference(*leaves, arch, True, force_symmetry,
                                         mm_dtype)
        dpoints, dweights, dbias = torch.autograd.grad(outs, leaves,
                                                       (sbar, fbar, gbar))
    return dweights, dbias, dpoints


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

def _launch_key(compute_grad, mm_dtype):
    return ("grad" if compute_grad else "nograd") + (
        "_bf16" if mm_dtype == "bfloat16" else "")


def _weights_arg(weights, mm_dtype):
    """The packed weights as the float32 forward and the backward read them:
    float32, or their bfloat16 copy (56 KB) for the bf16 products."""
    want = torch.float32 if mm_dtype == "float32" else torch.bfloat16
    if weights.dtype == torch.float32 and want == torch.bfloat16:
        weights = weights.to(torch.bfloat16)
    if weights.dtype != want or weights.numel() != NUM_WEIGHTS \
            or not weights.is_contiguous():
        raise TypeError(f"the {mm_dtype} kernels take {NUM_WEIGHTS} "
                        f"contiguous {want} weights, got {weights.dtype} "
                        f"{tuple(weights.shape)}")
    return weights


class FusedSdfKernel(CudaLibrary):
    """The forward library and its launch counts. `launches` counts launches
    of each instantiation ('grad' = K1, 'nograd' = K3, with '_bf16' for the
    bfloat16 products) and of the bf16 weight pack ('pack_bf16'); each is
    incremented where its kernel is launched and nowhere else."""

    stem = "scl_fused_sdf"
    source = _SOURCE

    def __init__(self, build_dir=BUILD_DIR):
        super().__init__(build_dir)
        self.launches = {_launch_key(g, m): 0 for m in MM_DTYPES
                         for g in (True, False)}
        self.launches["pack_bf16"] = 0

    def _bind(self, lib):
        fn = lib.scl_fused_sdf_fwd
        fn.argtypes = ([ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.scl_fused_sdf_num_weights.argtypes = []
        lib.scl_fused_sdf_num_weights.restype = ctypes.c_int
        if lib.scl_fused_sdf_num_weights() != NUM_WEIGHTS:
            raise RuntimeError("fused SDF library packs a different layout")
        lib.scl_fused_sdf_fwd_tile_points.argtypes = [ctypes.c_int] * 2
        lib.scl_fused_sdf_fwd_tile_points.restype = ctypes.c_int
        for mm, tiles in ((0, FWD_TILE_POINTS), (1, FWD_TILE_POINTS_BF16)):
            for key, grad in (("grad", 1), ("nograd", 0)):
                if lib.scl_fused_sdf_fwd_tile_points(grad, mm) != tiles[key]:
                    raise RuntimeError("fused SDF library walks a different "
                                       "tile")
        lib.scl_fused_sdf_bf16_frag_words.argtypes = []
        lib.scl_fused_sdf_bf16_frag_words.restype = ctypes.c_int
        if 2 * lib.scl_fused_sdf_bf16_frag_words() != BF16_FRAG_ELEMS:
            raise RuntimeError("fused SDF library packs other bf16 fragments")
        lib.scl_fused_sdf_pack_bf16.argtypes = [ctypes.c_void_p] * 4
        lib.scl_fused_sdf_pack_bf16.restype = ctypes.c_int

    def pack_bf16(self, weights):
        """weights [28032] float32 -> (the bf16 B fragments that K1-bf16 /
        K3-bf16 read [BF16_FRAG_ELEMS], the plain bf16 copy that K2-bf16
        reads [28032]): on CUDA one launch of the library's pack kernel; CPU
        tensors take the plain version (`pack_bf16_reference`)."""
        if weights.dtype != torch.float32 or weights.numel() != NUM_WEIGHTS \
                or not weights.is_contiguous():
            raise TypeError(f"the bf16 pack takes {NUM_WEIGHTS} contiguous "
                            f"float32 weights, got {weights.dtype} "
                            f"{tuple(weights.shape)}")
        if weights.device.type == "cpu":
            return pack_bf16_reference(weights)
        if weights.device.type != "cuda":
            raise ValueError(f"no bf16 pack for device {weights.device}")
        lib = self.build()
        dev = weights.device
        frags = torch.empty(BF16_FRAG_ELEMS, device=dev, dtype=torch.bfloat16)
        plain = torch.empty(NUM_WEIGHTS, device=dev, dtype=torch.bfloat16)
        with torch.cuda.device(dev):
            err = lib.scl_fused_sdf_pack_bf16(
                weights.data_ptr(), frags.data_ptr(), plain.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"bf16 weight pack launch failed: cudaError "
                               f"{err}")
        self.launches["pack_bf16"] += 1
        return frags, plain

    def _bf16_weights(self, weights):
        """What the bf16 instantiations read: the fragments of
        `pack_bf16` (a float32 copy is packed first, one launch)."""
        if weights.dtype == torch.float32 and weights.numel() == NUM_WEIGHTS:
            return self.pack_bf16(weights)[0]
        if weights.dtype != torch.bfloat16 \
                or weights.numel() != BF16_FRAG_ELEMS \
                or not weights.is_contiguous() or weights.data_ptr() % 16:
            raise TypeError(f"the bfloat16 kernels take {NUM_WEIGHTS} "
                            "float32 weights or the 16-byte aligned "
                            f"{BF16_FRAG_ELEMS} bf16 fragments of pack_bf16, "
                            f"got {weights.dtype} {tuple(weights.shape)}")
        return weights

    def launch(self, points, weights, biases, compute_grad, force_symmetry,
               mm_dtype="float32"):
        """points [B,N,3], weights [28032] float32 (or, for
        `mm_dtype="bfloat16"`, the fragments of `pack_bf16`), biases [B,385]
        (float32, contiguous, one CUDA device) -> (sdf [B,N], feat [B,N,64],
        grad [B,N,3] or None), float32."""
        _check_mm_dtype(mm_dtype)
        if mm_dtype == "bfloat16":
            weights = self._bf16_weights(weights)
        else:
            weights = _weights_arg(weights, mm_dtype)
        lib = self.build()
        B, N, _ = points.shape
        dev = points.device
        sdf = torch.empty(B, N, device=dev, dtype=torch.float32)
        feat = torch.empty(B, N, 64, device=dev, dtype=torch.float32)
        grad = (torch.empty(B, N, 3, device=dev, dtype=torch.float32)
                if compute_grad else None)
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = lib.scl_fused_sdf_fwd(
                points.data_ptr(), weights.data_ptr(), biases.data_ptr(),
                sdf.data_ptr(), feat.data_ptr(),
                grad.data_ptr() if compute_grad else None,
                B, N, int(bool(compute_grad)), int(bool(force_symmetry)),
                int(mm_dtype == "bfloat16"), stream)
        if err != 0:
            raise RuntimeError(f"fused SDF kernel launch failed: cudaError "
                               f"{err}")
        self.launches[_launch_key(compute_grad, mm_dtype)] += 1
        return sdf, feat, grad


class FusedSdfBackwardKernel(CudaLibrary):
    """The backward library: K2 (`csrc/fused_sdf_bwd.cu`, float32 products)
    and K2-bf16 (`csrc/fused_sdf_bwd_bf16.cu`, bf16 products on the tensor
    cores) behind one C entry point. `launches` counts its launches per
    `mm_dtype` ('float32', 'bfloat16'), incremented where it is launched and
    nowhere else."""

    stem = "scl_fused_sdf_bwd"
    source = _SOURCE_BWD
    extra_sources = (_SOURCE_BWD_BF16,)

    def __init__(self, build_dir=BUILD_DIR):
        super().__init__(build_dir)
        self.launches = {m: 0 for m in MM_DTYPES}

    def _bind(self, lib):
        fn = lib.scl_fused_sdf_bwd
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.scl_fused_sdf_bwd_num_weights.argtypes = []
        lib.scl_fused_sdf_bwd_num_weights.restype = ctypes.c_int
        if lib.scl_fused_sdf_bwd_num_weights() != NUM_WEIGHTS:
            raise RuntimeError("fused SDF backward packs a different layout")
        for name in ("scl_fused_sdf_bwd_stash_floats",
                     "scl_fused_sdf_bwd_tile_points"):
            getattr(lib, name).argtypes = [ctypes.c_int]
            getattr(lib, name).restype = ctypes.c_int
        if (lib.scl_fused_sdf_bwd_stash_floats(0),
                lib.scl_fused_sdf_bwd_stash_floats(1)) != (
                    BWD_STASH_FLOATS, BWD_STASH_FLOATS_BF16):
            raise RuntimeError("fused SDF backward stashes a different tile")
        if (lib.scl_fused_sdf_bwd_tile_points(0),
                lib.scl_fused_sdf_bwd_tile_points(1)) != (
                    BWD_TILE_POINTS, BWD_TILE_POINTS_BF16):
            raise RuntimeError("fused SDF backward walks a different tile")

    def launch(self, points, weights, biases, sbar, fbar, gbar,
               force_symmetry, mm_dtype="float32"):
        """points [B,N,3], weights [28032] (as `FusedSdfKernel.launch`),
        biases [B,385] and the cotangents sbar [B,N], fbar [B,N,64],
        gbar [B,N,3] (float32, contiguous, one CUDA device) -> (d weights
        [28032], d biases [B,385], d points [B,N,3]), float32."""
        _check_mm_dtype(mm_dtype)
        weights = _weights_arg(weights, mm_dtype)
        lib = self.build()
        B, N, _ = points.shape
        dev = points.device
        # one persistent block per SM (208 or 227 KB of shared memory), never
        # more blocks than tiles; each block owns a slice of the weight and
        # bias gradient partials and of the stash (float32: 5 x 128 x 64
        # pre-activations, 21 MB at 132 blocks; bf16: 288 KB a block, 39 MB;
        # L2-resident)
        bf16 = mm_dtype == "bfloat16"
        tile = BWD_TILE_POINTS_BF16 if bf16 else BWD_TILE_POINTS
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        grid = min(sms, B * -(-N // tile))
        with torch.cuda.device(dev):
            f32 = dict(device=dev, dtype=torch.float32)
            dpoints = torch.empty(B, N, 3, **f32)
            dweights = torch.empty(NUM_WEIGHTS, **f32)
            dbiases = torch.empty(B, BIAS_WIDTH, **f32)
            dk_partial = torch.empty(grid, NUM_WEIGHTS, **f32)
            db_partial = torch.empty(grid, B, BIAS_WIDTH, **f32)
            stash = torch.empty(grid, BWD_STASH_FLOATS_BF16 if bf16
                                else BWD_STASH_FLOATS, **f32)
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.scl_fused_sdf_bwd(
                points.data_ptr(), weights.data_ptr(), biases.data_ptr(),
                sbar.data_ptr(), fbar.data_ptr(), gbar.data_ptr(),
                dpoints.data_ptr(), dweights.data_ptr(), dbiases.data_ptr(),
                dk_partial.data_ptr(), db_partial.data_ptr(),
                stash.data_ptr(), B, N, grid, int(bool(force_symmetry)),
                int(bf16), stream)
        if err != 0:
            raise RuntimeError(f"fused SDF backward launch failed: cudaError "
                               f"{err}")
        self.launches[mm_dtype] += 1
        return dweights, dbiases, dpoints


class GenericSdfKernel(CudaLibrary):
    """The architecture-generic pair: K8 (forward with tangents, 'grad'),
    K8-nograd ('nograd') and K9 (the backward, 'bwd'), their float32
    products as 3xTF32 on the tensor cores in `csrc/fused_sdf_generic.cu`,
    which read the weights' tf32 pack ('pack_tf32', one launch before each
    float32 launch), and with '_bf16' their bf16 forms on the tensor cores
    in `csrc/fused_sdf_generic_bf16.cu`, which read the weights' bf16 pack
    ('pack_bf16', one launch before each bf16 launch). One build serves
    every architecture of `ENVELOPE`, which arrives at each launch.
    `launches` counts each where it is launched and nowhere else."""

    stem = "scl_fused_sdf_generic"
    source = _SOURCE_GENERIC
    extra_sources = (_SOURCE_GENERIC_BF16,)
    headers = (_HEADER_GENERIC,)

    def __init__(self, build_dir=BUILD_DIR):
        super().__init__(build_dir)
        self.launches = {k + m: 0 for k in ("grad", "nograd", "bwd")
                         for m in ("", "_bf16")}
        self.launches["pack_bf16"] = self.launches["pack_tf32"] = 0

    def _bind(self, lib):
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.scl_sdf_generic_fwd.argtypes = [p] * 6 + [i] * 9 + [p]
        lib.scl_sdf_generic_bwd.argtypes = [p] * 10 + [i] * 9 + [p]
        lib.scl_sdf_generic_num_weights.argtypes = [i] * 4
        lib.scl_sdf_generic_tile_points.argtypes = [i] * 7
        lib.scl_sdf_generic_stash_floats.argtypes = [i] * 5
        lib.scl_sdf_generic_bwd_blocks_per_sm.argtypes = [i] * 5
        for name in ("fwd", "bwd", "num_weights", "tile_points",
                     "stash_floats", "bwd_blocks_per_sm"):
            getattr(lib, f"scl_sdf_generic_{name}").restype = i
        for kind in ("bf16", "tf32"):
            getattr(lib, f"scl_sdf_generic_pack_{kind}").argtypes = \
                [p] * 2 + [i] * 4 + [p]
            getattr(lib, f"scl_sdf_generic_packed_{kind}").argtypes = [i] * 4
            getattr(lib, f"scl_sdf_generic_pack_{kind}").restype = i
            getattr(lib, f"scl_sdf_generic_packed_{kind}").restype = i
        for arch in (FLAGSHIP, SdfArch(4, (2,), 4, 32),
                     SdfArch(0, (), 16, 512)):
            args = self._arch_args(arch)
            if lib.scl_sdf_generic_num_weights(*args) != arch.num_weights \
                    or lib.scl_sdf_generic_packed_bf16(*args) \
                    != generic_packed_bf16(arch) \
                    or lib.scl_sdf_generic_packed_tf32(*args) \
                    != generic_packed_tf32(arch):
                raise RuntimeError("the generic SDF library packs another "
                                   f"layout for {arch}")

    @staticmethod
    def _arch_args(arch):
        return arch.n_freqs, arch.n_hidden, arch.width, arch.skip_mask

    @staticmethod
    def _check_operands(arch, points, weights, biases, *cots):
        """Raise unless every operand is float32, contiguous, on the points'
        CUDA device and of the shape the kernels index: points [B,N,3],
        weights [arch.num_weights] (the bf16 forms read their pack),
        biases [B, arch.bias_width], the cotangents [B,N], [B,N,W],
        [B,N,3]."""
        B, N = points.shape[:2]
        shapes = [(B, N, 3), (arch.num_weights,), (B, arch.bias_width)]
        shapes += [(B, N), (B, N, arch.width), (B, N, 3)][:len(cots)]
        for t, shape in zip((points, weights, biases, *cots), shapes):
            if t.dtype != torch.float32 or tuple(t.shape) != shape \
                    or not t.is_contiguous() or t.device != points.device \
                    or t.device.type != "cuda":
                raise TypeError(f"the generic SDF kernels take contiguous "
                                f"float32 {shape} on a CUDA device, got "
                                f"{t.dtype} {tuple(t.shape)} on {t.device}")

    def _pack(self, kind, weights, arch):
        """weights [arch.num_weights] float32 -> their `kind` ("bf16" or
        "tf32") pack: on CUDA one launch of the pack kernel; CPU tensors
        take the plain version."""
        if weights.dtype != torch.float32 \
                or tuple(weights.shape) != (arch.num_weights,) \
                or not weights.is_contiguous():
            raise TypeError(f"the generic {kind} pack takes "
                            f"{arch.num_weights} contiguous float32 weights, "
                            f"got {weights.dtype} {tuple(weights.shape)}")
        bf16 = kind == "bf16"
        if weights.device.type == "cpu":
            return (generic_pack_bf16_reference if bf16
                    else generic_pack_tf32_reference)(weights, arch)
        if weights.device.type != "cuda":
            raise ValueError(f"no generic {kind} pack for device "
                             f"{weights.device}")
        lib = self.build()
        dev = weights.device
        packed = torch.empty(
            (generic_packed_bf16 if bf16 else generic_packed_tf32)(arch),
            device=dev, dtype=torch.bfloat16 if bf16 else torch.float32)
        with torch.cuda.device(dev):
            err = getattr(lib, f"scl_sdf_generic_pack_{kind}")(
                weights.data_ptr(), packed.data_ptr(),
                *self._arch_args(arch),
                torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"generic {kind} weight pack launch failed: "
                               f"cudaError {err}")
        self.launches[f"pack_{kind}"] += 1
        return packed

    def pack_bf16(self, weights, arch):
        """What K8-bf16 / K9-bf16 read: [generic_packed_bf16(arch)] bf16 in
        `generic_pack_bf16_reference`'s layout (`_pack`)."""
        return self._pack("bf16", weights, arch)

    def pack_tf32(self, weights, arch):
        """What K8 / K9 read: [generic_packed_tf32(arch)] float32, (hi, lo)
        tf32 pairs in `generic_pack_tf32_reference`'s layout (`_pack`)."""
        return self._pack("tf32", weights, arch)

    def _weights(self, weights, arch, mm_dtype):
        return (self.pack_bf16(weights, arch) if mm_dtype == "bfloat16"
                else self.pack_tf32(weights, arch))

    def forward(self, points, weights, biases, arch, compute_grad,
                force_symmetry, mm_dtype="float32"):
        """points [B,N,3], weights [arch.num_weights], biases [B,
        arch.bias_width] (float32, contiguous, one CUDA device) -> (sdf
        [B,N], feat [B,N,W], grad [B,N,3] or None), float32: one launch of
        K8 (K8-nograd without `compute_grad`), after the weights' tf32 pack
        (bf16 pack for bf16 products)."""
        _check_mm_dtype(mm_dtype)
        self._check_operands(arch, points, weights, biases)
        lib = self.build()
        B, N, _ = points.shape
        dev = points.device
        f32 = dict(device=dev, dtype=torch.float32)
        sdf = torch.empty(B, N, **f32)
        feat = torch.empty(B, N, arch.width, **f32)
        grad = torch.empty(B, N, 3, **f32) if compute_grad else None
        w = self._weights(weights, arch, mm_dtype)
        with torch.cuda.device(dev):
            err = lib.scl_sdf_generic_fwd(
                points.data_ptr(), w.data_ptr(), biases.data_ptr(),
                sdf.data_ptr(), feat.data_ptr(),
                grad.data_ptr() if compute_grad else None, B, N,
                *self._arch_args(arch), int(bool(compute_grad)),
                int(bool(force_symmetry)), int(mm_dtype == "bfloat16"),
                torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"generic SDF forward launch failed: "
                               f"cudaError {err}")
        key = "grad" if compute_grad else "nograd"
        self.launches[key + ("_bf16" if mm_dtype == "bfloat16" else "")] += 1
        return sdf, feat, grad

    def scratch_floats(self, arch, B, N, mm_dtype="float32"):
        """(grid, partial floats a block, stash floats a block) of a K9
        launch at B x N on the current CUDA device: its blocks (as many as
        fit on the card, at most one a tile) each own a slice of the
        weight- and bias-gradient partials and of the stash."""
        lib = self.build()
        bf16 = int(mm_dtype == "bfloat16")
        args = self._arch_args(arch)
        tile = lib.scl_sdf_generic_tile_points(*args, 1, 1, bf16)
        per_sm = lib.scl_sdf_generic_bwd_blocks_per_sm(*args, bf16)
        stash = lib.scl_sdf_generic_stash_floats(*args, bf16)
        if tile < 1 or per_sm < 1 or stash < 1:
            raise RuntimeError(f"generic SDF backward has no launch for "
                               f"{arch}: tile {tile}, blocks {per_sm}")
        sms = torch.cuda.get_device_properties(
            torch.cuda.current_device()).multi_processor_count
        grid = min(sms * per_sm, B * -(-N // tile))
        return grid, arch.num_weights + B * arch.bias_width, stash

    def backward(self, points, weights, biases, arch, sbar, fbar, gbar,
                 force_symmetry, mm_dtype="float32"):
        """K9: points, weights and biases as `forward`, the cotangents sbar
        [B,N], fbar [B,N,W], gbar [B,N,3] -> (d weights [arch.num_weights],
        d biases [B, arch.bias_width], d points [B,N,3]), float32. Its
        blocks each add into their own slice of the partials, which a
        second launch sums (`scratch_floats`); the weights' tf32 pack first
        (bf16 pack for bf16 products)."""
        _check_mm_dtype(mm_dtype)
        self._check_operands(arch, points, weights, biases, sbar, fbar, gbar)
        lib = self.build()
        B, N, _ = points.shape
        dev = points.device
        bf16 = int(mm_dtype == "bfloat16")
        with torch.cuda.device(dev):
            grid, width, stash_floats = self.scratch_floats(arch, B, N,
                                                            mm_dtype)
            w = self._weights(weights, arch, mm_dtype)
            f32 = dict(device=dev, dtype=torch.float32)
            dpoints = torch.empty(B, N, 3, **f32)
            out = torch.empty(width, **f32)
            partials = torch.empty(grid, width, **f32)
            stash = torch.empty(grid, stash_floats, **f32)
            err = lib.scl_sdf_generic_bwd(
                points.data_ptr(), w.data_ptr(), biases.data_ptr(),
                sbar.data_ptr(), fbar.data_ptr(), gbar.data_ptr(),
                dpoints.data_ptr(), out.data_ptr(), partials.data_ptr(),
                stash.data_ptr(), B, N, grid, *self._arch_args(arch),
                int(bool(force_symmetry)), bf16,
                torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"generic SDF backward launch failed: "
                               f"cudaError {err}")
        self.launches["bwd" + ("_bf16" if bf16 else "")] += 1
        return (out[:arch.num_weights],
                out[arch.num_weights:].view(B, arch.bias_width), dpoints)


KERNEL = FusedSdfKernel()
BACKWARD = FusedSdfBackwardKernel()
GENERIC = GenericSdfKernel()


def _check_cuda_inputs(sdf_network, points, latent):
    """-> the network's route (`sdf_route`); raises on what the kernels do
    not take."""
    route = sdf_route(sdf_network)
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"points must be [B, N, 3], got {tuple(points.shape)}")
    if latent.dim() != 2 or latent.shape[0] != points.shape[0]:
        raise ValueError(f"latent must be [B, C] with B = {points.shape[0]}, "
                         f"got {tuple(latent.shape)}")
    if not points.is_contiguous():
        raise ValueError("points must be contiguous")
    for name, t in (("points", points), ("latent", latent)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != points.device:
            raise ValueError(f"{name} is on {t.device}, points on "
                             f"{points.device}")
    for p in sdf_network.parameters():
        if p.device != points.device or p.dtype != torch.float32:
            raise ValueError("SDF network parameters must be float32 on "
                             f"{points.device}")
    return route


def fused_sdf_forward(sdf_network, points, latent, compute_grad=False,
                      mm_dtype="float32"):
    """points [B, N, 3], latent [B, C] -> (sdf [B,N,1], feat [B,N,W],
    grad [B,N,3] or None), with the products' operands in `mm_dtype`. CPU
    tensors take the plain version; CUDA tensors run the Hopper kernel of
    the network's route."""
    _check_mm_dtype(mm_dtype)
    if points.device.type == "cpu":
        return fused_sdf_forward_reference(sdf_network, points, latent,
                                           compute_grad, mm_dtype)
    if points.device.type != "cuda":
        raise ValueError(f"no fused SDF path for device {points.device}")
    if torch.is_grad_enabled() and (
            points.requires_grad or latent.requires_grad
            or any(p.requires_grad for p in sdf_network.parameters())):
        raise RuntimeError("fused_sdf_forward has no backward; call it under "
                           "torch.inference_mode() / torch.no_grad(), or "
                           "use fused_sdf_train for gradients")
    with span("sdf.prepare"):
        route = _check_cuda_inputs(sdf_network, points, latent)
        weights, bias = pack_fused_params(
            *prepare_fused_params(sdf_network, latent))
    kind = "grad" if compute_grad else "nograd"
    with span(LAUNCH_SPANS[route, kind, mm_dtype]):
        if route == "flagship":
            sdf, feat, grad = KERNEL.launch(points, weights, bias,
                                            compute_grad,
                                            sdf_network.force_symmetry,
                                            mm_dtype)
        else:
            sdf, feat, grad = GENERIC.forward(points, weights, bias,
                                              sdf_arch(sdf_network),
                                              compute_grad,
                                              sdf_network.force_symmetry,
                                              mm_dtype)
    return sdf[..., None], feat, grad


class _FusedSdfTrain(torch.autograd.Function):
    """K1 (forward with tangents) and K2 (its VJP) -- K8 and K9 for an
    `arch` off the flagship -- as one autograd node over the packed
    weights, the per-sample biases and the points. The latent folding and
    skip scaling stay outside, in differentiable torch, as
    `fused_sdf_train` does around its `custom_vjp` in the JAX package."""

    @staticmethod
    def forward(ctx, weights, biases, points, force_symmetry, mm_dtype,
                arch=None):
        ctx.force_symmetry, ctx.mm_dtype, ctx.arch = (force_symmetry,
                                                      mm_dtype, arch)
        route = "flagship" if arch is None else "generic"
        with span(LAUNCH_SPANS[route, "grad", mm_dtype]):
            if arch is not None:
                ctx.save_for_backward(points, weights.detach(), biases)
                return GENERIC.forward(points, weights.detach(), biases, arch,
                                       True, force_symmetry, mm_dtype)
            if mm_dtype == "bfloat16":
                # one launch writes both bf16 layouts: the fragments that
                # K1-bf16 reads and the plain copy that K2-bf16 reads
                w_fwd, w_bwd = KERNEL.pack_bf16(weights.detach())
            else:
                w_fwd = w_bwd = weights.detach()
            sdf, feat, grad = KERNEL.launch(points, w_fwd, biases, True,
                                            force_symmetry, mm_dtype)
        ctx.save_for_backward(points, w_bwd, biases)
        return sdf, feat, grad

    @staticmethod
    @once_differentiable
    def backward(ctx, sbar, fbar, gbar):
        points, w_bwd, biases = ctx.saved_tensors
        # unused outputs arrive as zeros (autograd materializes them)
        cots = (sbar.contiguous(), fbar.contiguous(), gbar.contiguous())
        route = "flagship" if ctx.arch is None else "generic"
        with span(LAUNCH_SPANS[route, "bwd", ctx.mm_dtype]):
            if ctx.arch is not None:
                dweights, dbiases, dpoints = GENERIC.backward(
                    points, w_bwd, biases, ctx.arch, *cots,
                    ctx.force_symmetry, ctx.mm_dtype)
            else:
                dweights, dbiases, dpoints = BACKWARD.launch(
                    points, w_bwd, biases, *cots, ctx.force_symmetry,
                    ctx.mm_dtype)
        return dweights, dbiases, dpoints, None, None, None


def fused_sdf_train(sdf_network, points, latent, detach_latent=False,
                    mm_dtype="float32"):
    """Differentiable (sdf [B,N,1], feat [B,N,W], grad [B,N,3]) for
    points [B, N, 3] and latent [B, C], with the products' operands in
    `mm_dtype`; gradients reach the SDF network's parameters, the latent
    (unless `detach_latent`) and the points.

    CPU tensors: plain autograd through `_forward_plain(compute_grad=True)`
    (the counterpart of the JAX package's `sdf_fwdmode_xla`, and the plain
    version of the K1 + K2 pair). CUDA tensors: K1 forward and K2 backward
    (K8 and K9 off the flagship, `sdf_route`), or an error; there is no
    fallback."""
    _check_mm_dtype(mm_dtype)
    if detach_latent:
        latent = latent.detach()
    n_freqs, skip_in, n_hidden = _arch(sdf_network)
    if points.device.type == "cpu":
        kernels, biases = prepare_fused_params(sdf_network, latent)
        return _forward_plain(kernels, biases, points, n_freqs, skip_in,
                              n_hidden, True, sdf_network.force_symmetry,
                              mm_dtype)
    if points.device.type != "cuda":
        raise ValueError(f"no fused SDF path for device {points.device}")
    with span("sdf.prepare"):
        route = _check_cuda_inputs(sdf_network, points, latent)
        weights, bias = pack_fused_params(
            *prepare_fused_params(sdf_network, latent))
    arch = None if route == "flagship" else sdf_arch(sdf_network)
    sdf, feat, grad = _FusedSdfTrain.apply(weights, bias, points,
                                           sdf_network.force_symmetry,
                                           mm_dtype, arch)
    return sdf[..., None], feat, grad
