"""Plain PyTorch reference of ShapeClipper's mathematics: the encoders,
the viewpoint estimator, the latent projections, the camera, the SDF MLP
with its spatial gradient (forward-mode tangents, written out), the RGB
MLP, VolSDF's Laplace density and volume rendering, every training loss
and Adam.

A frozen copy of the mathematics, written from the published model and
independent of the code under test: it imports nothing of the program and
takes as inputs only what the benchmark made from the seed (weights under
their state_dict names, batches, draws). Everything runs in float32 with
TF32 off, unless a `Precision` rounds the operands of the products for the
control (a lower precision put in the program's place).

Tensors follow the program's layouts: images [B, H, W, 3], poses
[B, 3, 4], rays [B, R, ...].
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

INV_SQRT2 = 1.0 / math.sqrt(2.0)
BN_EPS = 1e-5
BETA_MIN = 1e-4
R_PERMUTE = ((-1.0, 0.0, 0.0), (0.0, 0.0, -1.0), (0.0, -1.0, 0.0))
RESNET_STAGES = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}


# ------------------------------------------------------------------ precision

def _rounded(x, kind):
    if kind == "tf32":      # round to nearest, 10 mantissa bits
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    if kind == "bfloat16":
        return x.to(torch.bfloat16).float()
    if kind in ("fp8", "fp8_e5m2"):   # one scale a tensor
        dtype, top = ((torch.float8_e4m3fn, 448.0) if kind == "fp8"
                      else (torch.float8_e5m2, 57344.0))
        scale = top / x.abs().amax().clamp(min=1e-30)
        return (x * scale).to(dtype).float() / scale
    raise ValueError(kind)


class _Round(torch.autograd.Function):
    """An operand of a product rounded to `kind`; its cotangent rounded
    likewise on the way back (fp8's in e5m2, as fp8 training keeps
    gradients)."""

    @staticmethod
    def forward(ctx, x, kind):
        ctx.kind = kind
        return _rounded(x, kind)

    @staticmethod
    def backward(ctx, g):
        return _rounded(g, "fp8_e5m2" if ctx.kind == "fp8" else ctx.kind), None


def _round(x, kind):
    return x if kind == "float32" else _Round.apply(x, kind)


class Precision(NamedTuple):
    """What the operands of each product are rounded to: `enc` the
    encoders' convolutions, `imp` the implicit MLPs of the renders, `f32`
    every other product (heads, projections, the SDF grid)."""
    enc: str = "float32"
    imp: str = "float32"
    f32: str = "float32"

    def q(self, part):
        kind = getattr(self, part)
        return lambda x: _round(x, kind)


FLOAT32 = Precision()


def linear(x, w, b=None, q=None):
    q = q or (lambda t: t)
    y = q(x) @ q(w).t()
    return y if b is None else y + b


# ------------------------------------------------------------- encoders

def batch_norm(x, P, name, train):
    """Train mode: the batch's moments (biased variance); eval mode: the
    running statistics."""
    shape = [1, -1] + [1] * (x.dim() - 2)
    if train:
        dims = [0] + list(range(2, x.dim()))
        mean = x.mean(dims, keepdim=True)
        var = ((x - mean) ** 2).mean(dims, keepdim=True)
    else:
        mean = P[name + ".running_mean"].reshape(shape)
        var = P[name + ".running_var"].reshape(shape)
    return ((x - mean) * torch.rsqrt(var + BN_EPS)
            * P[name + ".weight"].reshape(shape)
            + P[name + ".bias"].reshape(shape))


def resnet(P, prefix, images, stages, train, prec, fc=True):
    """BasicBlock ResNet on NHWC images -> pooled features (or the fc)."""
    q = prec.q("enc")

    def conv(x, name, stride, pad):
        return F.conv2d(q(x), q(P[name]), stride=stride, padding=pad)

    x = images.permute(0, 3, 1, 2)
    x = torch.relu(batch_norm(conv(x, prefix + "conv1.weight", 2, 3), P,
                              prefix + "bn1", train))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for i, count in enumerate(stages):
        for j in range(count):
            p = f"{prefix}layer{i + 1}.{j}."
            stride = 2 if (i > 0 and j == 0) else 1
            y = torch.relu(batch_norm(conv(x, p + "conv1.weight", stride, 1),
                                      P, p + "bn1", train))
            y = batch_norm(conv(y, p + "conv2.weight", 1, 1), P, p + "bn2",
                           train)
            if p + "downsample.0.weight" in P:
                x = batch_norm(conv(x, p + "downsample.0.weight", stride, 0),
                               P, p + "downsample.1", train)
            x = torch.relu(y + x)
    feat = x.mean(dim=(2, 3))
    if fc:
        feat = linear(feat, P[prefix + "fc.weight"], P[prefix + "fc.bias"],
                      prec.q("f32"))
    return feat


def bottleneck(P, prefix, x, train, prec):
    q = prec.q("f32")
    y = torch.relu(batch_norm(linear(x, P[prefix + "linear1.weight"], q=q),
                              P, prefix + "bn1", train))
    y = batch_norm(linear(y, P[prefix + "linear2.weight"], q=q), P,
                   prefix + "bn2", train)
    return torch.relu(y + x)


def latent_projection(P, prefix, x, train, prec):
    x = bottleneck(P, prefix + "block0.", x, train, prec)
    x = bottleneck(P, prefix + "block1.", x, train, prec)
    return linear(x, P[prefix + "proj.weight"], P[prefix + "proj.bias"],
                  prec.q("f32"))


def unit(x):
    """x / |x| along the last axis, finite at 0."""
    return x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True),
                                      min=1e-24))


class Estimate(NamedTuple):
    trig_azim: torch.Tensor
    trig_elev: torch.Tensor
    trig_theta: torch.Tensor
    scale_focal: torch.Tensor
    scale_dist: torch.Tensor


def estimator(P, cfg, images, train, prec):
    feat = resnet(P, "estimator.feature_extractor.", images,
                  RESNET_STAGES["resnet18"], train, prec, fc=False)
    q = prec.q("f32")

    def head(name):
        h = bottleneck(P, f"estimator.{name}_head.", feat, train, prec)
        return linear(h, P[f"estimator.{name}_fc.weight"],
                      P[f"estimator.{name}_fc.bias"], q)

    trig = head("extr")
    size = 1.0 + torch.tanh(head("size"))[:, 0] * cfg["camera"]["size_range"]
    persp = (1.0 + torch.tanh(head("perspect"))[:, 0]
             * cfg["camera"]["perspect_range"])
    return Estimate(unit(trig[:, 0:2]), unit(trig[:, 2:4]),
                    unit(trig[:, 4:6]), persp, size * persp)


def encode(P, cfg, images, train, prec):
    """-> (SDF latent, RGB latent): the encoder and both projections."""
    arch = cfg["arch"]
    lat = resnet(P, "encoder.", images, RESNET_STAGES[arch["enc_network"]],
                 train, prec)
    d = arch["latent_dim_shape"]
    return (latent_projection(P, "latent_proj_shape.", lat[:, :d], train,
                              prec),
            latent_projection(P, "latent_proj_rgb.", lat[:, d:], train, prec))


# ---------------------------------------------------------------- camera

def rotation(est):
    def trig(t):
        return t[:, 0], t[:, 1]

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    c, s = trig(est.trig_azim)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    Ry = mat(((c, z, s), (z, o, z), (-s, z, c)))
    c, s = trig(est.trig_elev)
    Rx = mat(((o, z, z), (z, c, -s), (z, s, c)))
    c, s = trig(est.trig_theta)
    Rz = mat(((c, s, z), (-s, c, z), (z, z, o)))
    perm = torch.tensor(R_PERMUTE, device=c.device)
    return Rz @ Rx @ Ry @ perm


def pose_and_intr(cfg, est, H, W):
    """-> (pose [B, 3, 4] = [R | (0, 0, dist * scale_dist)], intr)."""
    R = rotation(est)
    z = torch.zeros_like(est.scale_dist)
    t = torch.stack([z, z, est.scale_dist * cfg["camera"]["dist"]], -1)
    return torch.cat([R, t[..., None]], -1), intrinsics(cfg, est.scale_focal,
                                                        H, W)


def intrinsics(cfg, scale_focal, H, W):
    f = cfg["camera"]["focal"] * scale_focal
    z, o = torch.zeros_like(f), torch.ones_like(f)
    return torch.stack([f * W, z, o * W / 2, z, f * H, o * H / 2, z, z, o],
                       -1).reshape(-1, 3, 3)


def rays(pose, intr, H, W, ray_idx=None):
    """-> (camera centres [B, 1, 3], unnormalised directions [B, R, 3]) at
    the pixels `ray_idx` [B, R] or the whole H x W grid."""
    B = pose.shape[0]
    dev = pose.device
    if ray_idx is None:
        ray_idx = torch.arange(H * W, device=dev)[None].expand(B, -1)
    row = torch.div(ray_idx, W, rounding_mode="floor").float()
    col = (ray_idx % W).float()
    pix = torch.stack([col + 0.5, row + 0.5, torch.ones_like(col)], -1)
    cam = pix @ torch.linalg.inv(intr).transpose(-1, -2)
    R, t = pose[..., :3], pose[..., 3]
    centre = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    return centre[:, None], cam @ R          # R^T x for each row x


def to_canonical(normals, pose):
    """Rotate normals [B, N, 3] by pose's R^T."""
    return normals @ pose[..., :3]


# ----------------------------------------------------------- implicit MLPs

def posenc(p, n_freqs, sym, tangents):
    """NeRF posenc of |x|, y, z (x's sign folded when `sym`), and with
    `tangents` its derivative along each coordinate [3, ..., D]."""
    s = torch.where(p[..., :1] < 0, -1.0, 1.0) if sym else None
    pp = torch.cat([p[..., :1] * s, p[..., 1:]], -1) if sym else p
    feats = [pp]
    for k in range(n_freqs):
        feats += [torch.sin(pp * 2.0 ** k), torch.cos(pp * 2.0 ** k)]
    pe = torch.cat(feats, -1)
    if not tangents:
        return pe, None
    tans = []
    for d in range(3):
        e = torch.zeros_like(pp)
        e[..., d] = s[..., 0] if (sym and d == 0) else 1.0
        parts = [e]
        for k in range(n_freqs):
            f = 2.0 ** k
            parts += [torch.cos(pp * f) * f * e, -torch.sin(pp * f) * f * e]
        tans.append(torch.cat(parts, -1))
    return pe, torch.stack(tans)


def sdf_field(P, cfg, points, latent, prec, tangents=True, part="imp"):
    """The SDF MLP at points [B, N, 3] with latent [B, C] -> (sdf [B, N],
    feature [B, N, W], d sdf / d points [B, N, 3] or None). Layer l reads
    [posenc, latent] (l = 0), [h, posenc, latent] / sqrt 2 (a skip layer)
    or h; softplus(100 z) / 100 between layers."""
    a = cfg["arch"]["impl_sdf"]
    L, skips = a["n_hidden_layers"], tuple(a["skip_connection"])
    q = prec.q(part)
    pe, tpe = posenc(points, a["pos_enc"], cfg["arch"]["force_symmetry"],
                     tangents)
    D = pe.shape[-1]
    x, t = None, None
    for l in range(L + 1):
        w = P[f"sdf_network.lin{l}.weight"]
        b = P[f"sdf_network.lin{l}.bias"]
        if l == 0:
            segs, scale = [(pe, tpe)], 1.0
        elif l in skips:
            segs, scale = [(x, t), (pe, tpe)], INV_SQRT2
        else:
            segs, scale = [(x, t)], 1.0
        off, h, ht = 0, 0.0, 0.0
        for v, tv in segs:
            k = v.shape[-1]
            wk = q(w[:, off:off + k] * scale)
            h = h + q(v) @ wk.t()
            if tangents:
                ht = ht + q(tv) @ wk.t()
            off += k
        if off < w.shape[1]:         # the latent, a per-sample bias
            h = h + (q(latent) @ q(w[:, off:] * scale).t())[:, None]
        h = h + b
        if l < L:
            x = F.softplus(100.0 * h) / 100.0
            if tangents:
                t = torch.sigmoid(100.0 * h) * ht
        else:
            grad = ht[..., 0].permute(1, 2, 0) if tangents else None
            return h[..., 0], h[..., 1:], grad
    raise AssertionError("unreachable")


def rgb_field(P, cfg, points, latent, feat, prec):
    a = cfg["arch"]["impl_rgb"]
    q = prec.q("imp")
    pe, _ = posenc(points, a["pos_enc"], cfg["arch"]["force_symmetry"], False)
    n = a["n_hidden_layers"] + 1
    x = None
    for l in range(n):
        w = P[f"rgb_network.lin{l}.weight"]
        b = P[f"rgb_network.lin{l}.bias"]
        if l == 0:
            D, C = pe.shape[-1], latent.shape[-1]
            h = (q(pe) @ q(w[:, :D]).t()
                 + (q(latent) @ q(w[:, D:D + C]).t())[:, None]
                 + q(feat) @ q(w[:, D + C:]).t() + b)
        else:
            h = q(x) @ q(w).t() + b
        x = torch.relu(h) if l < n - 1 else torch.sigmoid(h)
    return x


def laplace(sdf, beta_param):
    beta = beta_param.abs() + BETA_MIN
    e = torch.exp(-sdf.abs() / beta)
    density = torch.where(sdf >= 0, 0.5 * e, 1.0 - 0.5 * e) / beta
    return density, -e / (2.0 * beta * beta)


class Render(NamedTuple):
    rgb: torch.Tensor       # [B, R, 3]
    mask: torch.Tensor      # [B, R, 1]
    depth: torch.Tensor     # [B, R, 1]
    normal: torch.Tensor    # [B, R, 3]


def z_values(cfg, scale_dist, R, t_rand=None):
    S = cfg["render"]["n_samples_uniform"]
    d = cfg["camera"]["dist"] * scale_dist[:, None, None]
    t = torch.linspace(0.0, 1.0, S, device=scale_dist.device)
    z = ((d - 0.7) * (1.0 - t) + (d + 0.7) * t).expand(-1, R, S)
    if t_rand is None:
        return z
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    upper = torch.cat([mids, z[..., -1:]], -1)
    lower = torch.cat([z[..., :1], mids], -1)
    return lower + (upper - lower) * t_rand


def render(P, cfg, pose, intr, scale_dist, lat_sdf, lat_rgb, H, W, prec,
           ray_idx=None, t_rand=None):
    """VolSDF volume rendering of the rays `ray_idx` (all H x W when None)
    with stratified jitter `t_rand` [B, R, S] (none when None)."""
    centre, ray = rays(pose, intr, H, W, ray_idx)
    B, R = ray.shape[:2]
    dirs = unit(ray)
    depth_fac = 1.0 / torch.sqrt(torch.clamp((ray * ray).sum(-1, keepdim=True),
                                             min=1e-24))
    z = z_values(cfg, scale_dist, R, t_rand)
    S = z.shape[-1]
    pts = (centre[:, :, None] + z[..., None] * dirs[:, :, None]).reshape(
        B, R * S, 3)
    sdf, feat, grad = sdf_field(P, cfg, pts, lat_sdf, prec)
    density, dd = laplace(sdf, P["density.beta"])
    normal = unit(-dd[..., None] * grad).reshape(B, R, S, 3)
    rgb = rgb_field(P, cfg, pts, lat_rgb, feat, prec).reshape(B, R, S, 3)
    density = density.reshape(B, R, S)
    dists = torch.cat([z[..., 1:] - z[..., :-1],
                       torch.zeros_like(z[..., :1])], -1)
    free = dists * density
    shifted = torch.cat([torch.zeros_like(free[..., :1]), free[..., :-1]], -1)
    weights = (1.0 - torch.exp(-free)) * torch.exp(-torch.cumsum(shifted, -1))
    acc = weights.sum(-1, keepdim=True)
    bg = cfg["data"]["bgcolor"]
    nw = weights[..., None] ** cfg["reg"]["normal_pow"]
    return Render(
        rgb=(weights[..., None] * rgb).sum(-2) + (1.0 - acc) * bg,
        mask=acc,
        depth=(weights * z * depth_fac).sum(-1, keepdim=True),
        normal=unit((nw * normal).sum(-2)))


def sdf_grid(P, cfg, latent, prec, chunk=131072):
    """The SDF on the (vox + 1)^3 lattice over eval.range, float32-stated
    products -> [B, vox + 1, vox + 1, vox + 1]."""
    N = cfg["eval"]["vox_res"]
    lo, hi = cfg["eval"]["range"]
    g = torch.linspace(lo, hi, N + 1, device=latent.device)
    pts = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1).reshape(
        -1, 3)
    B = latent.shape[0]
    out = [sdf_field(P, cfg, pts[i:i + chunk][None].expand(B, -1, 3),
                     latent, prec, tangents=False, part="f32")[0]
           for i in range(0, pts.shape[0], chunk)]
    return torch.cat(out, 1).reshape(B, N + 1, N + 1, N + 1)


def turntable_pose(cfg, n_views, device):
    """[n_views, 3, 4] poses around the azimuth at the mean elevation + 15
    degrees and the mean roll of the dataset's ranges."""
    ranges = cfg["data"][cfg["data"]["dataset"]]
    azim = torch.linspace(0, 2, n_views, device=device) * math.pi
    elev = torch.full_like(azim, (sum(ranges["elev_range"]) / 2 + 15)
                           * math.pi / 180)
    theta = torch.full_like(azim, sum(ranges["theta_range"]) / 2
                            * math.pi / 180)

    def trig(a):
        return torch.stack([torch.cos(a), torch.sin(a)], -1)

    R = rotation(Estimate(trig(azim), trig(elev), trig(theta), None, None))
    t = torch.zeros(n_views, 3, device=device)
    t[:, 2] = cfg["camera"]["dist"]
    return torch.cat([R, t[..., None]], -1)


# ----------------------------------------------------------------- losses

def mse(pred, label):
    return ((pred - label) ** 2).mean()


def iou_loss(x, y):
    B = x.shape[0]
    x, y = x.reshape(B, -1), y.reshape(B, -1)
    inter = (x * y).sum(1)
    union = (x + y - x * y + 1e-8).sum(1)
    return (1.0 - inter / union).mean()


def normal_loss(pred, gt, mask, normal_l1, tolerance):
    """normal_l1 * L1 + (1 - cos) over the masked pixels, keeping the
    floor(n (1 - tolerance)) of them with the smallest angular error."""
    angular = 1.0 - (pred * gt).sum(-1)
    loss = (normal_l1 * (pred - gt).abs().sum(-1) + angular).reshape(-1)
    m = mask.reshape(-1)
    key = torch.where(m, angular.reshape(-1).detach(),
                      torch.full_like(loss, math.inf))
    order = torch.argsort(key, stable=True)
    keep_n = int(math.floor(float(m.sum()) * (1.0 - tolerance)))
    keep = torch.zeros_like(loss)
    keep[order[:keep_n]] = 1.0
    keep = keep * m.float()
    return (loss * keep).sum() / keep.sum().clamp(min=1.0)


def cam_margin(trig, ranges, eps=5.0):
    angle = torch.atan2(trig[:, 1], trig[:, 0]) * 180.0 / math.pi
    return (torch.clamp(ranges[0] - eps - angle, min=0.0).mean()
            + torch.clamp(angle - ranges[1] - eps, min=0.0).mean())


def cam_uniform(trig):
    """2-Wasserstein distance (p = 2) between the batch's (cos, sin, cos sin)
    of the azimuth and those of B evenly spaced angles."""
    B = trig.shape[0]
    grid = torch.arange(1.0, 2 * B, 2.0, device=trig.device) * math.pi / B
    c, s = torch.cos(grid), torch.sin(grid)
    total = 0.0
    for p, e in ((c, trig[:, 0]), (s, trig[:, 1]),
                 (c * s, trig[:, 0] * trig[:, 1])):
        d = torch.sort(p).values - torch.sort(e).values
        total = total + torch.sqrt((d ** 2).sum() + 1e-24)
    return total / (3.0 * B)


def cam_sym(est, est_flip):
    (a, e, t), (af, ef, tf) = ((est.trig_azim, est.trig_elev, est.trig_theta),
                               (est_flip.trig_azim, est_flip.trig_elev,
                                est_flip.trig_theta))
    return (((a[:, 0] - af[:, 0]) ** 2 + (-a[:, 1] - af[:, 1]) ** 2).mean()
            + ((e - ef) ** 2).sum(-1).mean()
            + ((t[:, 0] - tf[:, 0]) ** 2 + (-t[:, 1] - tf[:, 1]) ** 2).mean())
