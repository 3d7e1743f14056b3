"""The inputs of a run, made from its seed: training batches in the
layout of the program's loader (a pre-collated numpy batch with one
pre-selected CLIP neighbour view a sample), the draws of each training
step, and request images.

An image is a shaded ellipsoid on the white background, as the
program's synthetic dataset draws them, with its radii, colour and
azimuth drawn from the seed; its rays are drawn without replacement with
probability 1 / (distance to the silhouette + ray_uniform_fac), as the
loader weighs them. Every seed gives the same sizes: only the contents
differ."""

from __future__ import annotations

import numpy as np
import torch

N_POINTS_GT = 2048


def _ellipsoids(rng, n, H, W):
    """n shaded ellipsoids -> (rgb [n, H, W, 3], mask [n, H, W, 1], normal
    [n, H, W, 3], boundary distance in pixels [n, H, W], radii [n, 3],
    azimuth [n])."""
    radii = 0.25 + 0.25 * rng.random((n, 3))
    color = 0.2 + 0.8 * rng.random((n, 3))
    azim = rng.uniform(-np.pi, np.pi, n)
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    u = ((x + 0.5) / W * 2 - 1)[None]
    v = ((y + 0.5) / H * 2 - 1)[None]
    a = (radii[:, 0] + 0.3)[:, None, None]
    b = (radii[:, 1] + 0.3)[:, None, None]
    r2 = (u / a) ** 2 + (v / b) ** 2
    mask = (r2 <= 1.0).astype(np.float32)
    nz = np.sqrt(np.maximum(1.0 - r2, 0.0))
    normal = np.stack([u / a, v / b, -nz], -1)
    normal = normal / np.maximum(np.linalg.norm(normal, axis=-1,
                                                keepdims=True), 1e-8)
    normal = normal * mask[..., None]
    shade = (0.4 + 0.6 * nz)[..., None]
    rgb = (color[:, None, None] * shade * mask[..., None]
           + (1.0 - mask[..., None]))
    # distance to the silhouette, in pixels along the smaller axis
    dist = np.abs(np.sqrt(r2) - 1.0) * np.minimum(a, b) * min(H, W) / 2
    return (rgb.astype(np.float32), mask[..., None], normal.astype(np.float32),
            dist, radii, azim)


def _rays(rng, dist, R, fac):
    """R flat pixel indices an image without replacement, weighted by
    1 / (dist + fac) (Gumbel top-k)."""
    n = dist.shape[0]
    logp = -np.log(dist.reshape(n, -1) + fac)
    keys = logp - np.log(-np.log(rng.random(logp.shape)))
    return np.argpartition(-keys, R - 1, axis=1)[:, :R].astype(np.int32)


def _pose(azim, dist):
    c, s = np.cos(azim), np.sin(azim)
    z, o = np.zeros_like(c), np.ones_like(c)
    R = np.stack([np.stack([c, z, s], -1), np.stack([z, o, z], -1),
                  np.stack([-s, z, c], -1)], -2)
    t = np.stack([z, z, np.full_like(c, dist)], -1)[..., None]
    return np.concatenate([R, t], -1).astype(np.float32)


def _gather(maps, idx):
    n = maps.shape[0]
    flat = maps.reshape(n, -1, maps.shape[-1])
    return np.take_along_axis(flat, idx[..., None].astype(np.int64), 1)


def train_batches(cfg, traffic, seed):
    """`traffic['pool_batches']` host batches of `cfg['batch_size']`
    samples, each with its neighbour view, every image different."""
    rng = np.random.default_rng([int(seed), 1])
    B, (H, W) = cfg["batch_size"], cfg["image_size"]
    R = cfg["render"]["rand_sample"]
    fac = cfg["render"]["ray_uniform_fac"]
    focal, dist = cfg["camera"]["focal"], cfg["camera"]["dist"]
    intr = np.array([[focal * W, 0, W / 2], [0, focal * H, H / 2], [0, 0, 1]],
                    np.float32)
    out = []
    for i in range(traffic["pool_batches"]):
        q = _ellipsoids(rng, B, H, W)
        nn_ = _ellipsoids(rng, B, H, W)
        q_idx, n_idx = _rays(rng, q[3], R, fac), _rays(rng, nn_[3], R, fac)
        gt = rng.standard_normal((B, N_POINTS_GT, 3))
        gt = gt / np.maximum(np.linalg.norm(gt, axis=-1, keepdims=True), 1e-8)
        pose_q = _pose(q[5], dist)
        batch = dict(
            idx=np.arange(i * B, (i + 1) * B, dtype=np.int32),
            rgb_input_map=q[0], mask_input_map=q[1], normal_input_map=q[2],
            category_label=np.zeros(B, np.int32),
            rgb_input=_gather(q[0], q_idx), mask_input=_gather(q[1], q_idx),
            normal_input=_gather(q[2], q_idx), pose_gt=pose_q,
            intr=np.broadcast_to(intr, (B, 3, 3)).copy(),
            dpc_points=(gt * q[4][:, None]).astype(np.float32),
            ray_idx=q_idx,
            rgb_input_map_NN=nn_[0][:, None], mask_input_map_NN=nn_[1][:, None],
            normal_input_map_NN=nn_[2][:, None],
            rgb_input_NN=_gather(nn_[0], n_idx)[:, None],
            mask_input_NN=_gather(nn_[1], n_idx)[:, None],
            normal_input_NN=_gather(nn_[2], n_idx)[:, None],
            pose_gt_NN=pose_q[:, None].copy(), ray_idx_NN=n_idx[:, None])
        out.append(batch)
    return out


def train_draws(cfg, traffic, seed, device):
    """A training step's draws for each pool batch, from a generator on
    the device: the merged render's jitter t_rand [2B, R, S] over
    [query; view], eik_idx [2B, R, 1] (the query's rows place its eikonal
    points) and eik_uniform [B, R, 3] in the eikonal sample range."""
    B = cfg["batch_size"]
    R = cfg["render"]["rand_sample"]
    S = cfg["render"]["n_samples_uniform"]
    lo, hi = cfg["arch"]["impl_sdf"]["eikonal_sample_range"]
    g = torch.Generator(device=device).manual_seed(int(seed) + 2)
    out = []
    for _ in range(traffic["pool_batches"]):
        out.append(dict(
            t_rand=torch.rand(2 * B, R, S, generator=g, device=device),
            eik_idx=torch.randint(0, S, (2 * B, R, 1), generator=g,
                                  device=device),
            eik_uniform=lo + (hi - lo) * torch.rand(B, R, 3, generator=g,
                                                    device=device)))
    return out


def request_images(cfg, traffic, seed):
    """`traffic['pool_images']` images [1, H, W, 3], as the serving CLI
    hands them in (composited on the background)."""
    rng = np.random.default_rng([int(seed), 3])
    H, W = cfg["image_size"]
    rgb = _ellipsoids(rng, traffic["pool_images"], H, W)[0]
    return [rgb[i:i + 1] for i in range(rgb.shape[0])]


def to_device(batch, device):
    """A host batch as tensors on `device` (for the reference)."""
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}
