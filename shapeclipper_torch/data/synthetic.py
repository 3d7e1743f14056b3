"""Procedural synthetic dataset (no external assets).

Renders a deterministic-per-index shaded ellipsoid to RGB/mask/normal maps,
with a matching GT surface point cloud and pose — enough geometric structure
to exercise the full train/eval pipeline (incl. the CLIP-NN branch, where
neighbors are other samples) when Pix3D assets are unavailable. Sample dict
schema matches `data/pix3d.py` exactly.

A copy of `shapeclipper_tpu/data/synthetic.py` (numpy only), kept in the
port so that it never imports the JAX package; `data/pix3d.py`,
`data/sampling.py` and `data/base.py` are copies too.
"""

from __future__ import annotations

import zlib

import numpy as np

from . import base
from .sampling import sample_ray_indices


class Dataset(base.Dataset):
    def __init__(self, opt, split="train", transform=None):
        super().__init__(opt, split)
        n = {"train": 64, "val": 8, "test": 8}.get(split, 8)
        n = int(opt.data.get("max_img_cat") or n)
        self.list = [("synthetic", f"{split}_{i:04d}") for i in range(n)]
        self.label2cat = ["synthetic"]
        self.clip_anno = transform is not None
        self.transform = transform
        self.H, self.W = opt.image_size

    def _shape_params(self, idx):
        # crc32, NOT hash(): str hashing is salted per process (PYTHONHASHSEED)
        # so hash-seeded samples would differ between processes (bench runs,
        # CLI subprocess tests, cross-process comparisons)
        seed = zlib.crc32(f"{self.split}/{idx}".encode()) % (2 ** 31)
        rng = np.random.RandomState(seed)
        radii = 0.25 + 0.25 * rng.rand(3)
        color = 0.2 + 0.8 * rng.rand(3)
        azim = rng.uniform(-np.pi, np.pi)
        return radii, color, azim

    def _render_maps(self, idx):
        """Orthographic-ish shaded ellipsoid at the image center."""
        H, W = self.H, self.W
        radii, color, azim = self._shape_params(idx)
        y, x = np.mgrid[0:H, 0:W].astype(np.float32)
        # normalized image coords in [-1, 1]
        u = (x + 0.5) / W * 2 - 1
        v = (y + 0.5) / H * 2 - 1
        a, b = radii[0] + 0.3, radii[1] + 0.3
        r2 = (u / a) ** 2 + (v / b) ** 2
        mask = (r2 <= 1.0).astype(np.float32)
        # sphere-cap normal
        nz = np.sqrt(np.maximum(1.0 - r2, 0.0))
        normal = np.stack([u / a, v / b, -nz], axis=-1)
        norm = np.linalg.norm(normal, axis=-1, keepdims=True)
        normal = normal / np.maximum(norm, 1e-8) * mask[..., None]
        shade = (0.4 + 0.6 * nz)[..., None]
        rgb = color[None, None, :] * shade * mask[..., None] \
            + 1.0 * (1 - mask[..., None])
        return (rgb.astype(np.float32), mask[..., None].astype(np.float32),
                normal.astype(np.float32))

    def _pose(self, idx):
        _, _, azim = self._shape_params(idx)
        c, s = np.cos(azim), np.sin(azim)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float32)
        pose = np.concatenate(
            [R, np.array([[0.0], [0.0], [self.opt.camera.dist]],
                         dtype=np.float32)], axis=1)
        return pose

    def _pointcloud(self, idx, n=2048):
        radii, _, _ = self._shape_params(idx)
        rng = np.random.RandomState(idx + 777)
        p = rng.randn(n, 3)
        p /= np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-8)
        return (p * radii[None]).astype(np.float32)

    def _sample_map(self, rgb_map, mask_map, normal_map, rng, ray_idx=None):
        opt = self.opt
        HW = self.H * self.W
        rgb = rgb_map.reshape(HW, 3)
        mask = mask_map.reshape(HW, 1)
        normal = normal_map.reshape(HW, 3)
        if self.split == "train" and opt.render.rand_sample:
            if ray_idx is None:
                ray_idx = sample_ray_indices(mask_map[..., 0],
                                             opt.render.rand_sample,
                                             opt.render.ray_uniform_fac, rng)
            rgb, mask, normal = rgb[ray_idx], mask[ray_idx], normal[ray_idx]
        else:
            ray_idx = None
        return rgb, mask, normal, ray_idx

    def __getitem__(self, idx):
        opt = self.opt
        rng = np.random.RandomState(idx * 9973 + 13)
        rgb_map, mask_map, normal_map = self._render_maps(idx)
        sample = dict(idx=np.int32(idx))
        if self.clip_anno:
            img = rgb_map
            if self.transform is not None:
                img = self.transform(img)
            sample.update(rgb_input=img)
            return sample
        aug = self.generate_augmentation(opt, rng) if self.augment else None
        nn_augs = ([self.generate_augmentation(opt, rng)
                    for _ in range(opt.data.k_nearest)] if self.augment
                   else None)
        pose_q = self._pose(idx)
        if aug is not None:
            rgb_map, mask_map, normal_map = self.apply_augmentation(
                opt, rgb_map, mask_map, normal_map, aug)
            pose_q = self.augment_pose(pose_q, aug)
        rgb, mask, normal, ray_idx = self._sample_map(
            rgb_map, mask_map, normal_map, rng)
        sample.update(
            rgb_input_map=rgb_map, mask_input_map=mask_map,
            normal_input_map=normal_map, category_label=np.int32(0),
            rgb_input=rgb, mask_input=mask, normal_input=normal,
            pose_gt=pose_q,
            intr=np.array([[opt.camera.focal * self.W, 0, self.W / 2],
                           [0, opt.camera.focal * self.H, self.H / 2],
                           [0, 0, 1]], dtype=np.float32),
            dpc_points=self._pointcloud(idx),
        )
        if ray_idx is not None:
            sample["ray_idx"] = ray_idx

        # neighbors: the next K samples (wrap-around)
        K = opt.data.k_nearest
        neighbor_ids = [(idx + k) % len(self.list) for k in range(1, K + 1)]
        pre_ray_idx = None
        if opt.data.get("preselect_NN") and self.split == "train":
            pre, masks_sampled = [], []
            for k, j in enumerate(neighbor_ids):
                _, m_map, _ = self._render_maps(j)
                if nn_augs is not None:
                    m_map = self.augment_mask2d(m_map[..., 0],
                                                nn_augs[k])[..., None]
                ridx = sample_ray_indices(
                    m_map[..., 0], opt.render.rand_sample,
                    opt.render.ray_uniform_fac, rng) \
                    if opt.render.rand_sample else None
                pre.append(ridx)
                masks_sampled.append(m_map.reshape(-1, 1)[ridx]
                                     if ridx is not None else m_map)
            sel = base.select_nn_views(opt, sample["mask_input"],
                                       masks_sampled, rng)
            neighbor_ids = [neighbor_ids[s] for s in sel]
            pre_ray_idx = [pre[s] for s in sel]
            if nn_augs is not None:
                nn_augs = [nn_augs[s] for s in sel]
        nn_maps, nn_masks, nn_normals = [], [], []
        nn_rgb, nn_m, nn_n, nn_ridx, nn_pose = [], [], [], [], []
        for k, j in enumerate(neighbor_ids):
            r_map, m_map, n_map = self._render_maps(j)
            if nn_augs is not None:
                r_map, m_map, n_map = self.apply_augmentation(
                    opt, r_map, m_map, n_map, nn_augs[k])
            nn_maps.append(r_map); nn_masks.append(m_map); nn_normals.append(n_map)
            r, m, n, ridx = self._sample_map(
                r_map, m_map, n_map, rng,
                ray_idx=(pre_ray_idx[k] if pre_ray_idx is not None else None))
            nn_rgb.append(r); nn_m.append(m); nn_n.append(n)
            if ridx is not None:
                nn_ridx.append(ridx)
            # reference quirk preserved: neighbor pose is the QUERY's pose
            # (reference `data/pix3d.py:192`)
            nn_pose.append(pose_q)
        sample.update(
            rgb_input_map_NN=np.stack(nn_maps), mask_input_map_NN=np.stack(nn_masks),
            normal_input_map_NN=np.stack(nn_normals),
            rgb_input_NN=np.stack(nn_rgb), mask_input_NN=np.stack(nn_m),
            normal_input_NN=np.stack(nn_n), pose_gt_NN=np.stack(nn_pose),
        )
        if nn_ridx:
            sample["ray_idx_NN"] = np.stack(nn_ridx)
        return sample
