"""Pix3D dataset with CLIP nearest-neighbor annotations.

Port of the reference dataset (reference `data/pix3d.py`) producing NHWC
numpy samples; NN stacks are [K, ...] (reference stacks on a trailing dim).
Behavioral quirks preserved and documented:
  * `pose_gt_NN` repeats the QUERY's pose, not the neighbor's
    (reference `data/pix3d.py:192`)
  * masks binarized at 0.5; white-background composite with `data.bgcolor`
  * normals renormalized from the `normal_processed` files and masked
"""

from __future__ import annotations

import csv
import json
import os
from functools import lru_cache

import numpy as np
import PIL.Image

from . import base
from .sampling import sample_ray_indices

CAT_ID_ALL = dict(
    bed="bed", bookcase="bookcase", chair="chair", desk="desk", misc="misc",
    sofa="sofa", table="table", tool="tool", wardrobe="wardrobe")


class Dataset(base.Dataset):
    def __init__(self, opt, split="train", transform=None):
        super().__init__(opt, split)
        # when transform is given, the dataset is used for CLIP annotation
        self.clip_anno = transform is not None
        self.transform = transform
        self.max_imgs = opt.data.get("max_img_cat") or np.inf
        self.H, self.W = opt.image_size

        self.cat_id = (list(CAT_ID_ALL.values())
                       if opt.data.pix3d.get("cat") is None else
                       [v for k, v in CAT_ID_ALL.items()
                        if k in opt.data.pix3d.cat.split(",")])
        self.cat2label = {cat: i for i, cat in enumerate(self.cat_id)}
        self.label2cat = [
            next(k for k, v in CAT_ID_ALL.items() if v == cat)
            for cat in self.cat_id]

        self.path = opt.data.get("root", "data/Pix3D")
        self.list = self.get_list(opt, split)
        if self.clip_anno:
            self.get_path_list(opt)
        else:
            self.NN_dict = self.get_NN_anno(opt)

    # ------------------------------------------------------------- listings
    def get_list(self, opt, split):
        cads = []
        for c in self.cat_id:
            list_fname = f"{self.path}/lists/{c}_{split}.txt"
            with open(list_fname) as f:
                for i, m in enumerate(f.read().splitlines()):
                    if i >= self.max_imgs:
                        break
                    cads.append((c, m))
        return cads

    def get_path_list(self, opt):
        self.img_path_list, self.pc_path_list, self.rel_path_list = [], [], []
        for idx in range(len(self.list)):
            meta = self.get_metadata(opt, idx)
            pc_fname = f"{self.path}/pointclouds/" + meta["cad_path"][6:]
            pc_fname = pc_fname.replace(".obj", ".npy")
            self.pc_path_list.append(pc_fname)
            self.img_path_list.append(f"{self.path}/{meta['img_path']}")
            self.rel_path_list.append("/".join(meta["img_path"].split("/")[1:]))

    def name_from_path(self, relpath):
        parts = relpath.split("/")
        return parts[0], parts[1].split(".")[0]

    def id_filename_mapping(self, opt, outpath):
        with open(outpath, "w") as outfile:
            for i in range(len(self.list)):
                meta = self.get_metadata(opt, i)
                image_fname = f"{self.path}/{meta['img_path']}"
                mask_fname = f"{self.path}/{meta['mask_path']}"
                normal_fname = f"{self.path}/" + meta["mask_path"].replace(
                    "mask", "normal")
                pc_fname = (f"{self.path}/pointclouds/"
                            + meta["cad_path"][6:]).replace(".obj", ".npy")
                outfile.write(f"{i} {image_fname} {mask_fname} "
                              f"{normal_fname} {pc_fname}\n")

    def get_NN_anno(self, opt):
        """CLIP_NN/{cats}_{split}.csv -> {(cat, name): [(cat, name), ...]}
        (reference `data/pix3d.py:95-108`)."""
        dict_anno = {}
        category_name = opt.data[opt.data.dataset].cat.replace(", ", "_")
        NN_fname = f"{self.path}/CLIP_NN/{category_name}_{self.split}.csv"
        with open(NN_fname) as csvfile:
            list_anno = list(csv.reader(csvfile))[1:]
        for anno in list_anno:
            c, name = self.name_from_path(anno[0])
            dict_anno[(c, name)] = [self.name_from_path(n)
                                    for n in anno[1:1 + opt.data.k_nearest]]
        return dict_anno

    # ------------------------------------------------------------- pixels
    def get_image(self, meta):
        image = PIL.Image.open(
            f"{self.path}/{meta['img_path']}").convert("RGB")
        mask = PIL.Image.open(
            f"{self.path}/{meta['mask_path']}").convert("L")
        return PIL.Image.merge("RGBA", (*image.split(), mask))

    def preprocess_image(self, opt, image, transform=None):
        image = image.resize((self.W, self.H))
        arr = np.asarray(image, dtype=np.float32) / 255.0   # [H,W,4]
        rgb, mask = arr[..., :3], arr[..., 3:]
        mask = (mask > 0.5).astype(np.float32)
        if opt.data.bgcolor is not None:
            rgb = rgb * mask + opt.data.bgcolor * (1 - mask)
        if transform is not None:
            rgb = transform(rgb)
        return rgb, mask

    def get_normal(self, opt, meta, mask):
        normal_path = meta["mask_path"].replace("mask", "normal")
        normal = PIL.Image.open(f"{self.path}/{normal_path}").convert("RGB")
        normal = normal.resize((self.W, self.H))
        normal = np.asarray(normal, dtype=np.float32) / 255.0
        normal = (normal - 0.5) * 2
        norm = np.linalg.norm(normal, axis=-1, keepdims=True)
        normal = normal / np.maximum(norm, 1e-8)
        return normal * mask

    def sample_map(self, opt, rgb_map, mask_map, normal_map, rng,
                   ray_idx=None):
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

    # ------------------------------------------------------------- geometry
    def get_camera(self, opt, meta):
        intr = np.array([[opt.camera.focal * self.W, 0, self.W / 2],
                         [0, opt.camera.focal * self.H, self.H / 2],
                         [0, 0, 1]], dtype=np.float32)
        R_raw = np.asarray(meta["cam_R"], dtype=np.float32)
        R_trans = np.diag([1.0, 1.0, -1.0]).astype(np.float32)
        R = R_trans @ R_raw
        pose = np.concatenate(
            [R, np.array([[0.0], [0.0], [opt.camera.dist]], np.float32)],
            axis=1)
        return intr, pose

    def get_pointcloud(self, meta):
        pc_fname = (f"{self.path}/pointclouds/"
                    + meta["cad_path"][6:]).replace(".obj", ".npy")
        return np.load(pc_fname).astype(np.float32)

    @lru_cache(maxsize=4096)
    def _meta_cached(self, c, name):
        meta_fname = f"{self.path}/annotation/{c}/{name}.json"
        with open(meta_fname, encoding="utf-8") as f:
            meta = json.load(f)
        return dict(
            focal=float(meta["focal_length"]),
            cam_R=tuple(map(tuple, meta["rot_mat"])),
            img_path=meta["img"].replace("img", "img_processed"),
            mask_path=meta["mask"].replace("mask", "mask_processed"),
            cad_path=meta["model"],
            bbox=tuple(meta["bbox"]),
        )

    def get_metadata(self, opt, idx, name=None, c=None):
        if name is None or c is None:
            c, name = self.list[idx]
        return self._meta_cached(c, name)

    # ------------------------------------------------------------- __getitem__
    def __getitem__(self, idx):
        opt = self.opt
        rng = np.random.RandomState(
            (idx * 100003 + (opt.seed or 0)) % (2 ** 31))
        sample = dict(idx=np.int32(idx))
        meta = self.get_metadata(opt, idx)

        if self.clip_anno:
            image = self.get_image(meta)
            rgb, _ = self.preprocess_image(opt, image, transform=self.transform)
            sample.update(rgb_input=rgb)
            return sample

        image = self.get_image(meta)
        c, name = self.list[idx]
        rgb_map, mask_map = self.preprocess_image(opt, image)
        normal_map = self.get_normal(opt, meta, mask_map)
        aug = self.generate_augmentation(opt, rng) if self.augment else None
        nn_augs = ([self.generate_augmentation(opt, rng)
                    for _ in range(opt.data.k_nearest)] if self.augment
                   else None)
        if aug is not None:
            rgb_map, mask_map, normal_map = self.apply_augmentation(
                opt, rgb_map, mask_map, normal_map, aug)
        sample.update(
            rgb_input_map=rgb_map, mask_input_map=mask_map,
            normal_input_map=normal_map,
            category_label=np.int32(self.cat2label[c]))

        rgb, mask, normal, ray_idx = self.sample_map(
            opt, rgb_map, mask_map, normal_map, rng)
        sample.update(rgb_input=rgb, mask_input=mask, normal_input=normal)
        if ray_idx is not None:
            sample["ray_idx"] = ray_idx

        intr, pose = self.get_camera(opt, meta)
        if aug is not None:
            pose = self.augment_pose(pose, aug)
        sample.update(pose_gt=pose, intr=intr,
                      dpc_points=self.get_pointcloud(meta))

        neighbors = self.NN_dict[(c, name)]
        maps = {k: [] for k in ("rgb_input_map_NN", "mask_input_map_NN",
                                "normal_input_map_NN")}
        tensors = {k: [] for k in ("rgb_input_NN", "mask_input_NN",
                                   "normal_input_NN", "ray_idx_NN",
                                   "pose_gt_NN")}
        if opt.data.get("preselect_NN") and self.split == "train":
            # load only the neighbor MASKS, do the IoU-weighted view
            # selection on host, then fully load just the selected views
            nn_ray_idx, nn_masks_sampled = [], []
            for i in range(opt.data.k_nearest):
                c_n, name_n = neighbors[i]
                meta_n = self.get_metadata(opt, 0, name_n, c_n)
                m = PIL.Image.open(
                    f"{self.path}/{meta_n['mask_path']}").convert("L")
                m = np.asarray(m.resize((self.W, self.H)),
                               np.float32) / 255.0
                m = (m > 0.5).astype(np.float32)
                if nn_augs is not None:
                    m = self.augment_mask2d(m, nn_augs[i])
                ridx = sample_ray_indices(m, opt.render.rand_sample,
                                          opt.render.ray_uniform_fac, rng) \
                    if opt.render.rand_sample else None
                nn_ray_idx.append(ridx)
                nn_masks_sampled.append(
                    m.reshape(-1)[ridx] if ridx is not None else m)
            selected = base.select_nn_views(
                opt, sample["mask_input"], nn_masks_sampled, rng)
            neighbors = [neighbors[j] for j in selected]
            preselected_ray_idx = [nn_ray_idx[j] for j in selected]
            if nn_augs is not None:
                nn_augs = [nn_augs[j] for j in selected]
            k_range = len(neighbors)
        else:
            preselected_ray_idx = None
            k_range = opt.data.k_nearest
        for i in range(k_range):
            c_n, name_n = neighbors[i]
            meta_n = self.get_metadata(opt, 0, name_n, c_n)
            image_n = self.get_image(meta_n)
            rgb_map_n, mask_map_n = self.preprocess_image(opt, image_n)
            normal_map_n = self.get_normal(opt, meta_n, mask_map_n)
            if nn_augs is not None:
                rgb_map_n, mask_map_n, normal_map_n = self.apply_augmentation(
                    opt, rgb_map_n, mask_map_n, normal_map_n, nn_augs[i])
            maps["rgb_input_map_NN"].append(rgb_map_n)
            maps["mask_input_map_NN"].append(mask_map_n)
            maps["normal_input_map_NN"].append(normal_map_n)
            rgb_n, mask_n, normal_n, ray_idx_n = self.sample_map(
                opt, rgb_map_n, mask_map_n, normal_map_n, rng,
                ray_idx=(preselected_ray_idx[i]
                         if preselected_ray_idx is not None else None))
            tensors["rgb_input_NN"].append(rgb_n)
            tensors["mask_input_NN"].append(mask_n)
            tensors["normal_input_NN"].append(normal_n)
            if ray_idx_n is not None:
                tensors["ray_idx_NN"].append(ray_idx_n)
            # reference quirk: neighbor pose = query pose (data/pix3d.py:192)
            tensors["pose_gt_NN"].append(pose)

        for k, v in maps.items():
            sample[k] = np.stack(v)
        for k, v in tensors.items():
            if v:
                sample[k] = np.stack(v)
        return sample
