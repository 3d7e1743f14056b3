"""CLIP nearest-neighbour annotator (counterpart of
`shapeclipper_tpu/clipnn/annotator.py`).

Encodes every train / val / test image with the CLIP image tower on the
device, L2-normalises, takes per-sample cosine top-k (or threshold
sampling) and writes the sorted CSVs that the training datasets read
(`data/pix3d.py:get_NN_anno`), plus a matplotlib contact sheet where the
dataset has image files and matplotlib is installed.
"""

from __future__ import annotations

import csv
import importlib
import os

import numpy as np
import torch

from ..utils.log import log
from .vit import CLIPVisionTower, clip_preprocess, load_clip_npz


class NNAnnotator:
    def __init__(self, opt, device):
        self.opt = opt
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device=cuda but torch.cuda.is_available() is "
                               "False")
        name = opt.get("clip", {}).get("model", "vit_l14")
        self.tower = CLIPVisionTower.from_name(
            name, opt.image_size,
            generator=torch.Generator().manual_seed(opt.seed or 0))
        weights = opt.get("clip", {}).get("weights")
        if weights and os.path.exists(weights):
            log.info(f"loading CLIP weights from {weights}...")
            load_clip_npz(self.tower, weights)
        else:
            log.warn("no CLIP weights found — running randomly initialized "
                     "(set clip.weights to a converted visual.* .npz)")
        self.tower = self.tower.to(self.device).eval()

    # ---------------------------------------------------------------- encode
    @torch.no_grad()
    def encode_split(self, opt, loader):
        """Every batch's `rgb_input` through the tower -> [N, D] numpy,
        L2-normalised (the norm clamped at 1e-12)."""
        feats = []
        for batch in loader:
            x = torch.from_numpy(np.asarray(batch["rgb_input"])).to(
                self.device)
            emb = self.tower(x)
            emb = emb / torch.clamp(
                torch.linalg.vector_norm(emb, dim=-1, keepdim=True),
                min=1e-12)
            feats.append(emb.cpu().numpy())
        return np.concatenate(feats, axis=0)

    # --------------------------------------------------------------- matches
    @torch.no_grad()
    def calc_matches(self, opt, features, k_nearest=6):
        """features: [N, D] L2-normalized. Returns (indices [N, k],
        values [N, k]); position 0 is self (reference `CLIP_anno.py:28-57`).
        Top-k mode sorts each row stably, so that among equal similarities
        the lower index comes first, as `jax.lax.top_k`."""
        f = torch.as_tensor(np.asarray(features, np.float32),
                            device=self.device)
        sims = f @ f.T                                 # [N, N]
        if opt.get("thres") is None:
            values, indices = torch.sort(sims, dim=-1, descending=True,
                                         stable=True)
            return (indices[:, :k_nearest].cpu().numpy(),
                    values[:, :k_nearest].cpu().numpy())
        # threshold mode: random k-1 among sims in [thres, 1), self first
        sims = sims.cpu().numpy()
        N = sims.shape[0]
        rng = np.random.RandomState(opt.seed or 0)
        indices, values = [], []
        for i in range(N):
            cand = np.nonzero((sims[i] >= opt.thres) & (sims[i] < 1.0))[0]
            if len(cand) < k_nearest - 1:
                order = np.argsort(-sims[i])[:k_nearest]
            else:
                pick = cand[rng.permutation(len(cand))[:k_nearest - 1]]
                order = np.concatenate([[i], pick])
            indices.append(order)
            values.append(sims[i][order])
        return np.stack(indices), np.stack(values)

    # ------------------------------------------------------------------ save
    def save_anno(self, opt, labels, index_topk, value_topk, split,
                  k_nearest=6):
        category_name = opt.data[opt.data.dataset].cat.replace(", ", "_")
        os.makedirs(opt.anno_root, exist_ok=True)
        csv_path = os.path.join(opt.anno_root,
                                f"{category_name}_{split}.csv")
        header = (["Query"]
                  + [f"Top_{i}" for i in range(1, k_nearest)]
                  + [f"Top_{i}_score" for i in range(1, k_nearest)])
        rows = []
        for i, label in enumerate(labels):
            row = [label]
            row += [labels[j] for j in index_topk[i][1:]]
            row += [f"{v:.4f}" for v in value_topk[i][1:]]
            rows.append(row)
        rows.sort(key=lambda r: r[0])
        with open(csv_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(header)
            w.writerows(rows)
        return csv_path

    def save_vis(self, opt, image_paths, indices, values, split,
                 k_nearest=6, n_vis=15):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import PIL.Image
        N = len(image_paths)
        n_vis = min(n_vis, N)
        sample_id = [N // n_vis * i for i in range(n_vis)]
        plt.figure(figsize=(5 * k_nearest, 5 * n_vis))
        count = 1
        for i in sample_id:
            img = PIL.Image.open(image_paths[i]).convert("RGB")
            plt.subplot(n_vis, k_nearest, count)
            plt.imshow(img)
            plt.xticks([]); plt.yticks([])
            count += 1
            for j, index in enumerate(indices[i][1:]):
                img = PIL.Image.open(image_paths[index]).convert("RGB")
                plt.subplot(n_vis, k_nearest, count)
                plt.imshow(img)
                plt.title(f"{values[i, j + 1]:.3f}", fontweight="bold")
                plt.xticks([]); plt.yticks([])
                count += 1
        plt.tight_layout()
        out = os.path.join(opt.output_path, f"CLIP_NN_{split}.png")
        plt.savefig(out)
        plt.close()
        return out


class Pix3DAnnotator(NNAnnotator):
    def load_dataset(self, opt):
        data = importlib.import_module(
            f"shapeclipper_torch.data.{opt.data.dataset}")
        self.datasets, self.loaders = {}, {}
        for split in ("train", "val", "test"):
            log.info(f"loading {split} data...")
            ds = data.Dataset(opt, split=split, transform=clip_preprocess)
            self.datasets[split] = ds
            self.loaders[split] = ds.setup_loader(
                opt, shuffle=False, drop_last=False)

    def compute_NN(self, opt):
        for split, loader in self.loaders.items():
            feats = self.encode_split(opt, loader)
            idx, vals = self.calc_matches(opt, feats,
                                          k_nearest=opt.k_nearest)
            ds = self.datasets[split]
            labels = getattr(ds, "rel_path_list",
                             [f"{c}/{n}.png" for c, n in ds.list])
            img_paths = getattr(ds, "img_path_list", None)
            self.save_anno(opt, labels, idx, vals, split,
                           k_nearest=opt.k_nearest)
            if img_paths:
                # the contact sheet is a by-product: the CSVs are written
                try:
                    self.save_vis(opt, img_paths, idx, vals, split,
                                  k_nearest=opt.k_nearest)
                except Exception as e:
                    log.warn(f"contact sheet failed: {e}")
