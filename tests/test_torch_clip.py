"""The port's CLIP annotation (`clipnn/vit.py`, `clipnn/annotator.py`,
`python -m shapeclipper_torch.clip_anno`) against the JAX package's, on the
CPU in float32, with tests/test_clip.py's small tower (patch 8, width 64, 2
layers, 4 heads, embed 32) on 32 x 32 images: the tower on weights carried
by `bridge.clip_state_from_flax` and on one converted `visual.*` npz loaded
by both packages, the top-k / threshold matching, ties, and the CSVs.
"""

import csv
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapeclipper_tpu.clipnn import annotator as jannotator
from shapeclipper_tpu.clipnn import vit as jvit
from shapeclipper_tpu.config import options as joptions
from shapeclipper_tpu.utils.easydict import EasyDict as jedict
from shapeclipper_torch import bridge
from shapeclipper_torch.clipnn import annotator
from shapeclipper_torch.clipnn import vit

torch.set_num_threads(2)
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SMALL = dict(patch_size=8, width=64, layers=2, heads=4, embed_dim=32)


def jax_tower(image_size, seed=0):
    tower = jvit.CLIPVisionTower(**SMALL)
    x = jnp.zeros((1, *image_size, 3))
    params = jax.jit(tower.init)(jax.random.PRNGKey(seed), x)["params"]
    return tower, jax.tree_util.tree_map(np.asarray, params)


def images(n, image_size, seed=1):
    rgb = np.random.RandomState(seed).uniform(0, 1, (n, *image_size, 3))
    return np.stack([jvit.clip_preprocess(x) for x in rgb])


@pytest.mark.parametrize("image_size", [(32, 32), (36, 30)],
                         ids=["32x32", "36x30"])
def test_tower_matches_flax(image_size):
    """The flax tower and the port's on the same weights; 36 x 30 is padded
    as flax's "SAME" (5 x 4 patches)."""
    tower, params = jax_tower(image_size)
    x = images(3, image_size)
    want = np.asarray(jax.jit(tower.apply)({"params": params}, x))
    port = vit.CLIPVisionTower(image_size, **SMALL)
    port.load_state_dict(bridge.clip_state_from_flax(params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_npz_loads_equal_in_both_packages(tmp_path):
    """A seeded fake OpenAI `visual.*` npz (plus a text-tower entry that
    both loaders skip): JAX's q/k/v split and the port's straight load
    give the same embeddings."""
    port = vit.CLIPVisionTower((32, 32), **SMALL)
    rng = np.random.RandomState(0)
    data = {f"visual.{k}": (rng.randn(*v.shape) * 0.1).astype(np.float32)
            for k, v in port.state_dict().items()}
    data["token_embedding.weight"] = np.zeros((4, 4), np.float32)
    path = str(tmp_path / "clip.npz")
    np.savez(path, **data)
    tower, params = jax_tower((32, 32), seed=5)
    params = jvit.load_clip_npz(params, path)
    vit.load_clip_npz(port, path)
    x = images(2, (32, 32))
    want = np.asarray(tower.apply({"params": params}, x))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def anno_opt(tmp_path, thres=None):
    """tests/test_clip.py's _anno_opt."""
    opt = joptions.load_options(os.path.join(REPO, "options/clip/pix3d.yaml"))
    opt.update(image_size=[32, 32], batch_size=4, seed=0, thres=thres,
               output_path=str(tmp_path), anno_root=str(tmp_path / "CLIP_NN"),
               k_nearest=3)
    opt.H, opt.W = opt.image_size
    opt.data.update(dataset="synthetic", num_workers=0, max_img_cat=8)
    opt.data.synthetic = jedict(cat="synthetic")
    opt.clip = jedict(model="vit_b32", weights=None)
    return opt


def matches(features, thres, k, tmp_path):
    opt = anno_opt(tmp_path, thres)
    jann = object.__new__(jannotator.Pix3DAnnotator)   # no tower
    ann = object.__new__(annotator.Pix3DAnnotator)
    ann.device = torch.device("cpu")
    return (jannotator.NNAnnotator.calc_matches(jann, opt, features, k),
            annotator.NNAnnotator.calc_matches(ann, opt, features, k))


@pytest.mark.parametrize("thres", [None, 0.2], ids=["topk", "threshold"])
def test_calc_matches_matches_jax(tmp_path, thres):
    feats = np.random.RandomState(0).randn(40, 16).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    (jidx, jval), (idx, val) = matches(feats, thres, 4, tmp_path)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(val, jval, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(idx[:, 0], np.arange(40))


def test_calc_matches_ties_put_the_lower_index_first(tmp_path):
    """Duplicated images: every similarity is exact (entries 0 or +-0.5,
    four per row), and among equal ones the lower index comes first, as
    jax.lax.top_k, so a duplicate's own row starts with its twin."""
    rng = np.random.RandomState(2)
    feats = np.zeros((12, 16), np.float32)
    for row in feats:
        row[rng.choice(16, 4, replace=False)] = rng.choice([-0.5, 0.5], 4)
    feats[7] = feats[2]
    feats[9] = feats[2]
    feats[11] = feats[4]
    (jidx, jval), (idx, val) = matches(feats, None, 4, tmp_path)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(val, jval)
    np.testing.assert_array_equal(idx[2, :3], [2, 7, 9])
    np.testing.assert_array_equal(idx[9, :3], [2, 7, 9])
    np.testing.assert_array_equal(idx[11, :2], [4, 11])


def read_csvs(root):
    return {f: open(os.path.join(root, f)).read()
            for f in sorted(os.listdir(root))}


def test_compute_nn_writes_the_jax_csvs(tmp_path, monkeypatch):
    """Pix3DAnnotator.compute_NN on the synthetic set (8 images a split)
    with the small tower writes the JAX annotator's CSVs byte for byte,
    from the same weights."""
    small = lambda name, *a, **k: jvit.CLIPVisionTower(**SMALL)  # noqa: E731
    monkeypatch.setattr(jannotator.CLIPVisionTower, "from_name",
                        staticmethod(small))
    monkeypatch.setattr(
        annotator.CLIPVisionTower, "from_name",
        staticmethod(lambda name, image_size, generator=None:
                     vit.CLIPVisionTower(image_size, **SMALL)))
    jopt = anno_opt(tmp_path / "jax")
    jann = jannotator.Pix3DAnnotator(jopt)
    jann.load_dataset(jopt)
    jann.compute_NN(jopt)
    opt = anno_opt(tmp_path / "port")
    ann = annotator.Pix3DAnnotator(opt, "cpu")
    ann.tower.load_state_dict(bridge.clip_state_from_flax(
        jax.tree_util.tree_map(np.asarray, jann.params)), strict=True)
    ann.load_dataset(opt)
    ann.compute_NN(opt)
    got, want = read_csvs(opt.anno_root), read_csvs(jopt.anno_root)
    assert list(got) == [f"synthetic_{s}.csv" for s in ("test", "train",
                                                        "val")]
    assert got == want


def test_clip_anno_cli_on_cpu(tmp_path):
    """`python -m shapeclipper_torch.clip_anno --device=cpu` with ViT-B/32
    writes the three CSVs; without `--device` it needs CUDA and raises
    here."""
    args = [sys.executable, "-m", "shapeclipper_torch.clip_anno",
            "--yaml=options/clip/pix3d.yaml", "--data.dataset=synthetic",
            "--data.synthetic.cat=synthetic", "--data.max_img_cat=8",
            "--clip.model=vit_b32", "--image_size=[64,64]",
            "--data.num_workers=0", "--k_nearest=3",
            f"--output_root={tmp_path}", f"--anno_root={tmp_path}/CLIP_NN"]
    r = subprocess.run(args + ["--device=cpu"], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    for split in ("train", "val", "test"):
        with open(tmp_path / "CLIP_NN" / f"synthetic_{split}.csv") as f:
            rows = list(csv.reader(f))
        assert rows[0] == ["Query", "Top_1", "Top_2", "Top_1_score",
                           "Top_2_score"]
        assert len(rows) == 9
        assert rows[1][0] == f"synthetic/{split}_0000.png"
    if not torch.cuda.is_available():
        r = subprocess.run(args, cwd=REPO, capture_output=True, text=True,
                           timeout=600)
        assert r.returncode != 0
        assert "torch.cuda.is_available() is False" in r.stderr
