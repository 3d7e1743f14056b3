"""The port's evaluation (`shapeclipper_torch/eval3d/metrics.py` and
`Runner.evaluate`) against the JAX package's, on the CPU.

Units: `normalize_pc`, `compute_fscore`, the Pix3D rotate-and-normalize and
`eval_metrics_finish` (host marching tetrahedra, surface sampling from the
same `np.random.RandomState`, Chamfer-L1, F-scores) on the same level grid
and clouds. The slice: `Runner.evaluate` over the synthetic test split (5
samples in batches of 2, so the last batch is ragged: the JAX package pads
it, the port runs it at its own size) from the same weights through
`bridge.py`, merge flags off, float32 on both sides.

Both packages' host marching tetrahedra run on one complete native library
(`tests/torch_native_lib.py`): the JAX loader's numpy fallback orders the
triangles differently, so a worker whose JAX loader lost its build race
would compare two meshes of other triangles.

Tolerances: clouds and distances rtol 1e-4 / atol 1e-5 (the level grids
agree to ~1e-6, so marching tets and sampling give the same triangles and
points); F-scores 1e-3 absolute (one point crossing a threshold moves a
score by 1/num_points); cd_cat.txt and f_score.txt to their printed
digits, last digit +-1; chamfer.txt's per-sample numbers to rtol 1e-4 (it
prints 8 decimals, below float32's resolution of the values).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapeclipper_tpu.eval3d import metrics as jmetrics
from shapeclipper_tpu.models.graph import Graph as JaxGraph
from shapeclipper_tpu.train.trainer import Runner as JaxRunner
from shapeclipper_tpu.utils.easydict import EasyDict as jedict
from shapeclipper_torch import bridge
from shapeclipper_torch.eval3d import metrics as tmetrics
from shapeclipper_torch.train.trainer import Runner
from shapeclipper_torch.utils.easydict import EasyDict as edict
from tests.torch_native_lib import (  # noqa: F401
    one_native_library, point_jax_loader_at_port_library)

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-5)
THRESHOLDS = (0.005, 0.01, 0.02, 0.05, 0.1, 0.2)


def _rotations(rng, B):
    q = rng.randn(B, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        axis=1).reshape(B, 3, 3)
    t = rng.randn(B, 3, 1)
    return np.concatenate([R, t], axis=2).astype(np.float32)


def test_normalize_pc_and_rotate_match_jax():
    rng = np.random.RandomState(0)
    pred = (rng.randn(3, 500, 3) * [0.3, 0.2, 0.4] + 0.1).astype(np.float32)
    gt = (rng.randn(3, 400, 3) * 0.25).astype(np.float32)
    pose, pose_gt = _rotations(rng, 3), _rotations(rng, 3)
    np.testing.assert_allclose(
        tmetrics.normalize_pc(torch.from_numpy(pred)).numpy(),
        np.asarray(jmetrics.normalize_pc(jnp.asarray(pred))), **TOL)
    got = tmetrics.rotate_and_normalize_pix3d(
        *map(torch.from_numpy, (pred, gt, pose, pose_gt)))
    want = jmetrics._rotate_and_normalize_pix3d(
        *map(jnp.asarray, (pred, gt, pose, pose_gt)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_compute_fscore_matches_jax():
    """Including rows with no point under a threshold (0 / 0 -> 0)."""
    rng = np.random.RandomState(1)
    d1 = rng.uniform(0, 0.3, (4, 300)).astype(np.float32)
    d2 = rng.uniform(0, 0.3, (4, 200)).astype(np.float32)
    d1[2] += 0.5
    d2[2] += 0.5
    got = tmetrics.compute_fscore(torch.from_numpy(d1), torch.from_numpy(d2),
                                  THRESHOLDS)
    want = jmetrics.compute_fscore(jnp.asarray(d1), jnp.asarray(d2),
                                   THRESHOLDS)
    assert got.shape == (4, len(THRESHOLDS))
    assert float(got[2].abs().max()) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def _level_grid(rng, B, N, lo, hi):
    """Noisy ellipsoid SDFs on the (N+1)^3 eval lattice."""
    g = np.linspace(lo, hi, N + 1)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    levels = []
    for _ in range(B):
        r = rng.uniform(0.25, 0.45, 3)
        s = np.sqrt((x / r[0]) ** 2 + (y / r[1]) ** 2 + (z / r[2]) ** 2) - 1
        levels.append(s * 0.3 + rng.randn(*s.shape) * 0.01)
    return np.stack(levels).astype(np.float32)


@pytest.mark.parametrize("vis_only", [False, True])
def test_eval_metrics_finish_matches_jax(base_opt, vis_only,
                                         one_native_library):
    opt = base_opt.deepcopy()
    opt.eval.update(num_points=3000, vox_res=20)
    opt.tpu.device_isosurface = False
    rng = np.random.RandomState(2)
    B = 2
    level = _level_grid(rng, B, opt.eval.vox_res, *opt.eval.range)
    dpc = (rng.randn(B, 2048, 3) * 0.3).astype(np.float32)
    pose, pose_gt = _rotations(rng, B), _rotations(rng, B)
    jvar = jedict(dpc_points=jnp.asarray(dpc), pose=jnp.asarray(pose),
                  pose_gt=jnp.asarray(pose_gt))
    jout = jmetrics.eval_metrics_finish(opt, jvar, jnp.asarray(level),
                                        vis_only=vis_only,
                                        rng=np.random.RandomState(5), seed=5)
    tvar = edict(dpc_points=torch.from_numpy(dpc),
                 pose=torch.from_numpy(pose),
                 pose_gt=torch.from_numpy(pose_gt))
    t = torch.from_numpy(level)
    tout = tmetrics.eval_metrics_finish(
        opt, tvar, tmetrics.PendingLevel(t, t, None), vis_only=vis_only,
        rng=np.random.RandomState(5))
    assert len(tvar.mesh_pred) == B
    for tm, jm in zip(tvar.mesh_pred, jvar.mesh_pred):
        np.testing.assert_array_equal(tm.faces, jm.faces)
    np.testing.assert_allclose(tvar.dpc_pred.numpy(),
                               np.asarray(jvar.dpc_pred), **TOL)
    for key in ("dpc_pred_normalized", "dpc_gt_normalized"):
        np.testing.assert_allclose(tvar[key].numpy(), np.asarray(jvar[key]),
                                   **TOL)
    if vis_only:
        assert tout is None and jout is None
        return
    np.testing.assert_allclose(tvar.cd_acc, np.asarray(jvar.cd_acc), **TOL)
    np.testing.assert_allclose(tvar.cd_comp, np.asarray(jvar.cd_comp), **TOL)
    np.testing.assert_allclose(tvar.f_score, np.asarray(jvar.f_score),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(tout, jout, **TOL)


# ------------------------------------------------------------- the slice
def eval_opt(base_opt, out):
    opt = base_opt.deepcopy()
    opt.update(image_size=[32, 32], batch_size=2, seed=0, resume=False,
               load=None, tb=False, output_path=str(out), max_epoch=1)
    opt.H, opt.W = opt.image_size
    opt.data.update(dataset="synthetic", num_workers=0, k_nearest=2,
                    max_img_cat=5)
    opt.data.synthetic = jedict(cat="synthetic", azim_range=[-180, 180],
                                elev_range=[-90, 90], theta_range=[-90, 90])
    opt.eval.update(batch_size=2, image_size=[8, 8], vox_res=12,
                    num_points=2048, n_vis=1, n_vis_classes=1)
    opt.render.update(rand_sample=16, n_samples_uniform=8)
    opt.reg.n_views = 1
    opt.arch.enc_pretrained = False
    opt.tpu.update(encoder_dtype="float32", implicit_dtype="float32",
                   sdf_grad_mode="vjp", merge_nn_render=False,
                   merge_flip_estimator=False, merge_encoders=False,
                   mesh={"data": 1}, device_isosurface=False)
    return opt


def perturbed_state(opt):
    """The JAX initialisation with random BN statistics and noisy MLPs; the
    latent projections are scaled down so that the field keeps a surface
    inside the grid."""
    state = jax.jit(JaxGraph(opt).init)(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, state["params"])
    rng = np.random.RandomState(0)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else
                (rng.uniform(0.5, 1.5, v.shape) if k == "var"
                 else rng.randn(*v.shape) * 0.1).astype(np.float32)
                for k, v in node.items()}

    stats = walk(jax.tree_util.tree_map(np.asarray, state["batch_stats"]))
    for name, noise in (("sdf_network", 0.02), ("rgb_network", 0.05)):
        for lin in params[name].values():
            lin["kernel"] = (lin["kernel"] + rng.randn(*lin["kernel"].shape)
                             * noise).astype(np.float32)
    for name in ("latent_proj_shape", "latent_proj_rgb"):
        params[name]["proj"]["kernel"] = params[name]["proj"]["kernel"] * 0.05
    return params, stats


def _capture_f_scores(runner):
    """Keep the per-sample F-score arrays that evaluate hands its report."""
    seen = []
    write = runner._write_eval_reports

    def spy(opt, acc_cat, comp_cat, counts_cat, f_scores):
        seen.extend(np.asarray(f) for f in f_scores)
        return write(opt, acc_cat, comp_cat, counts_cat, f_scores)

    runner._write_eval_reports = spy
    return seen


@pytest.fixture(scope="module")
def evaluated(base_opt, tmp_path_factory):
    """Runner.evaluate (a full evaluation with dumps) on both sides, both on
    the port's native library."""
    with pytest.MonkeyPatch.context() as mp:
        point_jax_loader_at_port_library(mp)
        return _evaluate_both(base_opt, tmp_path_factory)


def _evaluate_both(base_opt, tmp_path_factory):
    jopt = eval_opt(base_opt, tmp_path_factory.mktemp("jax_eval"))
    params, stats = perturbed_state(jopt)
    jr = JaxRunner(jopt)
    jr.load_dataset(jopt, eval_split="test")
    jr.build_networks(jopt)
    jr.setup_optimizer(jopt)
    jr.restore_checkpoint(jopt)
    jr.params = jax.tree_util.tree_map(jnp.asarray, params)
    jr.batch_stats = jax.tree_util.tree_map(jnp.asarray, stats)
    jf = _capture_f_scores(jr)
    jcd = jr.evaluate(jopt, ep=0)

    topt = eval_opt(base_opt, tmp_path_factory.mktemp("port_eval"))
    tr = Runner(topt, "cpu")
    tr.load_dataset(topt, eval_split="test")
    tr.build_networks(topt)
    tr.setup_optimizer(topt)
    tr.restore_checkpoint(topt)
    tr.graph.load_state_dict(bridge.state_dict_from_flax(params, stats),
                             strict=True)
    tf = _capture_f_scores(tr)
    tcd = tr.evaluate(topt, ep=0)
    return (jopt, jcd, np.concatenate(jf)), (topt, tcd, np.concatenate(tf))


def _read(opt, name):
    with open(os.path.join(opt.output_path, name)) as f:
        return f.read().split("\n")


def _same_printed(got, want):
    """Two report lines agree word by word; numbers to their printed digits,
    last digit +-1."""
    gw, ww = got.split(), want.split()
    assert len(gw) == len(ww), (got, want)
    for g, w in zip(gw, ww):
        try:
            gv, wv = float(g), float(w)
        except ValueError:
            assert g == w, (got, want)
            continue
        ulp = 10.0 ** -len(w.split(".")[1]) if "." in w else 1.0
        assert abs(gv - wv) <= ulp * 1.001, (got, want)


def test_evaluate_matches_jax(evaluated):
    (jopt, jcd, jf), (topt, tcd, tf) = evaluated
    # five samples in batches of two: three batches, the last one ragged
    assert jf.shape == tf.shape == (5, len(THRESHOLDS))
    np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-3)
    np.testing.assert_allclose(tcd, jcd, **TOL)
    jc = [l.split() for l in _read(jopt, "chamfer.txt") if l]
    tc = [l.split() for l in _read(topt, "chamfer.txt") if l]
    assert [r[0] for r in tc] == [r[0] for r in jc] == [str(i)
                                                        for i in range(5)]
    np.testing.assert_allclose(np.array([r[1:] for r in tc], float),
                               np.array([r[1:] for r in jc], float), **TOL)
    # chamfer.txt prints 8 decimals, finer than float32 resolves these
    # values (its ulp at 0.08 is 7.5e-9): its numbers are held to TOL above
    for name in ("cd_cat.txt", "f_score.txt"):
        got, want = _read(topt, name), _read(jopt, name)
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            _same_printed(g, w)


def test_evaluate_writes_the_jax_dumps(evaluated):
    """Every file of the JAX run's dump/ folder, and no other."""
    (jopt, _, _), (topt, _, _) = evaluated
    want = sorted(os.listdir(os.path.join(jopt.output_path, "dump")))
    got = sorted(os.listdir(os.path.join(topt.output_path, "dump")))
    assert got == want
    assert "4_pointclouds_comp.ply" in got and "4_mesh.ply" in got
