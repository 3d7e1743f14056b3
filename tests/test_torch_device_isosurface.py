"""The port's device isosurface (`shapeclipper_torch/eval3d/
device_isosurface.py`, the plain versions of K6 / K7) and its metric finish
against the JAX package's, on the CPU.

Inputs are made with numpy: `tests/test_device_isosurface.py`'s bumpy level
(M = 17, 21, 25) and its exact-ties grid (`randint(-2, 3)`, M = 11). JAX's
uniform draws are reproduced as its `sample_level_surface_batch` makes them
(`split(key, B)`, then `split(k, 3)` and `uniform`) and handed to the port.

Tolerances:
  * areas rtol 1e-6 against JAX run op by op (the same float32 steps: equal);
    against JAX as it runs (its `jnp.cross` is jitted and XLA contracts the
    products into multiply-adds) rtol 1e-6 plus atol 1e-6 x the largest
    area, for slivers whose cross product cancels (measured up to 1.1e-7 x
    the largest area at M = 25);
  * triangles as sets atol 2e-5, as JAX's own test;
  * faces: at most 1 draw in 1e4 off a numpy float64 searchsorted over
    JAX's areas (the port scans in float64; JAX's float32 scan picks
    another face for ~1 in 650 draws at M = 65), points at the port's faces
    atol 1e-5; against JAX's own sampler all but 0.5% of points to 1e-5;
  * the metric finish: per-sample CD rtol 1e-3, F-scores atol 1e-3 against
    JAX's on the same draws; the device path against the port's host path
    as JAX's `test_finish_device_vs_host_metrics` (rtol 0.05, atol 2e-3,
    F-scores atol 0.05: two different samplings of the same surface).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapeclipper_tpu.eval3d import device_isosurface as JD
from shapeclipper_tpu.eval3d import metrics as jmetrics
from shapeclipper_torch.eval3d import device_isosurface as TD
from shapeclipper_torch.eval3d import isosurface as tiso
from shapeclipper_torch.eval3d import metrics as tmetrics
from shapeclipper_torch.eval3d import native as tnative
from shapeclipper_torch.train import trainer
from shapeclipper_torch.utils.easydict import EasyDict as edict
from tests.test_torch_eval import eval_opt

torch.set_num_threads(2)
N_DRAWS = 100_000
FACES_OFF_PER = 10_000          # at most one face off the oracle per 1e4
JAX_SAMPLE_OFF = 0.005          # share of points off JAX's own sampler


def bumpy_level(M, extent=0.6):
    g = np.linspace(-extent, extent, M).astype(np.float32)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    lv = (np.sqrt(X ** 2 + 1.4 * Y ** 2 + 0.7 * Z ** 2) - 0.42
          + 0.05 * np.sin(7 * X) * np.cos(5 * Y + 2 * Z))
    return lv.astype(np.float32)


def ties_level():
    rng = np.random.RandomState(7)
    return rng.randint(-2, 3, size=(11, 11, 11)).astype(np.float32)


LEVELS = {"bumpy17": lambda: bumpy_level(17), "bumpy21": lambda: bumpy_level(21),
          "bumpy25": lambda: bumpy_level(25), "ties": ties_level}


def jax_draws(key, B, n):
    """The uniforms JAX's `sample_level_surface_batch(..., key)` draws:
    (r [B, n], u [B, n, 1], w [B, n, 1]) as numpy."""
    r, u, w = [], [], []
    for k in jax.random.split(key, B):
        k1, k2, k3 = jax.random.split(k, 3)
        r.append(np.asarray(jax.random.uniform(k1, (n,))))
        u.append(np.asarray(jax.random.uniform(k2, (n, 1))))
        w.append(np.asarray(jax.random.uniform(k3, (n, 1))))
    return np.stack(r), np.stack(u), np.stack(w)


def port_sample(level, draws, lo=-0.6, hi=0.6):
    """(points, faces) of `sample_level_surface_batch`'s three steps: the
    cell sums, their float64 CDF and the draw."""
    lv = torch.from_numpy(level)[None]
    cdf = torch.cumsum(TD.cell_area_sums(lv), dim=1)
    return TD.draw_points(lv, cdf, *(torch.from_numpy(d) for d in draws),
                          lo, hi, with_faces=True)


def numpy_mt_triangles(level):
    """The port's host marching tetrahedra through its numpy path (the
    correctness reference), not the native library."""
    orig = tnative.marching_tetrahedra
    tnative.marching_tetrahedra = lambda *a, **k: None
    try:
        mesh = tiso.marching_tetrahedra(level)
    finally:
        tnative.marching_tetrahedra = orig
    return mesh.vertices.reshape(-1, 3, 3)


def sorted_tris(tris):
    flat = np.round(np.asarray(tris, np.float64).reshape(len(tris), 9), 5)
    return flat[np.lexsort(flat.T[::-1])]


# ----------------------------------------------------- per-function parity
@pytest.mark.parametrize("name", sorted(LEVELS))
def test_triangle_areas_match_jax(name):
    level = LEVELS[name]()
    got = TD.triangle_areas(torch.from_numpy(level)).numpy()
    with jax.disable_jit():
        eager = np.asarray(JD.triangle_areas(jnp.asarray(level)))
    jitted = np.asarray(JD.triangle_areas(jnp.asarray(level)))
    assert got.shape == jitted.shape == ((level.shape[0] - 1) ** 3 * 12,)
    assert (got > 0).sum() > 0
    np.testing.assert_allclose(got, eager, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, jitted, rtol=1e-6,
                               atol=1e-6 * float(jitted.max()))


@pytest.mark.parametrize("name", sorted(LEVELS))
def test_triangles_match_jax_and_host(name):
    level = LEVELS[name]()
    tris, valid = TD.triangles_for_tests(torch.from_numpy(level))
    got = tris.numpy()[valid.numpy()]
    jt, jv = JD.triangles_for_tests(jnp.asarray(level))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    want = np.asarray(jt)[np.asarray(jv)]
    host = numpy_mt_triangles(level)
    assert got.shape[0] == want.shape[0] == host.shape[0] > 0
    np.testing.assert_allclose(sorted_tris(got), sorted_tris(want),
                               atol=2e-5)
    np.testing.assert_allclose(sorted_tris(got), sorted_tris(host),
                               atol=2e-5)


@pytest.mark.parametrize("name", sorted(LEVELS))
def test_faces_match_float64_oracle(name):
    """For JAX's own draws the port's faces are a float64 searchsorted over
    JAX's slot areas, and its points are JAX's `_gather_face_vertices` plus
    the barycentric step at those faces."""
    level = LEVELS[name]()
    r, u, w = jax_draws(jax.random.PRNGKey(2), 1, N_DRAWS)
    pts, faces = port_sample(level, (r, u, w))
    pts, faces = pts[0].numpy(), faces[0].numpy()
    areas = np.asarray(JD.triangle_areas(jnp.asarray(level)),
                       np.float64)
    cdf = np.cumsum(areas)
    oracle = np.clip(np.searchsorted(cdf, r[0].astype(np.float64) * cdf[-1],
                                     side="right"), 0, len(areas) - 1)
    off = int((faces != oracle).sum())
    print(f"{name}: {off} of {N_DRAWS} faces off the float64 oracle")
    assert off <= N_DRAWS // FACES_OFF_PER
    assert (areas[faces] > 0).all()

    p0, p1, p2 = map(np.asarray, JD._gather_face_vertices(
        jnp.asarray(level), jnp.asarray(faces, jnp.int32), 0.0))
    uu, ww = u[0], w[0]
    flip = (uu + ww) > 1.0
    uu, ww = np.where(flip, 1.0 - uu, uu), np.where(flip, 1.0 - ww, ww)
    want = (p0 + uu * (p1 - p0) + ww * (p2 - p0)) / level.shape[0] * 1.2 - 0.6
    np.testing.assert_allclose(pts, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", sorted(LEVELS))
def test_samples_match_jax_sampler(name):
    """Against JAX's `sample_level_surface_batch` at the same key: its
    float32 CDF picks another face for a few draws."""
    level = LEVELS[name]()
    key = jax.random.PRNGKey(4)
    want = np.asarray(JD.sample_level_surface_batch(
        jnp.asarray(level)[None], N_DRAWS, -0.6, 0.6, key))[0]
    got = TD.sample_level_surface_batch(
        torch.from_numpy(level)[None], N_DRAWS, -0.6, 0.6,
        draws=tuple(map(torch.from_numpy, jax_draws(key, 1, N_DRAWS))))
    got = got[0].numpy()
    off = int((np.abs(got - want).max(-1) > 1e-5).sum())
    print(f"{name}: {off} of {N_DRAWS} points off JAX's sampler")
    assert off <= JAX_SAMPLE_OFF * N_DRAWS


def test_draw_at_the_total_takes_the_last_face():
    """r * total at the total (r = 1) finds no slot: face T - 1, as JAX's
    clip, and JAX's vertices there."""
    level = bumpy_level(13)
    n = 3
    r = np.array([[0.0, 0.5, 1.0]], np.float32)
    u = np.full((1, n, 1), 0.25, np.float32)
    pts, faces = port_sample(level, (r, u, u))
    T = (level.shape[0] - 1) ** 3 * 12
    assert int(faces[0, 2]) == T - 1
    areas = np.asarray(JD.triangle_areas(jnp.asarray(level)))
    assert int(faces[0, 0]) == int(np.argmax(areas > 0))
    p0, p1, p2 = map(np.asarray, JD._gather_face_vertices(
        jnp.asarray(level), jnp.asarray([T - 1], jnp.int32), 0.0))
    want = (p0 + 0.25 * (p1 - p0) + 0.25 * (p2 - p0)) / 13 * 1.2 - 0.6
    np.testing.assert_allclose(pts[0, 2:].numpy(), want, atol=1e-6)


def test_empty_grid_gives_zeros():
    empty = torch.ones(9, 9, 9)
    pts = TD.sample_level_surface(empty, 128, -0.6, 0.6, seed=0)
    assert pts.shape == (128, 3) and pts.dtype == torch.float32
    assert torch.count_nonzero(pts) == 0
    lv = torch.stack([torch.from_numpy(bumpy_level(9)), empty])
    both = TD.sample_level_surface_batch(lv, 256, -0.6, 0.6, seed=5)
    assert both.shape == (2, 256, 3)
    assert torch.count_nonzero(both[1]) == 0
    assert torch.count_nonzero(both[0]) > 0


def test_same_seed_same_points():
    lv = torch.from_numpy(np.stack([bumpy_level(13), bumpy_level(13) + 0.05]))
    a = TD.sample_level_surface_batch(lv, 512, -0.6, 0.6, seed=3)
    b = TD.sample_level_surface_batch(lv, 512, -0.6, 0.6, seed=3)
    c = TD.sample_level_surface_batch(lv, 512, -0.6, 0.6, seed=4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # the samples lie on the surface, between the ellipsoids' radii
    r = a.norm(dim=-1)
    assert 0.2 < float(r.min()) and float(r.max()) < 0.6


def test_draw_points_stores_faces_only_when_asked():
    """`draw_points` gives the points alone unless `with_faces`; the drawn
    faces' vertices, rebuilt from the cells' data gathered for the walk, are
    `triangles_for_tests`' triangles at those faces."""
    level = torch.from_numpy(bumpy_level(13))
    lv = level[None]
    cdf = torch.cumsum(TD.cell_area_sums(lv), dim=1)
    r, u, w = TD.surface_draws(1, 300, seed=2)
    pts = TD.draw_points(lv, cdf, r, u, w, -0.6, 0.6)
    pts_f, faces = TD.draw_points(lv, cdf, r, u, w, -0.6, 0.6,
                                  with_faces=True)
    assert torch.equal(pts, pts_f) and faces.shape == (1, 300)
    tris, valid = TD.triangles_for_tests(level)
    assert bool(valid[faces[0]].all())
    data = TD._cell_corner_data(level, faces[0] // 12, 0.0)
    got = torch.stack(TD._gather_face_vertices(*data, faces[0] % 12, 0.0),
                      dim=1)
    assert torch.equal(got, tris[faces[0]])


def test_cell_sums_are_the_slot_areas_in_float64():
    level = bumpy_level(17)
    sums = TD.cell_area_sums(torch.from_numpy(level)[None])
    assert sums.dtype == torch.float64 and sums.shape == (1, 16 ** 3)
    areas = np.asarray(JD.triangle_areas(jnp.asarray(level)), np.float64)
    np.testing.assert_allclose(sums[0].numpy(), areas.reshape(-1, 12).sum(1),
                               rtol=1e-6, atol=1e-6 * areas.max())


# ------------------------------------------------------- the metric finish
def _finish_inputs(base_opt, B=2, vox=24, n=8192):
    opt = base_opt.deepcopy()
    opt.eval.update(vox_res=vox, num_points=n)
    rng = np.random.RandomState(0)
    M = vox + 1
    level = np.stack([bumpy_level(M), bumpy_level(M) * 1.1 + 0.02][:B])
    gt = rng.randn(B, n, 3).astype(np.float32)
    gt /= np.linalg.norm(gt, axis=-1, keepdims=True) / 0.45
    pose = np.broadcast_to(np.eye(3, 4, dtype=np.float32), (B, 3, 4)).copy()
    pose[-1, :, 3] = [0.05, -0.02, 0.1]
    return opt, level, gt, pose


def test_metric_finish_body_matches_jax(base_opt):
    opt, level, gt, pose = _finish_inputs(base_opt)
    key = jax.random.PRNGKey(7)
    jouts = jmetrics.metric_finish_body(
        opt, jnp.asarray(level), jnp.asarray(gt), jnp.asarray(pose),
        jnp.asarray(pose), key)
    draws = tuple(torch.from_numpy(d) for d in jax_draws(
        key, level.shape[0], opt.eval.num_points))
    touts = tmetrics.metric_finish_body(
        opt, torch.from_numpy(level), torch.from_numpy(gt),
        torch.from_numpy(pose), torch.from_numpy(pose), draws=draws)
    assert len(touts) == len(jouts) == 8
    got, want = [t.numpy() for t in touts], [np.asarray(j) for j in jouts]
    assert got[0].shape == want[0].shape == (2, opt.eval.num_points, 3)
    for i in (4, 5):                          # per-sample CD acc, comp
        np.testing.assert_allclose(got[i], want[i], rtol=1e-3)
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[6:], want[6:], rtol=1e-3)


def test_finish_device_vs_host_metrics(base_opt, monkeypatch):
    """eval_metrics_submit + eval_metrics_finish on the device path (and
    host meshes for dumps) against the host path, as the JAX package's test
    of the same name."""
    opt, level, gt, pose = _finish_inputs(base_opt, B=1)
    t = torch.from_numpy(level)
    monkeypatch.setattr(tmetrics, "compute_level_grid", lambda *a, **k: t)

    def run(device):
        opt.tpu.device_isosurface = device
        var = edict(dpc_points=torch.from_numpy(gt),
                    pose=torch.from_numpy(pose), pose_gt=torch.from_numpy(pose),
                    proj_latent_sdf=None)
        pending = tmetrics.eval_metrics_submit(opt, var, None, seed=1,
                                               need_meshes=device)
        acc, comp = tmetrics.eval_metrics_finish(
            opt, var, pending, rng=np.random.RandomState(1),
            need_meshes=device)
        return acc, comp, var

    acc_d, comp_d, var_d = run(True)
    acc_h, comp_h, var_h = run(False)
    np.testing.assert_allclose(acc_d, acc_h, rtol=0.05, atol=2e-3)
    np.testing.assert_allclose(comp_d, comp_h, rtol=0.05, atol=2e-3)
    np.testing.assert_allclose(var_d.f_score, var_h.f_score, atol=0.05)
    assert var_d.mesh_pred[0].n_faces > 0
    assert var_d.dpc_pred.shape == (1, opt.eval.num_points, 3)
    assert not np.array_equal(var_d.dpc_pred.numpy(), var_h.dpc_pred.numpy())


def test_device_submit_keeps_the_grid_on_the_device(base_opt, monkeypatch):
    """On the device path without meshes the submit enqueues the finish and
    starts no host copy; the finish runs no host marching tetrahedra."""
    opt, level, gt, pose = _finish_inputs(base_opt, B=1, vox=16, n=1024)
    opt.tpu.device_isosurface = True
    t = torch.from_numpy(level)
    monkeypatch.setattr(tmetrics, "compute_level_grid", lambda *a, **k: t)
    copies = []
    monkeypatch.setattr(tmetrics, "_start_host_copy",
                        lambda lv: copies.append(lv))
    monkeypatch.setattr(tiso, "marching_cubes_world", None)
    var = edict(dpc_points=torch.from_numpy(gt), pose=torch.from_numpy(pose),
                pose_gt=torch.from_numpy(pose), proj_latent_sdf=None)
    pending = tmetrics.eval_metrics_submit(opt, var, None, seed=3,
                                           need_meshes=False)
    assert pending.host is None and pending.outs is not None and not copies
    acc, comp = tmetrics.eval_metrics_finish(opt, var, pending,
                                             need_meshes=False)
    want = tmetrics.metric_finish_body(opt, t, var.dpc_points, var.pose,
                                       var.pose_gt, seed=3)
    assert acc == pytest.approx(float(want[4].mean()))
    assert comp == pytest.approx(float(want[5].mean()))
    assert "mesh_pred" not in var


# ------------------------------------------------------------- the Runner
def _runner(base_opt, out, device_isosurface, dump, pipeline=True):
    opt = eval_opt(base_opt, out)
    opt.tpu.update(device_isosurface=device_isosurface,
                   eval_pipeline=pipeline)
    opt.eval.dump = dump
    runner = trainer.Runner(opt, "cpu")
    runner.load_dataset(opt, eval_split="test")
    runner.build_networks(opt)
    runner.setup_optimizer(opt)
    runner.restore_checkpoint(opt)
    return runner, opt


def _chamfer_rows(opt):
    with open(os.path.join(opt.output_path, "chamfer.txt")) as f:
        return np.array([[float(x) for x in line.split()]
                         for line in f if line.strip()])


@pytest.fixture(scope="module")
def evaluated(base_opt, tmp_path_factory):
    """Runner.evaluate on the same seeded weights: host path with dumps,
    device path with dumps (host meshes for them), device path without
    dumps (counting host marching tetrahedra), each pipelined and serial."""
    out = {}
    for dev, dump in ((False, True), (True, True), (True, False),
                      (False, False)):
        for pipeline in (True, False):
            runner, opt = _runner(base_opt,
                                  tmp_path_factory.mktemp("iso_eval"), dev,
                                  dump, pipeline)
            calls = []
            mc = tiso.marching_cubes_world
            tiso.marching_cubes_world = \
                lambda *a, **k: calls.append(1) or mc(*a, **k)
            try:
                cd = runner.evaluate(opt, ep=0)
            finally:
                tiso.marching_cubes_world = mc
            out[dev, dump, pipeline] = (cd, opt, len(calls))
    return out


@pytest.mark.parametrize("dump", [True, False])
def test_evaluate_device_isosurface_writes_reports(evaluated, dump):
    cd, opt, mc_calls = evaluated[True, dump, True]
    cd_host, opt_host, _ = evaluated[False, dump, True]
    for name in ("cd_cat.txt", "f_score.txt", "chamfer.txt"):
        assert os.path.isfile(os.path.join(opt.output_path, name)), name
    rows, rows_host = _chamfer_rows(opt), _chamfer_rows(opt_host)
    assert rows.shape == rows_host.shape == (5, 3)
    np.testing.assert_array_equal(rows[:, 0], rows_host[:, 0])
    assert np.isfinite(cd) and cd > 0
    # the same surfaces sampled twice: agree to sampling noise, not bitwise
    np.testing.assert_allclose(cd, cd_host, rtol=0.05)
    np.testing.assert_allclose(rows[:, 1:], rows_host[:, 1:], rtol=0.15)
    assert not np.array_equal(rows, rows_host)
    if dump:    # host meshes for the mesh PLYs, one a sample
        assert mc_calls == 5
        assert os.path.isfile(os.path.join(opt.output_path, "dump",
                                           "4_mesh.ply"))
    else:       # no host marching tetrahedra at all
        assert mc_calls == 0


@pytest.mark.parametrize("device_isosurface", [False, True])
def test_eval_pipeline_false_gives_the_same_cd(evaluated, device_isosurface):
    """tpu.eval_pipeline: false finishes each batch before the next is
    submitted; the draws come from each batch's index, so the reports equal
    the pipelined ones."""
    cd, opt, _ = evaluated[device_isosurface, False, True]
    cd_serial, opt_serial, _ = evaluated[device_isosurface, False, False]
    assert cd_serial == cd
    np.testing.assert_array_equal(_chamfer_rows(opt_serial),
                                  _chamfer_rows(opt))


def test_evaluate_serial_submits_after_each_finish(base_opt, tmp_path,
                                                   monkeypatch):
    """The order of submits and finishes: pipelined, batch k+1 is submitted
    before batch k is finished; serial, never."""
    submit, finish = tmetrics.eval_metrics_submit, tmetrics.eval_metrics_finish
    for pipeline, want in ((True, ["s0", "s1", "f0", "s2", "f1", "f2"]),
                           (False, ["s0", "f0", "s1", "f1", "s2", "f2"])):
        runner, opt = _runner(base_opt, tmp_path / str(pipeline), True,
                              False, pipeline)
        order, batch_of = [], {}

        def s(*a, seed=0, **k):
            order.append(f"s{seed}")
            pending = submit(*a, seed=seed, **k)
            batch_of[id(pending)] = seed
            return pending

        def f(opt, var, pending, **k):
            order.append(f"f{batch_of[id(pending)]}")
            return finish(opt, var, pending, **k)

        monkeypatch.setattr(tmetrics, "eval_metrics_submit", s)
        monkeypatch.setattr(tmetrics, "eval_metrics_finish", f)
        runner.evaluate(opt, ep=0)
        assert order == want, (pipeline, order)
