"""The port's serving slice against the JAX package's, end to end at a small
size: 32x32 input, 8x8 eval render with 8 samples per ray, vox 8 grid, two
turntable views.

JAX side: `Graph.forward(training=False)` (sequential encoders, float32
encoder and implicit MLPs) with `tpu.sdf_grad_mode` 'vjp' and 'pallas' (the
Pallas kernel in interpret mode), `compute_level_grid`, the turntable render
loop of `Runner.vis_rotate`, and `marching_cubes_world`. Port side: the
`Runner` on the CPU, i.e. every SDF evaluation through the fused kernel's
plain version. Weights go through `shapeclipper_torch.bridge`; BN statistics
and the MLP weights are randomized first so every path is exercised.

Tolerances: latents, poses and the level grid 1e-5 (relative to their scale
after the ResNet chains, whose conv accumulation order differs between the
frameworks); rendered maps 1e-4 absolute (they pass through sigmoid(100 z)
tangents and exp(-sdf / beta) with beta = 0.1).
"""

import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapeclipper_tpu.eval3d import isosurface as jiso
from shapeclipper_tpu.eval3d import metrics as jmetrics
from shapeclipper_tpu.models.graph import Graph as JaxGraph
from shapeclipper_tpu.utils import checkpoint as jckpt
from shapeclipper_torch import bridge
from shapeclipper_torch.eval3d import isosurface as tiso
from shapeclipper_torch.train.trainer import Runner
from shapeclipper_torch.utils.easydict import EasyDict as tedict
from tests.torch_native_lib import one_native_library  # noqa: F401
from tests.torch_tmp import tmp_path  # noqa: F401

torch.set_num_threads(2)
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
N_VIEWS = 2


def _small_opt(base_opt, tmp_path, grad_mode="vjp"):
    opt = base_opt.deepcopy()
    opt.image_size = [32, 32]
    opt.H, opt.W = 32, 32
    opt.eval.image_size = [8, 8]
    opt.eval.vox_res = 8
    opt.render.n_samples_uniform = 8
    opt.arch.enc_pretrained = False
    opt.tpu.encoder_dtype = "float32"
    opt.tpu.implicit_dtype = "float32"
    opt.tpu.sdf_grad_mode = grad_mode
    opt.output_path = str(tmp_path)
    opt.resume = False
    opt.load = None
    return opt


def _perturb(params, stats, seed=0):
    """Random BN statistics and noisy MLP weights, the same for both sides.
    The latent projections are scaled down so that the perturbed field still
    has a surface inside the grid (about a quarter of it is inside)."""
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(np.asarray, params)
    stats = jax.tree_util.tree_map(np.asarray, stats)

    def walk_stats(node):
        if isinstance(node, dict):
            return {k: walk_stats(v) if isinstance(v, dict) else (
                rng.uniform(0.5, 1.5, v.shape) if k == "var"
                else rng.randn(*v.shape) * 0.1).astype(np.float32)
                for k, v in node.items()}
        return node

    stats = walk_stats(stats)
    for name, noise in (("sdf_network", 0.02), ("rgb_network", 0.05)):
        for lin in params[name].values():
            lin["kernel"] = (lin["kernel"] + rng.randn(*lin["kernel"].shape)
                             * noise).astype(np.float32)
    for name in ("latent_proj_shape", "latent_proj_rgb"):
        params[name]["proj"]["kernel"] = params[name]["proj"]["kernel"] * 0.05
    return params, stats


@pytest.fixture(scope="module")
def jax_model(base_opt, tmp_path_factory):
    opt = _small_opt(base_opt, tmp_path_factory.mktemp("jax"))
    # jit: half the time of the eager init on the CPU
    state = jax.jit(JaxGraph(opt).init)(jax.random.PRNGKey(0))
    params, stats = _perturb(state["params"], state["batch_stats"])
    image = np.random.RandomState(1).uniform(0, 1, (1, 32, 32, 3)).astype(
        np.float32)
    return params, stats, image


def _jax_serve(opt, params, stats, image):
    opt_e = opt.deepcopy()
    opt_e.H, opt_e.W = opt.eval.image_size
    graph, graph_eval = JaxGraph(opt), JaxGraph(opt_e)
    var = {"rgb_input_map": jnp.asarray(image), "idx": np.array([0])}
    var, _, _ = graph_eval.forward(params, stats, var, rng=None,
                                   training=False, get_loss=False)
    level = jmetrics.compute_level_grid(opt_e, graph.sdf_network.apply,
                                        params["sdf_network"],
                                        var.proj_latent_sdf)
    views = []
    for pose in graph.get_rotate_pose(n_views=N_VIEWS):
        out = graph_eval.render(params, pose[None], var.intr,
                                jnp.ones_like(var.scale_dist),
                                var.proj_latent_sdf, var.proj_latent_rgb,
                                None, None, training=False)
        views.append((out.rgb, out.mask, out.normal))
    return var, np.asarray(level), views


@pytest.fixture(scope="module")
def jax_served(base_opt, jax_model, tmp_path_factory):
    """The JAX serving run ('vjp' mode), shared by the tests below."""
    params, stats, image = jax_model
    opt = _small_opt(base_opt, tmp_path_factory.mktemp("jax_vjp"))
    return _jax_serve(opt, params, stats, image)


def _port_runner(opt, params, stats):
    runner = Runner(opt, "cpu")
    runner.build_networks(opt)
    runner.graph.load_state_dict(bridge.state_dict_from_flax(params, stats),
                                 strict=True)
    return runner


def _close(a, b, tol, scale=1.0):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_allclose(a, np.asarray(b), atol=tol * scale, rtol=tol)


@pytest.mark.parametrize("grad_mode", ["vjp", "pallas"])
def test_serving_slice_matches_jax(base_opt, jax_model, tmp_path, grad_mode,
                                   request):
    params, stats, image = jax_model
    opt = _small_opt(base_opt, tmp_path, grad_mode)
    jvar, jlevel, jviews = (request.getfixturevalue("jax_served")
                            if grad_mode == "vjp"
                            else _jax_serve(opt, params, stats, image))

    runner = _port_runner(opt, params, stats)
    var = tedict(idx=np.array([0]), rgb_input_map=torch.from_numpy(image))
    var, level = runner.eval_forward_and_grid(var)
    var = runner.vis_rotate(opt, var, n_views=N_VIEWS)

    for key in ("proj_latent_sdf", "proj_latent_rgb"):
        ref = np.asarray(jvar[key])
        _close(var[key], ref, 1e-5, float(np.abs(ref).max()))
    for key in ("pose", "intr", "scale_dist", "trig_azim", "trig_elev",
                "trig_theta"):
        _close(var[key], jvar[key], 1e-5)
    for key in ("rgb_recon_map", "mask_recon_map", "normal_recon_map"):
        assert var[key].shape == jvar[key].shape, key
        _close(var[key], jvar[key], 1e-4)
    _close(var.depth_recon, jvar.depth_recon, 1e-4)
    assert level.shape == jlevel.shape == (1, 9, 9, 9)
    _close(level, jlevel, 1e-5)
    assert len(var.rotating_imgs) == N_VIEWS
    for i, (rgb, mask, normal) in enumerate(jviews):
        _close(var.rotating_imgs[i], np.asarray(rgb).reshape(1, 8, 8, 3),
               1e-4)
        _close(var.rotating_masks[i], np.asarray(mask).reshape(1, 8, 8, 1),
               1e-4)
        _close(var.rotating_normals[i],
               np.asarray(normal).reshape(1, 8, 8, 3) / 2 + 0.5, 1e-4)


def test_port_isosurface_matches_jax(base_opt, jax_model, jax_served,
                                     tmp_path, one_native_library):
    """The port's copied marching tetrahedra on the JAX grid gives the JAX
    mesh exactly; the port's own grid gives the same mesh within 1e-3."""
    params, stats, image = jax_model
    opt = _small_opt(base_opt, tmp_path)
    jlevel = jax_served[1]
    lo, hi = opt.eval.range
    jmesh = jiso.marching_cubes_world(jlevel[0], lo, hi)
    tmesh = tiso.marching_cubes_world(jlevel[0], lo, hi)
    assert jmesh.vertices.shape[0] > 0
    np.testing.assert_array_equal(tmesh.vertices, jmesh.vertices)
    np.testing.assert_array_equal(tmesh.faces, jmesh.faces)

    runner = _port_runner(opt, params, stats)
    var = tedict(rgb_input_map=torch.from_numpy(image))
    _, level = runner.eval_forward_and_grid(var)
    own = tiso.marching_cubes_world(level[0].numpy(), lo, hi)
    assert own.vertices.shape == jmesh.vertices.shape
    np.testing.assert_allclose(own.vertices, jmesh.vertices, atol=1e-3)


def test_jax_checkpoint_converts_to_port(base_opt, jax_model, tmp_path):
    """scripts/jax_ckpt_to_torch.py: a JAX best.ckpt -> the port's best.pt,
    which `Runner.restore_checkpoint(--resume)` loads strictly."""
    params, stats, _ = jax_model
    run_dir = tmp_path / "run"
    jckpt.save_checkpoint(str(run_dir), {"params": params,
                                         "batch_stats": stats},
                          ep=3, it=30, best_val=0.25, latest=True, best=True)
    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_to_torch", os.path.join(REPO, "scripts",
                                          "jax_ckpt_to_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    script.convert(str(run_dir / "best.ckpt"), str(run_dir / "best.pt"))

    opt = _small_opt(base_opt, run_dir)
    opt.resume = True
    runner = Runner(opt, "cpu")
    runner.build_networks(opt)
    runner.restore_checkpoint(opt, best=True)
    want = bridge.state_dict_from_flax(params, stats)
    got = runner.graph.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


def test_port_imports_no_jax():
    """Importing every module of the port leaves jax, flax, optax and the
    JAX package out of sys.modules."""
    code = (
        "import pkgutil, sys, importlib, shapeclipper_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'shapeclipper_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'shapeclipper_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules "
        "if m.startswith('shapeclipper_torch')]))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.strip()) >= 20


def test_port_checkpoint_roundtrip(base_opt, jax_model, tmp_path):
    """save_checkpoint writes latest.pt (+ best.pt); --load restores it."""
    from shapeclipper_torch.utils.checkpoint import save_checkpoint
    params, stats, _ = jax_model
    opt = _small_opt(base_opt, tmp_path)
    src = _port_runner(opt, params, stats)
    save_checkpoint(str(tmp_path / "run"), src.graph.state_dict(), ep=2,
                    it=7, best_val=0.5, best=True)
    assert (tmp_path / "run" / "latest.pt").is_file()
    assert (tmp_path / "run" / "best.pt").is_file()
    opt.load = str(tmp_path / "run" / "latest.pt")
    dst = Runner(opt, "cpu")
    dst.build_networks(opt)
    dst.restore_checkpoint(opt)
    want = src.graph.state_dict()
    for k, v in dst.graph.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("chunk", [100, 729, 131072])
def test_level_grid_chunks(base_opt, jax_model, jax_served, tmp_path,
                           chunk):
    """Ragged, exact and single-chunk splits of the 9^3 grid agree with the
    JAX grid (the kernel masks the ragged tail of the last chunk)."""
    from shapeclipper_torch.eval3d.metrics import compute_level_grid
    params, stats, image = jax_model
    opt = _small_opt(base_opt, tmp_path)
    jlevel = jax_served[1]
    runner = _port_runner(opt, params, stats)
    var = runner.graph_eval(tedict(rgb_input_map=torch.from_numpy(image)))
    with torch.inference_mode():
        level = compute_level_grid(runner.graph_eval.opt,
                                   runner.graph.sdf_network,
                                   var.proj_latent_sdf.detach(), chunk=chunk)
    _close(level, jlevel, 1e-5)


def test_infer_cli_on_cpu(tmp_path):
    """`python -m shapeclipper_torch.infer --device=cpu` at a tiny size
    writes every output the JAX CLI writes."""
    import PIL.Image
    img = np.full((32, 32, 3), 255, np.uint8)
    img[8:24, 10:22] = (200, 90, 40)
    PIL.Image.fromarray(img).save(tmp_path / "img.png")
    r = subprocess.run(
        [sys.executable, "-m", "shapeclipper_torch.infer",
         "--yaml=options/pix3d/config.yaml", f"--output_root={tmp_path}",
         "--name=cli", f"--image={tmp_path / 'img.png'}", "--device=cpu",
         "--n_rotate=2", "--image_size=[32,32]", "--eval.image_size=[8,8]",
         "--eval.vox_res=8", "--render.n_samples_uniform=8"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = tmp_path / "pix3d_output" / "cli" / "infer"
    for f in ("0_image_input.png", "0_image_recon.png", "0_mask_recon.png",
              "0_normal_recon.png", "0_mesh.ply", "0_image_rotate.gif",
              "0_mask_rotate.gif", "0_normal_rotate.gif"):
        assert (out / f).is_file(), f


def test_infer_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from shapeclipper_torch import infer
    import PIL.Image
    PIL.Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "i.png")
    with pytest.raises(RuntimeError, match="cuda"):
        infer.main(["--yaml=" + os.path.join(REPO, "options/pix3d/config.yaml"),
                    f"--output_root={tmp_path}", f"--image={tmp_path}/i.png"])
