"""The port's training step against the JAX package's, on the CPU in float32.

Set-up: R = 16 rays x S = 8 samples, V = 1 neighbour view chosen from
K = 2 by Gumbel top-k, every `tpu.merge_*` flag false (the sequential
reference semantics), float32 encoders and MLPs, `tpu.sdf_grad_mode` 'vjp'
here and 'pallas' (interpret mode) in tests/test_torch_train_pallas.py.
The batch is 4 synthetic samples at 64 x 64 with uniform-noise input images;
the random draws of the step (stratified jitter, eikonal points, Gumbel
noise) are re-derived from the JAX step key along graph.py:325-326, 673-674
and renderer.py:108-121, 192-193, 280-281 and handed to the port.

Why batch 4 at 64 x 64 with noise images, not batch 2 at 32 x 32: train-mode
BatchNorm over two samples of the ResNets' 1 x 1 last stage, or over two
nearly equal latent vectors, divides by the difference of two nearly equal
numbers. The two frameworks' convolutions round differently (~4e-5
relative), and at batch 2 / 32 x 32 that difference came out 0.18 on a
ResNet18 output of scale 3.2; at batch 4 / 64 x 64 it is 1.6e-5.

Tolerances, and why:
  * The training render on the same inputs (exact poses, latents, rays and
    draws): outputs and every input gradient 1e-4 relative to their scale.
  * The camera step (eval-mode BatchNorm, as JAX's bn_eval): loss terms
    1e-5 relative, every parameter gradient 1e-4 in norm relative to its
    own norm, post-Adam parameters atol 0.1 * lr (the first Adam update is
    lr * g / (|g| + eps), which amplifies rounding where |g| ~ eps), BN
    statistics unchanged.
  * The full step (train-mode BatchNorm everywhere): the gradients of a
    ResNet in train mode are ill-conditioned in float32 -- the port alone,
    float32 against float64, differs by up to 5% (max-abs relative) in some
    conv-weight gradients of ResNet34 at this size. So: loss terms 2e-3
    relative; every parameter gradient 0.1 in norm relative to its own norm;
    post-Adam parameters atol 2 * lr (noise-level gradients may flip sign)
    with a mean absolute difference below 0.02 * lr; BN running statistics
    1e-3 relative to their scale.
"""

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shapeclipper_tpu.data import synthetic as jsynthetic
from shapeclipper_tpu.data.base import default_collate
from shapeclipper_tpu.models.graph import Graph as JaxGraph
from shapeclipper_tpu.models.graph import summarize_loss as jax_summarize
from shapeclipper_tpu.train.pretrainer import make_optimizer as jax_optimizer
from shapeclipper_tpu.utils.easydict import EasyDict as jedict
from shapeclipper_torch import bridge
from shapeclipper_torch.models.graph import summarize_loss
from shapeclipper_torch.train.trainer import (CAMERA_PHASE_INACTIVE, Runner,
                                              batch_to_var)
from shapeclipper_torch.utils.easydict import EasyDict as edict
from tests.torch_tmp import tmp_path  # noqa: F401

torch.set_num_threads(2)
B, R, S, K = 4, 16, 8, 2
VAR_KEYS = ("proj_latent_sdf", "proj_latent_rgb", "pose", "intr",
            "scale_dist", "trig_azim", "trig_elev", "trig_theta",
            "normal_transformed", "rgb_recon", "mask_recon", "depth_recon",
            "normal_recon", "grad_eikonal", "rgb_recon_NN_0",
            "mask_recon_NN_0", "normal_recon_NN_0", "pose_NN_0", "idx_NN")


def train_opt(base_opt, tmp_path, grad_mode, dtype="float32"):
    opt = base_opt.deepcopy()
    opt.update(image_size=[64, 64], batch_size=B, seed=0, resume=False,
               load=None, tb=None, output_path=str(tmp_path), max_epoch=1)
    opt.H, opt.W = opt.image_size
    opt.data.update(dataset="synthetic", num_workers=0, k_nearest=K,
                    max_img_cat=B, preselect_NN=False)
    opt.data.synthetic = jedict(azim_range=[-180, 180],
                                elev_range=[-90, 90], theta_range=[-90, 90])
    opt.render.update(rand_sample=R, n_samples_uniform=S)
    opt.reg.n_views = 1
    opt.arch.enc_pretrained = False
    opt.tpu.update(encoder_dtype=dtype, implicit_dtype=dtype,
                   sdf_grad_mode=grad_mode, merge_nn_render=False,
                   merge_flip_estimator=False, merge_encoders=False)
    opt.freq.update(save_vis=10 ** 6, ckpt_latest=10 ** 6)
    return opt


def perturbed_state(opt):
    """The JAX initialisation with random BN statistics and noisy MLPs."""
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
    return params, stats


def make_batch(opt):
    ds = jsynthetic.Dataset(opt, split="train")
    batch = default_collate([ds[i] for i in range(B)])
    rng = np.random.RandomState(3)
    for key in ("rgb_input_map", "rgb_input_map_NN"):
        batch[key] = rng.uniform(0, 1, batch[key].shape).astype(np.float32)
    return batch


def render_draws(key, n, eikonal, opt):
    """renderer.py:108-121, 192-193, 280-281: one render's draws."""
    rng_z, rng_eik_pts = jax.random.split(key)
    rng_strat, rng_eik = jax.random.split(rng_z)
    d = edict(t_rand=np.asarray(jax.random.uniform(rng_strat, (n, R, S))))
    if eikonal:
        lo, hi = opt.arch.impl_sdf.eikonal_sample_range
        d.eik_idx = np.asarray(jax.random.randint(rng_eik, (n, R, 1), 0, S))
        d.eik_uniform = np.asarray(jax.random.uniform(
            rng_eik_pts, (n, R, 3), minval=lo, maxval=hi))
    return edict({k: torch.from_numpy(v.copy()) for k, v in d.items()})


def step_draws(key, opt):
    """graph.py:325-326 (forward), 521-522 (Gumbel noise), 673-674 (one key
    per neighbour view)."""
    r_render, r_nn, r_nn_render = jax.random.split(key, 3)
    return edict(
        render=render_draws(r_render, B, True, opt),
        nn_uniform=torch.from_numpy(np.asarray(jax.random.uniform(
            r_nn, (B, K), minval=1e-20, maxval=1.0)).copy()),
        render_NN=[render_draws(k, B, False, opt) for k in
                   jax.random.split(r_nn_render, opt.reg.n_views)])


def jax_step(opt, params, stats, batch, key, camera):
    """trainer.py:192-221, one step from a fresh optimizer state."""
    graph = JaxGraph(opt)
    tx = jax_optimizer(opt, params, (lambda p: p[0] == "estimator")
                       if camera else (lambda p: True))
    jbatch = jedict({k: jnp.asarray(v) for k, v in batch.items()})

    def loss_fn(p):
        var, loss, new_stats = graph.forward(p, stats, jbatch, key,
                                             training=True, get_loss=True,
                                             bn_eval=camera)
        loss = jax_summarize(opt, loss, non_act_loss_keys=(
            CAMERA_PHASE_INACTIVE if camera else ()))
        return loss.all, (loss, new_stats, {k: var[k] for k in VAR_KEYS})

    (_, (loss, new_stats, var)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    new_params = optax.apply_updates(params, updates)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return SimpleNamespace(
        loss={k: float(np.asarray(v)) for k, v in loss.items()},
        grads=as_np(grads), params=as_np(new_params),
        stats=stats if camera else as_np(new_stats),
        var={k: np.asarray(v) for k, v in var.items()})


def jax_run(base_opt, tmp_path, grad_mode, camera_only=False,
            dtype="float32"):
    """The inputs and the JAX full and camera steps, for one mode
    (`camera_only`: the camera step alone, `full` None), with the encoders
    and the implicit MLPs in `dtype`."""
    opt = train_opt(base_opt, tmp_path, grad_mode, dtype)
    params, stats = perturbed_state(opt)
    batch = make_batch(opt)
    key = jax.random.PRNGKey(5)
    return SimpleNamespace(
        opt=opt, params=params, stats=stats, batch=batch,
        draws=step_draws(key, opt),
        full=(None if camera_only
              else jax_step(opt, params, stats, batch, key, False)),
        camera=jax_step(opt, params, stats, batch, key, True))


def port_runner(run):
    opt = run.opt
    runner = Runner(opt, "cpu")
    runner.build_networks(opt)
    runner.graph.load_state_dict(
        bridge.state_dict_from_flax(run.params, run.stats), strict=True)
    runner.setup_optimizer(opt)
    runner.restore_checkpoint(opt)
    return runner


def port_step(run, camera):
    runner = port_runner(run)
    runner.it = 0 if camera else 1
    loss = runner.train_iteration(run.opt, batch_to_var(run.batch, "cpu"),
                                  draws=run.draws)
    return runner, loss


def _norm_rel(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def check_step(run, camera):
    """The port's step against `run.camera` / `run.full` (see the module
    docstring for the tolerances)."""
    ref = run.camera if camera else run.full
    lr = float(run.opt.optim.lr)
    runner, loss = port_step(run, camera)
    assert set(loss) == set(ref.loss)
    for k, v in ref.loss.items():
        if k == "finite":
            assert bool(loss.finite) and v
            continue
        np.testing.assert_allclose(float(loss[k]), v,
                                   rtol=1e-5 if camera else 2e-3, atol=1e-6,
                                   err_msg=k)
    want_g = bridge.state_dict_from_flax(ref.grads, run.stats)
    want_p = bridge.state_dict_from_flax(ref.params, ref.stats)
    diffs = []
    for name, p in runner.graph.named_parameters():
        err = _norm_rel(p.grad.numpy(), want_g[name].numpy())
        assert err <= (1e-4 if camera else 0.1), (name, err)
        d = np.abs(p.detach().numpy() - want_p[name].numpy())
        # + 1e-6: the float32 rounding of parameter values up to ~8
        assert d.max() <= (0.1 if camera else 2.0) * lr + 1e-6, (name, d.max())
        diffs.append(d.ravel())
    assert np.concatenate(diffs).mean() <= 0.02 * lr
    for name, buf in runner.graph.named_buffers():
        if "running" in name:
            want = want_p[name]
            scale = float(want.abs().max())
            torch.testing.assert_close(buf, want, rtol=0,
                                       atol=0 if camera else 1e-3 * scale,
                                       msg=name)
    return runner


def check_forward(run, camera):
    """Graph.forward(training=True) + compute_loss + summarize_loss."""
    ref = run.camera if camera else run.full
    runner = port_runner(run)
    runner.graph.train(not camera)
    var, loss = runner.graph(batch_to_var(run.batch, "cpu"), training=True,
                             get_loss=True, draws=run.draws)
    loss = summarize_loss(run.opt, loss, CAMERA_PHASE_INACTIVE
                          if camera else ())
    tol = 1e-4 if camera else 1e-2
    for k in VAR_KEYS:
        want = ref.var[k]
        got = var[k].detach().numpy()
        assert got.shape == want.shape, k
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol,
                                   err_msg=k)
    np.testing.assert_allclose(float(loss.all), ref.loss["all"],
                               rtol=1e-5 if camera else 2e-3)


@pytest.fixture(scope="module")
def run_vjp(base_opt, tmp_path_factory):
    return jax_run(base_opt, tmp_path_factory.mktemp("vjp"), "vjp")


@pytest.mark.parametrize("camera", [False, True], ids=["full", "camera"])
def test_train_step_matches_jax(run_vjp, camera):
    check_step(run_vjp, camera)


@pytest.mark.parametrize("camera", [False, True], ids=["full", "camera"])
def test_training_forward_matches_jax(run_vjp, camera):
    check_forward(run_vjp, camera)


# ------------------------------------------------------------------- render
def test_training_render_matches_jax(run_vjp):
    check_render(run_vjp)


def check_render(run):
    """`render(training=True)` on identical inputs and draws: outputs and
    the gradients w.r.t. the MLPs, beta, pose, intrinsics, scale and both
    latents of a random linear function of every output."""
    from shapeclipper_torch.models.graph import pose_from_trig
    opt = run.opt
    params = run.params
    rng = np.random.RandomState(7)
    n = 2
    trig = [rng.randn(n, 2).astype(np.float32) for _ in range(3)]
    trig = [t / np.linalg.norm(t, axis=-1, keepdims=True) for t in trig]
    scale = rng.uniform(0.9, 1.1, n).astype(np.float32)
    lat_s = (rng.randn(n, 64) * 0.3).astype(np.float32)
    lat_r = (rng.randn(n, 64) * 0.3).astype(np.float32)
    ray_idx = rng.randint(0, opt.H * opt.W, (n, R)).astype(np.int32)
    key = jax.random.PRNGKey(11)
    draws = render_draws(key, n, True, opt)
    cots = [rng.randn(*s).astype(np.float32) for s in
            ((n, R, 3), (n, R, 1), (n, R, 1), (n, R, 3), (n, 2 * R))]

    def jax_fn(p, pose, intr, sd, ls, lr_):
        out = JaxGraph(opt).render(p, pose, intr, sd, ls, lr_,
                                   jnp.asarray(ray_idx), key, True)
        outs = (out.rgb, out.mask, out.depth, out.normal, out.grad_eikonal)
        return sum((o * c).sum() for o, c in zip(outs, cots)), outs

    tp = [torch.from_numpy(t) for t in trig]
    pose, intr = pose_from_trig(opt, *tp, torch.ones(n),
                                torch.from_numpy(scale))
    pose = pose.detach().requires_grad_(True)
    intr = intr.detach().requires_grad_(True)
    inputs = [pose, intr, torch.from_numpy(scale), torch.from_numpy(lat_s),
              torch.from_numpy(lat_r)]
    for t in inputs:
        t.requires_grad_(True)
    (jl, jouts), jgrads = jax.jit(jax.value_and_grad(
        jax_fn, argnums=(0, 1, 2, 3, 4, 5), has_aux=True))(
        params, *[jnp.asarray(t.detach().numpy()) for t in inputs])

    runner = port_runner(run)
    g = runner.graph
    out = g.render(*inputs, ray_idx=torch.from_numpy(ray_idx).long(),
                   training=True, draws=draws)
    outs = (out.rgb, out.mask, out.depth, out.normal, out.grad_eikonal)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots))
    loss.backward()
    for o, jo in zip(outs, jouts):
        jo = np.asarray(jo)
        np.testing.assert_allclose(o.detach().numpy(), jo, rtol=1e-4,
                                   atol=1e-4 * max(float(np.abs(jo).max()),
                                                   1.0))
    want = bridge.state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jgrads[0]), run.stats)
    pairs = [(p.grad, want[n_], n_) for n_, p in g.named_parameters()
             if n_.split(".")[0] in ("sdf_network", "rgb_network", "density")]
    pairs += [(t.grad, torch.from_numpy(np.asarray(jg)), name) for t, jg, name
              in zip(inputs, jgrads[1:], ("pose", "intr", "scale_dist",
                                          "latent_sdf", "latent_rgb"))]
    for got, w, name in pairs:
        sc = max(float(w.abs().max()), 1e-6)
        torch.testing.assert_close(got, w, rtol=1e-4, atol=1e-4 * sc,
                                   msg=name)


# -------------------------------------------------------- runner behaviour
def test_checkpoint_roundtrip_with_optimizer_states(run_vjp, tmp_path):
    """save_checkpoint after a step; --resume restores weights, BN stats,
    both Adam states, epoch and iteration, and the next step is identical."""
    src, _ = port_step(run_vjp, camera=False)
    opt = run_vjp.opt.deepcopy()
    opt.output_path = str(tmp_path)
    src.save_checkpoint(opt, ep=3, it=src.it, best_val=0.5)
    assert (tmp_path / "checkpoint" / "ep3.pt").is_file()
    opt.resume = True
    dst = Runner(opt, "cpu")
    dst.build_networks(opt)
    dst.setup_optimizer(opt)
    dst.restore_checkpoint(opt)
    assert (dst.epoch_start, dst.iter_start, dst.best_val) == (3, 2, 0.5)
    for a, b in ((src.graph.state_dict(), dst.graph.state_dict()),):
        for k in a:
            torch.testing.assert_close(b[k], a[k], rtol=0, atol=0, msg=k)
    for name in ("optim_full", "optim_V"):
        sa, sb = (getattr(r, name).state_dict() for r in (src, dst))
        assert sa["param_groups"] == sb["param_groups"]
        assert sa["state"].keys() == sb["state"].keys()
        for i, st in sa["state"].items():
            for k, v in st.items():
                torch.testing.assert_close(sb["state"][i][k], v, rtol=0,
                                           atol=0)
    assert len(dst.optim_full.state_dict()["state"]) > 0
    var = batch_to_var(run_vjp.batch, "cpu")
    la = src.train_iteration(opt, var, draws=run_vjp.draws)
    lb = dst.train_iteration(opt, var, draws=run_vjp.draws)
    assert float(la.all) == float(lb.all)
    for (k, a), b in zip(src.graph.state_dict().items(),
                         dst.graph.state_dict().values()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)


def test_iteration_zero_is_a_camera_step(base_opt, tmp_path):
    """Through load_dataset's loader (the K == V pre-selected path):
    iteration 0 updates the estimator only and leaves every BN statistic
    alone; iteration 1 updates everything and moves the statistics."""
    opt = train_opt(base_opt, tmp_path, "vjp")
    opt.update(image_size=[32, 32], batch_size=2)
    opt.H, opt.W = 32, 32
    opt.data.update(preselect_NN=True, max_img_cat=4)
    opt.eval.update(batch_size=1, image_size=[8, 8], n_vis=1)
    opt.freq.update(save_vis=1, ckpt_latest=2)
    runner = Runner(opt, "cpu")
    runner.load_dataset(opt)
    runner.build_networks(opt)
    runner.setup_optimizer(opt)
    runner.restore_checkpoint(opt)
    batch = next(iter(runner.train_loader))
    assert batch["rgb_input_map_NN"].shape[1] == 1
    snap = lambda: {k: v.clone() for k, v in  # noqa: E731
                    runner.graph.state_dict().items()}
    s0 = snap()
    loss = runner.train_iteration(opt, batch_to_var(batch, "cpu"))
    s1 = snap()
    for k in s0:
        moved = not torch.equal(s0[k], s1[k])
        if k.startswith("estimator.") and "running" not in k \
                and "num_batches" not in k:
            continue
        assert not moved, k
    assert any(not torch.equal(s0[k], s1[k]) for k in s0
               if k.startswith("estimator.feature_extractor.conv1"))
    assert not runner.optim_full.state_dict()["state"]
    for k in CAMERA_PHASE_INACTIVE:
        assert k in loss
    assert math.isfinite(float(loss.all))
    runner.train_iteration(opt, batch_to_var(batch, "cpu"))
    s2 = snap()
    for prefix in ("encoder.conv1.weight", "sdf_network.lin0.weight",
                   "rgb_network.lin0.weight", "density.beta",
                   "encoder.bn1.running_mean"):
        assert not torch.equal(s1[prefix], s2[prefix]), prefix
    assert (tmp_path / "latest.pt").is_file()
    assert (tmp_path / "vis_log" / "iter_0").is_dir()
