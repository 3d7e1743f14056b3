"""The port at the flagship's own precision, `tpu.encoder_dtype` and
`tpu.implicit_dtype` bfloat16, against the JAX package on the CPU.

JAX side: `sdf_grad_mode: pallas` with both keys bfloat16 and
`SCL_PAIR_MM=bfloat16` (set by `monkeypatch`), i.e. bf16 ResNets, the
fused SDF pair's bf16 products (its Pallas kernels in interpret mode) and
the RGB MLP cast to bf16: exactly the port's semantics. Set-up, weights and
draws are tests/test_torch_train.py's (batch 4, 64 x 64, R = 16 rays x S = 8
samples, sequential semantics), whose helpers this file uses.

Tolerances, and why. Every check measures the port's own float32-to-bf16
gap on the same inputs (the same measure: norm of the difference over the
norm of JAX's value) and asserts that its bound lies under half of it, so
that a port that quietly computed in float32 would fail. Measured at these
inputs, norm-relative:
  * the training render (both MLPs, beta, pose, intrinsics, scale and both
    latents; outputs and gradients) through the fused SDF pair's bf16
    products and the bf16 RGB MLP: the gradients 7e-4 .. 4.6e-3 from JAX
    (the most at the RGB MLP's first layers and latent) against gaps of
    1.5e-2 .. 5.8e-2, the SDF's output bias 0.12 against 0.73; the mask,
    depth, normal and eikonal outputs 5e-7 .. 3.2e-4 against 1.5e-3 ..
    9.2e-3. Each bound lies between.
Left out, because the two frameworks' bf16 roundings differ there by as
much as bf16 itself moves the value:
  * the RGB MLP's output and the gradients of its last two layers: it runs
    wholly in bf16, as JAX's, and its sigmoid output rounds to bf16 (1.0e-3
    from JAX against a gap of 1.2e-3);
  * anything after the bf16 ResNets. JAX's step runs under `jax.jit`,
    whose CPU fusion keeps some bf16 intermediates in float32: the camera
    phase's latent comes out 6.1e-3 from the port's against a gap of
    5.4e-3 (tests/test_torch_bf16_resnet.py holds the ResNets op by op). And
    the full step's train-mode BatchNorm at batch 4 turns rounding flips
    into differences of the size of the bf16 effect (loss 1.3e-2 from JAX
    against a gap of 1.7e-2, encoder gradients past 100%): no parity
    setting in bf16 (ROADMAP Queue 3).
`test_bf16_step_runs_at_its_dtypes` checks what a full step and a serving
forward compute in: bf16 convolutions, bf16 products in every fused SDF call
of a render, a bf16 RGB MLP, float32 latent projections and a float32
evaluation grid; and that the float32 flags give all of it back in
float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapeclipper_tpu.models.graph import Graph as JaxGraph
from shapeclipper_torch import bridge
from shapeclipper_torch.models.graph import pose_from_trig
from shapeclipper_torch.ops import fused_sdf as F
from shapeclipper_torch.train.trainer import batch_to_var
from tests.test_torch_train import (R, jax_run, make_batch, port_runner,
                                    render_draws, step_draws, train_opt)

torch.set_num_threads(2)

# bounds, norm-relative (see the module docstring), by output or parameter
RENDER_OUT_TOL = {"mask": 2e-4, "depth": 2e-4, "normal": 2e-3,
                  "grad_eikonal": 1e-4}
RENDER_GRAD_TOL = {"sdf_network.lin5.bias": 0.2, "rgb_network.lin0": 1e-2,
                   "rgb_network.lin1": 1e-2, "latent_rgb": 1e-2}
RENDER_GRAD_TOL_DEFAULT = 4e-3
RENDER_LEFT_OUT = ("rgb_network.lin2", "rgb_network.lin3")


def _f32(opt):
    opt = opt.deepcopy()
    opt.tpu.update(encoder_dtype="float32", implicit_dtype="float32")
    return opt


def _norm_rel(got, want, scale):
    return float(np.linalg.norm(np.asarray(got, np.float64)
                                - np.asarray(want, np.float64))
                 / max(np.linalg.norm(np.asarray(scale, np.float64)), 1e-30))


@pytest.fixture(scope="module")
def run_bf16(base_opt, tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCL_PAIR_MM", "bfloat16")
        run = jax_run(base_opt, tmp_path_factory.mktemp("bf16"), "pallas",
                      camera_only=True, dtype="bfloat16")
    return run


def _tol(table, name, default=None):
    for key, tol in table.items():
        if name == key or name.startswith(key + "."):
            return tol
    return default


def test_bf16_training_render_matches_jax(run_bf16, monkeypatch):
    """`render(training=True)` on identical inputs and draws, as
    tests/test_torch_train.py::check_render, at implicit_dtype bfloat16."""
    monkeypatch.setenv("SCL_PAIR_MM", "bfloat16")
    opt = run_bf16.opt
    params = run_bf16.params
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
    names = ("rgb", "mask", "depth", "normal", "grad_eikonal")

    def jax_fn(p, pose, intr, sd, ls, lr_):
        out = JaxGraph(opt).render(p, pose, intr, sd, ls, lr_,
                                   jnp.asarray(ray_idx), key, True)
        outs = tuple(getattr(out, k) for k in names)
        return sum((o * c).sum() for o, c in zip(outs, cots)), outs

    pose, intr = pose_from_trig(opt, *[torch.from_numpy(t) for t in trig],
                                torch.ones(n), torch.from_numpy(scale))
    inputs0 = [pose.detach(), intr.detach(), torch.from_numpy(scale),
               torch.from_numpy(lat_s), torch.from_numpy(lat_r)]
    (_, jouts), jgrads = jax.jit(jax.value_and_grad(
        jax_fn, argnums=(0, 1, 2, 3, 4, 5), has_aux=True))(
        params, *[jnp.asarray(t.numpy()) for t in inputs0])
    want = bridge.state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jgrads[0]), run_bf16.stats)
    in_names = ("pose", "intr", "scale_dist", "latent_sdf", "latent_rgb")
    for name, jg in zip(in_names, jgrads[1:]):
        want[name] = torch.from_numpy(np.asarray(jg))

    res = {}
    for label, o in (("bf16", opt), ("f32", _f32(opt))):
        run = type(run_bf16)(**{**vars(run_bf16), "opt": o})
        g = port_runner(run).graph
        inputs = [t.clone().requires_grad_(True) for t in inputs0]
        out = g.render(*inputs, ray_idx=torch.from_numpy(ray_idx).long(),
                       training=True, draws=draws)
        outs = [getattr(out, k) for k in names]
        sum((x * torch.from_numpy(c)).sum()
            for x, c in zip(outs, cots)).backward()
        grads = {k: p.grad.clone() for k, p in g.named_parameters()
                 if k.split(".")[0] in ("sdf_network", "rgb_network",
                                        "density")}
        grads.update({k: t.grad.clone() for k, t in zip(in_names, inputs)})
        res[label] = ([x.detach().numpy() for x in outs], grads)

    for i, name in enumerate(names):
        tol = _tol(RENDER_OUT_TOL, name)
        if tol is None:
            continue
        got, f32, w = res["bf16"][0][i], res["f32"][0][i], np.asarray(jouts[i])
        err, gap = _norm_rel(got, w, w), _norm_rel(got, f32, w)
        assert err <= tol, (name, err, gap)
        assert tol < 0.5 * gap, (name, tol, gap)
    for name, got in res["bf16"][1].items():
        if _tol({k: 0 for k in RENDER_LEFT_OUT}, name) is not None:
            continue
        tol = _tol(RENDER_GRAD_TOL, name, RENDER_GRAD_TOL_DEFAULT)
        w = want[name].numpy()
        err = _norm_rel(got.numpy(), w, w)
        gap = _norm_rel(got.numpy(), res["f32"][1][name].numpy(), w)
        assert err <= tol, (name, err, gap)
        assert tol < 0.5 * gap, (name, tol, gap)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bf16_step_runs_at_its_dtypes(base_opt, tmp_path, monkeypatch,
                                      dtype):
    """A full training step and a serving forward + grid through the Runner
    at `tpu.encoder_dtype` = `tpu.implicit_dtype` = `dtype` (the flagship
    YAML's bfloat16, or float32 from the flags): every convolution of the
    encoder and the estimator gets `dtype`, every fused SDF call of a render
    takes `mm_dtype=dtype`, the RGB MLP's inputs are `dtype`, the
    evaluation grid stays float32, and the latent projections, the heads
    and every parameter stay float32."""
    from shapeclipper_torch.eval3d import metrics
    from shapeclipper_torch.models.resnet import Conv2d
    from shapeclipper_torch.render import renderer
    from shapeclipper_torch.train.trainer import Runner

    opt = train_opt(base_opt, tmp_path, "pallas", dtype)
    opt.update(image_size=[32, 32])
    opt.H, opt.W = 32, 32
    opt.eval.update(image_size=[8, 8], vox_res=8)
    seen = {"conv": set(), "rgb": set(), "render_mm": [], "grid_mm": [],
            "proj": set()}
    for name in ("fused_sdf_train", "fused_sdf_forward"):
        fn = getattr(renderer, name)

        def spy(*a, _fn=fn, **k):
            seen["render_mm"].append(k.get("mm_dtype"))
            return _fn(*a, **k)
        monkeypatch.setattr(renderer, name, spy)
    grid_fn = metrics.fused_sdf_forward

    def grid_spy(*a, **k):
        seen["grid_mm"].append(k.get("mm_dtype", "float32"))
        return grid_fn(*a, **k)
    monkeypatch.setattr(metrics, "fused_sdf_forward", grid_spy)

    runner = Runner(opt, "cpu")
    runner.build_networks(opt)
    runner.setup_optimizer(opt)
    runner.restore_checkpoint(opt)
    g = runner.graph
    for root in (g.encoder, g.estimator):
        for m in root.modules():
            if isinstance(m, Conv2d):
                m.register_forward_pre_hook(
                    lambda m, i: seen["conv"].add(i[0].dtype))
    g.rgb_network.register_forward_pre_hook(
        lambda m, i: seen["rgb"].update(x.dtype for x in i))
    for m in (g.latent_proj_shape, g.latent_proj_rgb):
        m.register_forward_pre_hook(lambda m, i: seen["proj"].add(i[0].dtype))

    batch = make_batch(opt)
    runner.it = 1
    loss = runner.train_iteration(opt, batch_to_var(batch, "cpu"),
                                  draws=step_draws(jax.random.PRNGKey(5),
                                                   opt))
    assert bool(loss.finite) and np.isfinite(float(loss.all))
    want = getattr(torch, dtype)
    assert seen["conv"] == {want} and seen["rgb"] == {want}
    assert seen["proj"] == {torch.float32}
    # the query render and its eikonal points, then one neighbour view
    assert seen["render_mm"] == [dtype] * 3
    g.eval()
    seen["render_mm"].clear()
    with torch.inference_mode():
        _, level = runner.eval_forward_and_grid(
            batch_to_var({k: v[:1] for k, v in batch.items()
                          if k == "rgb_input_map"}, "cpu"))
    assert seen["render_mm"] == [dtype] and seen["grid_mm"]
    assert set(seen["grid_mm"]) == {"float32"}
    assert level.dtype == torch.float32 and torch.isfinite(level).all()
    for name, p in g.named_parameters():
        assert p.dtype == torch.float32, name
