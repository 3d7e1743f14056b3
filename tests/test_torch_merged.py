"""The flagship's merged training step (`tpu.merge_encoders`,
`tpu.merge_flip_estimator`, `tpu.merge_nn_render`) against the JAX
package's on the CPU, and against the port's own sequential step.

* Grouped BatchNorm (`layers.bn_groups`) against JAX's `GroupBatchNorm` in
  2-D and 4-D, with 1-3 view groups, `stats_groups` None / (0,) / (0, 2) /
  () and two replicas a group: outputs, input gradients, running statistics
  and `num_batches_tracked` (one a listed group). Both frameworks compute
  the same moments of the same float32 inputs: 1e-5 of the scale.
* `render(eikonal_batch=B)` over (1 + V) * B views against JAX's, on the
  same inputs and draws (JAX's: t_rand and eik_idx over every view,
  eik_uniform over the first B): outputs and input gradients 1e-4 relative
  to their scale, as tests/test_torch_train.py's render.
* The training forward in float32 at batch 4 with each flag set (all
  three, and each alone), against JAX's forward with the same flags and
  JAX's draws (tests/test_torch_train.py's set-up, whose helpers this file
  uses): the var keys and loss.all as that file's full-step forward (1e-2
  of the scale, 2e-3), and the BatchNorm running statistics after the
  forward, i.e. after the step, 1e-3 of their scale, as its full step.
* Which program each flag set runs: ResNet34, ResNet18 and render calls of
  a full step.
* The port's merged step against its sequential step in float64 (the
  merged and sequential programs differ only in the order of sums; in
  float32 train-mode BatchNorm over 4 samples turns that into 5e-5 at the
  latent projections, which the JAX package's own
  tests/test_train_step.py::test_merged_encoders_exact_single_device
  holds to 1e-5 and fails): a camera and a full step on the same draws
  (the sequential renders' draws re-sliced for the merged one), loss terms
  1e-12 relative, every gradient 1e-10 in norm relative to its own norm,
  the post-step parameters 1e-6 lr (Adam's first update divides by
  |g| + eps), the running statistics 1e-12 of their scale (measured: 3e-14,
  4.4e-13, 1.1e-7 lr, 6.7e-15) and `num_batches_tracked` equal.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapeclipper_tpu.models.graph import Graph as JaxGraph
from shapeclipper_tpu.models.graph import summarize_loss as jax_summarize
from shapeclipper_tpu.models.layers import GroupBatchNorm
from shapeclipper_tpu.utils.easydict import EasyDict as jedict
from shapeclipper_torch import bridge
from shapeclipper_torch.models.graph import Graph, summarize_loss
from shapeclipper_torch.models.layers import BatchNorm, bn_groups
from shapeclipper_torch.render import renderer as renderlib
from shapeclipper_torch.train.trainer import Runner, batch_to_var
from shapeclipper_torch.utils.easydict import EasyDict as edict
from tests.test_torch_ddp import global_inputs, make_opt
from tests.test_torch_train import (B, R, S, VAR_KEYS, make_batch,
                                    perturbed_state, port_runner, train_opt)
from tests.test_torch_train import step_draws as jax_sequential_draws

torch.set_num_threads(2)
FLAGS = ("merge_encoders", "merge_flip_estimator", "merge_nn_render")
FLAG_SETS = {"all": (True, True, True), "encoders": (True, False, False),
             "flip": (False, True, False), "render": (False, False, True)}
FLIPPED = ("trig_azim_flipped", "trig_elev_flipped", "trig_theta_flipped")


# ------------------------------------------------------------- BatchNorm
BN_CASES = [  # (groups, stats_groups, replicas)
    (1, None, 1), (2, None, 1), (2, (0,), 1), (3, None, 1), (3, (0, 2), 1),
    (3, (), 1), (2, None, 2), (3, (0, 2), 2)]


def _bn_id(case):
    g, sg, r = case
    listed = "all" if sg is None else "".join(map(str, sg)) or "none"
    return f"g{g}-s{listed}-r{r}"


@pytest.mark.parametrize("groups,stats_groups,replicas", BN_CASES,
                         ids=[_bn_id(c) for c in BN_CASES])
@pytest.mark.parametrize("dims", [2, 4])
def test_group_batchnorm_matches_jax(dims, groups, stats_groups, replicas):
    """A [G * 6, C] or [G * 6, C, 5, 5] batch: JAX's `GroupBatchNorm` with
    `groups = G * replicas` and `stats_groups` scaled by the replicas (what
    `Graph._apply_bn` hands it) against the port's BatchNorm under
    `bn_groups` with `replicas`."""
    rng = np.random.RandomState(groups * 10 + replicas + dims)
    C, G = 8, groups
    shape = (G * 6, 5, 5, C) if dims == 4 else (G * 6, C)
    x = (rng.randn(*shape) * rng.uniform(0.5, 2, C)
         + rng.randn(C)).astype(np.float32)
    cot = rng.randn(*shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = (rng.randn(C) * 0.1).astype(np.float32)
    ra_mean = (rng.randn(C) * 0.1).astype(np.float32)
    ra_var = rng.uniform(0.5, 1.5, C).astype(np.float32)
    sg = stats_groups
    if replicas > 1:   # Graph._apply_bn: every listed group's block 0
        sg = tuple(g * replicas for g in (range(G) if sg is None else sg))
    jbn = GroupBatchNorm(use_running_average=False, groups=G * replicas,
                         stats_groups=sg)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": ra_mean, "var": ra_var}}

    def f(v, xx):
        return jbn.apply(v, xx, mutable=["batch_stats"])

    (y, mut), vjp = jax.vjp(lambda xx: f(variables, xx), jnp.asarray(x))
    (dx,) = vjp((jnp.asarray(cot), jax.tree_util.tree_map(jnp.zeros_like,
                                                          mut)))

    bn = BatchNorm(C)
    bn.load_state_dict(dict(
        weight=torch.from_numpy(scale), bias=torch.from_numpy(bias),
        running_mean=torch.from_numpy(ra_mean),
        running_var=torch.from_numpy(ra_var),
        num_batches_tracked=torch.tensor(0)))
    bn.replicas = replicas
    bn.train()

    def nchw(a):
        return np.moveaxis(a, -1, 1) if dims == 4 else a

    xt = torch.from_numpy(np.ascontiguousarray(nchw(x))).requires_grad_(True)
    with bn_groups(bn, G, stats_groups):
        yt = bn(xt)
    assert (bn.groups, bn.stats_groups) == (1, None)   # restored
    yt.backward(torch.from_numpy(np.ascontiguousarray(nchw(cot))))
    for got, want in ((yt, y), (xt.grad, dx)):
        want = nchw(np.asarray(want))
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))
    for got, key in ((bn.running_mean, "mean"), (bn.running_var, "var")):
        want = np.asarray(mut["batch_stats"][key])
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    listed = G if stats_groups is None else len(stats_groups)
    assert int(bn.num_batches_tracked) == listed


# ------------------------------------------------------------ the render
def jax_render_draws(key, n, n_eik, opt):
    """renderer.py:108-121, 192-193, 280-281: one render's draws, t_rand and
    eik_idx over its `n` rows, eik_uniform over the first `n_eik`."""
    rng_z, rng_eik_pts = jax.random.split(key)
    rng_strat, rng_eik = jax.random.split(rng_z)
    lo, hi = opt.arch.impl_sdf.eikonal_sample_range
    d = dict(t_rand=jax.random.uniform(rng_strat, (n, R, S)),
             eik_idx=jax.random.randint(rng_eik, (n, R, 1), 0, S),
             eik_uniform=jax.random.uniform(rng_eik_pts, (n_eik, R, 3),
                                            minval=lo, maxval=hi))
    return edict({k: torch.from_numpy(np.asarray(v).copy())
                  for k, v in d.items()})


@pytest.fixture(scope="module")
def state(base_opt, tmp_path_factory):
    """tests/test_torch_train.py's weights and batch."""
    opt = train_opt(base_opt, tmp_path_factory.mktemp("merged"), "vjp")
    params, stats = perturbed_state(opt)
    return SimpleNamespace(opt=opt, params=params, stats=stats,
                           batch=make_batch(opt))


def test_render_eikonal_batch_matches_jax(state):
    """One training render over (1 + V) * n views (n = 2, V = 1) with the
    eikonal points of the first n only, on identical inputs and draws:
    outputs (grad_eikonal [n, 2R]) and the gradients w.r.t. the MLPs, beta,
    pose, intrinsics, scale and both latents of a random linear function
    of every output."""
    from shapeclipper_torch.models.graph import pose_from_trig
    opt = state.opt
    rng = np.random.RandomState(8)
    n, views = 2, 2 * opt.reg.n_views
    m = n * views
    trig = [rng.randn(m, 2).astype(np.float32) for _ in range(3)]
    trig = [t / np.linalg.norm(t, axis=-1, keepdims=True) for t in trig]
    scale = rng.uniform(0.9, 1.1, m).astype(np.float32)
    lat_s = np.tile((rng.randn(n, 64) * 0.3).astype(np.float32), (views, 1))
    lat_r = (rng.randn(m, 64) * 0.3).astype(np.float32)
    ray_idx = rng.randint(0, opt.H * opt.W, (m, R)).astype(np.int32)
    key = jax.random.PRNGKey(12)
    draws = jax_render_draws(key, m, n, opt)
    cots = [rng.randn(*s).astype(np.float32) for s in
            ((m, R, 3), (m, R, 1), (m, R, 1), (m, R, 3), (n, 2 * R))]

    def jax_fn(p, pose, intr, sd, ls, lr_):
        out = JaxGraph(opt).render(p, pose, intr, sd, ls, lr_,
                                   jnp.asarray(ray_idx), key, True,
                                   eikonal_batch=n)
        outs = (out.rgb, out.mask, out.depth, out.normal, out.grad_eikonal)
        return sum((o * c).sum() for o, c in zip(outs, cots)), outs

    tp = [torch.from_numpy(t) for t in trig]
    pose, intr = pose_from_trig(opt, *tp, torch.ones(m),
                                torch.from_numpy(scale))
    inputs = [pose.detach(), intr.detach(), torch.from_numpy(scale),
              torch.from_numpy(lat_s), torch.from_numpy(lat_r)]
    for t in inputs:
        t.requires_grad_(True)
    (_, jouts), jgrads = jax.jit(jax.value_and_grad(
        jax_fn, argnums=(0, 1, 2, 3, 4, 5), has_aux=True))(
        state.params, *[jnp.asarray(t.detach().numpy()) for t in inputs])

    g = port_runner(state).graph
    out = g.render(*inputs, ray_idx=torch.from_numpy(ray_idx).long(),
                   training=True, draws=draws, eikonal_batch=n)
    outs = (out.rgb, out.mask, out.depth, out.normal, out.grad_eikonal)
    assert out.grad_eikonal.shape == (n, 2 * R)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots)).backward()
    for o, jo in zip(outs, jouts):
        jo = np.asarray(jo)
        np.testing.assert_allclose(o.detach().numpy(), jo, rtol=1e-4,
                                   atol=1e-4 * max(float(np.abs(jo).max()),
                                                   1.0))
    want = bridge.state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jgrads[0]), state.stats)
    pairs = [(p.grad, want[k], k) for k, p in g.named_parameters()
             if k.split(".")[0] in ("sdf_network", "rgb_network", "density")]
    pairs += [(t.grad, torch.from_numpy(np.array(jg)), name) for t, jg, name
              in zip(inputs, jgrads[1:], ("pose", "intr", "scale_dist",
                                          "latent_sdf", "latent_rgb"))]
    for got, w, name in pairs:
        sc = max(float(w.abs().max()), 1e-6)
        torch.testing.assert_close(got, w, rtol=1e-4, atol=1e-4 * sc,
                                   msg=name)


# ------------------------------------------------ the forward against JAX
def flagged(opt, flags):
    opt = opt.deepcopy()
    opt.tpu.update(dict(zip(FLAGS, flags)))
    return opt


@pytest.mark.parametrize("flags", list(FLAG_SETS), ids=list(FLAG_SETS))
def test_merged_forward_matches_jax(state, flags):
    """The full step's training forward (train-mode BatchNorm) with the
    flags `flags`: var keys, loss.all and the BatchNorm running statistics
    against JAX's forward with the same flags, on JAX's draws (with the
    render merge: one draw over 2B rows, the eikonal points of the first
    B)."""
    opt = flagged(state.opt, FLAG_SETS[flags])
    key = jax.random.PRNGKey(5)
    if FLAG_SETS[flags][2]:
        r_render, r_nn, _ = jax.random.split(key, 3)
        draws = edict(
            render=jax_render_draws(r_render, (1 + opt.reg.n_views) * B, B,
                                    opt),
            nn_uniform=torch.from_numpy(np.asarray(jax.random.uniform(
                r_nn, (B, opt.data.k_nearest), minval=1e-20,
                maxval=1.0)).copy()))
    else:
        draws = jax_sequential_draws(key, opt)
    jbatch = jedict({k: jnp.asarray(v) for k, v in state.batch.items()})
    keys = VAR_KEYS + (FLIPPED if FLAG_SETS[flags][1] else ())

    def fwd(p, s, b, k):
        var, loss, new_stats = JaxGraph(opt).forward(
            p, s, b, k, training=True, get_loss=True, bn_eval=False)
        return ({n: var[n] for n in keys}, jax_summarize(opt, loss).all,
                new_stats)

    jvar, jall, jstats = jax.jit(fwd)(state.params, state.stats, jbatch, key)

    graph = Graph(opt)
    graph.load_state_dict(bridge.state_dict_from_flax(state.params,
                                                      state.stats))
    graph.train()
    var, loss = graph(batch_to_var(state.batch, "cpu"), training=True,
                      get_loss=True, draws=draws)
    assert all(k in var for k in FLIPPED) == FLAG_SETS[flags][1]
    for k in keys:
        want = np.asarray(jvar[k])
        got = var[k].detach().numpy()
        assert got.shape == want.shape, k
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(got, want, atol=1e-2 * scale, rtol=1e-2,
                                   err_msg=k)
    np.testing.assert_allclose(float(summarize_loss(opt, loss).all.detach()),
                               float(jall), rtol=2e-3)
    want = bridge.state_dict_from_flax(
        state.params, jax.tree_util.tree_map(np.asarray, jstats))
    for name, buf in graph.named_buffers():
        if "running" in name:
            torch.testing.assert_close(
                buf, want[name], rtol=0,
                atol=1e-3 * float(want[name].abs().max()), msg=name)


@pytest.mark.parametrize("flags", ["yaml", "none"] + list(FLAG_SETS))
def test_flags_pick_the_program(base_opt, tmp_path, monkeypatch, flags):
    """A full step's ResNet34 (encoder), ResNet18 (the estimator's) and
    render calls: with the YAML's flags (true) one of each, the render over
    (1 + V) * B views; with every flag false the sequential 1 + V, 2 + V
    (query, flipped, views) and 1 + V renders of B views; each flag alone
    merges its own part."""
    opt = train_opt(base_opt, tmp_path, "vjp")
    opt.update(image_size=[32, 32], batch_size=2)
    opt.H, opt.W = 32, 32
    if flags == "yaml":
        for k in FLAGS:
            del opt.tpu[k]
        enc, flip, render = True, True, True
    else:
        enc, flip, render = FLAG_SETS.get(flags, (False, False, False))
        opt.tpu.update(dict(zip(FLAGS, (enc, flip, render))))
    runner = Runner(opt, "cpu")
    runner.build_networks(opt)
    runner.setup_optimizer(opt)
    runner.restore_checkpoint(opt)
    calls = dict(resnet34=[], resnet18=[], render=[])
    g = runner.graph
    g.encoder.register_forward_pre_hook(
        lambda m, a: calls["resnet34"].append(a[0].shape[0]))
    g.estimator.feature_extractor.register_forward_pre_hook(
        lambda m, a: calls["resnet18"].append(a[0].shape[0]))
    render_fn = renderlib.render

    def counted(*a, **kw):
        calls["render"].append(a[4].shape[0])   # pose [views, 3, 4]
        return render_fn(*a, **kw)

    monkeypatch.setattr(renderlib, "render", counted)
    batch = make_batch(opt)
    batch = {k: v[:2] for k, v in batch.items()}
    runner.it = 1
    runner.train_iteration(opt, batch_to_var(batch, "cpu"))
    V, n = opt.reg.n_views, 2
    assert calls["resnet34"] == ([(1 + V) * n] if enc else [n] * (1 + V))
    est = [(1 + int(flip) + V) * n] if enc else \
        [(2 if flip else 1) * n] + [n] * V
    if not flip:
        est.append(n)   # the flipped pass inside the loss
    assert calls["resnet18"] == est
    assert calls["render"] == ([(1 + V) * n] if render else [n] * (1 + V))


# ------------------------------------------- merged against sequential
def run_port_steps(opt, batch, draws):
    """A camera step, then a full step, of a fresh Runner -> per step the
    loss terms, the gradients, the parameters and every buffer after it."""
    runner = Runner(opt, "cpu")
    runner.build_networks(opt)
    runner.setup_optimizer(opt)
    runner.restore_checkpoint(opt)
    out = []
    for it in (0, 1):
        runner.it = it
        loss = runner.train_iteration(opt, batch_to_var(batch, "cpu"),
                                      draws=draws)
        g = runner.graph
        out.append(dict(
            loss={k: float(v) for k, v in loss.items() if k != "finite"},
            grads={n: p.grad.clone() for n, p in g.named_parameters()},
            params={n: p.detach().clone() for n, p in g.named_parameters()},
            buffers={n: b.clone() for n, b in g.named_buffers()}))
    return out


@pytest.fixture(scope="module")
def float64_steps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("float64")
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        batch, draws = global_inputs(tmp / "inputs")
        return {merged: run_port_steps(
            make_opt(tmp / str(merged), "global", merged=merged), batch,
            draws) for merged in (False, True)}
    finally:
        torch.set_default_dtype(dtype)


@pytest.mark.parametrize("step", [0, 1], ids=["camera", "full"])
def test_merged_step_matches_sequential_float64(float64_steps, step):
    got, want = float64_steps[True][step], float64_steps[False][step]
    lr = 1e-4
    assert set(got["loss"]) == set(want["loss"])
    for k, v in want["loss"].items():
        np.testing.assert_allclose(got["loss"][k], v, rtol=1e-12, atol=0,
                                   err_msg=k)
    for name, w in want["grads"].items():
        err = float((got["grads"][name] - w).norm()
                    / w.norm().clamp(min=1e-30))
        assert err <= 1e-10, (name, err)
        d = float((got["params"][name] - want["params"][name]).abs().max())
        assert d <= 1e-6 * lr, (name, d)
    for name, w in want["buffers"].items():
        if "running" in name:
            e = float((got["buffers"][name] - w).abs().max())
            assert e <= 1e-12 * float(w.abs().max()), (name, e)
        else:   # num_batches_tracked: one a listed group, as sequential
            assert torch.equal(got["buffers"][name], w), name
