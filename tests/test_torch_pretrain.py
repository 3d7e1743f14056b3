"""The port's sphere pretraining (`models/pretrain_graph.py`,
`train/pretrainer.py`, `python -m shapeclipper_torch.pretrain`) against the
JAX package's, on the CPU in float32 at tests/test_pretrain.py's size:
32 x 32 images, batch 2, 512 points, lr 1e-3, with pre.viewpoint off and
on, float32 encoders (the port computes in float32 and ignores
`tpu.encoder_dtype`; the config's bfloat16 ResNet18 would hold w_dist to
bfloat16 rounding). Weights come from the JAX `PretrainGraph.init` through
`bridge.py`; the step's two draws (latent, points) are re-derived from the
JAX step key along pretrain_graph.py:23-28, 56-57 and handed to the port.

The parity tests (forward, one step, float32 rounding) run at batch 4,
the others at batch 2. At batch 2 train-mode BatchNorm normalises two
samples per feature, (a - b) / 2 / sqrt(((a - b) / 2)^2 + eps), which
amplifies rounding where a ~ b, as tests/test_torch_train.py found for the
training step; at batch 4 the port's float32 forward stays 10x inside the
bounds below against its float64 one
(test_float32_rounding_is_below_the_parity_bounds), so the bounds test the
code, not the rounding.

Tolerances, and why:
  * loss.sdf: rtol 1e-5 (an MLP on the same points and latents);
  * loss.w_dist: 2e-3 relative, the full-step bound of
    tests/test_torch_train.py: the train-mode ResNet18 enters it;
  * latent_proj_shape's BatchNorm running statistics: 1e-3 relative to
    their scale;
  * the step: every trainable parameter's gradient 1e-4 in norm relative
    to its own norm, and post-Adam parameters atol 0.1 * lr with a mean
    absolute difference below 0.02 * lr (the camera-step bounds of
    tests/test_torch_train.py: the frozen ResNet18 takes no backward pass
    here, so the ill-conditioned train-mode ResNet gradients behind that
    file's full-step bounds do not arise; the first Adam update is
    lr * g / (|g| + eps), which amplifies rounding where |g| ~ eps); the
    frozen estimator backbone and `*_head` bottlenecks bitwise unchanged.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from shapeclipper_tpu.models.pretrain_graph import \
    PretrainGraph as JaxPretrainGraph
from shapeclipper_tpu.train.pretrainer import make_optimizer as jax_optimizer
from shapeclipper_tpu.train.pretrainer import \
    pretrain_trainable as jax_trainable
from shapeclipper_tpu.utils.easydict import EasyDict as jedict
from shapeclipper_torch import bridge
from shapeclipper_torch.models.graph import Graph
from shapeclipper_torch.train.pretrainer import Runner, pretrain_trainable
from shapeclipper_torch.utils import checkpoint as ckpt
from shapeclipper_torch.utils.easydict import EasyDict as edict
from tests.torch_tmp import tmp_path  # noqa: F401

torch.set_num_threads(2)
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
B, P = 4, 512   # batch of the parity tests (see above)


def small_opt(base_opt, out, viewpoint=False, batch_size=2):
    """tests/test_pretrain.py's small_opt, with float32 encoders."""
    opt = base_opt.deepcopy()
    opt.update(image_size=[32, 32], batch_size=batch_size, seed=0,
               output_path=str(out))
    opt.H, opt.W = opt.image_size
    opt.pre.update(sample_points=P, viewpoint=viewpoint)
    opt.optim.lr = 1e-3
    opt.arch.enc_pretrained = False
    opt.tpu.update(encoder_dtype="float32", implicit_dtype="float32")
    return opt


@pytest.fixture(scope="module")
def jax_state(base_opt, tmp_path_factory):
    opt = small_opt(base_opt, tmp_path_factory.mktemp("init"))
    state = jax.jit(JaxPretrainGraph(opt).init)(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, state)


def jax_draws(opt, key):
    """pretrain_graph.py:23-28 and 56-57: the latent and the points."""
    rng_lat, rng_pts = jax.random.split(key)
    dim = opt.arch.latent_dim_shape + opt.arch.latent_dim_rgb
    lo, hi = opt.pre.sample_range
    latent = jax.random.normal(rng_lat, (B, dim)) * opt.pre.latent_std
    points = jax.random.uniform(rng_pts, (B, P, 3), minval=lo, maxval=hi)
    return edict(latent=torch.from_numpy(np.array(latent)),
                 points=torch.from_numpy(np.array(points)))


def jax_run(base_opt, tmp_path, state, viewpoint):
    """One JAX pretraining step (trainer.py's `step`, pretrainer.py:77-89)
    from a fresh optimizer state, with its inputs."""
    opt = small_opt(base_opt, tmp_path, viewpoint, batch_size=B)
    params, stats = state["params"], state["batch_stats"]
    images = np.random.RandomState(3).uniform(
        0, 1, (B, 32, 32, 3)).astype(np.float32)
    var = jedict(rgb_input_map=jnp.asarray(images)) if viewpoint else jedict()
    key = jax.random.PRNGKey(4)
    graph = JaxPretrainGraph(opt)
    tx = jax_optimizer(opt, params, jax_trainable)

    def step(p):
        def loss_fn(q):
            _, loss, new_stats = graph.forward(q, stats, var, key,
                                               training=True)
            return loss.all, (loss, new_stats)
        (_, (loss, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return loss, new_stats, grads, optax.apply_updates(p, updates)

    loss, new_stats, grads, new_params = jax.jit(step)(params)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return SimpleNamespace(
        opt=opt, params=params, stats=stats, draws=jax_draws(opt, key),
        var=edict(rgb_input_map=torch.from_numpy(images)) if viewpoint
        else edict(),
        loss={k: float(np.asarray(v)) for k, v in loss.items()},
        grads=bridge.state_dict_from_flax(as_np(grads)),
        new=bridge.state_dict_from_flax(as_np(new_params), as_np(new_stats)))


@pytest.fixture(scope="module", params=[False, True],
                ids=["density", "viewpoint"])
def run(request, base_opt, tmp_path_factory, jax_state):
    return jax_run(base_opt, tmp_path_factory.mktemp("pre"), jax_state,
                   request.param)


def port_runner(run):
    runner = Runner(run.opt, "cpu")
    runner.build_networks(run.opt)
    runner.graph.load_state_dict(
        bridge.state_dict_from_flax(run.params, run.stats), strict=True)
    runner.setup_optimizer(run.opt)
    return runner


def test_pretrain_forward_matches_jax(run):
    """PretrainGraph.forward: the loss terms and latent_proj_shape's
    running statistics."""
    runner = port_runner(run)
    runner.graph.train()
    _, loss = runner.graph(run.var, training=True, draws=run.draws)
    loss = {k: float(v) for k, v in loss.items()}
    assert set(loss) == set(run.loss)
    np.testing.assert_allclose(loss["sdf"], run.loss["sdf"], rtol=1e-5)
    if "w_dist" in run.loss:
        np.testing.assert_allclose(loss["w_dist"], run.loss["w_dist"],
                                   rtol=2e-3)
    np.testing.assert_allclose(loss["all"], run.loss["all"], rtol=2e-3)
    for name, buf in runner.graph.named_buffers():
        if name.startswith("latent_proj_shape") and "running" in name:
            want = run.new[name]
            torch.testing.assert_close(
                buf, want, rtol=0, atol=1e-3 * float(want.abs().max()),
                msg=name)


def _norm_rel(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def test_pretrain_step_matches_optax(run):
    """Runner.train_iteration: one Adam step against optax's. Every
    trainable parameter's gradient against JAX's (a leaf the loss does not
    reach holds no gradient in the port and zeros in JAX), the post-step
    parameters, the frozen estimator backbone and `*_head` parameters
    bit-identical, the `*_fc` ones moved when the viewpoint loss reaches
    them."""
    runner = port_runner(run)
    before = {n: p.detach().clone()
              for n, p in runner.graph.named_parameters()}
    runner.train_iteration(run.opt, run.var, draws=run.draws)
    lr = float(run.opt.optim.lr)
    diffs = []
    for name, p in runner.graph.named_parameters():
        want_g = run.grads[name].numpy()
        if pretrain_trainable(name):
            got_g = (np.zeros_like(want_g) if p.grad is None
                     else p.grad.numpy())
            err = _norm_rel(got_g, want_g)
            assert err <= 1e-4, (name, err)
        else:
            assert p.grad is None, name
            assert torch.equal(p.detach(), before[name]), name
        d = np.abs(p.detach().numpy() - run.new[name].numpy())
        assert d.max() <= 0.1 * lr + 1e-6, (name, d.max())
        diffs.append(d.ravel())
    assert np.concatenate(diffs).mean() <= 0.02 * lr
    fc_moved = [not torch.equal(p.detach(), before[n])
                for n, p in runner.graph.named_parameters()
                if n.startswith(("estimator.extr_fc", "estimator.size_fc",
                                 "estimator.perspect_fc"))]
    assert len(fc_moved) == 6
    if run.opt.pre.viewpoint:
        assert any(fc_moved)
    # (the geometric initialisation zeroes the SDF MLP's latent inputs, so
    # latent_proj_shape takes no gradient in the first step)
    assert not torch.equal(runner.graph.sdf_network.lin0.weight,
                           before["sdf_network.lin0.weight"])


def test_float32_rounding_is_below_the_parity_bounds(run):
    """The port's float32 forward against its own float64 one on the
    parity tests' inputs: the loss terms and latent_proj_shape's running
    statistics lie 10x inside the bounds above, so at batch 4 those bounds
    test the code, not the rounding of train-mode BatchNorm."""
    got = {}
    for dtype in (torch.float32, torch.float64):
        runner = port_runner(run)
        graph = runner.graph.to(dtype).train()
        var = edict({k: v.to(dtype) for k, v in run.var.items()})
        draws = edict({k: v.to(dtype) for k, v in run.draws.items()})
        with torch.no_grad():
            _, loss = graph(var, training=True, draws=draws)
        got[dtype] = (
            {k: float(v) for k, v in loss.items()},
            {n: b.double() for n, b in graph.named_buffers()
             if n.startswith("latent_proj_shape") and "running" in n})
    (loss32, bn32), (loss64, bn64) = got[torch.float32], got[torch.float64]
    np.testing.assert_allclose(loss32["sdf"], loss64["sdf"], rtol=1e-6)
    if "w_dist" in loss64:
        np.testing.assert_allclose(loss32["w_dist"], loss64["w_dist"],
                                   rtol=2e-4)
    for name, want in bn64.items():
        torch.testing.assert_close(
            bn32[name], want, rtol=0, atol=1e-4 * float(want.abs().max()),
            msg=name)


def test_trainable_set_matches_jax(jax_state, base_opt, tmp_path):
    """pretrain_trainable on the port's names is the JAX freeze mask under
    the bridge's name map: backbone and `*_head` frozen, `*_fc` and every
    other child trainable."""
    flat = traverse_util.flatten_dict(jax_state["params"])
    want = {}
    for trainable in (True, False):
        tree = traverse_util.unflatten_dict(
            {k: v for k, v in flat.items() if jax_trainable(k) == trainable})
        want[trainable] = set(bridge.state_dict_from_flax(tree))
    graph = Graph(small_opt(base_opt, tmp_path))
    got = {t: {n for n, _ in graph.named_parameters()
               if pretrain_trainable(n) == t} for t in (True, False)}
    assert got == want
    assert {n.split(".")[1] for n in got[False]} == {
        "feature_extractor", "extr_head", "size_head", "perspect_head"}
    assert {n for n in got[True] if n.startswith("estimator.")} == {
        f"estimator.{h}_fc.{w}" for h in ("extr", "size", "perspect")
        for w in ("weight", "bias")}


@pytest.mark.parametrize("viewpoint", [False, True],
                         ids=["density", "viewpoint"])
def test_children_checkpoint_loads_per_child(base_opt, tmp_path, capsys,
                                             viewpoint):
    """The pretraining save keeps exactly sdf_network, latent_proj_shape
    (and estimator with pre.viewpoint) with the Adam state as `optim`; a
    port training Graph `--load`s it child by child."""
    opt = small_opt(base_opt, tmp_path / "pre", viewpoint)
    runner = Runner(opt, "cpu")
    runner.build_networks(opt)
    runner.setup_optimizer(opt)
    runner.train_iteration(opt, edict(rgb_input_map=torch.rand(2, 32, 32, 3))
                           if viewpoint else edict())
    runner.save_checkpoint(opt, ep=1, it=1)
    saved = torch.load(tmp_path / "pre" / "checkpoint" / "ep1.pt",
                       weights_only=True)
    children = {"sdf_network", "latent_proj_shape"} | (
        {"estimator"} if viewpoint else set())
    assert {k.split(".")[0] for k in saved["graph"]} == children
    assert saved["optim"]["state"] and saved["iter"] == 1
    graph = Graph(small_opt(base_opt, tmp_path),
                  generator=torch.Generator().manual_seed(1))
    own = {k: v.clone() for k, v in graph.state_dict().items()}
    capsys.readouterr()
    ckpt.restore_checkpoint(str(tmp_path), graph,
                            load_name=str(tmp_path / "pre" / "latest.pt"))
    out = capsys.readouterr().out
    assert "restoring sdf_network..." in out and "skipping encoder..." in out
    for k, v in graph.state_dict().items():
        want = saved["graph"][k] if k.split(".")[0] in children else own[k]
        torch.testing.assert_close(v, want, rtol=0, atol=0, msg=k)


def test_pretrain_cli_on_cpu(tmp_path):
    """`python -m shapeclipper_torch.pretrain --device=cpu` for 3 steps
    writes latest.pt and checkpoint/ep1.pt; without `--device` it needs
    CUDA and raises here."""
    args = [sys.executable, "-m", "shapeclipper_torch.pretrain",
            "--yaml=options/synthetic/config.yaml", "--pre.iter=3",
            "--pre.sample_points=256", "--batch_size=2",
            "--image_size=[32,32]", "--data.num_workers=0",
            f"--output_root={tmp_path}"]
    r = subprocess.run(args + ["--device=cpu"], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert "pretrain it 3/3" in r.stdout
    run = tmp_path / "synthetic_output" / "smoke"
    for f in ("latest.pt", "checkpoint/ep1.pt", "options.yaml"):
        assert (run / f).is_file(), f
    if not torch.cuda.is_available():
        r = subprocess.run(args, cwd=REPO, capture_output=True, text=True,
                           timeout=600)
        assert r.returncode != 0
        assert "torch.cuda.is_available() is False" in r.stderr


def test_port_pretraining_fits_sphere(base_opt, tmp_path, jax_state):
    """tests/test_pretrain.py::test_pretrain_fits_sphere through the port's
    Runner, from that test's initialisation, with its 300 steps' draws and
    its probe latent: the final loss.sdf below half the first, and the SDF
    of the probe latent (eval-mode BatchNorm) within 0.1 of r - 0.5 along
    r in [0.3, 0.9]. The JAX test's own draws, not the port's: the probe's
    error moves with the training noise from step to step, so the port is
    held on the very run the JAX test makes."""
    opt = small_opt(base_opt, tmp_path)
    lo, hi = opt.pre.sample_range
    dim = opt.arch.latent_dim_shape + opt.arch.latent_dim_rgb

    def draws(key):
        rng_lat, rng_pts = jax.random.split(key)
        return (jax.random.normal(rng_lat, (2, dim)) * opt.pre.latent_std,
                jax.random.uniform(rng_pts, (2, P, 3), minval=lo, maxval=hi))

    keys, rng = [], jax.random.PRNGKey(1)
    for _ in range(300):
        rng, key = jax.random.split(rng)
        keys.append(key)
    latents, points = map(np.array, jax.jit(jax.vmap(draws))(
        jnp.stack(keys)))
    runner = Runner(opt, "cpu")
    runner.build_networks(opt)
    runner.graph.load_state_dict(bridge.state_dict_from_flax(
        jax_state["params"], jax_state["batch_stats"]), strict=True)
    runner.setup_optimizer(opt)
    losses = [float(runner.train_iteration(opt, edict(), draws=edict(
        latent=torch.from_numpy(latents[i]),
        points=torch.from_numpy(points[i]))).sdf) for i in range(300)]
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])
    graph = runner.graph.eval()
    latent = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(2), (1, opt.arch.latent_dim_shape))))
    r = torch.linspace(0.3, 0.9, 12)
    pts = torch.stack([r, torch.zeros_like(r), torch.zeros_like(r)], -1)[None]
    with torch.no_grad():
        sdf = graph.sdf_network(pts, graph.latent_proj_shape(latent))[0, :, 0]
    np.testing.assert_allclose(sdf.numpy(), (r - 0.5).numpy(), atol=0.1)
