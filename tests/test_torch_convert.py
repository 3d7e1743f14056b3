"""scripts/jax_ckpt_to_torch.py with the optax Adam states: a JAX run
converted to the port resumes and takes the step the JAX run would take.

Set-up: tests/test_torch_train.py's small training config (batch 4 at
64 x 64, 16 rays x 8 samples, one neighbour view of two, sequential
float32 encoders and MLPs). JAX takes the camera step (optim_V) and one
full step (optim_full) and saves its checkpoint; the script converts it;
the port `--resume`s and takes the next full step with JAX's draws, which
is held against JAX's own next step to the full-step bounds of
tests/test_torch_train.py (post-Adam parameters atol 2 * lr, mean
difference below 0.02 * lr; BatchNorm running statistics 1e-3 relative to
their scale). A JAX pretraining checkpoint (a partial tree, with the
optimizer state `optim`) converts too and `--load`s child by child.
"""

import importlib.util
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shapeclipper_tpu.config import options as joptions
from shapeclipper_tpu.models.graph import Graph as JaxGraph
from shapeclipper_tpu.models.graph import summarize_loss as jax_summarize
from shapeclipper_tpu.train import pretrainer as jpretrainer
from shapeclipper_tpu.train.pretrainer import make_optimizer as jax_optimizer
from shapeclipper_tpu.utils import checkpoint as jckpt
from shapeclipper_tpu.utils.easydict import EasyDict as jedict
from shapeclipper_torch import bridge
from shapeclipper_torch.models.graph import Graph
from shapeclipper_torch.train.pretrainer import pretrain_trainable
from shapeclipper_torch.train.trainer import (CAMERA_PHASE_INACTIVE, Runner,
                                              batch_to_var)
from shapeclipper_torch.utils import checkpoint as ckpt
from tests.test_torch_train import (make_batch, perturbed_state, step_draws,
                                    train_opt)
from tests.torch_tmp import kept_if_failed, tmp_path  # noqa: F401

torch.set_num_threads(2)
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def convert(src, dst):
    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_to_torch", os.path.join(REPO, "scripts",
                                          "jax_ckpt_to_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    script.convert(src, dst)


def jax_step_fn(opt, tx, camera):
    """trainer.py:192-221 with a carried optimizer state."""
    graph = JaxGraph(opt)

    def step(params, stats, opt_state, batch, key):
        def loss_fn(p):
            _, loss, new_stats = graph.forward(p, stats, batch, key,
                                               training=True, get_loss=True,
                                               bn_eval=camera)
            loss = jax_summarize(opt, loss, non_act_loss_keys=(
                CAMERA_PHASE_INACTIVE if camera else ()))
            return loss.all, new_stats
        grads, new_stats = jax.grad(loss_fn, has_aux=True)(params)
        updates, new_state = tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates),
                stats if camera else new_stats, new_state)

    return jax.jit(step)


@pytest.fixture(scope="module")
def jax_run(base_opt, tmp_path_factory, request):
    """Camera step, full step, save (RUN_DIR/latest.ckpt + options.yaml),
    then the reference's next full step."""
    with kept_if_failed(request, tmp_path_factory.mktemp("run")) as run_dir:
        yield jax_steps(base_opt, run_dir)


def jax_steps(base_opt, run_dir):
    opt = train_opt(base_opt, run_dir, "vjp")
    params, stats = perturbed_state(opt)
    batch = make_batch(opt)
    jbatch = jedict({k: jnp.asarray(v) for k, v in batch.items()})
    tx_full = jax_optimizer(opt, params, lambda p: True)
    tx_V = jax_optimizer(opt, params, lambda p: p[0] == "estimator")
    s_full, s_V = tx_full.init(params), tx_V.init(params)
    camera = jax_step_fn(opt, tx_V, True)
    full = jax_step_fn(opt, tx_full, False)
    k0, k1, k2 = jax.random.split(jax.random.PRNGKey(5), 3)
    p, s, s_V = camera(params, stats, s_V, jbatch, k0)
    p, s, s_full = full(p, s, s_full, jbatch, k1)
    jckpt.save_checkpoint(str(run_dir), {"params": p, "batch_stats": s},
                          optim_states={"optim_full": s_full,
                                        "optim_V": s_V},
                          ep=0, it=2, latest=True)
    joptions.save_options_file(opt)
    p3, s3, _ = full(p, s, s_full, jbatch, k2)
    convert(str(run_dir / "latest.ckpt"), str(run_dir / "latest.pt"))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return SimpleNamespace(
        opt=opt, run_dir=run_dir, batch=batch, draws=step_draws(k2, opt),
        params=params, stats=stats,
        raw=jckpt.load_raw(str(run_dir / "latest.ckpt")),
        next=bridge.state_dict_from_flax(as_np(p3), as_np(s3)))


def resumed_runner(run):
    opt = run.opt.deepcopy()
    opt.resume = True
    runner = Runner(opt, "cpu")
    runner.build_networks(opt)
    runner.setup_optimizer(opt)
    runner.restore_checkpoint(opt)
    return opt, runner


@pytest.mark.parametrize("name", ["optim_full", "optim_V"])
def test_adam_moments_carry_over(jax_run, name):
    """Every parameter of the resumed optimizer holds optax's mu / nu as
    exp_avg / exp_avg_sq (transposed as the weights) and count as step;
    lr, betas and eps are the run's."""
    _, runner = resumed_runner(jax_run)
    adam = jax_run.raw[name]["inner_states"]["train"]["inner_state"]["0"]
    mu = bridge.state_dict_from_flax(adam["mu"])
    optimizer = getattr(runner, name)
    module = runner.graph.estimator if name == "optim_V" else runner.graph
    prefix = "estimator." if name == "optim_V" else ""
    named = list(module.named_parameters())
    assert len(named) == len(mu) == len(optimizer.state)
    for n, p in named:
        st = optimizer.state[p]
        assert float(st["step"]) == float(adam["count"]) == 1.0
        assert st["step"].dtype == torch.float32
        torch.testing.assert_close(st["exp_avg"], mu[prefix + n], rtol=0,
                                   atol=0, msg=n)
    # two leaves by hand: a Dense kernel [in, out] and a Conv kernel HWIO
    kernel = np.asarray(adam["nu"]["estimator"]["extr_fc"]["kernel"]).T
    torch.testing.assert_close(
        optimizer.state[runner.graph.estimator.extr_fc.weight]["exp_avg_sq"],
        torch.from_numpy(kernel), rtol=0, atol=0)
    if name == "optim_full":
        conv = np.asarray(adam["mu"]["encoder"]["conv1"]["kernel"]).transpose(
            3, 2, 0, 1)
        torch.testing.assert_close(
            optimizer.state[runner.graph.encoder.conv1.weight]["exp_avg"],
            torch.from_numpy(conv), rtol=0, atol=0)
    group = optimizer.param_groups[0]
    assert group["lr"] == float(jax_run.opt.optim.lr)
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8


def test_resumed_run_takes_the_jax_step(jax_run):
    """--resume from the converted latest.pt (iteration 2: a full step)
    and the next step's parameters and statistics against JAX's."""
    opt, runner = resumed_runner(jax_run)
    assert (runner.epoch_start, runner.iter_start) == (0, 2)
    runner.train_iteration(opt, batch_to_var(jax_run.batch, "cpu"),
                           draws=jax_run.draws)
    lr = float(opt.optim.lr)
    diffs = []
    for name, p in runner.graph.named_parameters():
        d = (p.detach() - jax_run.next[name]).abs()
        # + 1e-6: the float32 rounding of parameter values up to ~8
        assert float(d.max()) <= 2 * lr + 1e-6, (name, float(d.max()))
        diffs.append(d.flatten())
    assert float(torch.cat(diffs).mean()) <= 0.02 * lr
    for name, buf in runner.graph.named_buffers():
        if "running" in name:
            want = jax_run.next[name]
            torch.testing.assert_close(
                buf, want, rtol=0, atol=1e-3 * float(want.abs().max()),
                msg=name)
    assert float(runner.optim_full.state[
        runner.graph.density.beta]["step"]) == 2.0


def test_pretrain_checkpoint_converts_and_loads(jax_run, base_opt, tmp_path,
                                               capsys):
    """The JAX pretraining Runner's checkpoint (children sdf_network,
    latent_proj_shape, estimator; optimizer state `optim`) converts, and a
    port training Graph `--load`s it per child."""
    opt = base_opt.deepcopy()
    opt.update(image_size=[32, 32], batch_size=2, seed=0,
               output_path=str(tmp_path / "pre"))
    opt.H, opt.W = opt.image_size
    opt.pre.update(iter=1, sample_points=256, viewpoint=True)
    opt.data.update(dataset="synthetic", num_workers=0, max_img_cat=2)
    opt.data.synthetic = jedict(azim_range=[-180, 180], elev_range=[-90, 90],
                                theta_range=[-90, 90])
    opt.arch.enc_pretrained = False
    opt.tpu.update(encoder_dtype="float32", implicit_dtype="float32")
    os.makedirs(opt.output_path)
    joptions.save_options_file(opt)
    jrun = jpretrainer.Runner(opt)
    jrun.load_dataset(opt)
    jrun.graph = jpretrainer.PretrainGraph(opt)
    jrun.params, jrun.batch_stats = jax_run.params, jax_run.stats
    jrun.setup_optimizer(opt)
    jrun.train(opt)
    src = os.path.join(opt.output_path, "latest.ckpt")
    dst = str(tmp_path / "pre.pt")
    convert(src, dst)
    saved = torch.load(dst, weights_only=True)
    children = {"sdf_network", "latent_proj_shape", "estimator"}
    assert {k.split(".")[0] for k in saved["graph"]} == children
    graph = Graph(opt)
    trainable = [n for n, _ in graph.named_parameters()
                 if pretrain_trainable(n)]
    state = saved["optim"]["state"]
    assert len(state) == len(trainable)
    assert all(float(st["step"]) == 1.0 for st in state.values())
    i = trainable.index("estimator.extr_fc.weight")
    adam = jckpt.load_raw(src)["optim"]["inner_states"]["train"][
        "inner_state"]["0"]
    torch.testing.assert_close(state[i]["exp_avg"], torch.from_numpy(
        np.asarray(adam["mu"]["estimator"]["extr_fc"]["kernel"]).T),
        rtol=0, atol=0)
    want = bridge.state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jrun.params),
        jax.tree_util.tree_map(np.asarray, jrun.batch_stats))
    own = {k: v.clone() for k, v in graph.state_dict().items()}
    capsys.readouterr()
    ckpt.restore_checkpoint(str(tmp_path), graph, load_name=dst)
    out = capsys.readouterr().out
    for child in children:
        assert f"restoring {child}..." in out
    assert "skipping encoder..." in out
    for k, v in graph.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        expect = want[k] if k.split(".")[0] in children else own[k]
        torch.testing.assert_close(v, expect, rtol=0, atol=0, msg=k)
