"""`loss_weight.category_reg` in the port: the `category_centers` parameter,
its loss in training, and its way across from the JAX package.

JAX draws the centres in `Graph.init` (0.02 * N(0, 1), [num_classes,
proj_latent_dim]) and adds `category_reg_loss` in training; `bridge` carries
them (and their optax Adam moments) into the port's state_dict instead of
dropping them. Tolerances: the loss 1e-6 relative, its gradients 1e-5 of
their scale (float32, one cosine-similarity cross-entropy).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapeclipper_tpu import losses as JL
from shapeclipper_tpu.config import options as joptions
from shapeclipper_tpu.models.graph import Graph as JaxGraph
from shapeclipper_tpu.train.pretrainer import make_optimizer as jax_optimizer
from shapeclipper_tpu.utils import checkpoint as jckpt
from shapeclipper_torch import bridge
from shapeclipper_torch.models.graph import Graph
from shapeclipper_torch.train.trainer import Runner, batch_to_var
from shapeclipper_torch.utils.easydict import EasyDict as edict
from tests.torch_tmp import tmp_path  # noqa: F401

torch.set_num_threads(2)
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def reg_opt(base_opt, out):
    opt = base_opt.deepcopy()
    opt.update(image_size=[32, 32], seed=0, resume=False, load=None,
               tb=None, output_path=str(out))
    opt.H, opt.W = opt.image_size
    opt.loss_weight.category_reg = 1.0
    # Pix3D's nine categories (the config trains one: a single centre's
    # cross-entropy is 0 with zero gradients)
    opt.data.num_classes = 9
    opt.arch.enc_pretrained = False
    opt.tpu.update(encoder_dtype="float32", implicit_dtype="float32")
    return opt


@pytest.fixture(scope="module")
def jax_state(base_opt, tmp_path_factory):
    opt = reg_opt(base_opt, tmp_path_factory.mktemp("reg"))
    state = jax.jit(JaxGraph(opt).init)(jax.random.PRNGKey(0))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return opt, as_np(state["params"]), as_np(state["batch_stats"])


def test_centres_cross_and_loss_matches_jax(jax_state):
    """The centres carried across by `bridge`, and `Graph.compute_loss`'s
    category_reg term with its gradients with respect to the centres and
    proj_latent_sdf, against `jax.grad` of JAX's `category_reg_loss`."""
    opt, params, stats = jax_state
    centers = params["category_centers"]
    assert centers.shape == (opt.data.num_classes,
                             opt.arch.impl_sdf.proj_latent_dim)
    graph = Graph(opt)
    graph.load_state_dict(bridge.state_dict_from_flax(params, stats),
                          strict=True)
    np.testing.assert_array_equal(graph.category_centers.detach().numpy(),
                                  centers)

    rng = np.random.RandomState(2)
    B = 6
    z = (rng.randn(B, centers.shape[1]) * 0.5).astype(np.float32)
    z[0] = 0.0   # a zero code: finite gradients on both sides
    labels = rng.randint(0, opt.data.num_classes, B).astype(np.int32)

    def jax_loss(c, zz):
        return JL.category_reg_loss(zz, c, jnp.asarray(labels))

    jval, (jgc, jgz) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(centers), jnp.asarray(z))

    lw_opt = opt.deepcopy()
    for k in lw_opt.loss_weight:
        if k != "category_reg":
            lw_opt.loss_weight[k] = None
    zt = torch.from_numpy(z).requires_grad_(True)
    var = edict(rgb_recon=torch.zeros(B, 1, 3), proj_latent_sdf=zt,
                category_label=torch.from_numpy(labels))
    loss = graph.with_opt(lw_opt).compute_loss(var)
    assert set(loss) == {"category_reg"}
    loss.category_reg.backward()
    np.testing.assert_allclose(float(loss.category_reg), float(jval),
                               rtol=1e-6)
    for got, want in ((graph.category_centers.grad, jgc), (zt.grad, jgz)):
        want = np.asarray(want)
        assert np.isfinite(got.numpy()).all() and np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_centres_train_in_full_steps_only(base_opt, tmp_path):
    """`--loss_weight.category_reg=1` trains in the port: the term is in
    every step's losses; the camera step (optim_V, the estimator only)
    leaves the centres alone, the full step (optim_full) moves them."""
    from shapeclipper_torch.config import options
    opt = options.load_options(
        os.path.join(REPO, "options/synthetic/config.yaml"))
    opt.update(image_size=[32, 32], batch_size=2, seed=0, resume=False,
               load=None, tb=None, output_path=str(tmp_path), max_epoch=1)
    opt.H, opt.W = opt.image_size
    opt.data.update(num_workers=0, max_img_cat=2)
    opt.render.update(rand_sample=16, n_samples_uniform=8)
    opt.arch.enc_pretrained = False
    opt.tpu.update(encoder_dtype="float32", implicit_dtype="float32")
    opt.loss_weight.category_reg = 1.0
    # the synthetic samples are all of category 0: three centres give the
    # cross-entropy something to separate
    opt.data.num_classes = 3
    opt.freq.update(save_vis=10 ** 6, ckpt_latest=10 ** 6)
    runner = Runner(opt, "cpu")
    runner.load_dataset(opt)
    runner.build_networks(opt)
    runner.setup_optimizer(opt)
    runner.restore_checkpoint(opt)
    centers = runner.graph.category_centers
    assert any(p is centers for g in runner.optim_full.param_groups
               for p in g["params"])
    assert not any(p is centers for g in runner.optim_V.param_groups
                   for p in g["params"])
    var = batch_to_var(next(iter(runner.train_loader)), "cpu")
    before = centers.detach().clone()
    loss = runner.train_iteration(opt, var)
    assert "category_reg" in loss and np.isfinite(float(loss.category_reg))
    assert torch.equal(centers.detach(), before)
    loss = runner.train_iteration(opt, var)
    assert "category_reg" in loss
    assert not torch.equal(centers.detach(), before)


def test_converter_carries_centres_and_moments(jax_state, tmp_path):
    """scripts/jax_ckpt_to_torch.py on a JAX checkpoint that holds the
    centres and an optim_full Adam state with moments for them: the port's
    checkpoint keeps both, and `--resume` restores them strictly."""
    opt, params, stats = jax_state
    opt = opt.deepcopy()
    opt.output_path = str(tmp_path)
    tx = jax_optimizer(opt, params, lambda p: True)
    rng = np.random.RandomState(3)
    grads = jax.tree_util.tree_map(
        lambda a: np.asarray(rng.randn(*np.shape(a)), np.float32), params)
    _, state = jax.jit(tx.update)(grads, tx.init(params), params)
    jckpt.save_checkpoint(str(tmp_path), {"params": params,
                                          "batch_stats": stats},
                          optim_states={"optim_full": state}, ep=0, it=1,
                          latest=True)
    joptions.save_options_file(opt)
    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_to_torch", os.path.join(REPO, "scripts",
                                          "jax_ckpt_to_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    script.convert(str(tmp_path / "latest.ckpt"), str(tmp_path / "latest.pt"))

    opt.resume = True
    runner = Runner(opt, "cpu")
    runner.build_networks(opt)
    runner.setup_optimizer(opt)
    runner.restore_checkpoint(opt)
    centers = runner.graph.category_centers
    np.testing.assert_array_equal(centers.detach().numpy(),
                                  params["category_centers"])
    adam = jckpt.load_raw(str(tmp_path / "latest.ckpt"))["optim_full"][
        "inner_states"]["train"]["inner_state"]["0"]
    st = runner.optim_full.state[centers]
    assert float(st["step"]) == 1.0
    for key, moment in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        want = np.asarray(adam[moment]["category_centers"])
        assert np.abs(want).max() > 0
        np.testing.assert_array_equal(st[key].numpy(), want)
