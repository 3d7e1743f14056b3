"""The port's modules against the JAX package's, on the same weights (through
`shapeclipper_torch.bridge`) and the same seeded numpy inputs, in float32
on the CPU.

Tolerances: 1e-5 for camera algebra, posenc and the MLPs (same fp32 math,
different summation order); after the conv/BN chains of the ResNets the
accumulation order of the two frameworks' convolutions differs, so those
compare at 1e-4 relative to the output scale (see CLAUDE.md on CPU conv
accumulation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shapeclipper_tpu.camera as jcam
from shapeclipper_tpu.models import embedder as jemb
from shapeclipper_tpu.models.estimator import Estimator as JaxEstimator
from shapeclipper_tpu.models.graph import pose_from_trig as jax_pose_from_trig
from shapeclipper_tpu.models.implicit import (RGBNetwork as JaxRGB,
                                              SDFNetwork as JaxSDF)
from shapeclipper_tpu.models.layers import LatentProjection as JaxLatentProj
from shapeclipper_tpu.models.resnet import resnet18 as jax_resnet18
from shapeclipper_tpu.models.resnet import resnet34 as jax_resnet34
import shapeclipper_torch.camera as tcam
from shapeclipper_torch import bridge
from shapeclipper_torch.models import embedder as temb
from shapeclipper_torch.models.estimator import Estimator
from shapeclipper_torch.models.graph import pose_from_trig
from shapeclipper_torch.models.implicit import RGBNetwork, SDFNetwork
from shapeclipper_torch.models.layers import LatentProjection
from shapeclipper_torch.models.resnet import resnet18, resnet34

torch.set_num_threads(2)
TIGHT = dict(atol=1e-5, rtol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomize_stats(stats, seed):
    """Non-trivial BN running statistics, so eval mode is really tested."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.uniform(0.5, 1.5, a.shape) if a.ndim and
                   np.all(np.asarray(a) == 1) else rng.randn(*a.shape) * 0.1
                   ).astype(np.float32), _np(stats))


def _randomize_bn_scales(params, seed):
    rng = np.random.RandomState(seed)

    def walk(node, bn):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if bn and k == "scale":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif bn and k == "bias":
                out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            else:
                out[k] = walk(v, "bn" in k)
        return out

    return walk(_np(params), False)


def _load(module, state, prefix=""):
    own = module.state_dict()
    sd = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    sd.update({k: v for k, v in own.items()
               if k.endswith("num_batches_tracked") and k not in sd})
    module.load_state_dict(sd, strict=True)
    return module.eval()


# ---------------------------------------------------------------- camera
def test_camera_matches_jax(base_opt):
    rng = np.random.RandomState(0)
    opt = base_opt.deepcopy()
    opt.H, opt.W = 6, 5
    B = 3
    trig = [rng.randn(B, 2).astype(np.float32) for _ in range(3)]
    trig = [t / np.linalg.norm(t, axis=-1, keepdims=True) for t in trig]
    ang = rng.uniform(-3, 3, B).astype(np.float32)
    for name in ("azim_to_rotation_matrix", "elev_to_rotation_matrix",
                 "roll_to_rotation_matrix"):
        for x, rep in ((trig[0], "trig"), (ang, "rad"), (ang * 30, "angle")):
            np.testing.assert_allclose(
                getattr(tcam, name)(torch.from_numpy(x), rep).numpy(),
                np.asarray(getattr(jcam, name)(jnp.asarray(x), rep)), **TIGHT)
    R = jcam.azim_to_rotation_matrix(jnp.asarray(trig[0]), "trig")
    t = rng.randn(B, 3).astype(np.float32)
    jp = jcam.compose([jcam.pose(R=R), jcam.pose(t=jnp.asarray(t))])
    tp = tcam.compose([tcam.pose(R=torch.from_numpy(np.array(R))),
                       tcam.pose(t=torch.from_numpy(t))])
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TIGHT)
    X = rng.randn(B, 7, 3).astype(np.float32)
    np.testing.assert_allclose(
        tcam.cam2world(torch.from_numpy(X), tp).numpy(),
        np.asarray(jcam.cam2world(jnp.asarray(X), jp)), **TIGHT)
    sf = rng.uniform(0.8, 1.2, B).astype(np.float32)
    ti = tcam.get_intr(opt, torch.from_numpy(sf))
    ji = jcam.get_intr(opt, jnp.asarray(sf))
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **TIGHT)
    np.testing.assert_allclose(
        tcam.img2cam(torch.from_numpy(X), ti).numpy(),
        np.asarray(jcam.img2cam(jnp.asarray(X), ji)), atol=1e-5, rtol=1e-4)
    tc, tr = tcam.get_center_and_ray(opt, tp, intr=ti)
    jc, jr = jcam.get_center_and_ray(opt, jp, intr=ji)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TIGHT)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(
        tcam.pixel_grid_xy(4, 4, "orthographic").numpy(),
        np.asarray(jcam.pixel_grid_xy(4, 4, "orthographic")), **TIGHT)


def test_pose_from_trig_matches_jax(base_opt):
    rng = np.random.RandomState(1)
    B = 4
    trig = [rng.randn(B, 2).astype(np.float32) for _ in range(3)]
    trig = [t / np.linalg.norm(t, axis=-1, keepdims=True) for t in trig]
    sf = rng.uniform(0.9, 1.1, B).astype(np.float32)
    sd = rng.uniform(0.8, 1.2, B).astype(np.float32)
    tp, ti = pose_from_trig(base_opt, *[torch.from_numpy(x)
                                        for x in trig + [sf, sd]])
    jp, ji = jax_pose_from_trig(base_opt, *[jnp.asarray(x)
                                            for x in trig + [sf, sd]])
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TIGHT)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **TIGHT)


def test_posenc_matches_jax():
    x = np.random.RandomState(2).uniform(-1, 1, (5, 9, 3)).astype(np.float32)
    np.testing.assert_allclose(
        temb.positional_encoding(torch.from_numpy(x), 6).numpy(),
        np.asarray(jemb.positional_encoding(jnp.asarray(x), 6)), **TIGHT)
    assert temb.posenc_dim(6) == jemb.posenc_dim(6) == 39


# ------------------------------------------------------------ implicit MLPs
@pytest.mark.parametrize("geometric_init", [True, False])
def test_sdf_network_matches_jax(geometric_init):
    rng = np.random.RandomState(3)
    pts = rng.uniform(-0.8, 0.8, (2, 50, 3)).astype(np.float32)
    lat = (rng.randn(2, 64) * 0.3).astype(np.float32)
    jnet = JaxSDF(geometric_init=geometric_init)
    params = _np(jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 3)),
                           jnp.zeros((1, 4, 64)))["params"])
    net = SDFNetwork(geometric_init=geometric_init)
    net.load_state_dict(bridge.mlp_state_from_flax(params))
    with torch.inference_mode():
        out = net(torch.from_numpy(pts), torch.from_numpy(lat))
    ref = jnet.apply({"params": params}, jnp.asarray(pts), jnp.asarray(lat))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TIGHT)


def test_sdf_geometric_init_structure():
    """Same zero pattern and sphere bias as the JAX init."""
    net = SDFNetwork(generator=torch.Generator().manual_seed(0))
    assert float(net.lin0.weight.detach()[:, 3:].abs().max()) == 0.0
    assert float(net.lin1.weight.detach()[:, 64 + 3:].abs().max()) == 0.0
    assert float(net.lin0.weight.detach()[:, :3].abs().max()) > 0.0
    np.testing.assert_allclose(net.lin5.bias.detach().numpy(), -0.5)


def test_rgb_network_matches_jax():
    rng = np.random.RandomState(4)
    pts = rng.uniform(-0.8, 0.8, (2, 40, 3)).astype(np.float32)
    lat = (rng.randn(2, 64) * 0.3).astype(np.float32)
    feat = rng.randn(2, 40, 64).astype(np.float32)
    jnet = JaxRGB()
    params = _np(jnet.init(jax.random.PRNGKey(1), jnp.zeros((1, 4, 3)),
                           jnp.zeros((1, 4, 64)),
                           jnp.zeros((1, 4, 64)))["params"])
    net = RGBNetwork()
    net.load_state_dict(bridge.mlp_state_from_flax(params))
    with torch.inference_mode():
        out = net(*[torch.from_numpy(x) for x in (pts, lat, feat)])
    ref = jnet.apply({"params": params}, *[jnp.asarray(x)
                                           for x in (pts, lat, feat)])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TIGHT)


# ----------------------------------------------------------------- encoders
def test_latent_projection_matches_jax():
    x = np.random.RandomState(5).randn(3, 512).astype(np.float32)
    jmod = JaxLatentProj(512, 64)
    v = jmod.init(jax.random.PRNGKey(2), jnp.zeros((1, 512)), train=False)
    params = _randomize_bn_scales(v["params"], 6)
    stats = _randomize_stats(v["batch_stats"], 7)
    out = {}
    bridge._latent_proj(out, "p", params, stats)
    mod = _load(LatentProjection(512, 64), out, "p.")
    with torch.inference_mode():
        got = mod(torch.from_numpy(x))
    ref = jmod.apply({"params": params, "batch_stats": stats},
                     jnp.asarray(x), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("depth", [18, 34])
def test_resnet_matches_jax(depth):
    x = np.random.RandomState(8).uniform(0, 1, (2, 32, 32, 3)).astype(
        np.float32)
    jnet = (jax_resnet18 if depth == 18 else jax_resnet34)(num_classes=10)
    v = jax.jit(lambda k: jnet.init(k, jnp.zeros((1, 32, 32, 3)),
                                    train=False))(jax.random.PRNGKey(3))
    params = _randomize_bn_scales(v["params"], 9)
    stats = _randomize_stats(v["batch_stats"], 10)
    out = {}
    bridge._resnet(out, "r", params, stats)
    net = _load((resnet18 if depth == 18 else resnet34)(num_classes=10), out,
                "r.")
    with torch.inference_mode():
        got = net(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.jit(lambda v, x: jnet.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x)))
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, atol=1e-4 * scale, rtol=1e-4)


def test_estimator_matches_jax(base_opt):
    x = np.random.RandomState(11).uniform(0, 1, (3, 32, 32, 3)).astype(
        np.float32)
    jest = JaxEstimator.from_opt(base_opt)
    v = jax.jit(lambda k: jest.init(k, jnp.zeros((1, 32, 32, 3)),
                                    train=False))(jax.random.PRNGKey(4))
    params = _randomize_bn_scales(v["params"], 12)
    # move the heads away from their init so every output is non-trivial
    rng = np.random.RandomState(13)
    for head in ("extr_fc", "size_fc", "perspect_fc"):
        params[head] = {k: (rng.randn(*a.shape) * 0.05).astype(np.float32)
                        for k, a in params[head].items()}
    stats = _randomize_stats(v["batch_stats"], 14)
    out = {}
    bridge._resnet(out, "feature_extractor", params["ResNet_0"],
                   stats["ResNet_0"])
    for head in ("extr", "size", "perspect"):
        bridge._bottleneck(out, f"{head}_head", params[f"{head}_head"],
                           stats[f"{head}_head"])
        bridge._dense(out, f"{head}_fc", params[f"{head}_fc"])
    est = _load(Estimator.from_opt(base_opt), out)
    with torch.inference_mode():
        got = est(torch.from_numpy(x))
    ref = jax.jit(lambda v, x: jest.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    for name in ("trig_azim", "trig_elev", "trig_theta", "scale_focal",
                 "scale_dist"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


def test_estimator_init_matches_jax_structure(base_opt):
    """Fresh init: elev = theta = angle 0 and scales exactly 1."""
    est = Estimator.from_opt(base_opt,
                             generator=torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(np.random.RandomState(15).uniform(
        0, 1, (2, 32, 32, 3)).astype(np.float32))
    with torch.inference_mode():
        out = est(x)
    np.testing.assert_allclose(out.trig_elev.numpy(), [[1, 0]] * 2, atol=1e-6)
    np.testing.assert_allclose(out.trig_theta.numpy(), [[1, 0]] * 2,
                               atol=1e-6)
    np.testing.assert_allclose(out.scale_dist.numpy(), 1.0, atol=1e-6)
