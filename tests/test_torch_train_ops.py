"""The port's training building blocks against the JAX package's, on the CPU
in float32: train-mode BatchNorm, `fused_sdf_train` (the plain version of
the K1 + K2 pair) and every loss term.

Tolerances:
  * BatchNorm: running statistics after one train-mode call and train-mode
    outputs 1e-4 relative to their scale (the moments of the same
    activations; only the convolutions' accumulation order differs; the
    largest error measured is 2.1e-5 on a running variance of 1.45, while
    the unbiased update of nn.BatchNorm*d would be off by ~0.07).
  * fused_sdf_train: the loss and tolerances of tests/test_fused_sdf.py:
    sdf / feature 2e-5, gradient 1e-4; parameter, latent and point gradients
    atol 3e-5 * max|ref| and rtol 2e-4.
  * losses: 1e-5 relative for values and gradients (same formulas, same
    inputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapeclipper_tpu import losses as JL
from shapeclipper_tpu.models.estimator import Estimator as JaxEstimator
from shapeclipper_tpu.models.implicit import SDFNetwork as JaxSDF
from shapeclipper_tpu.models.implicit import sdf_with_gradient as jax_sdf_grad
from shapeclipper_tpu.models.layers import LatentProjection as JaxLatentProj
from shapeclipper_tpu.models.resnet import resnet18 as jax_resnet18
from shapeclipper_tpu.ops.fused_sdf import fused_sdf_train as jax_fused_train
from shapeclipper_torch import bridge
from shapeclipper_torch import losses as TL
from shapeclipper_torch.models.estimator import Estimator
from shapeclipper_torch.models.implicit import SDFNetwork
from shapeclipper_torch.models.layers import LatentProjection, batch_stats_frozen
from shapeclipper_torch.models.resnet import resnet18
from shapeclipper_torch.ops.fused_sdf import fused_sdf_train

torch.set_num_threads(2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomize(stats, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.uniform(0.5, 1.5, a.shape) if np.all(np.asarray(a) == 1)
                   else rng.randn(*a.shape) * 0.1).astype(np.float32),
        _np(stats))


def _estimator_state(params, stats):
    out = {}
    bridge._resnet(out, "feature_extractor", params["ResNet_0"],
                   stats["ResNet_0"])
    for head in ("extr", "size", "perspect"):
        bridge._bottleneck(out, f"{head}_head", params[f"{head}_head"],
                           stats[f"{head}_head"])
        bridge._dense(out, f"{head}_fc", params[f"{head}_fc"])
    return out


def _case(name, base_opt):
    """(JAX module, input, port module, state_dict writer)."""
    rng = np.random.RandomState(1)
    if name == "latent_projection":
        x = rng.randn(3, 512).astype(np.float32)
        return (JaxLatentProj(512, 64), x, LatentProjection(512, 64),
                lambda p, s: _prefixed(bridge._latent_proj, p, s))
    x = rng.uniform(0, 1, (3, 64, 64, 3)).astype(np.float32)
    if name == "resnet18":
        return (jax_resnet18(num_classes=10), x, resnet18(num_classes=10),
                lambda p, s: _prefixed(bridge._resnet, p, s))
    return (JaxEstimator.from_opt(base_opt), x, Estimator.from_opt(base_opt),
            _estimator_state)


def _prefixed(fn, p, s):
    out = {}
    fn(out, "m", p, s)
    return {k[2:]: v for k, v in out.items()}


def _running(state):
    return {k: v for k, v in state.items() if "running" in k}


@pytest.mark.parametrize("name", ["latent_projection", "resnet18",
                                  "estimator"])
def test_batchnorm_train_mode_matches_jax(base_opt, name):
    """One train-mode call at batch 3: the running statistics move by
    0.1 * the BIASED batch variance, as GroupBatchNorm's (nn.BatchNorm*d
    would use the unbiased one, 3/2 times larger here)."""
    jmod, x, mod, to_state = _case(name, base_opt)
    v = jax.jit(lambda k: jmod.init(k, jnp.asarray(x[:1]), train=False))(
        jax.random.PRNGKey(0))
    params, stats = _np(v["params"]), _randomize(v["batch_stats"], 2)
    mod.load_state_dict(to_state(params, stats))
    mod.train()
    got = mod(torch.from_numpy(x))
    ref, mut = jax.jit(lambda v, x: jmod.apply(
        v, x, train=True, mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    want = _running(to_state(params, _np(mut["batch_stats"])))
    have = _running(mod.state_dict())
    assert set(have) == set(want) and want
    for k, w in want.items():
        scale = float(w.abs().max())
        torch.testing.assert_close(have[k], w, atol=1e-4 * scale, rtol=1e-4,
                                   msg=k)
    pairs = ([(got, ref)] if name != "estimator" else
             [(getattr(got, f), getattr(ref, f)) for f in got._fields])
    for g, r in pairs:
        r = np.asarray(r)
        np.testing.assert_allclose(g.detach().numpy(), r,
                                   atol=1e-4 * float(np.abs(r).max()),
                                   rtol=1e-4)


def test_batchnorm_frozen_stats_pass(base_opt):
    """The flipped cam_sym pass: batch statistics, running stats untouched
    (JAX discards that pass's update, models/graph.py:740-749)."""
    jmod, x, mod, to_state = _case("estimator", base_opt)
    v = jax.jit(lambda k: jmod.init(k, jnp.asarray(x[:1]), train=False))(
        jax.random.PRNGKey(1))
    params, stats = _np(v["params"]), _randomize(v["batch_stats"], 3)
    mod.load_state_dict(to_state(params, stats))
    mod.train()
    before = {k: v.clone() for k, v in _running(mod.state_dict()).items()}
    with batch_stats_frozen(mod):
        got = mod(torch.from_numpy(x))
    for k, v in _running(mod.state_dict()).items():
        assert torch.equal(v, before[k]), k
    ref, _ = jax.jit(lambda v, x: jmod.apply(
        v, x, train=True, mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    for f in got._fields:
        np.testing.assert_allclose(getattr(got, f).detach().numpy(),
                                   np.asarray(getattr(ref, f)), atol=1e-4,
                                   rtol=1e-4, err_msg=f)
    mod(torch.from_numpy(x))   # the context restored the updates
    assert any(not torch.equal(v, before[k])
               for k, v in _running(mod.state_dict()).items())


@pytest.mark.parametrize("mode", ["per_replica", "global"])
def test_graph_encode_bn_modes_match_jax(base_opt, mode):
    """`tpu.bn_mode: per_replica` with `bn_replicas: 2` at batch 4 (the case
    of tests/test_group_bn.py::test_per_replica_bn_matches_split_forward):
    every BatchNorm of `Graph.encode` normalises each half of the batch with
    its own moments and the running statistics follow the first half, as
    the JAX package's `Graph.encode`; `global` takes the whole batch's
    moments.

    Conditioning: a train-mode BatchNorm over two samples divides by their
    difference, so the two frameworks' rounding of the convolutions
    (~1e-6) comes out of the ResNet34 at 3e-5 of its scale, and out of the
    latent projections' two-sample BatchNorms at up to 2e-2 when two
    samples' codes nearly coincide, as they do for a seeded encoder on
    noise images (JAX's own per-replica encode and its split forward
    differ by 0.97 at 32 x 32). So 64 x 64 inputs, the encoder's fc kernel
    scaled by 1000 to spread the codes apart, and 1e-4 of the scale for
    the outputs and the encoder's running statistics, as the other
    BatchNorm tests here. The latent projections' statistics of two nearly
    parallel codes come from E[x^2] - E[x]^2 with cancellation; their
    per-replica arithmetic is held on well-separated inputs by
    test_latent_projection_per_replica_matches_jax."""
    from shapeclipper_tpu.models.graph import Graph as JaxGraph
    from shapeclipper_torch.models.graph import Graph

    opt = base_opt.deepcopy()
    opt.H = opt.W = 64
    opt.tpu.update(bn_mode=mode, bn_replicas=2, encoder_dtype="float32",
                   implicit_dtype="float32")
    opt.arch.enc_pretrained = False
    jg = JaxGraph(opt)
    assert jg.bn_replicas == (2 if mode == "per_replica" else 1)
    state = jax.jit(jg.init)(jax.random.PRNGKey(0))
    params, stats = _np(state["params"]), _np(state["batch_stats"])
    params["encoder"]["fc"]["kernel"] = params["encoder"]["fc"]["kernel"] * 1e3
    imgs = np.random.RandomState(1).uniform(
        0, 1, (4, 64, 64, 3)).astype(np.float32)
    ps, pr, lat, new_stats = jax.jit(
        lambda p, s, x: jg.encode(p, s, x, True, False))(
        params, stats, jnp.asarray(imgs))

    graph = Graph(opt)
    assert graph.bn_replicas == jg.bn_replicas
    graph.load_state_dict(bridge.state_dict_from_flax(params, stats))
    graph.train()
    got = graph.encode(torch.from_numpy(imgs))
    for g, w in zip(got, (ps, pr, lat)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()))
    want = {k: v for k, v in _running(bridge.state_dict_from_flax(
        params, _np(new_stats))).items() if k.startswith("encoder.")}
    have = {k: v for k, v in _running(graph.state_dict()).items()
            if k.startswith("encoder.")}
    assert set(have) == set(want) and want
    for k, w in want.items():
        torch.testing.assert_close(have[k], w, rtol=0,
                                   atol=1e-4 * float(w.abs().max()))


@pytest.mark.parametrize("replicas", [2, 3])
def test_latent_projection_per_replica_matches_jax(replicas):
    """LatentProjection with `replicas` BatchNorm blocks at batch 12 against
    JAX's with `groups=replicas, stats_groups=(0,)` (what `_apply_bn` hands
    it under per_replica): outputs and running statistics (block 0's) to
    1e-4 of their scale, as the other BatchNorm tests here. Blocks of two
    samples are left out: var = E[x^2] - E[x]^2 over two samples a, b
    divides by |a - b|, and a channel with |a - b| ~ 0.01 turns the two
    frameworks' Dense rounding into 2e-3 (measured)."""
    from shapeclipper_torch.models.layers import set_bn_mode
    jmod = JaxLatentProj(512, 64)
    x = np.random.RandomState(5).randn(12, 512).astype(np.float32)
    v = jax.jit(lambda k: jmod.init(k, jnp.asarray(x[:1]), train=False))(
        jax.random.PRNGKey(3))
    params, stats = _np(v["params"]), _randomize(v["batch_stats"], 4)
    ref, mut = jax.jit(lambda v, x: jmod.apply(
        v, x, train=True, groups=replicas, stats_groups=(0,),
        mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    mod = LatentProjection(512, 64)
    mod.load_state_dict(_prefixed(bridge._latent_proj, params, stats))
    set_bn_mode(mod, replicas=replicas)
    mod.train()
    got = mod(torch.from_numpy(x))
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref).max()))
    want = _running(_prefixed(bridge._latent_proj, params,
                              _np(mut["batch_stats"])))
    for k, w in _running(mod.state_dict()).items():
        torch.testing.assert_close(w, want[k], rtol=0,
                                   atol=1e-4 * float(want[k].abs().max()),
                                   msg=k)


def test_per_replica_encode_is_the_split_forward(base_opt):
    """The port's own per-replica `Graph.encode` at batch 4 equals its
    global-mode encode of each half from the same statistics, bit for bit,
    and its running statistics are the first half's chain
    (test_per_replica_bn_matches_split_forward's assertions)."""
    from shapeclipper_torch.models.graph import Graph

    opt = base_opt.deepcopy()
    opt.H = opt.W = 16
    opt.tpu.update(bn_mode="per_replica", bn_replicas=2)
    opt.arch.enc_pretrained = False
    rep = Graph(opt, generator=torch.Generator().manual_seed(0))
    opt_g = opt.deepcopy()
    opt_g.tpu.bn_mode = "global"
    halves = Graph(opt_g)
    start = {k: v.clone() for k, v in rep.state_dict().items()}
    imgs = torch.from_numpy(np.random.RandomState(1).uniform(
        0, 1, (4, 16, 16, 3)).astype(np.float32))
    rep.train()
    got = rep.encode(imgs)
    halves.train()
    outs = []
    for half in (imgs[:2], imgs[2:]):
        halves.load_state_dict(start)
        outs.append(halves.encode(half))
        if not outs[1:]:
            first = {k: v.clone() for k, v in _running(
                halves.state_dict()).items()}
    for g, h0, h1 in zip(got, *outs):
        assert torch.equal(g, torch.cat([h0, h1])), "outputs"
    for k, v in _running(rep.state_dict()).items():
        assert torch.equal(v, first[k]), k
    glob = Graph(opt_g)
    glob.load_state_dict(start)
    glob.train()
    glob.encode(imgs)
    assert any(not torch.equal(v, _running(glob.state_dict())[k])
               for k, v in _running(rep.state_dict()).items())


# ------------------------------------------------------------ fused_sdf_train
def _sdf_case(B=2, N=300, plane=False):
    rng = np.random.RandomState(4)
    pts = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    if plane:
        pts[:, ::3, 0] = 0.0
    lat = (rng.randn(B, 64) * 0.3).astype(np.float32)
    jnet = JaxSDF(geometric_init=False)
    params = _np(jnet.init(jax.random.PRNGKey(2), jnp.zeros((1, 4, 3)),
                           jnp.zeros((1, 4, 64)))["params"])
    net = SDFNetwork(geometric_init=False)
    net.load_state_dict(bridge.mlp_state_from_flax(params))
    return jnet, params, net, pts, lat


def _loss(s, f, g, norm):
    return (s ** 2).mean() + (f ** 2).mean() + ((norm(g) - 1) ** 2).mean()


@pytest.mark.parametrize("plane", [False, True])
def test_fused_sdf_train_matches_jax(plane):
    """B = 2, N = 300 (ragged for the JAX kernel's 256-point tiles); with
    `plane` every third point lies on x = 0, where the |x0| symmetry's
    derivative is taken as +1 by both."""
    jnet, params, net, pts, lat = _sdf_case(plane=plane)
    p = torch.from_numpy(pts).requires_grad_(True)
    lt = torch.from_numpy(lat).requires_grad_(True)
    s, f, g = fused_sdf_train(net, p, lt)
    _loss(s, f, g, lambda x: x.norm(dim=-1)).backward()

    def jloss(prm, x, l, fn):
        return _loss(*fn(prm, x, l), lambda v: jnp.linalg.norm(v, axis=-1))

    def pallas(prm, x, l):
        return jax_fused_train(prm, x, l, interpret=True)

    def vjp(prm, x, l):
        return jax_sdf_grad(jnet.apply, prm, x, l)

    for fn in (pallas, vjp):
        js, jf, jg = fn(params, jnp.asarray(pts), jnp.asarray(lat))
        np.testing.assert_allclose(s.detach().numpy(), np.asarray(js),
                                   atol=2e-5)
        np.testing.assert_allclose(f.detach().numpy(), np.asarray(jf),
                                   atol=2e-5)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(jg),
                                   atol=1e-4)
        gp, gx, gl = jax.grad(jloss, argnums=(0, 1, 2))(
            params, jnp.asarray(pts), jnp.asarray(lat), fn)
        want = bridge.mlp_state_from_flax(_np(gp))
        got = {n: q.grad for n, q in net.named_parameters()}
        pairs = [(got[k], want[k].numpy(), k) for k in want]
        pairs += [(p.grad, np.asarray(gx), "points"),
                  (lt.grad, np.asarray(gl), "latent")]
        for a, b, name in pairs:
            scale = max(float(np.abs(b).max()), 1e-3)
            np.testing.assert_allclose(a.numpy(), b, atol=3e-5 * scale,
                                       rtol=2e-4, err_msg=f"{fn.__name__} "
                                       f"{name}")
    net.zero_grad()


def test_fused_sdf_train_detach_latent():
    _, _, net, pts, lat = _sdf_case(B=1, N=64)
    lt = torch.from_numpy(lat).requires_grad_(True)
    fused_sdf_train(net, torch.from_numpy(pts), lt,
                    detach_latent=True)[2].sum().backward()
    assert lt.grad is None or float(lt.grad.abs().max()) == 0.0
    assert float(net.lin0.weight.grad.abs().max()) > 0.0


# --------------------------------------------------------------------- losses
def _both(fn_t, fn_j, *arrays):
    """Value and gradients of a scalar loss w.r.t. every float input."""
    ts = [torch.from_numpy(a).requires_grad_(a.dtype == np.float32)
          if isinstance(a, np.ndarray) else a for a in arrays]
    out = fn_t(*ts)
    out.backward()
    idx = [i for i, a in enumerate(arrays)
           if isinstance(a, np.ndarray) and a.dtype == np.float32]
    jv, jg = jax.value_and_grad(
        lambda *fl: fn_j(*[fl[idx.index(i)] if i in idx else
                           (jnp.asarray(a) if isinstance(a, np.ndarray)
                            else a) for i, a in enumerate(arrays)]),
        argnums=tuple(range(len(idx))))(*[jnp.asarray(arrays[i])
                                         for i in idx])
    np.testing.assert_allclose(float(out.detach()), float(jv), rtol=1e-5,
                               atol=1e-6)
    for k, i in enumerate(idx):
        want = np.asarray(jg[k])
        scale = max(float(np.abs(want).max()), 1e-6)
        np.testing.assert_allclose(ts[i].grad.numpy(), want,
                                   atol=1e-5 * scale, rtol=1e-5)


def _normals(rng, shape):
    n = rng.randn(*shape).astype(np.float32)
    return n / np.linalg.norm(n, axis=-1, keepdims=True)


@pytest.mark.parametrize("tolerance", [0.0, 0.2])
def test_normal_loss_matches_jax(tolerance):
    """With tied angles: the last 12 pixels repeat the angular error of the
    first 12, so the trim's cut falls among equal keys and only a stable
    rank keeps the same pixels as jnp.argsort."""
    rng = np.random.RandomState(0)
    gt = _normals(rng, (2, 40, 3))
    pred = _normals(rng, (2, 40, 3))
    pred[:, 28:] = pred[:, :12]
    gt[:, 28:] = gt[:, :12]
    mask = rng.rand(2, 40, 1) > 0.3
    w = rng.uniform(0.5, 1.5, (2, 1, 1)).astype(np.float32)
    for weight in (None, w):
        _both(lambda p, g, m, ww=weight: TL.normal_loss(
            p, g, m, normal_l1=5.0, tolerance=tolerance,
            weight=None if ww is None else torch.from_numpy(ww)),
            lambda p, g, m, ww=weight: JL.normal_loss(
                p, g, m, normal_l1=5.0, tolerance=tolerance, weight=ww),
            pred, gt, mask)


def test_mask_mse_iou_losses_match_jax():
    rng = np.random.RandomState(1)
    pred = rng.uniform(0.01, 0.99, (2, 30, 1)).astype(np.float32)
    target = (rng.rand(2, 30, 1) > 0.5).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (2, 1, 1)).astype(np.float32)
    _both(lambda p, t: TL.mask_loss(p, t, mask_mse=0.5),
          lambda p, t: JL.mask_loss(p, t, mask_mse=0.5), pred, target)
    _both(lambda p, t: TL.mask_loss(p, t, weight=torch.from_numpy(w)),
          lambda p, t: JL.mask_loss(p, t, weight=jnp.asarray(w)), pred,
          target)
    _both(lambda p, t: TL.iou_loss(p, t, tolerance=0.1),
          lambda p, t: JL.iou_loss(p, t, tolerance=0.1), pred, target)
    rgb = rng.uniform(0, 1, (2, 30, 3)).astype(np.float32)
    _both(lambda p, t: TL.mse_loss(p, t, weight=torch.from_numpy(w)),
          lambda p, t: JL.mse_loss(p, t, weight=jnp.asarray(w)), rgb,
          rgb[::-1].copy())
    _both(lambda p, t: TL.mse_loss(p, t, tolerance=0.2),
          lambda p, t: JL.mse_loss(p, t, tolerance=0.2), rgb,
          rgb[::-1].copy())
    _both(lambda p: TL.mse_loss(p, 1.0), lambda p: JL.mse_loss(p, 1.0),
          rgb[..., 0])
    _both(lambda p, t: TL.bce_loss(p, t, tolerance=0.1),
          lambda p, t: JL.bce_loss(p, t, tolerance=0.1), pred, target)
    _both(lambda p, t: TL.l1_loss(p, t), lambda p, t: JL.l1_loss(p, t),
          pred, target + 0.25)


def test_camera_losses_match_jax(base_opt):
    rng = np.random.RandomState(2)
    trig = [_normals(rng, (6, 2)) for _ in range(6)]
    for t in trig[:2]:   # push some angles past the +-90 degree margins
        t[:2] = np.array([[-0.9, 0.43], [-0.8, -0.6]], np.float32)
    _both(lambda e, t: TL.cam_margin_loss(base_opt, e, t),
          lambda e, t: JL.cam_margin_loss(base_opt, e, t), trig[0], trig[1])
    _both(lambda *t: TL.cam_sym_loss(t[:3], t[3:]),
          lambda *t: JL.cam_sym_loss(t[:3], t[3:]), *trig)
    for emd_p in (1, 2, 3):
        _both(lambda t, p=emd_p: TL.cam_uniform_loss(t, emd_p=p),
              lambda t, p=emd_p: JL.cam_uniform_loss(t, emd_p=p), trig[2])


def test_losses_finite_at_zero_vectors():
    """cam_uniform at its optimum (every sorted difference exactly 0) and
    category_reg with a zero shape code: finite gradients, equal to JAX's."""
    B = 4
    grid = np.arange(1.0, 2 * B, 2.0, dtype=np.float32) * np.float32(np.pi) / B
    trig = np.stack([np.cos(grid), np.sin(grid)], -1).astype(np.float32)
    _both(lambda t: TL.cam_uniform_loss(t[:, :2]),
          lambda t: JL.cam_uniform_loss(t[:, :2]), trig)
    rng = np.random.RandomState(3)
    code = rng.randn(3, 8).astype(np.float32)
    code[1] = 0.0
    centers = rng.randn(2, 8).astype(np.float32)
    labels = np.array([0, 1, 1], np.int32)
    _both(lambda c, k: TL.category_reg_loss(c, k, torch.from_numpy(labels)),
          lambda c, k: JL.category_reg_loss(c, k, jnp.asarray(labels)),
          code, centers)
