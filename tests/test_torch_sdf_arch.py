"""SDF MLPs other than the flagship's, through the port's fused SDF path,
against the JAX package on the CPU in float32.

The CUDA path runs these architectures through the generic pair K8 / K9
(`csrc/fused_sdf_generic.cu`); on the CPU the wrappers take the plain
versions, which are what these tests hold against JAX's `sdf_with_gradient`
(autodiff of the flax module) and `sdf_fwdmode_xla` (its forward-mode
formulation, the semantics of the Pallas pair). The architectures: the JAX
package's own second one (tests/test_fused_sdf.py::
test_fwdmode_xla_nondefault_arch: posenc 4, skip (2,), 4 x 32, latent 16,
no symmetry), a deep one of odd width (7 x 45, skips (2, 5)), and one
without positional encoding (pos_enc 0). Inputs are drawn with numpy from
fixed seeds; each point set puts a third of its points on the x = 0 plane,
where the |x0| symmetry's derivative is +1 on both sides.

Tolerances: sdf, feature, point gradient and every gradient of the
eikonal-style loss rtol 1e-5 and atol 1e-5 times the larger of 1 and the
reference's largest magnitude (`close`): float32 sums in another order.
The scale matters for the deep network alone, whose loss gradients reach
37 in magnitude: there both frameworks' float32 results sit ~1e-4 from the
port's float64 one (points: JAX 2.2e-4, the port 8.7e-5), so an absolute
1e-5 would test float32 rounding, not the port. The Runner's training step and
serving forward at the narrow architecture keep the tolerances of
tests/test_torch_train.py and tests/test_torch_serve.py, whose set-ups they
reuse.
"""

import importlib.util
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapeclipper_tpu.models.graph import Graph as JaxGraph
from shapeclipper_tpu.models.implicit import SDFNetwork as JaxSDF
from shapeclipper_tpu.models.implicit import sdf_with_gradient
from shapeclipper_tpu.ops.fused_sdf import (
    prepare_fused_params as jax_prepare, sdf_fwdmode_xla)
from shapeclipper_tpu.utils import checkpoint as jckpt
from shapeclipper_torch import bridge
from shapeclipper_torch.models.implicit import SDFNetwork
from shapeclipper_torch.ops import fused_sdf as F
from shapeclipper_torch.train.trainer import Runner, tpu_keys_note
from shapeclipper_torch.utils.easydict import EasyDict as tedict
from tests import test_torch_serve as serve
from tests import test_torch_train as train
from tests.torch_tmp import tmp_path  # noqa: F401

torch.set_num_threads(2)
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOL = 1e-5


def close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=TOL, atol=TOL * max(float(np.abs(want).max()), 1.0),
        err_msg=what)

# (posenc, skips, hidden layers, width, latent, force_symmetry)
ARCHS = {
    "jax_test": (4, (2,), 4, 32, 16, False),
    "deep_odd": (6, (2, 5), 7, 45, 8, True),
    "no_posenc": (0, (1,), 3, 24, 12, True),
}
NARROW = ARCHS["jax_test"]


def _nets(spec, seed=0):
    """The flax network with its params (geometric init plus noise, so that
    every layer's posenc and latent rows are dense) and the port's network
    holding the same weights."""
    n_freqs, skips, hidden, width, latent, sym = spec
    kw = dict(posenc_res=n_freqs, skip_in=skips, n_hidden=hidden,
              n_channels=width, proj_latent_dim=latent, force_symmetry=sym)
    jnet = JaxSDF(**kw)
    params = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4, 3)),
                       jnp.zeros((1, latent)))["params"]
    rng = np.random.RandomState(seed)
    params = {name: {k: (np.asarray(v) + rng.randn(*v.shape) * 0.05)
                     .astype(np.float32) for k, v in lin.items()}
              for name, lin in params.items()}
    net = SDFNetwork(**kw)
    net.load_state_dict(bridge.mlp_state_from_flax(params))
    return jnet, params, net


def _inputs(spec, B=2, N=50, seed=1):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    pts[:, ::3, 0] = 0.0
    lat = (rng.randn(B, spec[4]) * 0.3).astype(np.float32)
    return pts, lat


def _jax_fns(spec, jnet):
    """JAX's two formulations, jitted (eager dispatch is the slow part)."""
    n_freqs, skips, hidden, _, _, sym = spec
    return {
        "sdf_with_gradient": jax.jit(lambda p, x, l: sdf_with_gradient(
            jnet.apply, p, x, l)),
        "sdf_fwdmode_xla": jax.jit(lambda p, x, l: sdf_fwdmode_xla(
            p, x, l, n_freqs=n_freqs, skip_in=skips, n_hidden=hidden,
            force_symmetry=sym))}


def _loss(s, f, g, norm):
    return (s ** 2).mean() + (f ** 2).mean() + ((norm(g) - 1) ** 2).mean()


@pytest.mark.parametrize("name", list(ARCHS))
def test_forward_matches_jax(name):
    """fused_sdf_forward with and without the point gradient."""
    spec = ARCHS[name]
    jnet, params, net = _nets(spec)
    pts, lat = _inputs(spec)
    with torch.no_grad():
        got = F.fused_sdf_forward(net, torch.from_numpy(pts),
                                  torch.from_numpy(lat), compute_grad=True)
        nograd = F.fused_sdf_forward(net, torch.from_numpy(pts),
                                     torch.from_numpy(lat))
    assert got[1].shape == (2, 50, spec[3]) and nograd[2] is None
    for fn_name, fn in _jax_fns(spec, jnet).items():
        want = fn(params, jnp.asarray(pts), jnp.asarray(lat))
        for part, g, w in zip(("sdf", "feat", "grad"), got, want):
            close(g.numpy(), w, f"{fn_name} {part}")
        for part, g, w in zip(("sdf", "feat"), nograd, want):
            close(g.numpy(), w, f"{fn_name} {part} (no grad)")


@pytest.mark.parametrize("name", list(ARCHS))
def test_train_gradients_match_jax(name):
    """fused_sdf_train's outputs and the gradients of an eikonal-style loss
    with respect to every parameter, the points and the latent."""
    spec = ARCHS[name]
    jnet, params, net = _nets(spec, seed=2)
    pts, lat = _inputs(spec, seed=3)
    p = torch.from_numpy(pts).requires_grad_(True)
    lt = torch.from_numpy(lat).requires_grad_(True)
    out = F.fused_sdf_train(net, p, lt)
    _loss(*out, lambda v: v.norm(dim=-1)).backward()
    got = {n: q.grad.numpy() for n, q in net.named_parameters()}
    got.update(points=p.grad.numpy(), latent=lt.grad.numpy())

    for fn_name, fn in _jax_fns(spec, jnet).items():
        def jloss(prm, x, l):
            return _loss(*fn(prm, x, l), lambda v: jnp.linalg.norm(v, axis=-1))

        want_out = fn(params, jnp.asarray(pts), jnp.asarray(lat))
        for part, g, w in zip(("sdf", "feat", "grad"), out, want_out):
            close(g.detach().numpy(), w, f"{fn_name} {part}")
        gp, gx, gl = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
            params, jnp.asarray(pts), jnp.asarray(lat))
        want = {k: v.numpy() for k, v in bridge.mlp_state_from_flax(
            jax.tree_util.tree_map(np.asarray, gp)).items()}
        want.update(points=np.asarray(gx), latent=np.asarray(gl))
        assert set(want) == set(got)
        for k, w in want.items():
            close(got[k], w, f"{fn_name} {k}")


def test_route_picks_the_kernels_by_architecture():
    """The flagship goes to K1 / K3 + K2, every other architecture of the
    envelope to K8 / K9 (its edges included), anything outside raises a
    ValueError that names the envelope."""
    assert F.sdf_route(F.FLAGSHIP) == "flagship"
    assert F.ROUTES["flagship"] == ("K1", "K3", "K2")
    assert F.ROUTES["generic"] == ("K8", "K8-nograd", "K9")
    assert F.sdf_route(SDFNetwork()) == "flagship"
    for spec in ARCHS.values():
        assert F.sdf_route(_nets(spec)[2]) == "generic"
    for arch in (F.SdfArch(6, (1, 2), 5, 65), F.SdfArch(6, (1,), 5, 64),
                 F.SdfArch(5, (1, 2), 5, 64), F.SdfArch(6, (1, 2), 6, 64),
                 F.SdfArch(0, (), 1, 1), F.SdfArch(16, tuple(range(1, 17)),
                                                   16, 512),
                 F.SdfArch(6, (4,), 8, 256)):
        assert F.sdf_route(arch) == "generic", arch
    for arch in (F.SdfArch(6, (4,), 8, 513), F.SdfArch(6, (4,), 8, 0),
                 F.SdfArch(6, (), 17, 64), F.SdfArch(6, (), 0, 64),
                 F.SdfArch(17, (), 4, 64), F.SdfArch(6, (0,), 4, 64),
                 F.SdfArch(6, (5,), 4, 64)):
        with pytest.raises(ValueError, match="n_channels 1-512, "
                           "n_hidden_layers 1-16, pos_enc 0-16"):
            F.sdf_route(arch)
    assert "generic pair (K8 / K8-nograd + K9)" in F.route_note(
        F.SdfArch(6, (4,), 8, 256))
    assert "flagship's kernels (K1 / K3 + K2)" in F.route_note(F.FLAGSHIP)
    assert "outside" in F.route_note(F.SdfArch(6, (4,), 8, 1024))


@pytest.mark.parametrize("name", list(ARCHS) + ["flagship"])
def test_packing_matches_jax_layout(name):
    """pack_fused_params lays out what JAX's prepare_fused_params returns,
    kernel after kernel (a skip layer's h rows, then its posenc rows), and
    the biases side by side; its sizes are the architecture's; unpacking
    gives the same views back."""
    spec = ARCHS.get(name, (6, (1, 2), 5, 64, 64, True))
    n_freqs, skips, hidden, width, latent, _ = spec
    _, params, net = _nets(spec)
    _, lat = _inputs(spec)
    with torch.no_grad():
        weights, bias = F.pack_fused_params(
            *F.prepare_fused_params(net, torch.from_numpy(lat)))
    jk, jb = jax_prepare(params, jnp.asarray(lat), n_freqs, skips, hidden)
    want_w = np.concatenate([np.asarray(k).ravel() for pair in jk
                             for k in pair if k is not None])
    want_b = np.concatenate([np.asarray(b) for b in jb], axis=1)
    np.testing.assert_allclose(weights.numpy(), want_w, rtol=0, atol=0)
    close(bias.numpy(), want_b, "biases")
    arch = F.sdf_arch(net)
    assert weights.numel() == arch.num_weights
    assert bias.shape == (lat.shape[0], arch.bias_width)
    if name == "flagship":
        assert (arch.num_weights, arch.bias_width) == (F.NUM_WEIGHTS,
                                                       F.BIAS_WIDTH)
    kernels, biases = F.unpack_fused_params(weights, bias, arch)
    for (a, b), (ja, jbk) in zip(kernels, jk):
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        assert (b is None) == (jbk is None)
        if b is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(jbk))
    np.testing.assert_array_equal(torch.cat(biases, 1).numpy(), bias.numpy())


def test_generic_wrappers_refuse_what_the_kernels_do_not_take():
    """K8 / K9's wrappers check every operand before they build or launch:
    CPU tensors, another dtype, a wrong bias width or cotangent shape."""
    arch = F.SdfArch(*NARROW[:4])
    pts, w = torch.zeros(2, 5, 3), torch.zeros(arch.num_weights)
    b = torch.zeros(2, arch.bias_width)
    cots = (torch.zeros(2, 5), torch.zeros(2, 5, arch.width),
            torch.zeros(2, 5, 3))
    for args in ((pts, w, b), (pts, w.double(), b), (pts, w, b[:, 1:])):
        with pytest.raises(TypeError, match="contiguous float32"):
            F.GENERIC.forward(*args, arch, True, False)
    for bad in ((cots[0][:, :4],) + cots[1:], cots[:2] + (cots[1],)):
        with pytest.raises(TypeError, match="contiguous float32"):
            F.GENERIC.backward(pts, w, b, arch, *bad, False)
    assert F.GENERIC.lib is None


def test_pack_refuses_kernels_of_another_shape():
    _, _, net = _nets(NARROW)
    kernels, biases = F.prepare_fused_params(net, torch.zeros(1, NARROW[4]))
    kernels[2] = (kernels[2][0][:, :-1], kernels[2][1])
    with pytest.raises(AssertionError):
        F.pack_fused_params(kernels, biases)


def test_generic_plain_versions_match_the_modules():
    """The plain versions of K8 / K9 on the packed operands (what the card
    checks its kernels against) give fused_sdf_forward's outputs and
    autograd's gradients through fused_sdf_train."""
    spec = ARCHS["deep_odd"]
    _, _, net = _nets(spec, seed=4)
    pts, lat = map(torch.from_numpy, _inputs(spec, seed=5))
    arch = F.sdf_arch(net)
    with torch.no_grad():
        w, b = F.pack_fused_params(*F.prepare_fused_params(net, lat))
        got = F.generic_forward_reference(pts, w, b, arch, True, True)
        want = F.fused_sdf_forward(net, pts, lat, compute_grad=True)
    for g, v in zip(got, (want[0][..., 0], want[1], want[2])):
        torch.testing.assert_close(g, v, rtol=0, atol=0)
    rng = np.random.RandomState(6)
    cots = [torch.from_numpy(rng.randn(*s).astype(np.float32))
            for s in ((2, 50), (2, 50, spec[3]), (2, 50, 3))]
    dw, db, dp = F.generic_backward_reference(pts, w, b, arch, *cots, True)
    wl = w.clone().requires_grad_(True)
    bl = b.clone().requires_grad_(True)
    pl = pts.clone().requires_grad_(True)
    kernels, biases = F.unpack_fused_params(wl, bl, arch)
    out = F._forward_plain(kernels, biases, pl, arch.n_freqs, arch.skip_in,
                           arch.n_hidden, True, True)
    torch.autograd.backward((out[0][..., 0], out[1], out[2]), cots)
    for g, v in ((dw, wl.grad), (db, bl.grad), (dp, pl.grad)):
        torch.testing.assert_close(g, v, rtol=0, atol=0)


# ------------------------------------------------ the Runner at NARROW
def _narrow(opt):
    n_freqs, skips, hidden, width, latent, _ = NARROW
    opt.arch.impl_sdf.update(pos_enc=n_freqs, skip_connection=list(skips),
                             n_hidden_layers=hidden, n_channels=width,
                             proj_latent_dim=latent)
    return opt


def test_train_step_matches_jax_at_the_narrow_arch(base_opt, tmp_path):
    """One full Runner step (batch 4, train-mode BatchNorm) at the narrow
    SDF MLP against the JAX step, with tests/test_torch_train.py's set-up
    and tolerances; the step's log line names the generic pair."""
    opt = _narrow(train.train_opt(base_opt, tmp_path, "vjp"))
    params, stats = train.perturbed_state(opt)
    assert params["sdf_network"]["lin0"]["kernel"].shape == (27 + 16, 32)
    batch = train.make_batch(opt)
    key = jax.random.PRNGKey(5)
    run = SimpleNamespace(
        opt=opt, params=params, stats=stats, batch=batch,
        draws=train.step_draws(key, opt),
        full=train.jax_step(opt, params, stats, batch, key, False))
    runner = train.check_step(run, camera=False)
    assert F.sdf_route(runner.graph.sdf_network) == "generic"
    assert "generic pair (K8 / K8-nograd + K9)" in tpu_keys_note(opt)


def test_eval_forward_and_grid_matches_jax_at_the_narrow_arch(base_opt,
                                                              tmp_path):
    """Runner.eval_forward_and_grid (the serving forward and the level
    grid) at batch 4 against JAX's forward and compute_level_grid, with
    tests/test_torch_serve.py's set-up and tolerances."""
    from shapeclipper_tpu.eval3d import metrics as jmetrics
    opt = _narrow(serve._small_opt(base_opt, tmp_path))
    state = jax.jit(JaxGraph(opt).init)(jax.random.PRNGKey(0))
    params, stats = serve._perturb(state["params"], state["batch_stats"])
    images = np.random.RandomState(1).uniform(0, 1, (4, 32, 32, 3)).astype(
        np.float32)
    opt_e = opt.deepcopy()
    opt_e.H, opt_e.W = opt.eval.image_size
    graph, graph_eval = JaxGraph(opt), JaxGraph(opt_e)
    jvar, _, _ = graph_eval.forward(
        params, stats, {"rgb_input_map": jnp.asarray(images),
                        "idx": np.arange(4)}, rng=None, training=False,
        get_loss=False)
    jlevel = jmetrics.compute_level_grid(opt_e, graph.sdf_network.apply,
                                         params["sdf_network"],
                                         jvar.proj_latent_sdf)
    runner = serve._port_runner(opt, params, stats)
    var = tedict(idx=np.arange(4), rgb_input_map=torch.from_numpy(images))
    var, level = runner.eval_forward_and_grid(var)
    assert var.proj_latent_sdf.shape == (4, NARROW[4])
    for key in ("proj_latent_sdf", "proj_latent_rgb"):
        ref = np.asarray(jvar[key])
        serve._close(var[key], ref, 1e-5, float(np.abs(ref).max()))
    for key in ("rgb_recon_map", "mask_recon_map", "normal_recon_map",
                "depth_recon"):
        assert var[key].shape == jvar[key].shape, key
        serve._close(var[key], jvar[key], 1e-4)
    assert level.shape == (4, 9, 9, 9)
    serve._close(level, np.asarray(jlevel), 1e-5)


def test_jax_checkpoint_of_the_narrow_arch_converts(base_opt, tmp_path):
    """scripts/jax_ckpt_to_torch.py converts a JAX checkpoint of the
    narrow architecture; the port's Runner loads it strictly and runs a
    training iteration on it."""
    opt = _narrow(serve._small_opt(base_opt, tmp_path / "run"))
    state = jax.jit(JaxGraph(opt).init)(jax.random.PRNGKey(3))
    params, stats = serve._perturb(state["params"], state["batch_stats"], 3)
    run_dir = tmp_path / "run"
    jckpt.save_checkpoint(str(run_dir), {"params": params,
                                         "batch_stats": stats},
                          ep=1, it=5, best_val=0.5, latest=True, best=True)
    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_to_torch", os.path.join(REPO, "scripts",
                                          "jax_ckpt_to_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    script.convert(str(run_dir / "best.ckpt"), str(run_dir / "best.pt"))
    opt.resume = True
    runner = Runner(opt, "cpu")
    runner.build_networks(opt)
    runner.restore_checkpoint(opt, best=True)
    want = bridge.state_dict_from_flax(params, stats)
    got = runner.graph.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
    assert runner.graph.sdf_network.lin2.weight.shape == (32, 32 + 27 + 16)
    assert F.sdf_route(runner.graph.sdf_network) == "generic"
