"""The port's fused SDF forward against the JAX package's.

JAX side: `shapeclipper_tpu.ops.fused_sdf.fused_sdf_forward`, the Pallas
kernel run in interpret mode on the CPU (as tests/test_fused_sdf.py runs it).
Port side: `shapeclipper_torch.ops.fused_sdf.fused_sdf_forward` on CPU
tensors, i.e. the kernel's plain PyTorch version. Both get the same weights
(through `shapeclipper_torch.bridge`) and the same seeded numpy inputs.

Tolerances follow tests/test_fused_sdf.py: sdf / feature atol 2e-5 (fp32,
different summation order); gradient atol 5e-4, rtol 5e-3 (the tangent rows
pass through sigmoid(100 z), which amplifies rounding in z by up to 25x).

The kernel itself needs the card: its tests are in
tests/test_torch_cuda.py (marked `cuda`, no JAX).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapeclipper_tpu.models.implicit import SDFNetwork as JaxSDFNetwork
from shapeclipper_tpu.ops.fused_sdf import fused_sdf_forward as jax_fused
from shapeclipper_torch.bridge import mlp_state_from_flax
from shapeclipper_torch.models.implicit import SDFNetwork, sdf_with_gradient
from shapeclipper_torch.ops import fused_sdf as F

torch.set_num_threads(2)

SDF_TOL = dict(atol=2e-5, rtol=0)
GRAD_TOL = dict(atol=5e-4, rtol=5e-3)


def _nets(geometric_init, seed=0):
    jnet = JaxSDFNetwork(geometric_init=geometric_init)
    params = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4, 3)),
                       jnp.zeros((1, 4, 64)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    net = SDFNetwork(geometric_init=geometric_init)
    net.load_state_dict(mlp_state_from_flax(params))
    return params, net


def _inputs(seed, B=2, N=700):
    """N = 700 is a multiple of none of the tiles (512 TPU, 32 / 128 card);
    batch row 1 is row 0 mirrored in x, and the first points sit exactly on
    the symmetry plane x0 = 0."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-0.6, 0.6, size=(1, N, 3)).astype(np.float32)
    pts[0, :8, 0] = 0.0
    pts = np.concatenate([pts, pts * np.array([-1, 1, 1], np.float32)], 0)
    lat = (rng.randn(1, 64) * 0.3).astype(np.float32)
    return pts[:B], np.repeat(lat, B, axis=0)


@pytest.mark.parametrize("geometric_init", [True, False])
@pytest.mark.parametrize("compute_grad", [True, False])
def test_fused_forward_matches_jax(geometric_init, compute_grad):
    params, net = _nets(geometric_init)
    pts, lat = _inputs(1)
    js, jf, jg = jax_fused(params, jnp.asarray(pts), jnp.asarray(lat),
                           compute_grad=compute_grad)
    with torch.inference_mode():
        ts, tf, tg = F.fused_sdf_forward(net, torch.from_numpy(pts),
                                         torch.from_numpy(lat),
                                         compute_grad=compute_grad)
    assert ts.shape == (2, 700, 1) and tf.shape == (2, 700, 64)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **SDF_TOL)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **SDF_TOL)
    if compute_grad:
        assert tg.shape == (2, 700, 3)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **GRAD_TOL)
    else:
        assert tg is None and jg is None


def test_symmetry_flip_and_plane():
    """Mirroring x leaves sdf unchanged and flips grad_x; on x0 = 0 exactly
    the sign is +1 (`x < 0 ? -1 : 1`), as in the JAX kernel."""
    params, net = _nets(False, seed=3)
    pts, lat = _inputs(2)
    with torch.inference_mode():
        s, _, g = F.fused_sdf_forward(net, torch.from_numpy(pts),
                                      torch.from_numpy(lat), True)
    np.testing.assert_allclose(s[0].numpy(), s[1].numpy(), atol=1e-6)
    np.testing.assert_allclose(g[0, 8:, 0].numpy(), -g[1, 8:, 0].numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(g[0, :, 1:].numpy(), g[1, :, 1:].numpy(),
                               atol=1e-6)
    # on the plane both rows see x0 = +0 / -0: identical gradients
    np.testing.assert_allclose(g[0, :8].numpy(), g[1, :8].numpy(), atol=1e-6)
    _, _, jg = jax_fused(params, jnp.asarray(pts[:, :8]),
                         jnp.asarray(lat), compute_grad=True)
    np.testing.assert_allclose(g[:, :8].numpy(), np.asarray(jg), **GRAD_TOL)


def test_plain_matches_module_and_autograd():
    """The plain version equals SDFNetwork.forward, and its forward-mode
    gradient equals autograd's (away from the x0 = 0 kink)."""
    _, net = _nets(False, seed=5)
    pts, lat = _inputs(4, N=257)
    pts = torch.from_numpy(pts[:, 8:])
    lat = torch.from_numpy(lat)
    s, f, g = F.fused_sdf_forward_reference(net, pts, lat, compute_grad=True)
    rs, rf, rg = sdf_with_gradient(net, pts, lat)
    np.testing.assert_allclose(s.detach().numpy(), rs.numpy(), atol=1e-6)
    np.testing.assert_allclose(f.detach().numpy(), rf.numpy(), atol=1e-6)
    np.testing.assert_allclose(g.detach().numpy(), rg.numpy(), atol=1e-5)


def test_cpu_calls_never_count_as_launches():
    _, net = _nets(True)
    pts, lat = _inputs(6, B=1, N=33)
    before = dict(F.KERNEL.launches)
    F.fused_sdf_forward(net, torch.from_numpy(pts), torch.from_numpy(lat),
                        True)
    assert F.KERNEL.launches == before


def test_wrapper_refuses_unknown_devices():
    _, net = _nets(True)
    with pytest.raises(ValueError):
        F.fused_sdf_forward(net, torch.zeros(1, 4, 3, device="meta"),
                            torch.zeros(1, 64, device="meta"))
