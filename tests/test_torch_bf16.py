"""The port's bf16 products of the fused SDF pair against the JAX package's.

JAX side: `shapeclipper_tpu.ops.fused_sdf.fused_sdf_forward` /
`fused_sdf_train` with `mm_dtype="bfloat16"` (`_mm_cast`: every product
inside the Pallas kernels rounds both operands to bfloat16 and accumulates
in float32), run in interpret mode on the CPU. Port side: the same functions
of `shapeclipper_torch.ops.fused_sdf` on CPU tensors, i.e. the plain version
of K1-bf16 / K3-bf16 / K2-bf16 (`_CastProduct`). Weights come through
`shapeclipper_torch.bridge`, inputs from numpy seeds.

Tolerances, and why. The two frameworks round the same operands, but their
float32 sums run in different orders, and a sum one float32 ulp apart can
round to the neighbouring bfloat16 operand (2^-8 relative) in the next
layer; sigmoid(100 z) amplifies such a flip in the tangents up to 25x. Each
test also measures the port's own float32-to-bf16 gap on the same inputs
and asserts that every bound lies under half of it, so that a port that
quietly computed in float32 would fail; the bounds sit between the two
(measured at these inputs, max abs):
  * forward, geometric init: sdf / feature 5.7e-5 from JAX against a gap of
    5.3e-3 (bound 3e-4), gradient 7.5e-4 against 7.7e-3 (bound 2e-3);
  * forward, nn.Linear's init: sdf / feature 6e-8 against 1.9e-4 (bound
    5e-5), gradient 4.2e-4 against 1.9e-3 (bound 8e-4);
  * training gradients, relative to max|ref|: the parameters' up to 2.3e-4
    against gaps of 1.8e-3 or more (bound 5e-4), the points' 1.5e-3 against
    2.6e-2 (bound 3e-3), the output bias's 8e-7 against 4.4e-5 (bound
    1e-5: its gradient sums the cotangents, which no product rounds).

The bf16 ResNets and BatchNorm are checked in tests/test_torch_bf16_resnet.py
and a bf16 training step in tests/test_torch_bf16_step.py. The kernels
themselves need the card: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapeclipper_tpu.models.implicit import SDFNetwork as JaxSDFNetwork
from shapeclipper_tpu.ops.fused_sdf import fused_sdf_forward as jax_fused
from shapeclipper_tpu.ops.fused_sdf import fused_sdf_train as jax_fused_train
from shapeclipper_torch.bridge import mlp_state_from_flax
from shapeclipper_torch.models.implicit import SDFNetwork
from shapeclipper_torch.ops import fused_sdf as F

torch.set_num_threads(2)

# (sdf / feature, gradient) atol per initialisation (geometric_init)
FWD_ATOL = {True: (3e-4, 2e-3), False: (5e-5, 8e-4)}
# training gradients: atol times max|ref|, by name (default: the rest)
TRAIN_ATOL = {"points": 3e-3, "lin5.bias": 1e-5}
TRAIN_ATOL_DEFAULT = 5e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nets(geometric_init, seed=0):
    jnet = JaxSDFNetwork(geometric_init=geometric_init)
    params = _np(jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4, 3)),
                           jnp.zeros((1, 4, 64)))["params"])
    net = SDFNetwork(geometric_init=geometric_init)
    net.load_state_dict(mlp_state_from_flax(params))
    return params, net


def _inputs(seed, B=2, N=700):
    """N = 700 fills no tile of either side's kernels; batch row 1 is row 0
    mirrored in x, and the first points sit exactly on x0 = 0."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-0.6, 0.6, size=(1, N, 3)).astype(np.float32)
    pts[0, :8, 0] = 0.0
    pts = np.concatenate([pts, pts * np.array([-1, 1, 1], np.float32)], 0)
    lat = (rng.randn(1, 64) * 0.3).astype(np.float32)
    return pts[:B], np.repeat(lat, B, axis=0)


def _gap(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("geometric_init", [True, False])
@pytest.mark.parametrize("compute_grad", [True, False])
def test_bf16_forward_matches_jax(geometric_init, compute_grad):
    params, net = _nets(geometric_init)
    pts, lat = _inputs(1)
    want = jax_fused(params, jnp.asarray(pts), jnp.asarray(lat),
                     compute_grad=compute_grad, mm_dtype="bfloat16")
    tp, tl = torch.from_numpy(pts), torch.from_numpy(lat)
    with torch.inference_mode():
        got = F.fused_sdf_forward(net, tp, tl, compute_grad,
                                  mm_dtype="bfloat16")
        f32 = F.fused_sdf_forward(net, tp, tl, compute_grad)
    sdf_atol, grad_atol = FWD_ATOL[geometric_init]
    for name, g, w, g32, atol in zip(("sdf", "feat", "grad"), got, want, f32,
                                     (sdf_atol, sdf_atol, grad_atol)):
        if w is None:
            assert g is None and not compute_grad
            continue
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol,
                                   rtol=0, err_msg=name)
        assert atol < 0.5 * _gap(g, g32), (name, atol, _gap(g, g32))


def _sdf_loss(s, f, g, norm):
    return (s ** 2).mean() + (f ** 2).mean() + ((norm(g) - 1) ** 2).mean()


def _port_train_grads(net, pts, lat, mm_dtype):
    net.zero_grad()
    p = torch.from_numpy(pts).requires_grad_(True)
    lt = torch.from_numpy(lat).requires_grad_(True)
    s, f, g = F.fused_sdf_train(net, p, lt, mm_dtype=mm_dtype)
    _sdf_loss(s, f, g, lambda x: x.norm(dim=-1)).backward()
    out = {n: q.grad.numpy().copy() for n, q in net.named_parameters()}
    out.update(points=p.grad.numpy().copy(), latent=lt.grad.numpy().copy())
    return out


@pytest.mark.parametrize("B,N,plane", [
    pytest.param(2, 300, False, id="False"),
    pytest.param(2, 300, True, id="True"),
    # the edges of K2-bf16's 64-point tiles (csrc/fused_sdf_bwd_bf16.cu)
    pytest.param(3, 129, False, id="B3-N129"),
    pytest.param(3, 65, True, id="B3-N65-plane"),
])
def test_bf16_train_gradients_match_jax(B, N, plane):
    """B = 2, N = 300 (ragged for the JAX kernel's 256-point tiles), and
    B = 3 with N one past two or one past one of K2-bf16's 64-point tiles;
    dense weights: the gradients of a loss on
    (sdf, feat, grad) with respect to the points, the latent and every SDF
    parameter, through the port's plain bf16 pair and JAX's bf16 Pallas
    pair; with `plane` every third point lies on x = 0."""
    rng = np.random.RandomState(4)
    pts = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    if plane:
        pts[:, ::3, 0] = 0.0
    lat = (rng.randn(B, 64) * 0.3).astype(np.float32)
    params, net = _nets(False, seed=2)

    def jloss(prm, x, l):
        out = jax_fused_train(prm, x, l, interpret=True, mm_dtype="bfloat16")
        return _sdf_loss(*out, lambda v: jnp.linalg.norm(v, axis=-1))

    gp, gx, gl = jax.grad(jloss, argnums=(0, 1, 2))(
        params, jnp.asarray(pts), jnp.asarray(lat))
    want = {k: v.numpy() for k, v in mlp_state_from_flax(_np(gp)).items()}
    want.update(points=np.asarray(gx), latent=np.asarray(gl))
    got = _port_train_grads(net, pts, lat, "bfloat16")
    f32 = _port_train_grads(net, pts, lat, "float32")
    assert set(got) == set(want)
    for k, w in want.items():
        atol = (TRAIN_ATOL.get(k, TRAIN_ATOL_DEFAULT)
                * max(float(np.abs(w).max()), 1e-3))
        np.testing.assert_allclose(got[k], w, atol=atol, rtol=0, err_msg=k)
        assert atol < 0.5 * _gap(got[k], f32[k]), (k, atol,
                                                   _gap(got[k], f32[k]))


def test_cast_product_rounds_operands_before_each_product():
    """`_CastProduct`: the forward is the float32 product of the two
    operands rounded to bfloat16; the backward rounds the cotangent and the
    saved operands, so each of its products is exact in float32 too."""
    rng = np.random.RandomState(0)
    a = torch.from_numpy(rng.randn(2, 3, 5, 16).astype(np.float32))
    w = torch.from_numpy(rng.randn(16, 8).astype(np.float32))
    g = torch.from_numpy(rng.randn(2, 3, 5, 8).astype(np.float32))
    a.requires_grad_(True)
    w.requires_grad_(True)
    out = F._CastProduct.apply(a, w)
    out.backward(g)
    r = lambda t: t.detach().to(torch.bfloat16).double()  # noqa: E731
    torch.testing.assert_close(out.double(), r(a) @ r(w), rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(a.grad.double(), r(g) @ r(w).t(), rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(
        w.grad.double(), r(a).reshape(-1, 16).t() @ r(g).reshape(-1, 8),
        rtol=1e-6, atol=1e-6)


def test_unknown_mm_dtype_raises():
    _, net = _nets(True)
    pts, lat = _inputs(2, B=1, N=5)
    for fn in (F.fused_sdf_forward, F.fused_sdf_train):
        with pytest.raises(ValueError, match="mm_dtype"):
            fn(net, torch.from_numpy(pts), torch.from_numpy(lat),
               mm_dtype="float16")
