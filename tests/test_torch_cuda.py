"""The Hopper kernels of the port against their plain PyTorch versions, on
the card: the fused SDF forward and backward (`shapeclipper_torch/csrc/
fused_sdf_fwd.cu`, K1 / K3 and their bf16 forms with the bf16 weight pack,
`csrc/fused_sdf_bwd.cu`, K2, and `csrc/fused_sdf_bwd_bf16.cu`, K2-bf16), the
generic pair for every other SDF MLP (`csrc/fused_sdf_generic.cu`, K8 /
K9, and their bf16 forms on the tensor cores with their weight pack,
`csrc/fused_sdf_generic_bf16.cu`), the nearest-neighbour sweep (`csrc/chamfer.cu`, K4 / K5) and the device
isosurface (`csrc/isosurface.cu`, K6 / K7).

Every test here is marked `cuda` and skips without an NVIDIA GPU. The file
imports torch and the port only (no JAX), so on a machine with the card
and without JAX it runs as

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerances follow tests/test_fused_sdf.py: sdf / feature atol 2e-5; gradient
atol 5e-4, rtol 5e-3 (sigmoid(100 z) amplifies rounding in the tangents);
K2's parameter, latent and point gradients atol 3e-5 * max|ref|, rtol 2e-4.
K4 / K5 distances rtol 1e-5, atol 1e-7 (the kernel fuses two of the three
squares into multiply-adds); K5's argmin equal to the plain one wherever
the nearest point is not a near-tie (the kernel's choice is at the plain
minimum within that tolerance), and exactly equal on exact ties. K6 / K7
equal to their plain versions (cell sums and faces exactly, points to
1e-5): both round the same float32 steps.
"""

import copy

import numpy as np
import pytest
import torch

from shapeclipper_torch.models.implicit import SDFNetwork
from shapeclipper_torch.ops import chamfer as C
from shapeclipper_torch.ops import fused_sdf as F

SDF_TOL = dict(atol=2e-5, rtol=0.0)
GRAD_TOL = dict(atol=5e-4, rtol=5e-3)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, N, geometric_init, seed=0):
    """Two batch rows, the second the first mirrored in x; the first eight
    points lie exactly on the symmetry plane x0 = 0."""
    g = torch.Generator().manual_seed(seed)
    net = SDFNetwork(geometric_init=geometric_init, generator=g).to(dev)
    net.eval()
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-0.6, 0.6, size=(1, N, 3)).astype(np.float32)
    pts[0, :8, 0] = 0.0
    pts = np.concatenate([pts, pts * np.array([-1, 1, 1], np.float32)], 0)
    lat = np.repeat((rng.randn(1, 64) * 0.3).astype(np.float32), 2, axis=0)
    return net, torch.from_numpy(pts).to(dev), torch.from_numpy(lat).to(dev)


@pytest.mark.parametrize("N", [1, 33, 1000])
@pytest.mark.parametrize("geometric_init", [True, False])
@pytest.mark.parametrize("compute_grad", [True, False])
def test_kernel_matches_plain(dev, N, geometric_init, compute_grad):
    """N = 1, 33 and 1000 leave ragged tails for both tile sizes
    (`F.FWD_TILE_POINTS`); each call is exactly one launch."""
    net, pts, lat = _case(dev, N, geometric_init)
    key = "grad" if compute_grad else "nograd"
    with torch.inference_mode():
        before = F.KERNEL.launches[key]
        s, f, g = F.fused_sdf_forward(net, pts, lat, compute_grad)
        assert F.KERNEL.launches[key] == before + 1
        rs, rf, rg = F.fused_sdf_forward_reference(net, pts, lat,
                                                   compute_grad)
        torch.cuda.synchronize()
    assert s.shape == (2, N, 1) and f.shape == (2, N, 64)
    torch.testing.assert_close(s, rs, **SDF_TOL)
    torch.testing.assert_close(f, rf, **SDF_TOL)
    if compute_grad:
        assert g.shape == (2, N, 3)
        torch.testing.assert_close(g, rg, **GRAD_TOL)
        # mirror symmetry: grad_x flips sign off the plane, equal on it
        torch.testing.assert_close(g[0, 8:, 0], -g[1, 8:, 0], atol=1e-6,
                                   rtol=0.0)
        torch.testing.assert_close(g[0, :8], g[1, :8], atol=1e-6, rtol=0.0)
    else:
        assert g is None and rg is None


def test_wrapper_refuses_gradients_and_bad_inputs(dev):
    net, pts, lat = _case(dev, 40, True)
    with pytest.raises(RuntimeError, match="no backward"):
        F.fused_sdf_forward(net, pts, lat, True)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="contiguous"):
            F.fused_sdf_forward(net, pts.transpose(0, 1).contiguous()
                                .transpose(0, 1), lat)
        with pytest.raises(TypeError, match="float32"):
            F.fused_sdf_forward(net, pts.double(), lat)
        with pytest.raises(ValueError, match="parameters"):
            F.fused_sdf_forward(net.cpu(), pts, lat)


# ---------------------------------------------------------------- K1 + K2
def _fwd_case(dev, B, N, seed=0, plane=False):
    """Dense weights (geometric_init off), points in [-1, 1]^3 (every third
    on the plane x0 = 0 with `plane`), one latent per batch row."""
    g = torch.Generator().manual_seed(seed)
    net = SDFNetwork(geometric_init=False, generator=g).to(dev).eval()
    pts = torch.rand(B, N, 3, generator=g) * 2 - 1
    if plane:
        pts[:, ::3, 0] = 0.0
    lat = torch.randn(B, 64, generator=g) * 0.3
    return net, pts.to(dev), lat.to(dev)


def _fwd_check(net, pts, lat, compute_grad, ref_dtype=torch.float32):
    """K1 / K3 through `fused_sdf_forward` against the plain version, run in
    `ref_dtype`, at the sdf / feature and gradient tolerances."""
    with torch.inference_mode():
        got = F.fused_sdf_forward(net, pts, lat, compute_grad)
        ref_net = copy.deepcopy(net).to(ref_dtype)
        want = F.fused_sdf_forward_reference(
            ref_net, pts.to(ref_dtype), lat.to(ref_dtype), compute_grad)
        torch.cuda.synchronize()
    B, N = pts.shape[:2]
    assert got[0].shape == (B, N, 1) and got[1].shape == (B, N, 64)
    for name, k, r, tol in (("sdf", got[0], want[0], SDF_TOL),
                            ("feat", got[1], want[1], SDF_TOL),
                            ("grad", got[2], want[2], GRAD_TOL)):
        if r is None:
            assert k is None
            continue
        assert torch.isfinite(k).all(), name
        torch.testing.assert_close(k.to(ref_dtype), r, **tol, msg=name)


@pytest.mark.parametrize("offset", [-1, 0, 1])
@pytest.mark.parametrize("compute_grad", [True, False])
def test_forward_kernel_tile_edges(dev, compute_grad, offset):
    """N = tile - 1, tile and tile + 1 points of the instantiation's tile
    (`F.FWD_TILE_POINTS`): a partial, a full, and a full plus one-point
    tile."""
    N = F.FWD_TILE_POINTS["grad" if compute_grad else "nograd"] + offset
    _fwd_check(*_fwd_case(dev, 1, N, seed=N), compute_grad)


@pytest.mark.parametrize("compute_grad", [True, False])
def test_forward_kernel_ragged_batch(dev, compute_grad):
    """B = 3 with a ragged N: blocks take tiles of three batch rows, each
    with a partial last tile."""
    N = 2 * F.FWD_TILE_POINTS["grad" if compute_grad else "nograd"] + 37
    _fwd_check(*_fwd_case(dev, 3, N, seed=5), compute_grad)


@pytest.mark.parametrize("force_symmetry", [True, False])
@pytest.mark.parametrize("compute_grad", [True, False])
def test_forward_kernel_symmetry_plane(dev, compute_grad, force_symmetry):
    """Points on x0 = 0, where sign(0) = +1 in both versions, with the |x|
    symmetry on and off."""
    net, pts, lat = _fwd_case(dev, 2, 500, seed=3, plane=True)
    net.force_symmetry = force_symmetry
    _fwd_check(net, pts, lat, compute_grad)


@pytest.mark.parametrize("compute_grad", [True, False])
def test_forward_kernel_is_deterministic(dev, compute_grad):
    """Two launches on the same inputs are bitwise equal (no atomics, a
    fixed order of every sum)."""
    net, pts, lat = _fwd_case(dev, 3, 5000, seed=9)
    with torch.inference_mode():
        weights, bias = F.pack_fused_params(*F.prepare_fused_params(net, lat))
        first = F.KERNEL.launch(pts, weights, bias, compute_grad, True)
        second = F.KERNEL.launch(pts, weights, bias, compute_grad, True)
        torch.cuda.synchronize()
    for name, a, b in zip(("sdf", "feat", "grad"), first, second):
        if a is None:
            assert b is None and not compute_grad
            continue
        assert torch.isfinite(a).all(), name
        assert torch.equal(a, b), name


def test_forward_kernel_render_shape(dev):
    """K1 at the flagship training render's shape, 12 x 32,768, against the
    plain version in float64 (the rule for any K1 / K2 redesign: at this
    size the float32 plain version is not an oracle)."""
    _fwd_check(*_fwd_case(dev, 12, 32768, seed=11), True,
               ref_dtype=torch.float64)


def _train_grads(net, pts, lat, cots, kernel, detach_latent=False,
                 dtype=torch.float32):
    """Gradients of <cotangents, (sdf, feat, grad)> w.r.t. the parameters,
    the points and the latent: through K1 + K2 (`fused_sdf_train`) or
    through plain autograd of the plain version on the same device, in
    `dtype` (returned as float32)."""
    if dtype != torch.float32:
        net = copy.deepcopy(net).to(dtype)
        pts, lat = pts.to(dtype), lat.to(dtype)
        cots = [c.to(dtype) for c in cots]
    net.zero_grad()
    p = pts.clone().requires_grad_(True)
    l = lat.clone().requires_grad_(True)
    if kernel:
        out = F.fused_sdf_train(net, p, l, detach_latent)
    else:
        kk, bb = F.prepare_fused_params(net, l.detach() if detach_latent
                                        else l)
        out = F._forward_plain(kk, bb, p, *F._arch(net), True,
                               net.force_symmetry)
    sum((o * c).sum() for o, c in zip(out, cots)).backward()
    grads = {n: q.grad.clone() for n, q in net.named_parameters()}
    grads["points"] = p.grad.clone()
    grads["latent"] = (l.grad.clone() if l.grad is not None
                       else torch.zeros_like(l))
    return {k: v.float() for k, v in grads.items()}


def _k2_check(dev, B, N, plane=False, detach_latent=False, unused=False,
              ref_dtype=torch.float32):
    g = torch.Generator().manual_seed(B * 1000 + N)
    net = SDFNetwork(geometric_init=False, generator=g).to(dev)
    pts = torch.rand(B, N, 3, generator=g) * 2 - 1
    if plane:
        pts[:, ::3, 0] = 0.0
    lat = torch.randn(B, 64, generator=g) * 0.3
    cots = [torch.randn(B, N, c, generator=g) for c in (1, 64, 3)]
    if unused:   # the eikonal call: only the point gradient is read
        cots[0].zero_()
        cots[1].zero_()
    pts, lat, cots = pts.to(dev), lat.to(dev), [c.to(dev) for c in cots]
    before = dict(F.KERNEL.launches), F.BACKWARD.launches["float32"]
    got = _train_grads(net, pts, lat, cots, True, detach_latent)
    assert F.KERNEL.launches["grad"] == before[0]["grad"] + 1
    assert F.BACKWARD.launches["float32"] == before[1] + 1
    want = _train_grads(net, pts, lat, cots, False, detach_latent,
                        ref_dtype)
    torch.cuda.synchronize()
    for k, w in want.items():
        scale = max(float(w.abs().max()), 1e-3)
        torch.testing.assert_close(got[k], w, atol=3e-5 * scale, rtol=2e-4,
                                   msg=k)
    if detach_latent:
        assert float(got["latent"].abs().max()) == 0.0


@pytest.mark.parametrize("B,N", [(1, 1), (2, 300), (3, 1000), (12, 1024)])
def test_backward_kernel_matches_plain(dev, B, N):
    """Ragged N (tiles of 32 points), B > 1: K2's weight, bias (so latent)
    and point gradients against plain autograd; one launch each of K1, K2."""
    _k2_check(dev, B, N)


@pytest.mark.parametrize("N", [31, 32, 33, 127, 129])
def test_backward_kernel_tile_edges(dev, N):
    """N one short of, at, and one past a 32-point tile and past four of
    them, at B = 3: the last tile of each batch row is ragged or full, and
    blocks take tiles of two batch rows."""
    _k2_check(dev, 3, N)


def test_backward_kernel_render_shape(dev):
    """The flagship training render's shape, 12 x 32,768 (12,288 tiles on
    one block per SM), against plain autograd of the plain version in
    float64: at 393,216 points the float32 plain version's own rounding
    leaves a few weight and point gradients past the tolerance from the
    float64 ones (`chip_smoke.py` phase 3 logs both errors)."""
    _k2_check(dev, 12, 32768, ref_dtype=torch.float64)


def test_backward_kernel_is_deterministic(dev):
    """Two K2 launches on the same inputs give bitwise equal weight, bias
    and point gradients: fixed tile-to-block assignment, fixed in-block
    order and a block-ordered sum of the per-block partials."""
    g = torch.Generator().manual_seed(7)
    net = SDFNetwork(geometric_init=False, generator=g).to(dev)
    B, N = 4, 3000
    pts = (torch.rand(B, N, 3, generator=g) * 2 - 1).to(dev)
    lat = (torch.randn(B, 64, generator=g) * 0.3).to(dev)
    sbar, fbar, gbar = (torch.randn(B, N, *c, generator=g).to(dev)
                        for c in ((), (64,), (3,)))
    with torch.no_grad():
        weights, bias = F.pack_fused_params(*F.prepare_fused_params(net, lat))
    first = F.BACKWARD.launch(pts, weights, bias, sbar, fbar, gbar, True)
    second = F.BACKWARD.launch(pts, weights, bias, sbar, fbar, gbar, True)
    torch.cuda.synchronize()
    for name, a, b in zip(("weights", "biases", "points"), first, second):
        assert torch.isfinite(a).all(), name
        assert torch.equal(a, b), name


def test_backward_kernel_symmetry_plane(dev):
    """Points on x = 0, where the |x0| sign is +1 in both versions."""
    _k2_check(dev, 2, 300, plane=True)


def test_backward_kernel_detach_latent_and_unused_outputs(dev):
    """The eikonal call: latent detached, sdf and feature unused."""
    _k2_check(dev, 2, 257, detach_latent=True, unused=True)


def test_training_call_launches_k1_and_k2(dev):
    """A CUDA call with gradients runs K1 forward and K2 backward, or
    raises: there is no fallback to the plain version."""
    net, pts, lat = _case(dev, 40, True)
    pts.requires_grad_(True)
    k1, k2 = F.KERNEL.launches["grad"], F.BACKWARD.launches["float32"]
    s, f, g = F.fused_sdf_train(net, pts, lat)
    assert (F.KERNEL.launches["grad"],
            F.BACKWARD.launches["float32"]) == (k1 + 1, k2)
    g.norm(dim=-1).sum().backward()
    assert F.BACKWARD.launches["float32"] == k2 + 1
    with pytest.raises(TypeError, match="float32"):
        F.fused_sdf_train(net, pts.double(), lat)


# ------------------------------------------------- K1 / K3 / K2, bf16 products
# The bf16 instantiations against the plain version with the same bf16
# products (`mm_dtype="bfloat16"`). Kernel and plain version round the same
# operands, but their float32 sums differ in order, and a difference of one
# float32 ulp can move an operand to the neighbouring bfloat16 value (2^-8
# relative): hence tolerances ten times the float32 ones (sdf / feature
# atol 2e-4; gradient atol 5e-3, rtol 5e-3; K2 atol 1e-3 * max|ref|, rtol
# 2e-3: at B x N = 3 x 1,000 one point gradient of 9,000 lay 5.9e-4 * max|ref|
# from the plain version, where the float32 pair lies 1.7e-2 away). Each check also asserts that the kernel lies from its plain
# version under half as far as from the float32 kernel, so that a kernel
# that quietly ran float32 products fails.
BF16_SDF_TOL = dict(atol=2e-4, rtol=0.0)
BF16_GRAD_TOL = dict(atol=5e-3, rtol=5e-3)
BF16_K2_ATOL, BF16_K2_RTOL = 1e-3, 2e-3


def _max_gap(a, b):
    return float((a.float() - b.float()).abs().max())


# the bf16 forward's gates of `chip_smoke.py` phase 5a (`check_bf16`):
# max abs error under a bound that a bf16 flip stays inside and a wrong
# product does not, mean abs error tight and under half the mean distance
# from the float32 kernel
BF16_FWD_MAX = dict(sdf=1e-2, feat=1e-2, grad=3e-2)
BF16_FWD_MEAN = dict(sdf=1e-5, feat=1e-5, grad=2e-5)


def _bf16_fwd_check(net, pts, lat, compute_grad, flips=False):
    """K1-bf16 / K3-bf16 through `fused_sdf_forward`: one weight pack and
    one launch of the instantiation, outputs against the plain version's
    bf16 products and under half as far from it as from the float32
    kernel; at BF16_SDF_TOL / BF16_GRAD_TOL, or with `flips` at phase 5a's
    gates (a float32 sum one ulp apart can round an operand to the
    neighbouring bf16 value and move a point's features by ~3e-4)."""
    key = "grad_bf16" if compute_grad else "nograd_bf16"
    with torch.inference_mode():
        before = dict(F.KERNEL.launches)
        got = F.fused_sdf_forward(net, pts, lat, compute_grad,
                                  mm_dtype="bfloat16")
        assert F.KERNEL.launches[key] == before[key] + 1
        assert F.KERNEL.launches["pack_bf16"] == before["pack_bf16"] + 1
        assert sum(F.KERNEL.launches.values()) == sum(before.values()) + 2
        want = F.fused_sdf_forward_reference(net, pts, lat, compute_grad,
                                             mm_dtype="bfloat16")
        f32 = F.fused_sdf_forward(net, pts, lat, compute_grad)
        torch.cuda.synchronize()
    B, N = pts.shape[:2]
    assert got[0].shape == (B, N, 1) and got[1].shape == (B, N, 64)
    for name, k, r, r32, tol in zip(("sdf", "feat", "grad"), got, want, f32,
                                    (BF16_SDF_TOL, BF16_SDF_TOL,
                                     BF16_GRAD_TOL)):
        if r is None:
            assert k is None and not compute_grad
            continue
        assert k.dtype == torch.float32 and torch.isfinite(k).all(), name
        if flips:
            e = (k - r).abs()
            mean, gap = float(e.mean()), float((k - r32).abs().mean())
            assert float(e.max()) <= BF16_FWD_MAX[name], (name, float(e.max()))
            assert mean <= BF16_FWD_MEAN[name] and mean < 0.5 * gap, (
                name, mean, gap)
            continue
        torch.testing.assert_close(k, r, **tol,
                                   msg=lambda m, name=name: f"{name}: {m}")
        assert _max_gap(k, r) < 0.5 * _max_gap(k, r32), name


@pytest.mark.parametrize("N", [33, 1000])
@pytest.mark.parametrize("compute_grad", [True, False])
def test_bf16_forward_kernel_matches_plain(dev, compute_grad, N):
    """K1-bf16 / K3-bf16 at B = 2 and ragged N, one pack and one launch
    each, against the plain version's bf16 products; farther from the
    float32 kernel."""
    _bf16_fwd_check(*_fwd_case(dev, 2, N, seed=N), compute_grad)


@pytest.mark.parametrize("edge", ["short", "at", "past", "two past"])
@pytest.mark.parametrize("compute_grad", [True, False])
def test_bf16_forward_kernel_tile_edges(dev, compute_grad, edge):
    """B = 3 at one short of, at, one past and two past a warp's tile
    (`F.FWD_TILE_POINTS_BF16`: 8 points with tangents, 32 without), so that
    warps of a block take tiles of several batch rows, some partial; at
    phase 5a's gates."""
    tile = F.FWD_TILE_POINTS_BF16["grad" if compute_grad else "nograd"]
    N = {"short": tile - 1, "at": tile, "past": tile + 1,
         "two past": 2 * tile + 1}[edge]
    _bf16_fwd_check(*_fwd_case(dev, 3, N, seed=N), compute_grad, flips=True)


@pytest.mark.parametrize("compute_grad", [True, False])
def test_bf16_forward_kernel_ragged_batch(dev, compute_grad):
    """B = 3 with a ragged N over many blocks (8 warps a block), at phase
    5a's gates."""
    N = 40 * F.FWD_TILE_POINTS_BF16["grad" if compute_grad else "nograd"] + 5
    _bf16_fwd_check(*_fwd_case(dev, 3, N, seed=7), compute_grad, flips=True)


@pytest.mark.parametrize("force_symmetry", [True, False])
@pytest.mark.parametrize("compute_grad", [True, False])
def test_bf16_forward_kernel_symmetry_plane(dev, compute_grad,
                                            force_symmetry):
    """Every third point on x0 = 0 (sign(0) = +1 in both versions), with
    the |x| symmetry on and off, at phase 5a's gates."""
    net, pts, lat = _fwd_case(dev, 2, 500, seed=3, plane=True)
    net.force_symmetry = force_symmetry
    _bf16_fwd_check(net, pts, lat, compute_grad, flips=True)


@pytest.mark.parametrize("compute_grad", [True, False])
def test_bf16_forward_kernel_is_deterministic(dev, compute_grad):
    """Two K1-bf16 / K3-bf16 launches on the same inputs are bitwise equal
    (no atomics, a fixed order of every sum)."""
    net, pts, lat = _fwd_case(dev, 3, 5000, seed=9)
    with torch.inference_mode():
        weights, bias = F.pack_fused_params(*F.prepare_fused_params(net, lat))
        frags = F.KERNEL.pack_bf16(weights)[0]
        first = F.KERNEL.launch(pts, frags, bias, compute_grad, True,
                                "bfloat16")
        second = F.KERNEL.launch(pts, frags, bias, compute_grad, True,
                                 "bfloat16")
        torch.cuda.synchronize()
    for name, a, b in zip(("sdf", "feat", "grad"), first, second):
        if a is None:
            assert b is None and not compute_grad
            continue
        assert torch.isfinite(a).all(), name
        assert torch.equal(a, b), name


def test_bf16_weight_pack_matches_plain(dev):
    """The pack kernel writes the bf16 fragments and the plain bf16 copy
    bitwise as `pack_bf16_reference` does (one launch), and the training
    call packs once: K1-bf16 reads the fragments, K2-bf16 the copy."""
    net, pts, lat = _fwd_case(dev, 2, 300, seed=4)
    with torch.no_grad():
        weights, _ = F.pack_fused_params(*F.prepare_fused_params(net, lat))
    before = F.KERNEL.launches["pack_bf16"]
    frags, plain = F.KERNEL.pack_bf16(weights)
    assert F.KERNEL.launches["pack_bf16"] == before + 1
    want = F.pack_bf16_reference(weights)
    torch.cuda.synchronize()
    assert frags.shape == (F.BF16_FRAG_ELEMS,) and plain.shape == (
        F.NUM_WEIGHTS,)
    assert torch.equal(frags.view(torch.int16), want[0].view(torch.int16))
    assert torch.equal(plain.view(torch.int16), want[1].view(torch.int16))
    before = dict(F.KERNEL.launches)
    p = pts.clone().requires_grad_(True)
    F.fused_sdf_train(net, p, lat, mm_dtype="bfloat16")[0].sum().backward()
    assert F.KERNEL.launches["pack_bf16"] == before["pack_bf16"] + 1
    assert F.KERNEL.launches["grad_bf16"] == before["grad_bf16"] + 1


@pytest.mark.parametrize("B,N,plane,symmetry", [
    pytest.param(2, 300, False, True, id="2-300"),
    pytest.param(3, 1000, False, True, id="3-1000"),
    # K2-bf16's tile is 64 points (8 warps of 8): one short of, at, and one
    # past a tile, and one past two, with B = 3 (blocks take tiles of two
    # batch rows); the eikonal call's shape
    pytest.param(3, 63, False, True, id="3-63"),
    pytest.param(3, 64, False, True, id="3-64"),
    pytest.param(3, 65, False, True, id="3-65"),
    pytest.param(3, 129, False, True, id="3-129"),
    pytest.param(12, 1024, False, True, id="eikonal"),
    # every third point on x = 0, with the |x0| symmetry and without
    pytest.param(2, 300, True, True, id="plane"),
    pytest.param(2, 300, True, False, id="plane-no-symmetry"),
])
def test_bf16_backward_kernel_matches_plain(dev, B, N, plane, symmetry):
    """K2-bf16 (the tensor-core kernel): the weight, latent and point
    gradients through K1-bf16 + K2-bf16 against plain autograd with
    `_CastProduct`'s bf16 backward products; farther from the float32
    pair."""
    g = torch.Generator().manual_seed(B * 1000 + N)
    net = SDFNetwork(geometric_init=False, generator=g).to(dev)
    net.force_symmetry = symmetry
    pts = torch.rand(B, N, 3, generator=g) * 2 - 1
    if plane:
        pts[:, ::3, 0] = 0.0
    pts = pts.to(dev)
    lat = (torch.randn(B, 64, generator=g) * 0.3).to(dev)
    cots = [torch.randn(B, N, c, generator=g).to(dev) for c in (1, 64, 3)]

    def grads(kernel, mm_dtype):
        net.zero_grad()
        p = pts.clone().requires_grad_(True)
        l = lat.clone().requires_grad_(True)
        if kernel:
            out = F.fused_sdf_train(net, p, l, mm_dtype=mm_dtype)
        else:
            kk, bb = F.prepare_fused_params(net, l)
            out = F._forward_plain(kk, bb, p, *F._arch(net), True,
                                   net.force_symmetry, mm_dtype)
        sum((o * c).sum() for o, c in zip(out, cots)).backward()
        out = {n: q.grad.clone() for n, q in net.named_parameters()}
        out.update(points=p.grad.clone(), latent=l.grad.clone())
        return out

    k2 = F.BACKWARD.launches["bfloat16"]
    got = grads(True, "bfloat16")
    assert F.BACKWARD.launches["bfloat16"] == k2 + 1
    want = grads(False, "bfloat16")
    f32 = grads(True, "float32")
    torch.cuda.synchronize()
    rel = {k: (_max_gap(got[k], w) / max(float(w.abs().max()), 1e-3),
               _max_gap(got[k], f32[k]) / max(float(w.abs().max()), 1e-3))
           for k, w in want.items()}
    for k, w in want.items():
        scale = max(float(w.abs().max()), 1e-3)
        torch.testing.assert_close(
            got[k], w, atol=BF16_K2_ATOL * scale, rtol=BF16_K2_RTOL,
            msg=lambda m, k=k: f"{k}: {m} ({rel[k]})")
    for k in ("points", "latent", "lin0.weight", "lin5.weight"):
        assert _max_gap(got[k], want[k]) < 0.5 * _max_gap(got[k], f32[k]), \
            (k, rel[k])


def test_bf16_backward_kernel_is_deterministic(dev):
    """Two K2-bf16 launches on the same inputs give bitwise equal weight,
    bias and point gradients (per-block partials summed in block order, no
    atomics)."""
    g = torch.Generator().manual_seed(7)
    net = SDFNetwork(geometric_init=False, generator=g).to(dev)
    B, N = 4, 3000
    pts = (torch.rand(B, N, 3, generator=g) * 2 - 1).to(dev)
    lat = (torch.randn(B, 64, generator=g) * 0.3).to(dev)
    sbar, fbar, gbar = (torch.randn(B, N, *c, generator=g).to(dev)
                        for c in ((), (64,), (3,)))
    with torch.no_grad():
        weights, bias = F.pack_fused_params(*F.prepare_fused_params(net, lat))
    w16 = weights.to(torch.bfloat16)
    first = F.BACKWARD.launch(pts, w16, bias, sbar, fbar, gbar, True,
                              "bfloat16")
    second = F.BACKWARD.launch(pts, w16, bias, sbar, fbar, gbar, True,
                               "bfloat16")
    torch.cuda.synchronize()
    for name, a, b in zip(("weights", "biases", "points"), first, second):
        assert torch.isfinite(a).all(), name
        assert torch.equal(a, b), name


def test_bf16_backward_kernel_render_shape(dev):
    """12 x 32,768 (the training render) under `chip_smoke.py` phase 5a's
    gates, on its network and another draw of inputs (seed 11, the render
    drawn first): every gradient's max abs error against the plain
    bf16 backward under 2e-2 x max|ref| (a bf16 flip at one of 393,216
    points stays inside it, a wrong product does not), its mean under
    1e-4 x max|ref| and, but for the output bias's (an unrounded sum in
    both precisions), under half its mean distance from the float32 pair."""
    g = torch.Generator().manual_seed(0)
    net = SDFNetwork(geometric_init=False, generator=g).to(dev)
    g = torch.Generator().manual_seed(11)
    B, N = 12, 32768
    pts = (torch.rand(B, N, 3, generator=g) * 2 - 1).to(dev)
    lat = (torch.randn(B, 64, generator=g) * 0.3).to(dev)
    cots = [torch.randn(B, N, c, generator=g).to(dev) for c in (1, 64, 3)]

    def grads(kernel, mm_dtype):
        net.zero_grad()
        p = pts.clone().requires_grad_(True)
        l = lat.clone().requires_grad_(True)
        if kernel:
            out = F.fused_sdf_train(net, p, l, mm_dtype=mm_dtype)
        else:
            kk, bb = F.prepare_fused_params(net, l)
            out = F._forward_plain(kk, bb, p, *F._arch(net), True, True,
                                   mm_dtype)
        sum((o * c).sum() for o, c in zip(out, cots)).backward()
        out = {n: q.grad.clone() for n, q in net.named_parameters()}
        out.update(points=p.grad.clone(), latent=l.grad.clone())
        return out

    got, want = grads(True, "bfloat16"), grads(False, "bfloat16")
    f32 = grads(True, "float32")
    torch.cuda.synchronize()
    for k, w in want.items():
        scale = max(float(w.abs().max()), 1e-3)
        e = (got[k] - w).abs()
        gap = float((got[k] - f32[k]).abs().mean())
        assert torch.isfinite(got[k]).all(), k
        assert float(e.max()) <= 2e-2 * scale, (k, float(e.max()) / scale)
        assert float(e.mean()) <= 1e-4 * scale, (k, float(e.mean()) / scale)
        if k != "lin5.bias":
            assert float(e.mean()) < 0.5 * gap, (k, float(e.mean()), gap)


def test_bad_mm_dtype_raises(dev):
    """An mm_dtype the kernels lack raises; so do float32 products handed
    the bfloat16 weights, and bf16 products handed the plain bf16 copy.
    Nothing falls back to another instantiation."""
    net, pts, lat = _case(dev, 40, True)
    with torch.inference_mode():
        before = dict(F.KERNEL.launches)
        for bad in ("float16", "bf16", None):
            with pytest.raises(ValueError, match="mm_dtype"):
                F.fused_sdf_forward(net, pts, lat, True, mm_dtype=bad)
        weights, bias = F.pack_fused_params(*F.prepare_fused_params(net, lat))
        with pytest.raises(TypeError, match="float32"):
            F.KERNEL.launch(pts, weights.to(torch.bfloat16), bias, True, True)
        # the bf16 products read the packed fragments, not the plain copy
        with pytest.raises(TypeError, match="fragments"):
            F.KERNEL.launch(pts, weights.to(torch.bfloat16), bias, True, True,
                            "bfloat16")
        assert F.KERNEL.launches == before
    with pytest.raises(ValueError, match="mm_dtype"):
        F.fused_sdf_train(net, pts, lat, mm_dtype="float16")


# ---------------------------------------------------------------- K4 / K5
NN_TOL = dict(rtol=1e-5, atol=1e-7)


def _clouds(dev, B, N1, N2, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, N1, 3, generator=g).to(dev),
            torch.randn(B, N2, 3, generator=g).to(dev))


def _check_argmin(x1, x2, idx, want_d, want_i):
    """idx equals the plain argmin, or points at a plain minimum (a
    near-tie that the kernel's rounding breaks the other way)."""
    chosen = torch.gather(x2, 1, idx.long()[..., None].expand(-1, -1, 3))
    d_chosen = ((x1 - chosen) ** 2).sum(-1)
    differ = idx != want_i
    torch.testing.assert_close(d_chosen[differ], want_d[differ], **NN_TOL)
    assert int(differ.sum()) <= max(1, idx.numel() // 10000)


@pytest.mark.parametrize("B,N1,N2", [(1, 1, 1), (3, 57, 201),
                                     (2, 1000, 3001), (1, 2049, 4097),
                                     (4, 8192, 8192), (1, 2048, 100_000),
                                     (3, 257, 20_001)])
def test_chamfer_kernels_match_plain(dev, B, N1, N2):
    """Ragged rows (blocks of 256) and ragged tiles of B (2,048 points);
    the last two shapes split B's cloud into chunks (`nn_splits`), the last
    with a ragged last chunk; one K4 launch per direction for the
    distances, one K5 launch per direction with the argmin."""
    x1, x2 = _clouds(dev, B, N1, N2)
    before = dict(C.KERNEL.launches)
    d1, d2 = C.chamfer_dists_sq(x1, x2)
    assert C.KERNEL.launches["dist"] == before["dist"] + 2
    k1, k2, i1, i2 = C.chamfer_distance_sq(x1, x2)
    assert C.KERNEL.launches["argmin"] == before["argmin"] + 2
    p1, j1 = C.nn_plain(x1, x2, with_index=True)
    p2, j2 = C.nn_plain(x2, x1, with_index=True)
    torch.cuda.synchronize()
    assert d1.shape == (B, N1) and d2.shape == (B, N2)
    assert i1.dtype == torch.int32 and i1.shape == (B, N1)
    for got, want in ((d1, p1), (d2, p2), (k1, p1), (k2, p2)):
        torch.testing.assert_close(got, want, **NN_TOL)
    _check_argmin(x1, x2, i1, p1, j1)
    _check_argmin(x2, x1, i2, p2, j2)


def test_chamfer_kernel_exact_ties(dev):
    """Identical clouds: distance 0 and argmin = self. Duplicated points
    across tiles of B: the lowest index wins."""
    x1, _ = _clouds(dev, 2, 3000, 1, seed=3)
    d1, d2, i1, i2 = C.chamfer_distance_sq(x1, x1)
    assert float(d1.abs().max()) == 0.0 and float(d2.abs().max()) == 0.0
    self_idx = torch.arange(3000, device=dev, dtype=torch.int32)
    assert torch.equal(i1, self_idx.expand(2, -1))
    assert torch.equal(i2, self_idx.expand(2, -1))
    x2 = torch.cat([x1, x1, x1[:, 7:8].expand(2, 5, 3)], dim=1).contiguous()
    _, d2, i1, i2 = C.chamfer_distance_sq(x1, x2)
    assert torch.equal(i1, self_idx.expand(2, -1))
    want = torch.cat([self_idx, self_idx,
                      torch.full((5,), 7, device=dev, dtype=torch.int32)])
    assert torch.equal(i2, want.expand(2, -1))
    assert float(d2.abs().max()) == 0.0


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


@pytest.mark.parametrize("B,N1,N2", [(1, 100_000, 2048), (3, 257, 20_001)])
def test_chamfer_split_is_bitwise_unsplit(dev, B, N1, N2):
    """K4 and K5 with `nn_splits`'s chunks, in both directions, bitwise
    equal to one chunk (`splits=1`) and to a second launch: the atomic
    combine is exact and independent of the blocks' order."""
    x1, x2 = _clouds(dev, B, N1, N2, seed=5)
    # the direction with the fewer rows splits
    assert C.nn_splits(B, min(N1, N2), max(N1, N2), _sms(dev)) > 1
    for a, b in ((x1, x2), (x2, x1)):
        for with_index in (False, True):
            chosen = C.KERNEL.launch(a, b, with_index)
            one = C.KERNEL.launch(a, b, with_index, splits=1)
            again = C.KERNEL.launch(a, b, with_index)
            torch.cuda.synchronize()
            for other in (one, again):
                assert torch.equal(chosen[0], other[0])
                if with_index:
                    assert torch.equal(chosen[1], other[1])


def test_chamfer_exact_ties_across_chunks(dev):
    """Every point of A twice in B, the two copies in different chunks of a
    split sweep: the lower index wins the atomic combine, in K5 and against
    `splits=1`."""
    g = torch.Generator().manual_seed(6)
    x1 = torch.randn(2, 64, 3, generator=g)
    far = torch.randn(2, 10_000, 3, generator=g) + 50.0
    x2 = torch.cat([far, x1, far, x1], dim=1).to(dev)
    x1 = x1.to(dev)
    first, second = 10_000 + torch.arange(64), 20_064 + torch.arange(64)
    splits = C.nn_splits(2, 64, x2.shape[1], _sms(dev))
    chunk = C.nn_chunk(x2.shape[1], splits)
    assert splits > 1 and bool((first // chunk != second // chunk).all())
    d, i = C.KERNEL.launch(x1, x2, True)
    d1, i1 = C.KERNEL.launch(x1, x2, True, splits=1)
    dk, _ = C.KERNEL.launch(x1, x2, False)
    torch.cuda.synchronize()
    assert float(d.abs().max()) == 0.0 and float(dk.abs().max()) == 0.0
    assert torch.equal(i, first.to(dev, torch.int32).expand(2, -1))
    assert torch.equal(i, i1) and torch.equal(d, d1)


def test_chamfer_gradient_matches_reference(dev):
    """K5 forward + the gather / index_add_ backward against autograd of
    the plain reference, on the card."""
    x1, x2 = _clouds(dev, 2, 300, 500, seed=4)
    grads = []
    for fn in (C.chamfer_distance_sq, C.chamfer_distance_sq_reference):
        a = x1.clone().requires_grad_(True)
        b = x2.clone().requires_grad_(True)
        d1, d2, _, _ = fn(a, b)
        (d1.mean() + 0.5 * d2.mean()).backward()
        grads.append((a.grad, b.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


def test_chamfer_wrapper_refuses_bad_inputs(dev):
    x1, x2 = _clouds(dev, 1, 40, 50)
    with pytest.raises(TypeError, match="float32"):
        C.chamfer_dists_sq(x1.double(), x2.double())
    with pytest.raises(ValueError, match="contiguous"):
        C.chamfer_dists_sq(x1.transpose(1, 2).contiguous().transpose(1, 2),
                           x2)
    with pytest.raises(ValueError, match="is on"):
        C.chamfer_dists_sq(x1, x2.cpu())


def test_eval_submit_copies_the_grid_to_pinned_memory(dev):
    """The pipelined evaluation's stage A: the grid's host copy, waited on
    through its own event, equals the device grid."""
    from shapeclipper_torch.config import options
    from shapeclipper_torch.eval3d import metrics
    from shapeclipper_torch.utils.easydict import EasyDict as edict
    opt = options.load_options("options/pix3d/config.yaml")
    opt.eval.vox_res = 32
    net, _, lat = _case(dev, 1, True)
    with torch.inference_mode():
        pending = metrics.eval_metrics_submit(opt, edict(proj_latent_sdf=lat),
                                              net)
        pending.ready.synchronize()
        assert pending.host.is_pinned() and pending.host.device.type == "cpu"
        assert torch.equal(pending.host, pending.level.cpu())


def _iso_levels():
    """A bumpy ellipsoid (tests/test_device_isosurface.py's), a grid with no
    surface and an exact-ties grid, as one batch of 3 x 25^3."""
    g = np.linspace(-0.6, 0.6, 25).astype(np.float32)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    bumpy = (np.sqrt(X ** 2 + 1.4 * Y ** 2 + 0.7 * Z ** 2) - 0.42
             + 0.05 * np.sin(7 * X) * np.cos(5 * Y + 2 * Z))
    ties = np.random.RandomState(7).randint(-2, 3, size=(25, 25, 25))
    return np.stack([bumpy, np.ones_like(bumpy), ties]).astype(np.float32)


def test_isosurface_kernels_match_plain(dev):
    """K6's cell sums and K7's faces and points equal their plain versions'
    on the same grid, CDF and draws (the kernels round every float32 step as
    the plain version does); the empty grid gives zeros."""
    from shapeclipper_torch.eval3d import device_isosurface as D
    from shapeclipper_torch.ops import isosurface as I
    level = torch.from_numpy(_iso_levels()).to(dev)
    before = dict(I.KERNEL.launches)
    sums = D.cell_area_sums(level)
    torch.testing.assert_close(sums, D.cell_area_sums_plain(level),
                               rtol=0, atol=0)
    cdf = torch.cumsum(sums, dim=1)
    r, u, w = D.surface_draws(3, 50_000, seed=1, device=dev)
    pts, faces = D.draw_points(level, cdf, r, u, w, -0.6, 0.6,
                               with_faces=True)
    want_pts, want_faces = D.draw_points_plain(level, cdf, r, u, w, -0.6,
                                               0.6, with_faces=True)
    assert I.KERNEL.launches == {"area": before["area"] + 1,
                                 "draw": before["draw"] + 1}
    assert torch.equal(faces, want_faces)
    # the evaluation's form stores no face and gives the same points
    assert torch.equal(D.draw_points(level, cdf, r, u, w, -0.6, 0.6), pts)
    torch.testing.assert_close(pts, want_pts, rtol=0, atol=1e-5)
    assert torch.count_nonzero(pts[1]) == 0
    assert bool(torch.isfinite(pts).all())


def test_isosurface_sampler_same_on_card_and_cpu(dev):
    """The same draws give the same points on both devices, to within the
    CDF scan's rounding (a cumsum on the card sums in another order); on
    the card the same seed draws the same numbers twice, from a CUDA
    generator."""
    from shapeclipper_torch.eval3d import device_isosurface as D
    level = torch.from_numpy(_iso_levels()[:1])
    draws = D.surface_draws(1, 20_000, seed=3)
    got = D.sample_level_surface_batch(level.to(dev), 20_000, -0.6, 0.6,
                                       draws=draws).cpu()
    want = D.sample_level_surface_batch(level, 20_000, -0.6, 0.6,
                                        draws=draws)
    same = (got - want).abs().amax(-1) <= 1e-5
    assert int((~same).sum()) <= 2
    seeded = [D.sample_level_surface_batch(level.to(dev), 20_000, -0.6, 0.6,
                                           seed=3) for _ in range(2)]
    assert seeded[0].device.type == "cuda"
    assert torch.equal(seeded[0], seeded[1])


def test_isosurface_wrapper_refuses_bad_inputs(dev):
    from shapeclipper_torch.ops import isosurface as I
    level = torch.zeros(1, 9, 9, 9, device=dev)
    with pytest.raises(TypeError, match="float32"):
        I.KERNEL.cell_areas(level.double())
    with pytest.raises(ValueError, match="M, M, M"):
        I.KERNEL.cell_areas(torch.zeros(1, 9, 9, 8, device=dev))
    with pytest.raises(ValueError, match="no isosurface kernel"):
        I.KERNEL.cell_areas(level.cpu())
    cdf = torch.zeros(1, 512, device=dev, dtype=torch.float64)
    r = torch.zeros(1, 4, device=dev)
    u = torch.zeros(1, 4, 1, device=dev)
    with pytest.raises(TypeError, match="float64"):
        I.KERNEL.draw(level, cdf.float(), r, u, u, -0.6, 0.6)
    with pytest.raises(ValueError, match="is on"):
        I.KERNEL.draw(level, cdf, r.cpu(), u, u, -0.6, 0.6)


# ------------------------------------------------------- the generic pair
GENERIC_ARCHS = {"jax_test": (4, (2,), 4, 32, 16, False),
                 "deep_odd": (6, (2, 5), 7, 45, 8, True),
                 "no_posenc": (0, (1,), 3, 24, 12, True)}


@pytest.mark.parametrize("name", list(GENERIC_ARCHS))
def test_generic_pair_matches_plain(dev, name):
    """K8 (with and without tangents; 3xTF32 on the tensor cores) against
    its plain version at SDF_TOL / GRAD_TOL, K9 against the float64 plain
    version at atol 3e-5 * max|ref|, rtol 2e-4, and two K9 launches bitwise
    equal; 2 x 300 points (a ragged last tile), every third on the x0 = 0
    plane; the routed entry points launch K8 / K9, each after the weights'
    tf32 pack, and not K1 / K2 / K3."""
    n_freqs, skips, hidden, width, latent, sym = GENERIC_ARCHS[name]
    g = torch.Generator().manual_seed(3)
    net = SDFNetwork(proj_latent_dim=latent, n_hidden=hidden,
                     n_channels=width, skip_in=skips, posenc_res=n_freqs,
                     force_symmetry=sym, geometric_init=False,
                     generator=g).to(dev)
    pts = torch.rand(2, 300, 3, generator=g) * 2 - 1
    pts[:, ::3, 0] = 0.0
    pts, lat = pts.to(dev), (torch.randn(2, latent, generator=g) * 0.3).to(dev)
    arch = F.sdf_arch(net)
    assert F.sdf_route(net) == "generic"
    with torch.no_grad():
        w, b = F.pack_fused_params(*F.prepare_fused_params(net, lat))
        for grad in (True, False):
            got = F.GENERIC.forward(pts, w, b, arch, grad, sym)
            want = F.generic_forward_reference(pts, w, b, arch, grad, sym)
            for k, r, tol in zip(got, want, (SDF_TOL, SDF_TOL, GRAD_TOL)):
                if r is not None:
                    torch.testing.assert_close(k, r, **tol)
    cots = [torch.randn(2, 300, *c, generator=g).to(dev)
            for c in ((), (width,), (3,))]
    got = F.GENERIC.backward(pts, w, b, arch, *cots, sym)
    again = F.GENERIC.backward(pts, w, b, arch, *cots, sym)
    want = F.generic_backward_reference(
        *(t.double() for t in (pts, w, b)), arch, *(c.double() for c in cots),
        sym)
    for k, k2, r in zip(got, again, want):
        assert torch.equal(k, k2)
        scale = max(float(r.abs().max()), 1e-3)
        torch.testing.assert_close(k.double(), r, atol=3e-5 * scale,
                                   rtol=2e-4)
    before = (dict(F.GENERIC.launches), dict(F.KERNEL.launches),
              dict(F.BACKWARD.launches))
    p = pts.clone().requires_grad_(True)
    sum(o.sum() for o in F.fused_sdf_train(net, p, lat)).backward()
    with torch.no_grad():
        F.fused_sdf_forward(net, pts, lat)
    torch.cuda.synchronize()
    after = (F.GENERIC.launches, F.KERNEL.launches, F.BACKWARD.launches)
    assert {k: after[0][k] - before[0][k] for k in after[0]} == dict(
        grad=1, nograd=1, bwd=1, grad_bf16=0, grad_bf16_wgmma=0,
        nograd_bf16=0, bwd_bf16=0, pack_bf16=0, pack_tf32=3)
    assert after[1] == before[1] and after[2] == before[2]


GENERIC_BF16_ARCHS = {"deep_odd": GENERIC_ARCHS["deep_odd"],
                      "narrow": (4, (2,), 4, 32, 16, False),
                      "wide": (6, (4,), 8, 256, 64, True)}


@pytest.mark.parametrize("name", list(GENERIC_BF16_ARCHS))
def test_generic_pair_bf16_matches_plain(dev, name):
    """K8-bf16, K8-nograd-bf16 and K9-bf16 (tensor cores) against the bf16
    plain version (K9's in float64) at the deep, the narrow (the JAX
    package's second architecture) and the wide (VolSDF's 8 x 256)
    architecture: max error within 1e-2 (a float32 sum one ulp apart can
    round to the neighbouring bf16 operand), mean error under half the
    mean distance from the float32 kernels; two K9-bf16 launches bitwise
    equal; one pack launch before each launch (bf16 and tf32); K8-bf16
    counted under its wgmma form at the wide one."""
    n_freqs, skips, hidden, width, latent, sym = GENERIC_BF16_ARCHS[name]
    g = torch.Generator().manual_seed(4)
    net = SDFNetwork(proj_latent_dim=latent, n_hidden=hidden,
                     n_channels=width, skip_in=skips, posenc_res=n_freqs,
                     force_symmetry=sym, geometric_init=False, generator=g)
    pts = (torch.rand(2, 2048, 3, generator=g) * 2 - 1).to(dev)
    lat = (torch.randn(2, latent, generator=g) * 0.3).to(dev)
    with torch.no_grad():
        w, b = F.pack_fused_params(*F.prepare_fused_params(net, lat.cpu()))
    w, b, arch = w.to(dev), b.to(dev), F.sdf_arch(net)
    cots = [torch.randn(2, 2048, *c, generator=g).to(dev)
            for c in ((), (width,), (3,))]
    before = dict(F.GENERIC.launches)
    pairs = [(F.GENERIC.forward(pts, w, b, arch, grad, sym, "bfloat16"),
              F.generic_forward_reference(pts, w, b, arch, grad, sym,
                                          "bfloat16"),
              F.GENERIC.forward(pts, w, b, arch, grad, sym))
             for grad in (True, False)]
    got16 = F.GENERIC.backward(pts, w, b, arch, *cots, sym, "bfloat16")
    again = F.GENERIC.backward(pts, w, b, arch, *cots, sym, "bfloat16")
    pairs.append((got16, F.generic_backward_reference(
                      *(t.double() for t in (pts, w, b)), arch,
                      *(c.double() for c in cots), sym, "bfloat16"),
                  F.GENERIC.backward(pts, w, b, arch, *cots, sym)))
    torch.cuda.synchronize()
    for k, k2 in zip(got16, again):
        assert torch.equal(k, k2)
    for got, want, f32 in pairs:
        for k, r, k32 in zip(got, want, f32):
            if r is None:
                continue
            scale = max(float(r.abs().max()), 1.0)
            err = (k.double() - r.double()).abs()
            gap = (k.double() - k32.double()).abs().mean()
            assert float(err.max()) <= 1e-2 * scale
            assert float(err.mean()) < 0.5 * float(gap)
    after = F.GENERIC.launches
    wgmma = int(width == 256)
    assert {k: after[k] - before[k] for k in after} == dict(
        grad=1, nograd=1, bwd=1, grad_bf16=1 - wgmma, grad_bf16_wgmma=wgmma,
        nograd_bf16=1, bwd_bf16=2, pack_bf16=4, pack_tf32=3)


def _wide_net(generator):
    n_freqs, skips, hidden, width, latent, sym = GENERIC_BF16_ARCHS["wide"]
    return SDFNetwork(proj_latent_dim=latent, n_hidden=hidden,
                      n_channels=width, skip_in=skips, posenc_res=n_freqs,
                      force_symmetry=sym, geometric_init=False,
                      generator=generator), latent, sym


@pytest.mark.parametrize("shape", [(1, 262144), (12, 1024), (2, 1000)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_generic_wgmma_form_matches_plain(dev, shape):
    """K8-bf16's wgmma form (VolSDF's 8 x 256) against the bf16 plain
    version at a request's render (1 x 262,144), the eikonal's 12 x 1,024
    and a ragged 2 x 1,000 (each row's last tile of 32 points partial):
    max error within 1e-2 of the value's scale (a float32 sum one ulp apart
    can round to the neighbouring bf16 operand), mean error under half the
    mean distance from the float32 kernel (3xTF32)."""
    g = torch.Generator().manual_seed(7)
    net, latent, sym = _wide_net(g)
    B, N = shape
    pts = (torch.rand(B, N, 3, generator=g) * 2 - 1).to(dev)
    pts[:, ::5, 0] = 0.0
    lat = (torch.randn(B, latent, generator=g) * 0.3).to(dev)
    with torch.no_grad():
        w, b = F.pack_fused_params(*F.prepare_fused_params(net, lat.cpu()))
    w, b, arch = w.to(dev), b.to(dev), F.sdf_arch(net)
    with torch.inference_mode():
        got = F.GENERIC.forward(pts, w, b, arch, True, sym, "bfloat16")
        want = F.generic_forward_reference(pts, w, b, arch, True, sym,
                                           "bfloat16")
        f32 = F.GENERIC.forward(pts, w, b, arch, True, sym)
    torch.cuda.synchronize()
    for k, r, k32 in zip(got, want, f32):
        scale = max(float(r.abs().max()), 1.0)
        err = (k.double() - r.double()).abs()
        gap = (k.double() - k32.double()).abs().mean()
        assert torch.isfinite(k).all()
        assert float(err.max()) <= 1e-2 * scale
        assert float(err.mean()) < 0.5 * float(gap)


@pytest.mark.parametrize("name", ["wide", "narrow"])
def test_generic_bf16_forward_counts_its_form(dev, name):
    """A K8-bf16 launch counts under the form the library says it took:
    'grad_bf16_wgmma' at width 256 (and not 'grad_bf16'), 'grad_bf16' at
    width 32 (and not 'grad_bf16_wgmma'); K8-nograd-bf16 under
    'nograd_bf16' at both."""
    n_freqs, skips, hidden, width, latent, sym = GENERIC_BF16_ARCHS[name]
    g = torch.Generator().manual_seed(8)
    net = SDFNetwork(proj_latent_dim=latent, n_hidden=hidden,
                     n_channels=width, skip_in=skips, posenc_res=n_freqs,
                     force_symmetry=sym, geometric_init=False, generator=g)
    pts = (torch.rand(1, 100, 3, generator=g) * 2 - 1).to(dev)
    with torch.no_grad():
        w, b = F.pack_fused_params(*F.prepare_fused_params(
            net, torch.zeros(1, latent)))
    w, b, arch = w.to(dev), b.to(dev), F.sdf_arch(net)
    before = dict(F.GENERIC.launches)
    with torch.inference_mode():
        for grad in (True, False):
            F.GENERIC.forward(pts, w, b, arch, grad, sym, "bfloat16")
    torch.cuda.synchronize()
    wgmma = int(name == "wide")
    assert {k: F.GENERIC.launches[k] - before[k] for k in before
            if k.startswith(("grad", "nograd"))} == dict(
        grad=0, nograd=0, grad_bf16=1 - wgmma, grad_bf16_wgmma=wgmma,
        nograd_bf16=1)


@pytest.mark.parametrize("name", list(GENERIC_BF16_ARCHS))
def test_generic_bf16_pack_matches_plain(dev, name):
    """The generic pair's bf16 weight pack (each layer zero-padded to
    multiples of 16; at the wide architecture K8-bf16's chunk images after
    them) bitwise against its plain version."""
    n_freqs, skips, hidden, width, latent, sym = GENERIC_BF16_ARCHS[name]
    g = torch.Generator().manual_seed(5)
    net = SDFNetwork(proj_latent_dim=latent, n_hidden=hidden,
                     n_channels=width, skip_in=skips, posenc_res=n_freqs,
                     force_symmetry=sym, geometric_init=False, generator=g)
    with torch.no_grad():
        w, _ = F.pack_fused_params(*F.prepare_fused_params(
            net, torch.zeros(1, latent)))
    arch = F.sdf_arch(net)
    got = F.GENERIC.pack_bf16(w.to(dev), arch)
    want = F.generic_pack_bf16_reference(w, arch)
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("name", list(GENERIC_BF16_ARCHS))
def test_generic_tf32_pack_matches_plain(dev, name):
    """The generic pair's tf32 weight pack (each layer zero-padded to
    multiples of 8, each element its (hi, lo) pair of cvt.rna.tf32 halves)
    bitwise against its plain version; hi + lo gives every weight back to
    within 2^-22 of its size."""
    n_freqs, skips, hidden, width, latent, sym = GENERIC_BF16_ARCHS[name]
    g = torch.Generator().manual_seed(6)
    net = SDFNetwork(proj_latent_dim=latent, n_hidden=hidden,
                     n_channels=width, skip_in=skips, posenc_res=n_freqs,
                     force_symmetry=sym, geometric_init=False, generator=g)
    with torch.no_grad():
        w, _ = F.pack_fused_params(*F.prepare_fused_params(
            net, torch.zeros(1, latent)))
    arch = F.sdf_arch(net)
    before = F.GENERIC.launches["pack_tf32"]
    got = F.GENERIC.pack_tf32(w.to(dev), arch)
    torch.cuda.synchronize()
    assert F.GENERIC.launches["pack_tf32"] == before + 1
    want = F.generic_pack_tf32_reference(w, arch)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    pairs = want.view(-1, 2).double()
    back = F._padded_layers(w, arch, 8).double()
    assert torch.all((pairs.sum(1) - back).abs()
                     <= 2.0 ** -22 * back.abs())
