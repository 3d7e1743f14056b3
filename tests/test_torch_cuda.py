"""The fused SDF Hopper kernel (`shapeclipper_torch/csrc/fused_sdf_fwd.cu`)
against its plain PyTorch version, on the card.

Every test here is marked `cuda` and skips without an NVIDIA GPU. The file
imports torch and the port only (no JAX), so on a machine with the card
and without JAX it runs as

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerances follow tests/test_fused_sdf.py: sdf / feature atol 2e-5; gradient
atol 5e-4, rtol 5e-3 (sigmoid(100 z) amplifies rounding in the tangents).
"""

import numpy as np
import pytest
import torch

from shapeclipper_torch.models.implicit import SDFNetwork
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
    """N = 1, 33 and 1000 leave ragged tails for both tile sizes (32 points
    with tangents, 128 without); each call is exactly one launch."""
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
