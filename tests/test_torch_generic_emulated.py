"""The generic fused SDF pair's device code (K8 / K8-nograd / K9 of
`shapeclipper_torch/csrc/fused_sdf_generic.cu`) run on the CPU, against
its plain versions in `ops/fused_sdf.py`.

There is no CUDA compiler here, so the test compiles the source's device
part (everything above its C entry points) with g++ against the stub
headers of `tests/cuda_emu/`: a block's 256 threads are std::threads,
`__syncthreads` a barrier over them, blocks run in turn, shared memory
starts as NaN patterns. This checks the kernels' indexing, tiling, barriers
and arithmetic at small sizes; whether nvcc builds them and how fast they
run only the card shows (`tests/test_torch_cuda.py -k generic`, phase 16 of
`chip_smoke.py`). It skips where g++ cannot build C++20 (`<barrier>`).

Tolerances: float32 kernels against the float64 plain version, K8 as the
card tests (sdf / feature atol 2e-5, gradient atol 5e-4 rtol 5e-3), K9
atol 3e-5 x max|ref| rtol 2e-4; bf16 kernels against the bf16 plain
version by `chip_smoke.check_bf16`'s rule (see the test).
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from shapeclipper_torch.models.implicit import SDFNetwork
from shapeclipper_torch.ops import fused_sdf as F

EMU_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "cuda_emu")
MARKER = "// ---------------------------------------------------------------- C entry"
# (posenc, skips, hidden layers, width, latent, force_symmetry): the JAX
# package's second architecture, a deep one of odd width whose output layer
# is a skip layer, one without posenc, the flagship's, and a wide one
# whose tile is the smallest (16 rows)
ARCHS = {
    "jax_test": (4, (2,), 4, 32, 16, False),
    "deep_odd": (2, (2, 5, 6), 6, 13, 8, True),
    "no_posenc": (0, (1,), 3, 24, 12, True),
    "flagship": (6, (1, 2), 5, 64, 64, True),
    "wide_512": (3, (1,), 1, 512, 8, True),
}


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the CPU emulation")
    out = tmp_path_factory.mktemp("cuda_emu")
    with open(F._SOURCE_GENERIC) as f:
        device = f.read().split(MARKER)[0]
    assert "__global__" in device and "extern \"C\"" not in device
    device = device.replace("#include <cuda_bf16.h>", '#include "cuda_bf16.h"')
    device = device.replace("#include <cuda_runtime.h>",
                            '#include "cuda_runtime.h"')
    (out / "device_part.inc").write_text(device)
    lib = out / "libgeneric_emu.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-pthread", "-shared", "-fPIC",
         "-I", str(out), "-I", EMU_DIR, "-o", str(lib),
         os.path.join(EMU_DIR, "harness.cpp")],
        capture_output=True, text=True, timeout=600)
    if proc.returncode and "barrier" in proc.stderr:
        pytest.skip("g++ has no C++20 <barrier>")
    assert proc.returncode == 0, proc.stderr[-3000:]
    emu = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    emu.emu_fwd.argtypes = [p] * 6 + [i] * 9
    emu.emu_bwd.argtypes = [p] * 10 + [i] * 9
    emu.emu_tile_points.argtypes = [i] * 6
    return emu


def _ptr(t):
    assert t.is_contiguous() and t.dtype == torch.float32
    return ctypes.c_void_p(t.data_ptr())


def _case(spec, B, N, seed):
    n_freqs, skips, hidden, width, latent, sym = spec
    g = torch.Generator().manual_seed(seed)
    net = SDFNetwork(proj_latent_dim=latent, n_hidden=hidden,
                     n_channels=width, skip_in=skips, posenc_res=n_freqs,
                     force_symmetry=sym, geometric_init=False, generator=g)
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    pts[:, ::4, 0] = 0.0
    pts = torch.from_numpy(pts)
    lat = torch.from_numpy((rng.randn(B, latent) * 0.3).astype(np.float32))
    with torch.no_grad():
        w, b = F.pack_fused_params(*F.prepare_fused_params(net, lat))
    cots = [torch.from_numpy(rng.randn(B, N, *c).astype(np.float32))
            for c in ((), (width,), (3,))]
    return F.sdf_arch(net), sym, pts, w, b, cots


def _run(emu, case, bf16, grid=3):
    """K8 with and without tangents, then K9 over `grid` blocks, emulated
    -> ((sdf, feat, grad), (sdf, feat)) and (d weights, d biases, d
    points)."""
    arch, sym, pts, w, b, cots = case
    B, N = pts.shape[:2]
    args = (arch.n_freqs, arch.n_hidden, arch.width, arch.skip_mask)
    fwd = []
    for grad in (True, False):
        out = [torch.full((B, N), float("nan")),
               torch.full((B, N, arch.width), float("nan")),
               torch.full((B, N, 3), float("nan"))]
        assert emu.emu_fwd(_ptr(pts), _ptr(w), _ptr(b), *map(_ptr, out), B,
                           N, *args, int(grad), int(sym), int(bf16)) == 0
        fwd.append(out if grad else out[:2])
    tile = emu.emu_tile_points(*args, 1, 1)
    assert B * -(-N // tile) > grid
    width = arch.num_weights + B * arch.bias_width
    dpoints = torch.full((B, N, 3), float("nan"))
    out = torch.full((width,), float("nan"))
    partials = torch.full((grid, width), float("nan"))
    stash = torch.full((grid, arch.n_hidden * arch.width * 4 * tile),
                       float("nan"))
    assert emu.emu_bwd(_ptr(pts), _ptr(w), _ptr(b), *map(_ptr, cots),
                       _ptr(dpoints), _ptr(out), _ptr(partials),
                       _ptr(stash), B, N, grid, *args, int(sym),
                       int(bf16)) == 0
    return fwd, (out[:arch.num_weights], out[arch.num_weights:].view(B, -1),
                 dpoints)


def _plain(case, mm, dtype):
    arch, sym, pts, w, b, cots = case
    ops = [t.to(dtype) for t in (pts, w, b)]
    fwd = [F.generic_forward_reference(*ops, arch, grad, sym, mm)
           for grad in (True, False)]
    return [fwd[0], fwd[1][:2]], F.generic_backward_reference(
        *ops, arch, *(c.to(dtype) for c in cots), sym, mm)


@pytest.mark.parametrize("name", list(ARCHS))
def test_emulated_generic_pair_matches_plain(emu, name):
    """K8 with and without tangents and K9 (three blocks over a ragged set
    of tiles, so that each block adds several tiles to its partials), with
    float32 and with bf16 products, against the plain versions."""
    case = _case(ARCHS[name], 2, 37, seed=7)
    f32 = _run(emu, case, False)
    want = _plain(case, "float32", torch.float64)
    fwd_tol = (dict(atol=2e-5, rtol=0.0),) * 2 + (dict(atol=5e-4, rtol=5e-3),)
    for got, ref in zip(f32[0], want[0]):
        for g, r, tol in zip(got, ref, fwd_tol):
            torch.testing.assert_close(g.double(), r, **tol)
    for g, r in zip(f32[1], want[1]):
        scale = max(float(r.abs().max()), 1e-3)
        torch.testing.assert_close(g.double(), r, atol=3e-5 * scale,
                                   rtol=2e-4)
    # bf16: a float32 sum one ulp apart may round to the neighbouring bf16
    # operand and move a value by far more than float32 noise, so (as
    # chip_smoke.check_bf16) the largest error is held to 1e-2 of the
    # value's scale and the mean error under half the mean distance from
    # the float32 kernel
    b16 = _run(emu, case, True)
    want = _plain(case, "bfloat16", torch.float32)
    got = [t for part in b16[0] for t in part] + list(b16[1])
    ref = [t for part in want[0] for t in part] + list(want[1])
    away = [t for part in f32[0] for t in part] + list(f32[1])
    for g, r, a in zip(got, ref, away):
        err = (g - r).abs()
        assert float(err.max()) <= 1e-2 * max(float(r.abs().max()), 1.0)
        assert float(err.mean()) < 0.5 * float((g - a).abs().mean())


def test_emulated_tiles_follow_shared_memory(emu):
    """The tile shrinks with the width so that its buffers fit a block's
    227 KB: 16 / 64 points (K8 with / without tangents) and 16 for K9 at
    width 256, 8 / 32 and 8 at 512; outside the envelope there is none."""
    def tiles(f, l, w, m):
        return (emu.emu_tile_points(f, l, w, m, 1, 0),
                emu.emu_tile_points(f, l, w, m, 0, 0),
                emu.emu_tile_points(f, l, w, m, 1, 1))
    assert tiles(6, 8, 256, 1 << 4) == (16, 64, 16)
    assert tiles(16, 2, 512, 0b110) == (8, 32, 8)
    assert tiles(16, 16, 512, 0) == (8, 32, 8)
    assert tiles(6, 8, 513, 0) == (-1, -1, -1)
    assert tiles(6, 8, 256, 1 << 9) == (-1, -1, -1)
