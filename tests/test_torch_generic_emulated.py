"""The generic fused SDF pair's device code (the float32 K8 / K8-nograd /
K9 of `shapeclipper_torch/csrc/fused_sdf_generic.cu`, 3xTF32 on the tensor
cores, and their tf32 weight pack; their bf16 forms on the tensor cores and
the bf16 weight pack of `csrc/fused_sdf_generic_bf16.cu`) run on the CPU,
against its plain versions in `ops/fused_sdf.py`.

There is no CUDA compiler here, so the test compiles each source's device
part (everything above its C entry points) with g++ against the stub
headers of `tests/cuda_emu/`, one translation unit each as nvcc builds
them: a block's 256 threads are std::threads, `__syncthreads` a barrier
over them, blocks run in turn, shared memory starts as NaN patterns. The
warp collectives (ldmatrix x1 / x2 / x4 and .trans, mma.sync m16n8k16 bf16
and m16n8k8 tf32, shuffles) are emulated with the PTX ISA's fragment
layouts behind a per-warp barrier (the tf32 mma reads only the top 19 bits
of each operand register, as the hardware does, so an operand left
unsplit loses the rest), `cvt.rna.tf32.f32` as the ISA rounds, and
cp.async copies land only when their thread waits for them, so a read
before the wait shows. K8-bf16's wgmma form adds wgmma (m64n256k16 and
m64n16k16 from shared-memory descriptors under the 128-byte swizzle,
evaluated when their group is waited for; fence, commit, and a wait that
meets the warp as `.sync.aligned` does), mbarriers (arrivals, expected
transaction bytes, parity waits), the bulk copy (landing only when a
thread waits on its barrier) and named barriers; the emulation is itself
held to numpy through the ISA's layouts. This checks the kernels'
indexing, tiling, barriers and arithmetic at small sizes; whether nvcc
builds them and how fast they run only the card shows (`tests/
test_torch_cuda.py -k generic`, phase 16 of `chip_smoke.py`). It skips
where g++ cannot build C++20 (`<barrier>`).

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
    for source, name in ((F._SOURCE_GENERIC, "device_part.inc"),
                         (F._SOURCE_GENERIC_BF16, "device_part_bf16.inc")):
        with open(source) as f:
            device = f.read().split(MARKER)[0]
        assert "__global__" in device and "extern \"C\"" not in device
        (out / name).write_text(device)
    lib = out / "libgeneric_emu.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-pthread", "-shared", "-fPIC",
         "-I", str(out), "-I", EMU_DIR,
         "-I", os.path.dirname(F._SOURCE_GENERIC), "-o", str(lib), os.path.join(EMU_DIR, "harness.cpp"),
         os.path.join(EMU_DIR, "harness_bf16.cpp")],
        capture_output=True, text=True, timeout=600)
    if proc.returncode and "barrier" in proc.stderr:
        pytest.skip("g++ has no C++20 <barrier>")
    assert proc.returncode == 0, proc.stderr[-3000:]
    emu = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    emu.emu_fwd.argtypes = [p] * 6 + [i] * 8
    emu.emu_bwd.argtypes = [p] * 10 + [i] * 8
    emu.emu_pack.argtypes = [p] * 2 + [i] * 4
    emu.emu_tile_points.argtypes = [i] * 6
    emu.emu_stash_floats.argtypes = [i] * 4
    emu.emu_packed.argtypes = [i] * 4
    emu.emu_tf32_rna.argtypes = [p, p, i]
    emu.emu_tf32_mma.argtypes = [p] * 4
    emu.emu_tf32_dot.argtypes = [p] * 3 + [i] * 2
    emu.emu_bf16_fwd.argtypes = [p] * 6 + [i] * 8
    emu.emu_bf16_bwd.argtypes = [p] * 10 + [i] * 8
    emu.emu_bf16_pack.argtypes = [p] * 2 + [i] * 4
    emu.emu_bf16_tile_points.argtypes = [i] * 6
    emu.emu_bf16_stash_floats.argtypes = [i] * 4
    emu.emu_bf16_packed.argtypes = [i] * 4
    emu.emu_ldmatrix_rows.argtypes = [p, i, i, p]
    emu.emu_fragment_product.argtypes = [p] * 4 + [i]
    emu.emu_bf16_wgmma_form.argtypes = [i] * 4
    emu.emu_sw_off.argtypes = [i, i, p]
    emu.emu_wgmma_product.argtypes = [p, p, i, i, p, i]
    emu.emu_mbar_ring.argtypes = [p, i, i, p, p]
    return emu


def _ptr(t):
    assert t.is_contiguous() and t.dtype in (torch.float32, torch.bfloat16,
                                             torch.int32)
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


def _bf16_forward(emu, case, grad):
    """K8-bf16 (`grad`) or K8-nograd-bf16, emulated on the emulated bf16
    pack, which must equal its plain version bitwise -> (sdf, feat, grad or
    None)."""
    arch, sym, pts, w, b, _ = case
    B, N = pts.shape[:2]
    args = (arch.n_freqs, arch.n_hidden, arch.width, arch.skip_mask)
    weights = torch.full((emu.emu_bf16_packed(*args),), float("nan"),
                         dtype=torch.bfloat16)
    assert emu.emu_bf16_pack(_ptr(w), _ptr(weights), *args) == 0
    assert torch.equal(weights.view(torch.int16),
                       F.generic_pack_bf16_reference(w, arch)
                       .view(torch.int16))
    out = [torch.full((B, N), float("nan")),
           torch.full((B, N, arch.width), float("nan")),
           torch.full((B, N, 3), float("nan"))]
    assert emu.emu_bf16_fwd(_ptr(pts), _ptr(weights), _ptr(b),
                            *map(_ptr, out), B, N, *args, int(grad),
                            int(sym)) == 0
    return out if grad else out[:2] + [None]


def _check_bf16(got, ref, away):
    """`chip_smoke.check_bf16`'s rule: the largest error within 1e-2 of the
    value's scale, the mean error under half the mean distance from
    float32 (a float32 sum one ulp apart may round to the neighbouring bf16
    operand and move a value by far more than float32 noise)."""
    for g, r, a in zip(got, ref, away):
        err = (g - r).abs()
        assert torch.isfinite(g).all()
        assert float(err.max()) <= 1e-2 * max(float(r.abs().max()), 1.0)
        assert float(err.mean()) < 0.5 * float((g - a).abs().mean())


def _run(emu, case, bf16, grid=3):
    """K8 with and without tangents, then K9 over `grid` blocks, emulated
    (3xTF32 on the emulated tf32 pack, or the bf16 forms on the emulated
    bf16 pack; each pack must equal its plain version bitwise) -> ((sdf,
    feat, grad), (sdf, feat)) and (d weights, d biases, d points)."""
    arch, sym, pts, w, b, cots = case
    B, N = pts.shape[:2]
    args = (arch.n_freqs, arch.n_hidden, arch.width, arch.skip_mask)
    if bf16:
        weights = torch.full((emu.emu_bf16_packed(*args),), float("nan"),
                             dtype=torch.bfloat16)
        assert emu.emu_bf16_pack(_ptr(w), _ptr(weights), *args) == 0
        assert torch.equal(weights.view(torch.int16),
                           F.generic_pack_bf16_reference(w, arch)
                           .view(torch.int16))
        fwd_fn, bwd_fn = emu.emu_bf16_fwd, emu.emu_bf16_bwd
        tile = emu.emu_bf16_tile_points(*args, 1, 1)
        stash_floats = emu.emu_bf16_stash_floats(*args)
    else:
        weights = torch.full((emu.emu_packed(*args),), float("nan"))
        assert emu.emu_pack(_ptr(w), _ptr(weights), *args) == 0
        assert torch.equal(weights.view(torch.int32),
                           F.generic_pack_tf32_reference(w, arch)
                           .view(torch.int32))
        fwd_fn, bwd_fn = emu.emu_fwd, emu.emu_bwd
        tile = emu.emu_tile_points(*args, 1, 1)
        stash_floats = emu.emu_stash_floats(*args)
    fwd = []
    for grad in (True, False):
        out = [torch.full((B, N), float("nan")),
               torch.full((B, N, arch.width), float("nan")),
               torch.full((B, N, 3), float("nan"))]
        assert fwd_fn(_ptr(pts), _ptr(weights), _ptr(b), *map(_ptr, out), B,
                      N, *args, int(grad), int(sym)) == 0
        fwd.append(out if grad else out[:2])
    assert B * -(-N // tile) > grid
    width = arch.num_weights + B * arch.bias_width
    dpoints = torch.full((B, N, 3), float("nan"))
    out = torch.full((width,), float("nan"))
    partials = torch.full((grid, width), float("nan"))
    stash = torch.full((grid, stash_floats), float("nan"))
    assert bwd_fn(_ptr(pts), _ptr(weights), _ptr(b), *map(_ptr, cots),
                  _ptr(dpoints), _ptr(out), _ptr(partials), _ptr(stash), B,
                  N, grid, *args, int(sym)) == 0
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
    float32 products (3xTF32, after the tf32 pack) and in their bf16 forms
    (after the bf16 pack), both on the tensor cores, each pack bitwise its
    plain version, against the plain versions: float32 at 2 x 37 points (2
    x 12 at width 512, whose 8-point tiles still give K9 more tiles than
    blocks and a ragged last one: every tf32 mma is a warp exchange here).
    The bf16 forms' tiles are larger (64 points but at width 512), so they
    run 2 x 150 points there (2 x 37 at width 512)."""
    case = _case(ARCHS[name], 2, 12 if ARCHS[name][3] == 512 else 37,
                 seed=7)
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
    # float32 (here the float32 plain version on the same inputs)
    case = _case(ARCHS[name], 2, 150 if ARCHS[name][3] < 512 else 37,
                 seed=7)
    arch = case[0]
    assert emu.emu_bf16_wgmma_form(arch.n_freqs, arch.n_hidden, arch.width,
                                   arch.skip_mask) == 0
    b16 = _run(emu, case, True)
    want = _plain(case, "bfloat16", torch.float32)
    away = _plain(case, "float32", torch.float32)
    _check_bf16([t for part in b16[0] for t in part] + list(b16[1]),
                [t for part in want[0] for t in part] + list(want[1]),
                [t for part in away[0] for t in part] + list(away[1]))


# architectures whose K8-bf16 takes the wgmma form (width padded to 256):
# one whose output layer is a skip layer, with 80 posenc columns (two
# atoms, the second a single k-step; a 3-buffer ring) and 272 output
# columns (the m64n16 product beside the m64n256 one); and VolSDF's depth
# at width 250 (padding columns inside the form's 256, 256 output columns)
WGMMA_ARCHS = {
    "skip_out": (12, (2, 3), 3, 256, 8, True),
    "deep_250": (6, (4,), 8, 250, 16, False),
}


@pytest.mark.parametrize("name", list(WGMMA_ARCHS))
def test_emulated_wgmma_form_matches_plain(emu, name):
    """K8-bf16's wgmma form (warp-specialised persistent blocks: a producer
    lane bulk-copying each layer's chunk images into an mbarrier ring, two
    consumer warpgroups of m64n256k16 wgmma, sigma' shared by shuffles)
    against the bf16 plain version by `check_bf16`'s rule, beside the
    float32 plain version: 2 x 45 points, so each batch row ends in a
    ragged tile, over three persistent blocks that walk the four tiles
    (the first takes two). The pack with its chunk images is bitwise its
    plain version."""
    case = _case(WGMMA_ARCHS[name], 2, 45, seed=9)
    arch = case[0]
    assert emu.emu_bf16_wgmma_form(arch.n_freqs, arch.n_hidden, arch.width,
                                   arch.skip_mask) == 1
    got = _bf16_forward(emu, case, True)
    ops = case[2:5]
    want = F.generic_forward_reference(*ops, arch, True, case[1], "bfloat16")
    away = F.generic_forward_reference(*ops, arch, True, case[1], "float32")
    _check_bf16(got, want, away)


def test_emulated_tiles_follow_shared_memory(emu):
    """The float32 (3xTF32) forms' tile is the largest of 128, 64, 32 rows
    whose float32 buffers fit a block's 227 KB: at width 256 K8 / K8-nograd
    / K9 take 16 / 64 / 16 points (64 rows; 128 rows of two float32 row
    buffers would take 270 KB), at width 512 8 / 32 / 8, at width 32 32 /
    128 / 32; outside the envelope there is none. The tf32 pack pads each
    layer to multiples of 8, two floats an element."""
    def tiles(f, l, w, m):
        return (emu.emu_tile_points(f, l, w, m, 1, 0),
                emu.emu_tile_points(f, l, w, m, 0, 0),
                emu.emu_tile_points(f, l, w, m, 1, 1))
    assert tiles(6, 8, 256, 1 << 4) == (16, 64, 16)
    assert tiles(16, 2, 512, 0b110) == (8, 32, 8)
    assert tiles(16, 16, 512, 0) == (8, 32, 8)
    assert tiles(4, 4, 32, 1 << 2) == (32, 128, 32)
    assert tiles(6, 8, 513, 0) == (-1, -1, -1)
    assert tiles(6, 8, 256, 1 << 9) == (-1, -1, -1)
    for arch in (F.SdfArch(6, (4,), 8, 256), F.SdfArch(2, (2, 5, 6), 6, 13)):
        assert emu.emu_packed(arch.n_freqs, arch.n_hidden, arch.width,
                              arch.skip_mask) == F.generic_packed_tf32(arch)


def test_emulated_bf16_tiles_follow_shared_memory(emu):
    """The bf16 forms' tile is the largest of 256, 128, 64, 32 rows whose
    bf16 buffers fit a block's 227 KB: at width 256 K8-bf16 / K8-nograd-bf16
    / K9-bf16 take 32 / 128 / 32 points (128 rows), twice the float32
    kernels' 16 / 64 / 16; at width 512 16 / 64 / 16; at width 32 64 / 256
    / 64; outside the envelope there is none. The pack pads each layer to
    multiples of 16."""
    def tiles(f, l, w, m):
        return (emu.emu_bf16_tile_points(f, l, w, m, 1, 0),
                emu.emu_bf16_tile_points(f, l, w, m, 0, 0),
                emu.emu_bf16_tile_points(f, l, w, m, 1, 1))
    assert tiles(6, 8, 256, 1 << 4) == (32, 128, 32)
    assert tiles(16, 2, 512, 0b110) == (16, 64, 16)
    assert tiles(16, 16, 512, 0) == (16, 64, 16)
    assert tiles(4, 4, 32, 1 << 2) == (64, 256, 64)
    assert tiles(6, 8, 513, 0) == (-1, -1, -1)
    assert tiles(6, 8, 256, 1 << 9) == (-1, -1, -1)
    for arch in (F.SdfArch(6, (4,), 8, 256), F.SdfArch(2, (2, 5, 6), 6, 13)):
        assert emu.emu_bf16_packed(arch.n_freqs, arch.n_hidden, arch.width,
                                   arch.skip_mask) \
            == F.generic_packed_bf16(arch)


def _bf16_bits(x):
    """float32 array -> its bf16 bits (nearest even) as uint16, and the
    bf16 values as float64."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    b = t.to(torch.bfloat16)
    return b.view(torch.int16).numpy().view(np.uint16), b.double().numpy()


@pytest.mark.parametrize("count", [1, 2, 4])
@pytest.mark.parametrize("trans", [False, True])
def test_emulated_ldmatrix_follows_the_fragment_layout(emu, count, trans):
    """ldmatrix.m8n8 .x1 / .x2 / .x4 (.trans), lane l handing over row l of
    a [32][8] bf16 array: matrix i is rows 8 i .. 8 i + 7, and lane (g, t)
    receives row g, columns 2 t, 2 t + 1 (the lower in the low half) or,
    with .trans, rows 2 t, 2 t + 1 of column g (the PTX ISA's layout)."""
    rows = np.random.RandomState(count + 8 * trans).randint(
        0, 1 << 16, (32, 8)).astype(np.uint16)
    out = torch.zeros(32, 4, dtype=torch.int32)
    assert emu.emu_ldmatrix_rows(
        ctypes.c_void_p(rows.ctypes.data), count, int(trans), _ptr(out)) == 0
    got = out.numpy().view(np.uint32)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i in range(count):
            m = rows[8 * i:8 * i + 8].astype(np.uint32)
            lo, hi = ((m[2 * t, g], m[2 * t + 1, g]) if trans
                      else (m[g, 2 * t], m[g, 2 * t + 1]))
            assert got[lane, i] == lo | (hi << 16), (lane, i)


@pytest.mark.parametrize("b_from_rows", [False, True])
def test_emulated_mma_matches_numpy(emu, b_from_rows):
    """One mma.sync m16n8k16 bf16 through the fragments the kernels load:
    A by ldmatrix.x4, B by ldmatrix.x2.trans from [k][n] rows or by plain
    ldmatrix.x2 from [n][k] rows (W and W^T in the kernels), C and D in the
    accumulator's layout: D = C + A B in float64 to float32 rounding (bf16
    products are exact in float32; the emulation rounds the sum once)."""
    rng = np.random.RandomState(3 + b_from_rows)
    a_bits, a = _bf16_bits(rng.randn(16, 16))
    b_bits, b = _bf16_bits(rng.randn(16, 8))
    c = rng.randn(16, 8).astype(np.float32)
    d = np.zeros((16, 8), np.float32)
    assert emu.emu_fragment_product(
        *(ctypes.c_void_p(x.ctypes.data) for x in (a_bits, b_bits, c, d)),
        int(b_from_rows)) == 0
    np.testing.assert_allclose(d, c + a @ b, rtol=1e-6, atol=1e-6)


def _tf32_rna_numpy(x):
    """cvt.rna.tf32.f32 in numpy: the magnitude rounded to 10 mantissa
    bits, ties away from zero, as bits (NaN as it is)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    r = ((u + 0x1000) & 0xffffe000).astype(np.uint32)
    nan = (u & 0x7fffffff) > 0x7f800000
    return np.where(nan, u.astype(np.uint32), r)


def test_emulated_tf32_rna_matches_numpy(emu):
    """cvt.rna.tf32.f32 (the kernels' operand split) and the pack's plain
    version `F.tf32_rna` against numpy: nearest, ties away from zero on
    the magnitude, over random floats of every scale, exact ties of both
    signs, subnormals, the largest float (to infinity) and infinities."""
    rng = np.random.RandomState(11)
    x = (rng.randn(4096) * np.exp2(rng.randint(-140, 120, 4096))).astype(
        np.float32)
    ties = (rng.randint(1, 1 << 10, 64) << 13 | 0x1000).astype(np.uint32)
    ties |= (rng.randint(1, 254, 64) << 23).astype(np.uint32)
    special = np.array([0.0, -0.0, 1e-45, -3e-39, np.finfo(np.float32).max,
                        -np.finfo(np.float32).max, np.inf, -np.inf],
                       np.float32)
    x = np.concatenate([x, ties.view(np.float32), -ties.view(np.float32),
                        special])
    out = np.zeros(x.size, np.uint32)
    emu.emu_tf32_rna(ctypes.c_void_p(x.ctypes.data),
                     ctypes.c_void_p(out.ctypes.data), x.size)
    want = _tf32_rna_numpy(x)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(
        F.tf32_rna(torch.from_numpy(x)).numpy().view(np.uint32), want)
    assert ((want[4096:4096 + 64] & 0x1fff) == 0).all()
    assert np.isinf(want[-4:-2].view(np.float32)).all()


def test_emulated_tf32_mma_matches_numpy(emu):
    """One mma.sync m16n8k8 tf32 through its fragment layout (a0 A[g][t],
    a1 A[g + 8][t], a2 A[g][t + 4], a3 A[g + 8][t + 4]; b0 B[t][g], b1
    B[t + 4][g]; C and D as m16n8k16's) on float32 operands that are not
    tf32 values: D = C + A' B' in float64 to float32 rounding, A' and B'
    each element cut to its top 19 bits, as the hardware reads them."""
    rng = np.random.RandomState(5)
    a = rng.randn(16, 8).astype(np.float32)
    b = rng.randn(8, 8).astype(np.float32)
    c = rng.randn(16, 8).astype(np.float32)
    d = np.zeros((16, 8), np.float32)
    a_bits, b_bits = a.view(np.uint32), b.view(np.uint32)
    assert emu.emu_tf32_mma(*(ctypes.c_void_p(x.ctypes.data)
                              for x in (a_bits, b_bits, c, d))) == 0

    def cut(bits):
        return (bits & np.uint32(0xffffe000)).view(np.float32).astype(
            np.float64)
    want = c + cut(a_bits) @ cut(b_bits)
    np.testing.assert_allclose(d, want, rtol=1e-6, atol=1e-6)
    # the low bits are dropped, not rounded: unsplit operands miss them
    assert np.abs(d - (c + a.astype(np.float64) @ b)).max() > 1e-4


def test_emulated_3xtf32_dot_keeps_float32_precision(emu):
    """The kernels' product of 256-deep rows (A staged as float32 rows and
    fetched by `load_a`, B split as the pack splits it, `mma3_tiles`'s
    three tf32 products a k-step): within float32's error bound K u sum|a||b|
    (u = 2^-24) of the float64 product everywhere, where the same
    product of the hi halves alone (plain TF32) exceeds it."""
    rng = np.random.RandomState(8)
    K = 256
    a = rng.randn(16, K).astype(np.float32)
    b = rng.randn(K, 8).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    bound = K * 2.0 ** -24 * (np.abs(a).astype(np.float64) @ np.abs(b))
    errs = []
    for hi_only in (0, 1):
        d = np.zeros((16, 8), np.float32)
        assert emu.emu_tf32_dot(*(ctypes.c_void_p(x.ctypes.data)
                                  for x in (a, b, d)), K, hi_only) == 0
        errs.append(np.abs(d - ref) / bound)
    assert errs[0].max() <= 1.0, errs[0].max()
    assert errs[1].max() > 2.0, errs[1].max()


def _swizzled(rows_k, n_rows):
    """[atoms][n_rows][64] bf16 bits -> the bytes of each atom as the
    128-byte swizzle lays them out: row r at r * 128, the 16-byte group k
    // 8 at byte address bits 4-6 XOR bits 7-9 (r % 8), as uint16."""
    atoms = rows_k.shape[0]
    out = np.zeros((atoms, n_rows * 64), np.uint16)
    r = np.arange(n_rows)[:, None]
    k = np.arange(64)[None, :]
    byte = r * 128 + 2 * k
    byte = byte ^ (((byte >> 7) & 7) << 4)
    for a in range(atoms):
        out[a, byte // 2] = rows_k[a]
    return out


def test_emulated_sw_off_is_the_128byte_swizzle(emu):
    """`sw_off`, where the kernel stores its operand rows and the pack its
    chunk images, is the 128-byte swizzle of the PTX ISA's K-major layout:
    atom k // 64 of [64 rows][64 k] 8192 bytes on, row r 128 bytes on, and
    the byte address's bits 4-6 XOR its bits 7-9; for a chunk image (k <
    64) at every one of its 272 rows."""
    for rows, ks in ((64, 128), (272, 64)):
        got = np.zeros((rows, ks), np.int32)
        emu.emu_sw_off(rows, ks, ctypes.c_void_p(got.ctypes.data))
        r = np.arange(rows)[:, None]
        k = np.arange(ks)[None, :]
        byte = (k // 64) * 8192 + r * 128 + 2 * (k % 64)
        want = (byte ^ (((byte >> 7) & 7) << 4)) // 2
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [256, 16])
@pytest.mark.parametrize("atoms", [1, 2])
def test_emulated_wgmma_matches_numpy(emu, n, atoms):
    """wgmma.mma_async m64nNk16 bf16 -> f32 through the kernels'
    descriptors (`wg_desc`: start, 1024 bytes between 8-row groups, the
    128-byte swizzle; + 2 a k-step of 16, + 512 an atom), 4 x `atoms`
    k-steps, the first overwriting D: D = A B^T for A [64][64 atoms] and B
    [n][64 atoms] laid out by numpy as the ISA swizzles them, D read back
    through the accumulator layout (warp w, lane (g, t): rows 16 w + g,
    + 8, columns 8 j + 2 t, + 1), within one float32 rounding a k-step of
    the float64 product (bf16 products are exact; the sum is float32); read
    before the wait, D still holds what it held (the products land at the
    wait)."""
    rng = np.random.RandomState(n + atoms)
    a_bits, a = _bf16_bits(rng.randn(64, 64 * atoms))
    b_bits, b = _bf16_bits(rng.randn(n, 64 * atoms))
    a_img = _swizzled(a_bits.reshape(64, atoms, 64).transpose(1, 0, 2), 64)
    b_img = _swizzled(b_bits.reshape(n, atoms, 64).transpose(1, 0, 2), n)
    for late in (0, 1):
        d = np.zeros((64, n), np.float32)
        assert emu.emu_wgmma_product(
            ctypes.c_void_p(a_img.ctypes.data),
            ctypes.c_void_p(b_img.ctypes.data), atoms, n,
            ctypes.c_void_p(d.ctypes.data), late) == 0
        if late:
            assert (d == -1.0).all()
        else:
            bound = 4 * atoms * 2.0 ** -24 * (np.abs(a) @ np.abs(b).T)
            assert (np.abs(d - a @ b.T) <= bound).all()


def test_emulated_mbarrier_ring_lands_at_the_wait(emu):
    """The wgmma form's ring as its mbarriers drive it, emulated: a
    producer lane waits on a buffer's empty barrier (the parity flipped,
    so a fresh barrier passes), expects the round's bytes on the full
    barrier and bulk-copies them; 32 consumer lanes wait on the full
    barrier, read, and arrive on the empty one. Over 5 rounds of two
    buffers each lane reads round r's words after its wait, and before it
    what the buffer held: the NaN fill in rounds 0 and 1, round r - 2's
    words after (a bulk copy lands only at a wait on its barrier)."""
    rounds, words = 5, 64
    src = np.arange(rounds * words, dtype=np.float32).reshape(rounds, words)
    before = np.zeros((rounds, 32), np.float32)
    after = np.zeros((rounds, 32), np.float32)
    assert emu.emu_mbar_ring(*(ctypes.c_void_p(x.ctypes.data)
                               for x in (src,)), rounds, words,
                             ctypes.c_void_p(before.ctypes.data),
                             ctypes.c_void_p(after.ctypes.data)) == 0
    np.testing.assert_array_equal(after, src[:, :32])
    assert np.isnan(before[:2]).all()
    np.testing.assert_array_equal(before[2:], src[:-2, :32])
