"""The host-side helpers around the fused SDF kernels K2, K2-bf16 and K1 /
K3 (`shapeclipper_torch/csrc/fused_sdf_bwd.cu`, `fused_sdf_bwd_bf16.cu`,
`fused_sdf_fwd.cu`), on the CPU: the wrapper's tile and stash constants
against the sources,
`chip_smoke.py`'s reading of the ptxas log, and `scripts/sdf_segments.py`'s
instrumentation of the backward and forward kernels."""

import os
import re
import sys

import pytest

import chip_smoke
from shapeclipper_torch.ops import fused_sdf as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import sdf_segments  # noqa: E402

PTXAS_LOG = """\
ptxas info    : 24 bytes gmem
ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_122reduce_partials_kernelEPKfS1_PfS2_ii' for 'sm_90a'
ptxas info    : Function properties for _ZN4_GLOBAL__N_122reduce_partials_kernelEPKfS1_PfS2_ii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_120fused_sdf_bwd_kernelEPKfS1_' for 'sm_90a'
ptxas info    : Function properties for _ZN4_GLOBAL__N_120fused_sdf_bwd_kernelEPKfS1_
    32 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 212 registers, used 1 barriers, 32 bytes cumulative stack size
"""


def _source():
    with open(F._SOURCE_BWD) as f:
        return f.read()


def test_wrapper_constants_match_the_kernel():
    """The wrapper sizes the grid by the kernel's tile and allocates its
    stash; both must be the kernel's own (the library checks the stash size
    again when it is bound on the card)."""
    src = _source()
    const = {m.group(1): m.group(2) for m in re.finditer(
        r"constexpr int (\w+) = ([^;]+);", src)}
    assert int(const["kPoints"]) == F.BWD_TILE_POINTS
    assert const["kStashFloats"] == "kHidden * kRows * kWidth"
    assert int(const["kHidden"]) * 4 * F.BWD_TILE_POINTS * 64 \
        == F.BWD_STASH_FLOATS


def test_bf16_backward_tile_and_stash_match_the_kernel():
    """K2-bf16's tile in points and its per-block stash in floats
    (`F.BWD_TILE_POINTS_BF16`, `F.BWD_STASH_FLOATS_BF16`: the wrapper caps
    the grid and allocates the stash by them, and the library checks both
    when it is bound on the card): 8 warps of 8 points, each warp two m16
    tiles of [primal; t_x] and [t_y; t_z] rows; per warp, hidden layers 0-3
    of 18 16-byte words a lane."""
    with open(F._SOURCE_BWD_BF16) as f:
        const = {m.group(1): m.group(2) for m in re.finditer(
            r"constexpr int (\w+) = ([^;]+);", f.read())}
    warps = int(const["kWarps"])
    assert const["kPoints"] == "8 * kWarps"
    assert const["kRows"] == "4 * kPoints"
    assert 8 * warps == F.BWD_TILE_POINTS_BF16
    assert 4 * F.BWD_TILE_POINTS_BF16 == 16 * 2 * warps
    assert const["kStashFloats"] == \
        "kWarps * kStashLayers * kStashWords * 32 * 4"
    assert (warps * int(const["kStashLayers"]) * int(const["kStashWords"])
            * 32 * 4) == F.BWD_STASH_FLOATS_BF16


def test_forward_tile_matches_the_kernel():
    """The forward's tile in points (`F.FWD_TILE_POINTS`, which the `cuda`
    tests' tile edges use and the library checks when it is bound): one
    group of kG rows with tangents, four without."""
    with open(F._SOURCE) as f:
        const = {m.group(1): m.group(2) for m in re.finditer(
            r"constexpr int (\w+) = ([^;]+);", f.read())}
    G = int(const["kG"])
    assert const["kRows"] == "4 * kG"
    assert F.FWD_TILE_POINTS == {"grad": G, "nograd": 4 * G}


@pytest.mark.parametrize("kernel,want", [
    ("fused_sdf_bwd_kernel", (212, 8, 12)),
    ("reduce_partials_kernel", (32, 0, 0)),
])
def test_ptxas_usage_reads_each_entry_function(kernel, want):
    assert chip_smoke.ptxas_usage(PTXAS_LOG, kernel) == want


def test_ptxas_usage_without_a_log_or_the_kernel():
    """A library loaded from an earlier build has no log: the spill check
    fails rather than pass unread."""
    with pytest.raises(AssertionError, match="no ptxas log"):
        chip_smoke.ptxas_usage(None, "fused_sdf_bwd_kernel")
    with pytest.raises(AssertionError, match="no ptxas usage"):
        chip_smoke.ptxas_usage(PTXAS_LOG, "nn_kernel")


def _check_instrumented(src, kernel, body_end):
    """One counter after each __syncthreads() from the namespace to the end
    of `kernel`, with that barrier's source line; the rest is unchanged."""
    out, lines = sdf_segments.instrument(src, kernel + "(")
    body = src[src.index("namespace {"):body_end]
    assert len(lines) == body.count("__syncthreads();") > 0
    assert lines == sorted(lines)
    src_lines = src.split("\n")
    assert all("__syncthreads();" in src_lines[n - 1] for n in lines)
    for i in range(len(lines)):
        assert f"__syncthreads(); SCL_SEGMENT({i});" in out
    # + the #define, + the source's own marks (the bf16 forward's stages)
    assert out.count("SCL_SEGMENT(") == len(lines) + 1 + src.count(
        "SCL_SEGMENT(")
    assert out.count("scl_last_ = clock64();") == 1     # the timer starts
    assert 'extern "C" int scl_segments_read' in out
    kept = re.sub(r"__syncthreads\(\); SCL_SEGMENT\(\d+\);",
                  "__syncthreads();", out)
    kept = kept.replace("\n  if (SCL_IS_TIMER) scl_last_ = clock64();", "")
    assert src[src.index("namespace {"):] in kept
    return lines


def test_segments_mark_every_barrier_of_the_main_kernel():
    """K2: the barriers of fused_sdf_bwd_kernel (its helpers have none)."""
    src = _source()
    lines = _check_instrumented(
        src, "fused_sdf_bwd_kernel",
        src.index("__global__ void reduce_partials_kernel"))
    kernel_start = src.index("fused_sdf_bwd_kernel(")
    assert min(lines) > src.count("\n", 0, kernel_start)


def test_segments_mark_every_barrier_of_the_forward_kernel():
    """K1 / K3: the barriers of fused_sdf_fwd_kernel, helpers included."""
    with open(F._SOURCE) as f:
        src = f.read()
    _check_instrumented(src, "fused_sdf_fwd_kernel",
                        src.index("cudaError_t launch("))


def _forward_source():
    with open(F._SOURCE) as f:
        return f.read()


def test_bf16_forward_tile_matches_the_kernel():
    """K1-bf16 / K3-bf16's tile in points (`F.FWD_TILE_POINTS_BF16`, which
    the `cuda` tests' tile edges use and the library checks when it is
    bound): a warp's 8 points with tangents (two m16 tiles of [primal; t_x]
    and [t_y; t_z] rows), 16 without (one m16 tile of 16 points)."""
    src = _forward_source()
    m = re.search(r"static constexpr int kM = kGrad \? (\d+) : (\d+);", src)
    assert m, "Bf16Tile::kM not found"
    tiles = {"grad": int(m.group(1)), "nograd": int(m.group(2))}
    assert "static constexpr int kPoints = kGrad ? 8 : 16 * kM;" in src
    assert F.FWD_TILE_POINTS_BF16 == {"grad": 8, "nograd": 16 * tiles[
        "nograd"]}
    # with tangents four rows a point: two m16 tiles hold 8 points
    assert 4 * F.FWD_TILE_POINTS_BF16["grad"] == 16 * tiles["grad"]


# `csrc/fused_sdf_fwd.cu::frag_source`, transcribed line by line: (first
# fragment, packed offset, rows, n8 tiles) of K0, K1h, K1pe, K2h, K2pe, K3,
# K4 and K5 (the kFrag* and kOff* constants)
_FRAG_MATRICES = ((0, 0, 39, 8), (24, 2496, 64, 8), (56, 6592, 39, 8),
                  (80, 9088, 64, 8), (112, 13184, 39, 8), (136, 15680, 64, 8),
                  (168, 19776, 64, 8), (200, 23872, 64, 9))


def _posenc_slot_feature(t, s):
    if s == 0:
        return t if t < 3 else -1
    i = (s - 1) // 2
    p = t + 4 * i
    if p >= 18:
        return -1
    return 3 + 6 * (p // 3) + 3 * ((s - 1) % 2) + p % 3


def _frag_source(frag, w, e):
    base, off, rows, nt = [m for m in _FRAG_MATRICES if frag >= m[0]][-1]
    f = frag - base
    kk, j = f // nt, f % nt
    lane, reg = w // 2, w % 2
    n = 8 * j + (lane >> 2)
    if rows == 39:
        q = _posenc_slot_feature(lane & 3, 4 * kk + 2 * reg + e)
        return -1 if q < 0 else off + q * 64 + n
    k = 16 * kk + 2 * (lane & 3) + 8 * reg + e
    if k >= rows:
        return -1
    if frag < 200:
        return off + k * 64 + n
    if n < 64:
        return off + k * 65 + 1 + n
    return off + k * 65 if n == 64 else -1


def test_bf16_fragment_index_matches_frag_source():
    """The plain version of the bf16 weight pack (`F.bf16_fragment_index`,
    which `pack_bf16_reference` gathers by and the pack kernel is held to
    bitwise on the card) element for element against the kernel's own
    layout; every packed weight appears exactly once."""
    src = _forward_source()
    const = {m.group(1): m.group(2) for m in re.finditer(
        r"constexpr int (\w+) = ([^;]+);", src)}
    assert const["kNTOut"].startswith("9") and const["kPeSteps"].startswith(
        "3")
    assert "return off + k * kOut + 1 + n;" in src   # K5: features first
    assert "return q < 0 ? -1 : off + q * kWidth + n;" in src
    assert "return n == kWidth ? off + k * kOut : -1;" in src
    idx = F.bf16_fragment_index()
    want = [_frag_source(i // 128, (i % 128) // 2, i % 2)
            for i in range(F.BF16_FRAG_ELEMS)]
    assert idx.tolist() == want
    used = idx[idx >= 0]
    assert sorted(used.tolist()) == list(range(F.NUM_WEIGHTS))


def test_bf16_pack_reference_rounds_and_pads():
    """`pack_bf16_reference`: the plain copy is `.to(bfloat16)`, the
    fragments hold those values where the index points and zero in the
    padding."""
    import torch
    w = torch.randn(F.NUM_WEIGHTS, generator=torch.Generator().manual_seed(0))
    frags, plain = F.pack_bf16_reference(w)
    assert plain.dtype == frags.dtype == torch.bfloat16
    assert torch.equal(plain, w.to(torch.bfloat16))
    idx = torch.from_numpy(F.bf16_fragment_index().copy())
    assert torch.equal(frags[idx >= 0], plain[idx[idx >= 0]])
    assert not frags[idx < 0].float().abs().any()


def test_segments_of_the_bf16_forward_are_its_marks():
    """fwd-bf16: no barrier is instrumented; the kernel's own SCL_SEGMENT
    marks (empty in the library) add to the counters 0-12, one per name of
    `FWD_BF16_SEGMENTS`."""
    src = _forward_source()
    kernel = "fused_sdf_fwd_bf16_kernel("
    out, lines = sdf_segments.instrument(src, kernel)
    assert lines == []
    assert "SCL_SEGMENT(" not in out.replace("#define SCL_SEGMENT(", "")[
        :out.index("namespace {")]
    assert "#undef SCL_SEGMENT\n#define SCL_SEGMENT(i) if (SCL_IS_TIMER)" \
        in out
    assert "__syncthreads(); SCL_SEGMENT(" not in out
    assert "#ifndef SCL_SEGMENT\n#define SCL_SEGMENT(i)\n#endif" in src
    body, end = sdf_segments._kernel_body(src, kernel,
                                          src.index("namespace {"))
    seen = set()
    for m in re.finditer(r"SCL_SEGMENT\(([^)]*)\);", src[body:end]):
        seen |= {eval(m.group(1), {"l": l}) for l in range(5)}
    assert seen == set(range(len(sdf_segments.FWD_BF16_SEGMENTS))) \
        == set(range(13))


FIRST_DESIGN_LIKE = """namespace {
template <bool kGrad>
__global__ void fused_sdf_fwd_bf16_kernel(const float* p) {
  stage();
  __syncthreads();
  const int lane = threadIdx.x % 32;
  for (int tile = 0; tile < 4; ++tile) {
    const int b = tile / tiles_per_batch;
    // ---- the posenc A fragments
    // ---- hidden layers 0..4, the activations carried in registers
    for (int l = 0; l < 5; ++l) {
      if (l > 0) {
        products();
      }
      // bias and activation; the next layer's A fragments
    }
    // ---- output layer: sdf + 64 features
  }
}
}  // namespace
"""


def test_segments_insert_marks_at_the_pr11_stage_boundaries():
    """A bf16 forward without marks (the first tensor-core design) gets one
    mark on a line of its own before each anchor of `FIRST_FWD_BF16_MARKS`,
    in order, and the output layer's again before the kernel's end;
    instrumenting it then reads those marks, not its barrier."""
    kernel = "fused_sdf_fwd_bf16_kernel("
    marked = sdf_segments.insert_marks(FIRST_DESIGN_LIKE, kernel)
    got = marked.split("\n")
    for anchor, mark in sdf_segments.FIRST_FWD_BF16_MARKS:
        i = next(n for n, line in enumerate(got) if anchor in line)
        assert got[i - 1] == mark
    assert got[got.index("}  // namespace") - 2] == "SCL_SEGMENT(12);"
    unmarked = "\n".join(line for line in got if not line.startswith(
        ("SCL_SEGMENT(", "if (l > 0) SCL_SEGMENT(")))
    assert unmarked == FIRST_DESIGN_LIKE
    out, lines = sdf_segments.instrument(marked, kernel)
    assert lines == [] and "__syncthreads(); SCL_SEGMENT(" not in out
    with pytest.raises(ValueError):
        sdf_segments.insert_marks(FIRST_DESIGN_LIKE.replace("// ---- output", "//"),
                                  kernel)
