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
    assert out.count("SCL_SEGMENT(") == len(lines) + 1   # + the #define
    assert out.count("scl_last_ = clock64();") == 1     # the timer starts
    assert 'extern "C" int scl_segments_read' in out
    kept = re.sub(r" SCL_SEGMENT\(\d+\);", "", out)
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
