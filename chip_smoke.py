#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, evaluation, pretraining and
CLIP annotation paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (each one succeeds or raises; any failure exits non-zero, and there is
no CPU fallback):
  1. set-up: versions, the card, the TF32 switches (both off: fp32), and the
     build of the five libraries from `shapeclipper_torch/csrc/` into
     `build/` (five nvcc runs at once);
  2. K1 / K3 (forward) against their plain PyTorch version at the serving
     shapes: N = 262,144 render points with gradients, N = 274,625 and
     1,030,301 grid points without; K1 again at the training shape, there
     also against the plain version in float64; two launches bitwise equal;
     registers and spills of both instantiations from the ptxas log (a
     spill fails the run); cycles per barrier segment of K1 and K3, and
     K1-bf16's per stage (`scripts/sdf_segments.py`);
  3. K2 (backward) against plain autograd of the plain version at
     B x N = 12 x 32,768 (render), 12 x 1,024 (eikonal), a ragged 2 x 300
     and 2 x 300 with points on the x = 0 plane; two launches bitwise
     equal; its registers and spills from the ptxas log; CUDA-event times
     of K2 alone at the eikonal and the render shape, of the K1 + K2 pair
     and of the plain forward + backward (every fused-SDF kernel time here
     and in phase 5a is SDF_TIMED_CALLS launches between two events);
  4. four single-image requests through the port's Runner at the full width
     of options/pix3d/config.yaml (the serving path), launch counts reset
     just before and read just after, request 0 held against the CPU plain
     path, then the CLI once;
  5. training steps at the flagship config (options/pix3d/config.yaml with
     bench.py's overrides: synthetic data, batch 12, 224^2; like every
     phase that holds the sequential step, phases 5-5d, 10, 13's gloo
     ranks and 15, with the three `tpu.merge_*` flags pinned false) on one
     pre-collated batch: step 0 (camera phase) and six full steps, launch
     counts per step (K1 3 / K2 1, then K1 3 / K2 3), every loss finite,
     per-step times, peak memory, one step under torch.profiler with
     cuDNN's share; then the first full step at batch 4 on the card and on
     the CPU plain path from the same weights, optimizer state and draws;
     5a-5d. the YAML's own precision, `tpu.encoder_dtype` and
     `tpu.implicit_dtype` bfloat16 (every phase above and below pins both
     to float32 and keeps its float32 gate): (a) K1-bf16, K3-bf16 and
     K2-bf16 against their bf16 plain versions at 262,144, 12 x 32,768,
     vox 64 and 12 x 1,024, each held under half its distance from the
     float32 kernel and timed beside it, K1-bf16 at 12 x 32,768 also by
     torch.profiler's device time, with K1-bf16 / K3-bf16's registers and
     stack bytes; the bf16 weight pack (K1-bf16 / K3-bf16's fragments and
     K2-bf16's plain copy, one launch) bitwise against its plain version;
     K2-bf16 (the tensor-core kernel of
     `csrc/fused_sdf_bwd_bf16.cu`) also bitwise equal over two launches at
     12 x 32,768, with its registers and spills from the ptxas log (a spill
     fails the run); (b) a camera and four full bf16
     training steps with launch counts (K1-bf16 3 / K2-bf16 1, then 3 /
     3, one weight pack per K1-bf16 launch, the float32 K1 / K2 none), the
     steady step, peak memory and a
     profiled step with cuDNN's share; (c) three bf16 requests (K1-bf16
     and the pack 9, the float32 K3 3 per request); (d) a batch-4 full
     step on the card
     against the CPU at implicit bfloat16 (gated: each MLP's gradient
     under half its distance from float32) and with both keys bfloat16 (a
     reading); (e) the YAML's own step, bf16 with the three merge flags
     true (one ResNet34, one ResNet18, one render over 24 views): a camera
     and four full steps with launch counts (K1-bf16 2 / K2-bf16 1, then
     2 / 2, a pack a K1-bf16 launch), the steady step, peak memory, a
     profiled step and its BatchNorm calls, each beside (b)'s sequential
     step; the merged step at batch 4 on the card against the CPU (float32,
     phase 5's gates); K1 / K2 and K1-bf16 / K2-bf16 at the merged render's
     24 x 32,768 against their plain versions (phases 2, 3 and 5a's checks,
     the float64 ones included), timed beside them and their bounds (phase
     9's train CLI opens the profiler window and phase 13's NCCL rank takes
     the merged step);
  6. convergence: 200 steps of options/synthetic/config.yaml with
     scripts/validate_training.py's overrides through the loader, with
     `Runner.evaluate` before and after (the Chamfer distance must fall);
  7. K4 / K5 (nearest-neighbour sweep) against their plain PyTorch version:
     ragged 2 x (1,000 vs 3,001), 4 x 8,192, identical clouds and duplicated
     points (the copies in different chunks of a split sweep), a ragged
     split 3 x (257 vs 20,001), 1 x 100,000 x 100,000 and 1 x 100,000 x
     2,048 (the evaluation's shape, whose 2,048-row direction splits B's
     cloud into chunks); at the last three the chosen chunks bitwise equal
     to `splits=1` and to a repeat; CUDA-event times at the last two shapes
     with the chosen chunks and with `splits=1` in turns, beside the plain
     version, `torch.cdist` as the library yardstick, and the bound;
  8. `Runner.evaluate` at the full eval width of options/pix3d/config.yaml
     (64^2 render, vox 64, 100,000 points, six F-score thresholds) over the
     8 synthetic test samples with dumps: launch counts reset just before
     and read just after, ms per sample, K4 / K5 against their plain
     version on the clouds each sample handed to K4, a stage split of the
     same path with each stage synchronised, the evaluation under the
     profiler, and 2 samples at vox 32 / 8,192 points held against the CPU
     plain path; then K5 through the differentiable chamfer API (forward +
     backward, the gradient held against autograd of the plain version),
     which no CLI path calls;
 8b. the device isosurface (`tpu.device_isosurface`): K6 / K7
     (`csrc/isosurface.cu`) against their plain versions on the same grid,
     CDF and draws, on the eval runner's vox-64 and vox-100 grids, the
     bumpy ellipsoid of tests/test_device_isosurface.py and an exact-ties
     grid (area error, share of identical faces, points' error), timed at
     vox 64 and vox 100 with 100,000 draws beside the plain versions and
     the bounds; `Runner.evaluate` with eval.dump false at the full eval
     width on the host and the device path, in turns (ms per sample,
     launch counts per sample K3 / K4 / K6 / K7, no host isosurface work
     or grid copy on the device path, a synchronised stage split, a
     profiled run, both CDs within ISO_CD_RTOL); `tpu.eval_pipeline` true
     against false on each path, in turns (ms per sample, the four CDs
     within EVAL_CD_RTOL); the device path at vox 32 / 8,192 points, card
     against CPU on the card's draws (phase 8's gates);
  9. the train and evaluate CLIs (`python -m shapeclipper_torch.train` for
     one tiny epoch with `--tpu.profile_iters=[1,3]`, whose Chrome trace
     must name the fused SDF kernels, then `python -m
     shapeclipper_torch.evaluate --resume`);
 10. pretraining (`train/pretrainer.py`) at the flagship width (batch 12,
     224^2, 10,000 points, density and viewpoint losses): 2 + 10 steps on
     one batch with the kernels' launch counts (none lies on this path),
     ms per step, peak memory, one step under the profiler; a step at
     batch 4 on the card and on the CPU plain path from the same weights
     and draws; tests/test_pretrain.py's 300-step sphere fit;
 11. CLIP annotation (`clipnn/`) with ViT-L/14 at full width on 256
     synthetic images a split: images/s of `encode_split` and of the tower
     alone, peak memory, 2 embeddings and one split's top-k against the
     CPU, the three CSVs;
 12. the pretrain, `train --load=<the pretrain run>` and clip_anno CLIs;
 13. data parallelism at the flagship config (batch 12, noise input
     images, a camera step and two full steps on the same draws), each
     run under `python -m torch.distributed.run` on this script
     (`--ddp-worker`): one NCCL rank, its Runner under DDP, against the
     Runner without a process group before and after it (bitwise or
     within 1e-6; the full steps' times on either side), in the sequential
     and the merged step (float32, K1 / K2 2 / 2 a full step), then two ranks
     on the one card through gloo (6 samples each) against one process at
     batch 12, in global and per_replica BatchNorm (losses, every
     gradient, the post-step parameters and statistics; the camera step
     and the first full step to tests/test_torch_ddp.py's bounds or twice
     one process's own float32 noise, the largest under three reorderings
     of the batch, the second full step a reading; deterministic cuDNN, so
     that each run reads the same); the K1 / K2 launches per step and the step
     times; K1 and K2 timed at a rank's 6 x 32,768 beside 12 x 32,768;
 14. `train --distributed` under torchrun (one NCCL rank: DDP, the
     sharded evaluation's gather) and `train` without it at a tiny size,
     then `evaluate --distributed --resume` under torchrun (one NCCL rank)
     and `evaluate --resume`: equal reports and `Best CD`
     (tests/test_torch_ddp_cli.py's set-up); then at the full eval width of
     options/pix3d/config.yaml (its precision, dumps and host surface
     sampling) over the 8 synthetic test samples, seeded weights as a
     run's best.pt, evaluated by `evaluate --resume` in this process and
     by one NCCL rank of `evaluate --distributed --resume`: byte-equal
     reports, the same dump files, launches per sample K1-bf16 1 / pack 1
     / K3 3 / K4 2 in both, and both runs' ms per sample;
 15. `loss_weight.category_reg=1`: a batch-4 flagship step on the card
     against the CPU (the loss term 1e-4, the centres' gradient 1e-3, the
     post-step centres 0.05 lr);
 16. the generic pair K8 / K8-nograd / K9 (`csrc/fused_sdf_generic.cu`),
     which runs every SDF MLP but the flagship's: each against its plain
     version in float32 (K9 against the float64 one) and bf16
     (`check_bf16`'s rule) at the JAX package's second architecture (posenc
     4, skip 2, 4 x 32) at 12 x 1,024 and at VolSDF's 8 x 256 (skip 4) at
     12 x 1,024, 12 x 32,768, 24 x 32,768 and the vox-64 grid, K9 bitwise
     over two launches, each timed beside its plain version and its bound;
     then that wide MLP (`GENERIC_WIDE_ARGS` on options/pix3d/config.yaml)
     through the YAML's own step (bf16, merged) for a camera and three
     full steps, a float32 camera and full step, two requests and a
     2-sample evaluation at the full eval width, with launch counts that
     show K8 / K9 in place of K1 / K2 / K3;
 17. the kernel summary line, the card line and the result line.
A warning from the guards that keep metric and visualization failures from
stopping a training run fails the run.

Weights are the port's seeded initialisation (no trained checkpoints exist);
images are drawn with numpy from a seed.
"""

import contextlib
import copy
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "options", "pix3d", "config.yaml")
OUT_DIR = os.path.join(REPO, "build", "chip_smoke")
SOURCE = "shapeclipper_torch/csrc/fused_sdf_fwd.cu"
SOURCE_BWD = "shapeclipper_torch/csrc/fused_sdf_bwd.cu"
SOURCE_BWD_BF16 = "shapeclipper_torch/csrc/fused_sdf_bwd_bf16.cu"
SOURCE_NN = "shapeclipper_torch/csrc/chamfer.cu"
REPLACES = "shapeclipper_tpu/ops/fused_sdf.py:311"
REPLACES_BWD = "shapeclipper_tpu/ops/fused_sdf.py:617"
REPLACES_K4 = "shapeclipper_tpu/ops/chamfer.py:155"
REPLACES_K5 = "shapeclipper_tpu/ops/chamfer.py:93"
# K6 / K7 replace no `pl.pallas_call`: JAX computes them in XLA
SOURCE_ISO = "shapeclipper_torch/csrc/isosurface.cu"
REPLACES_K6 = "shapeclipper_tpu/eval3d/device_isosurface.py:106"
REPLACES_K7 = "shapeclipper_tpu/eval3d/device_isosurface.py:161"

# tests/test_fused_sdf.py:24-27 (sdf, feature), :41-43 (gradient) and
# :143-147 (training gradients: atol 3e-5 * max|ref|, rtol 2e-4)
SDF_TOL = dict(atol=2e-5, rtol=0.0)
GRAD_TOL = dict(atol=5e-4, rtol=5e-3)
BWD_ATOL, BWD_RTOL = 3e-5, 2e-4
N_REQUESTS = 4
N_VIEWS = 8
SEED = 0
N_FULL_STEPS = 6
N_CONVERGE = 200
# the card-vs-CPU training step: norm-relative gradient limits, 0.1 for the
# encoders (train-mode BatchNorm), MLP_GRAD_TOL for the modules without it
MLP_ROOTS = ("sdf_network", "rgb_network", "density")
MLP_GRAD_TOL = 1e-2
# K4 / K5 against the plain version: the kernel fuses two of the three
# squares into multiply-adds (a few ulps); an argmin may differ only where
# the plain distance to the kernel's choice equals the plain minimum within
# the same tolerance (a near-tie), and at most once per NN_TIES_PER rows
# (tests/test_torch_cuda.py's cap)
NN_TOL = dict(rtol=1e-5, atol=1e-7)
NN_TIES_PER = 10_000            # at most one near-tie per 10,000 rows
NN_GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# elements of one [rows, N2] block of the plain version when timed on the card
PLAIN_BLOCK_CARD = 1 << 26
N_NN = 100_000
N_GT = 2048                     # the synthetic GT cloud (data/synthetic.py)
NN_TIMED_CALLS = 10             # K4 / K5 calls between two CUDA events
# fused-SDF kernel calls (K1 / K3 / K2 and their bf16 forms) between two
# CUDA events: one call would time the host's launch path with the kernel
SDF_TIMED_CALLS = 20
NN_FLOP_PER_PAIR = 8            # 3 subtractions, 3 multiplies, 2 additions
# the card-vs-CPU evaluation: per-sample CD rtol, F-score absolute
EVAL_CD_RTOL, EVAL_F_ATOL = 1e-4, 1e-3
# K6 / K7 (phase 8b) against their plain versions: cell area sums to 1e-6 of
# the largest (both round the same float32 steps: expected equal), faces off
# at most once per ISO_FACES_PER draws, points atol 1e-5 at equal faces;
# host against device path of the evaluation to rtol 0.05 (two samplings)
ISO_AREA_RTOL, ISO_FACES_PER, ISO_PTS_ATOL = 1e-6, 10_000, 1e-5
ISO_CD_RTOL = 0.05
ISO_VOX = (64, 100)             # the eval runner's grids K6 / K7 are timed on
# operations a valid triangle slot needs: 3 vertices x 15 (edge lerp: 2
# subtractions, a division, the clip, 1 - t, 3 x (2 multiplies, an add)),
# 6 edge subtractions, the cross product 9, squares and sums 5, sqrt, x 0.5,
# the float64 sum; a cell 8 sign tests; a draw the binary search, 8 sign
# tests, its face's vertices 45, the flip and barycentric step 15, the world
# scale 9 (the walk's slots counted as K6's)
ISO_FLOP_SLOT, ISO_FLOP_CELL, ISO_FLOP_DRAW = 68, 8, 8 + 45 + 15 + 9
# pretraining: warm-up and timed steps at the flagship width, the batch of
# the card-vs-CPU step, the sphere fit's steps (tests/test_pretrain.py)
N_PRE_WARM, N_PRE_TIMED = 2, 10
PRE_CMP_BATCH = 4
N_SPHERE = 300
CLIP_IMAGES = 256               # synthetic images a split for ViT-L/14
# the guards that keep a failed metric or visualization from stopping
# training (trainer.py, as the JAX package): a warning from one fails the run
GUARD_WARNINGS = ("train-split metric eval failed", "rotating vis failed")

# roofline of one H100 SXM (NVIDIA data sheet, 700 W): fp32 outside the
# tensor cores and HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# Multiply-adds a point needs (the function's, not the kernels' dense rows).
# Without tangents every weight is used once: 28,032. With tangents, a
# posenc tangent row is non-zero at 13 of its 39 entries (K0, K1pe, K2pe:
# 39 + 3 x 13 rows of 64 each), the hidden products take all four rows
# (4 x 4,096 each of K1h, K2h, K3, K4), and the output layer's tangent rows
# need only the sdf column (64 x 65 + 3 x 64): 84,864.
MAC_TANGENT = 3 * (39 + 3 * 13) * 64 + 4 * 4 * 4096 + 64 * 65 + 3 * 64
FLOP_K1 = 2 * MAC_TANGENT        # per point, with tangents: 169,728
FLOP_K3 = 2 * 28032              # per point, without
# K2: the recompute, then per layer the input cotangent and the weight
# gradient, each with the same non-zero pattern as the forward product
FLOP_K2 = 3 * FLOP_K1            # per point: 509,184

# The bf16 instantiations (`mm_dtype="bfloat16"`): their bound is the
# products' FLOPs at the H100 SXM's dense bf16 tensor-core peak plus the
# elementwise FLOPs at the fp32 peak, or the bytes, whichever is larger.
# Elementwise FLOPs a point needs, counting a transcendental as one: per
# hidden primal value the bias and the activation pair (100 z, |z|, exp,
# 1 + e, reciprocal, select, max, log1p, add, / 100: 11), per tangent value
# the sigmoid scaling (3 tangents), the posenc (3 coordinates x 6
# frequencies x scale, sin, cos; with tangents 36 x 2 more) and the output
# layer's 65 bias adds. K2 adds per hidden value the activation's backward
# (sigma'' 3, the tangents' sum 5, the primal cotangent 3, the tangent
# cotangents 3) and the 385 bias-gradient sums.
PEAK_BF16 = 989e12
ELEM_K3 = 5 * 64 * 11 + 54 + 65                  # 3,639 per point
ELEM_K1 = ELEM_K3 + 5 * 64 * 3 + 72              # 4,671
ELEM_K2 = ELEM_K1 + 5 * 64 * 14 + 385            # 9,536
# K1-bf16 / K3-bf16 / K2-bf16 against their bf16 plain versions. Both round
# the same operands, but a float32 sum one ulp apart can round to the
# neighbouring bf16 operand (2^-8 relative), which moves that point's
# outputs by up to a few 1e-3 (measured at 262,144 points: 3.8e-3 on sdf in
# 84 of them, where the whole bf16 change is 6.0e-3). So each check is
# two-fold: the max abs error under a bound that such flips stay inside
# and a wrong product does not, and the mean abs error under a tight bound
# and under half the mean distance from the float32 kernel (measured: 2.6e-7
# against 8.9e-4), which a kernel that quietly ran float32 products fails.
BF16_MAX_TOL = dict(sdf=1e-2, feat=1e-2, grad=3e-2)
BF16_MEAN_TOL = dict(sdf=1e-5, feat=1e-5, grad=2e-5)
BF16_K2_MAX, BF16_K2_MEAN = 2e-2, 1e-4     # times max|ref| of each gradient
N_BF16_STEPS = 4                 # full steps of the bf16 training phase
N_MERGED_STEPS = 4               # full steps of the merged training phase
MERGED_VIEWS = 24                # the merged render's views: (1 + V) x 12
N_BF16_REQUESTS = 3
# kernels whose device time counts as cuDNN's in a profiled step
CONV_KERNELS = ("cudnn", "implicit_gemm", "dgrad", "wgrad", "conv",
                "nchwToNhwc", "nhwcToNchw")
# phase 16, the generic pair K8 / K8-nograd / K9 for SDF MLPs other than the
# flagship's: (posenc, skips, hidden layers, width, latent, force_symmetry)
# of the JAX package's second architecture (tests/test_fused_sdf.py::
# test_fwdmode_xla_nondefault_arch) and of VolSDF's SDF MLP (8 x 256, a
# skip at layer 4, posenc 6), which the paths take as CLI overrides of
# options/pix3d/config.yaml
SOURCE_GENERIC = "shapeclipper_torch/csrc/fused_sdf_generic.cu"
GENERIC_NARROW = (4, (2,), 4, 32, 16, False)
GENERIC_WIDE = (6, (4,), 8, 256, 64, True)
GENERIC_WIDE_ARGS = ("--arch.impl_sdf.n_hidden_layers=8",
                     "--arch.impl_sdf.n_channels=256",
                     "--arch.impl_sdf.skip_connection=[4]")
GENERIC_NONE = dict(k8=0, k8_bf16=0, k8_nograd=0, k8_nograd_bf16=0, k9=0,
                    k9_bf16=0)
N_GENERIC_STEPS = 3              # full steps of the wide YAML step
# blocks of the plain version on the card: batch rows, and points of a row
# for the float64 K9 reference (a whole 24 x 32,768 float64 graph at width
# 256 would need ~1 TB)
GENERIC_PLAIN_ROWS = 1
GENERIC_F64_POINTS = 8192


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, runs=10, warmup=3, calls=1):
    """Median of per-call CUDA-event times after warm-up, in ms; each of the
    `runs` times `calls` calls between its two events (so that a short call
    is timed on the card, not by the host's launch overhead)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def bound(flop, nbytes, mm_flop=0):
    """(least ms on the card, 'operations' or 'bytes'): `flop` at the fp32
    peak plus `mm_flop` (the bf16 products) at the bf16 tensor-core peak,
    or `nbytes` at the memory rate."""
    t_op = (flop / PEAK_FP32 + mm_flop / PEAK_BF16) * 1e3
    t_b = nbytes / PEAK_BYTES * 1e3
    return (t_op, "operations") if t_op >= t_b else (t_b, "bytes")


def ptxas_usage(ptxas_log, kernel, stack=False):
    """(registers, spill store bytes, spill load bytes), and with `stack` the
    stack frame's bytes after them, of the entry function whose mangled name
    contains `kernel`, from nvcc's `-Xptxas -v` output. Raises when there is
    no log (a library loaded from an earlier build) or no such entry."""
    if not ptxas_log:
        raise AssertionError(f"no ptxas log for {kernel}: its library was "
                             "not compiled in this run")
    entries = ptxas_log.split("Compiling entry function")
    for entry in entries[1:]:
        if kernel not in entry.split("\n")[0]:
            continue
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", entry)
        if regs and spill:
            usage = (int(regs.group(1)), int(spill.group(2)),
                     int(spill.group(3)))
            return usage + (int(spill.group(1)),) if stack else usage
    raise AssertionError(f"no ptxas usage for {kernel} in the build log")


def within(got, want, atol, rtol):
    err = (got - want).abs()
    return float(err.max()), bool((err <= atol + rtol * want.abs()).all())


def load_opt(dtype="float32"):
    """options/pix3d/config.yaml with both `tpu.*_dtype` keys pinned to
    `dtype` (the float32 phases keep their float32 gates; the YAML itself
    says bfloat16)."""
    from shapeclipper_torch.config import options
    opt = options.load_options(CONFIG)
    opt.tpu.update(encoder_dtype=dtype, implicit_dtype=dtype)
    opt.seed = SEED
    opt.H, opt.W = opt.image_size
    opt.output_path = OUT_DIR
    return opt


def render_points(opt_e, device):
    """The eval render's sample points for one turntable pose: [1, H*W*S, 3]."""
    import torch
    from shapeclipper_torch import camera
    from shapeclipper_torch.models.graph import pose_from_trig
    from shapeclipper_torch.render.renderer import _safe_normalize, sample_z_vals
    one = torch.ones(1, device=device)
    a = torch.tensor([[0.8, 0.6]], device=device)
    pose, intr = pose_from_trig(opt_e, a, torch.tensor([[0.96, 0.28]],
                                                       device=device),
                                torch.tensor([[1.0, 0.0]], device=device),
                                one, one)
    cam, ray = camera.get_center_and_ray(opt_e, pose, intr=intr)
    dirs = _safe_normalize(ray)
    z, _ = sample_z_vals(opt_e, dirs.shape[1], one)
    pts = cam[:, :, None, :] + z[..., None] * dirs[:, :, None, :]
    return pts.reshape(1, -1, 3).contiguous()


# --------------------------------------------------------------- phase 2
def forward_cases(opt, dev):
    """K1 / K3's shapes on the port's paths -> (the SDF network, [(key,
    compute_grad, points, latent)]): the eval render's 262,144 points with
    tangents, the training render's 12 x 32,768, and the vox-64 and vox-100
    grids without. `key` is the launch count's key ('grad' or 'nograd')."""
    import torch
    from shapeclipper_torch.eval3d.metrics import dense_grid_points
    from shapeclipper_torch.models.implicit import SDFNetwork

    g = torch.Generator().manual_seed(SEED)
    # nn.Linear's default init everywhere (geometric_init off), so that the
    # posenc and latent rows of every layer are dense
    net = SDFNetwork(geometric_init=False, generator=g).to(dev).eval()
    latent = (torch.randn(1, 64, generator=g) * 0.3).to(dev)
    opt_e = opt.deepcopy()
    opt_e.H, opt_e.W = opt.eval.image_size
    cases = [("grad", True, render_points(opt_e, dev), latent)]
    # the training render's shape: batch 12 x 512 rays x 64 samples
    gp = torch.Generator().manual_seed(SEED + 1)
    cases.append(("grad", True,
                  (torch.rand(12, 32768, 3, generator=gp) * 2 - 1).to(dev),
                  (torch.randn(12, 64, generator=gp) * 0.3).to(dev)))
    for vox in (64, 100):
        cases.append(("nograd", False, dense_grid_points(opt, vox, dev)[None]
                      .contiguous(), latent))
    return net, cases


def check_forward(got, want, where):
    """(sdf, feat, grad) of a forward against the plain version's at
    SDF_TOL / GRAD_TOL -> {part: max abs err}; raises where a part has
    another shape, is not finite or is outside its tolerance."""
    import torch
    errs, bad = {}, []
    for part, k, r, tol in zip(("sdf", "feat", "grad"), got, want,
                               (SDF_TOL, SDF_TOL, GRAD_TOL)):
        if r is None:
            continue
        if k.shape != r.shape or not torch.isfinite(k).all():
            raise AssertionError(f"{part} {where}: shape {tuple(k.shape)} "
                                 "or non-finite")
        errs[part], ok = within(k, r, **tol)
        if not ok:
            bad.append(part)
    if bad:
        raise AssertionError(f"the forward disagrees with its plain version "
                             f"{where} in {bad}: {errs}")
    return errs


def check_bf16(got, want, f32, where, max_tol, mean_tol, no_gap=()):
    """Outputs of a bf16 kernel against its bf16 plain version (`want`) and
    the float32 kernel (`f32`), dicts of tensors: every part finite and of
    the same shape, its max abs error under `max_tol[part]`, its mean abs
    error under `mean_tol[part]` and, but for the parts in `no_gap`, under
    half its mean distance from the float32 kernel -> {part: (max err, mean
    err, mean distance)}."""
    import torch
    res, bad = {}, []
    for part, k in got.items():
        r = want[part]
        if k.shape != r.shape or not torch.isfinite(k).all():
            raise AssertionError(f"{part} {where}: shape {tuple(k.shape)} "
                                 "or non-finite")
        e = (k - r).abs()
        res[part] = (float(e.max()), float(e.mean()),
                     float((k - f32[part]).abs().mean()))
        if not (res[part][0] <= max_tol[part]
                and res[part][1] <= mean_tol[part]
                and (part in no_gap or res[part][1] < 0.5 * res[part][2])):
            bad.append(part)
    if bad:
        raise AssertionError(f"the bf16 kernel {where} disagrees with its "
                             f"bf16 plain version in {bad}: {res}")
    return res


def forward_bound(B, N, compute_grad, bf16=False):
    """K1 / K3's bound at B x N: the function's FLOPs, and its bytes (points,
    sdf, features and tangents once, the weights and biases once). With
    `bf16` the products run at the bf16 peak, the elementwise FLOPs at the
    fp32 one, and the weights are 2 bytes each."""
    from shapeclipper_torch.ops import fused_sdf as F
    flop = (FLOP_K1 if compute_grad else FLOP_K3) * B * N
    nbytes = (4 * (B * N * (3 + 65 + (3 if compute_grad else 0))
                   + B * F.BIAS_WIDTH) + (2 if bf16 else 4) * F.NUM_WEIGHTS)
    if bf16:
        elem = (ELEM_K1 if compute_grad else ELEM_K3) * B * N
        return flop, bound(elem, nbytes, mm_flop=flop)
    return flop, bound(flop, nbytes)


def phase_kernels(opt):
    import torch
    from shapeclipper_torch.ops import fused_sdf as F

    dev = torch.device("cuda")
    net, cases = forward_cases(opt, dev)
    results = {"grad": [], "nograd": []}
    with torch.inference_mode():
        for name, cg, pts, latent in cases:
            kernels, biases = F.prepare_fused_params(net, latent)
            weights, bias = F.pack_fused_params(kernels, biases)
            B, N = pts.shape[:2]
            k = F.fused_sdf_forward(net, pts, latent, compute_grad=cg)
            torch.cuda.synchronize()
            r = F.fused_sdf_forward_reference(net, pts, latent,
                                              compute_grad=cg)
            errs = check_forward(k, r, f"at B={B} N={N}")
            ms = cuda_ms(lambda: F.KERNEL.launch(pts, weights, bias, cg,
                                                 True), calls=SDF_TIMED_CALLS)
            plain_ms = cuda_ms(lambda: F._forward_plain(
                kernels, biases, pts, *F._arch(net), cg, True))
            log(f"[kernel] B={B} N={N} compute_grad={cg}: max abs err "
                + ", ".join(f"{p}={e:.3e}" for p, e in errs.items())
                + f" (tol sdf/feat {SDF_TOL}, grad {GRAD_TOL}); kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms "
                f"({plain_ms / ms:.2f}x)")
            flop, (bound_ms, bound_by) = forward_bound(B, N, cg)
            log(f"[kernel]   bound {bound_ms:.4f} ms ({bound_by}; "
                f"{100 * bound_ms / ms:.1f}% of it reached); "
                f"{flop / ms / 1e9:.1f} TFLOP/s of the function's FLOPs")
            results[name].append(dict(B=B, N=N, err=max(errs.values()), ms=ms,
                                      plain_ms=plain_ms, bound_ms=bound_ms,
                                      bound_by=bound_by))
            if (name, B) == ("grad", 12):
                forward_float64(net, pts, latent, k)
            if B == 1 and N in (262144, 274625):
                # two launches on the same inputs are bitwise equal
                a = F.KERNEL.launch(pts, weights, bias, cg, True)
                b = F.KERNEL.launch(pts, weights, bias, cg, True)
                torch.cuda.synchronize()
                if not all(x is y or torch.equal(x, y) for x, y in zip(a, b)):
                    raise AssertionError(f"two launches differ at N={N}")
                log(f"[kernel] two launches at B={B} N={N} "
                    f"compute_grad={cg}: bitwise equal")
    for label, name in (("K1", "fused_sdf_fwd_kernelILb1E"),
                        ("K3", "fused_sdf_fwd_kernelILb0E"),
                        ("K1-bf16", "fused_sdf_fwd_bf16_kernelILb1E"),
                        ("K3-bf16", "fused_sdf_fwd_bf16_kernelILb0E")):
        usage = ptxas_usage(F.KERNEL.ptxas_log, name)
        log(f"[kernel] {label} ptxas: {usage[0]} registers, {usage[1]} bytes "
            f"spill stores, {usage[2]} bytes spill loads")
        if usage[1] or usage[2]:
            raise AssertionError(f"{label} spills registers: {usage}")
    segment_shares()
    return results


def forward_float64(net, pts, latent, got):
    """K1's outputs at a training render's shape against the plain version
    in float64, beside the float32 plain version's own error."""
    import torch
    from shapeclipper_torch.ops import fused_sdf as F
    net64 = copy.deepcopy(net).double()
    ref = F.fused_sdf_forward_reference(net64, pts.double(), latent.double(),
                                        True)
    ref32 = F.fused_sdf_forward_reference(net, pts, latent, True)
    errs, plain, ok = {}, {}, True
    for part, k, r32, r, tol in zip(("sdf", "feat", "grad"), got, ref32, ref,
                                    (SDF_TOL, SDF_TOL, GRAD_TOL)):
        errs[part], good = within(k.double(), r, **tol)
        plain[part] = float((r32.double() - r).abs().max())
        ok &= good
    B, N = pts.shape[:2]
    log(f"[kernel] K1 at {B} x {N:,} against the float64 plain version: "
        + ", ".join(f"{p}={e:.3e}" for p, e in errs.items())
        + "; float32 plain " + ", ".join(f"{p}={e:.3e}"
                                           for p, e in plain.items()))
    if not ok:
        raise AssertionError(f"K1 is outside the tolerance of the float64 "
                             f"plain version: {errs}")
    del net64, ref, ref32
    torch.cuda.empty_cache()


def segment_shares():
    """K1 and K3's cycles per barrier segment and K1-bf16's per stage
    (`scripts/sdf_segments.py`: one instrumented build each, thread 0 of
    block 0)."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import sdf_segments
    for argv in (["--kernel", "fwd", "--label", "k1", "--B", "12",
                  "--N", "32768"],
                 ["--kernel", "fwd", "--label", "k3", "--B", "1",
                  "--N", "274625", "--no-grad"],
                 ["--kernel", "fwd-bf16", "--label", "k1_bf16", "--B", "12",
                  "--N", "32768"]):
        if sdf_segments.main(argv) != 0:
            raise AssertionError(f"sdf_segments.py {' '.join(argv)} failed")


# --------------------------------------------------------------- phase 3
def request_image(i, H, W):
    """A shaded ellipsoid on white, like data/synthetic.py::_render_maps."""
    rng = np.random.RandomState(1000 + i)
    radii = 0.25 + 0.25 * rng.rand(3)
    color = 0.2 + 0.8 * rng.rand(3)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    u = (x + 0.5) / W * 2 - 1
    v = (y + 0.5) / H * 2 - 1
    r2 = (u / (radii[0] + 0.3)) ** 2 + (v / (radii[1] + 0.3)) ** 2
    mask = (r2 <= 1.0).astype(np.float32)[..., None]
    shade = (0.4 + 0.6 * np.sqrt(np.maximum(1.0 - r2, 0.0)))[..., None]
    rgb = color[None, None] * shade * mask + (1 - mask)
    return rgb[None].astype(np.float32)


def check_finite(name, t):
    import torch
    t = torch.as_tensor(t)
    if t.numel() == 0 or not torch.isfinite(t).all():
        raise AssertionError(f"{name}: empty or non-finite output")


def serve(runner, opt, image, stages=None):
    """One request: forward + grid, marching tets, turntable. `stages`, when
    given, collects each stage's host-clock ms (synchronised)."""
    import torch
    from shapeclipper_torch.eval3d import isosurface
    from shapeclipper_torch.utils.easydict import EasyDict as edict

    def mark(name, t0):
        if stages is not None:
            if runner.device.type == "cuda":
                torch.cuda.synchronize()
            stages.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)
        return time.perf_counter()

    t = time.perf_counter()
    var = edict(idx=np.array([0]),
                rgb_input_map=torch.from_numpy(image).to(runner.device))
    var, level = runner.eval_forward_and_grid(var)
    t = mark("forward+grid", t)
    level_np = level[0].cpu().numpy()
    mesh = isosurface.marching_cubes_world(level_np, *opt.eval.range)
    t = mark("marching tets (host)", t)
    var = runner.vis_rotate(opt, var, n_views=N_VIEWS)
    mark(f"turntable ({N_VIEWS} views)", t)
    return var, level, mesh


def profiled(tag, what, fn, n_top, watch=(), share=None, counts=None):
    """Run `fn` once under torch.profiler and log its wall time, the device
    busy time (kernels, copies and sets; user-annotation ranges such as
    `Optimizer.step#Adam.step` span kernels already counted and are left
    out) and their number, the busy share, the top device events and, in or
    out of the top, the events whose name holds a string of `watch`; with
    `share = (label, strings)` the device time of the events whose name
    holds one of `strings` and its part of the busy time; into the dict
    `counts`, when given, wall, busy and device_events -> (wall ms, busy ms
    or None when the trace holds no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, ranges = {}, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        into = ranges if e.is_user_annotation else busy
        into[e.key] = (e.self_device_time_total / 1e3, e.count)
    total = sum(v[0] for v in busy.values())
    events = sum(v[1] for v in busy.values())
    if counts is not None:
        counts.update(wall=wall_ms, busy=total if total > 0 else None,
                      device_events=events)
    if total <= 0:
        log(f"[{tag}] no device time in the trace: busy share not measured")
        return wall_ms, None
    top = sorted(busy.items(), key=lambda kv: -kv[1][0])[:n_top]
    log(f"[{tag}] {what} under the profiler: wall {wall_ms:.1f} ms, device "
        f"busy {total:.1f} ms ({100 * total / wall_ms:.1f}%) over {events} "
        "device events; top: "
        + "; ".join(f"{k[:50]} {v:.2f} ms x{c}" for k, (v, c) in top)
        + "; annotation ranges left out: "
        + (", ".join(f"{k[:40]} {v:.2f} ms" for k, (v, _) in ranges.items())
           or "none"))
    if watch:
        log(f"[{tag}] watched: " + ("; ".join(
            f"{k[:60]} {v:.3f} ms x{c}" for k, (v, c) in busy.items()
            if any(w in k for w in watch)) or "none in the trace"))
    if share:
        label, strings = share
        part = sum(v for k, (v, _) in busy.items()
                   if any(w in k for w in strings))
        log(f"[{tag}] {label}: {part:.2f} ms of the {total:.1f} ms busy "
            f"({100 * part / total:.1f}%)")
    return wall_ms, total


def kernel_device_ms(fn, kernel, calls=SDF_TIMED_CALLS):
    """Device time a launch of the kernels whose name holds `kernel`, from
    torch.profiler's trace of `calls` calls of `fn` (after one warm-up
    call), or None when the trace holds no device time for them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key:
            total += e.self_device_time_total
            count += e.count
    return total / 1e3 / count if count and total > 0 else None


def phase_serve(opt):
    import torch
    from shapeclipper_torch.ops import fused_sdf as F
    from shapeclipper_torch.train.trainer import Runner
    from shapeclipper_torch import vis as util_vis

    runner = Runner(opt, "cuda")
    runner.build_networks(opt)
    runner.restore_checkpoint(opt)
    images = [request_image(i, opt.H, opt.W) for i in range(N_REQUESTS)]
    vox = opt.eval.vox_res
    n_chunks = -(-(vox + 1) ** 3 // 131072)
    per_request = {"grad": 1 + N_VIEWS, "nograd": n_chunks, "grad_bf16": 0,
                   "nograd_bf16": 0, "pack_bf16": 0}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    latencies, outputs, stages = [], [], {}
    for i, image in enumerate(images):
        before = dict(F.KERNEL.launches)
        t0 = time.perf_counter()
        var, level, mesh = serve(runner, opt, image,
                                 stages if i > 0 else None)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        delta = {k: F.KERNEL.launches[k] - before[k] for k in before}
        if delta != per_request:
            raise AssertionError(f"request {i}: kernel launches {delta}, "
                                 f"expected {per_request}")
        outputs.append((var, level, mesh))
    launches = dict(F.KERNEL.launches)
    if any(F.BACKWARD.launches.values()):
        raise AssertionError("serving launched the backward kernel")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    H, W = opt.eval.image_size
    for i, (var, level, mesh) in enumerate(outputs):
        for key in ("rgb_recon_map", "mask_recon_map", "normal_recon_map",
                    "depth_recon", "pose", "proj_latent_sdf"):
            check_finite(f"request {i} {key}", var[key])
        assert var.rgb_recon_map.shape == (1, H, W, 3)
        check_finite(f"request {i} level", level)
        assert level.shape == (1, vox + 1, vox + 1, vox + 1)
        for frames in (var.rotating_imgs, var.rotating_masks,
                       var.rotating_normals):
            assert len(frames) == N_VIEWS
            check_finite(f"request {i} turntable", np.stack(frames))
        if mesh.vertices.shape[0] == 0:
            raise AssertionError(f"request {i}: empty mesh")
        check_finite(f"request {i} mesh", mesh.vertices)
        radius = float(np.linalg.norm(mesh.vertices, axis=-1).mean())
        # the width-64 geometric init is a rough sphere of radius
        # init_sphere_radius; seeds 0-2 gave mean radii 0.485-0.593 on the
        # CPU, so hold it to 0.5 +- 0.15
        if abs(radius - opt.arch.impl_sdf.init_sphere_radius) > 0.15:
            raise AssertionError(f"request {i}: mean vertex radius {radius}")
        log(f"[serve] request {i}: {latencies[i]:.1f} ms, mesh "
            f"{mesh.vertices.shape[0]} vertices, mean radius {radius:.4f}, "
            f"mask mean {float(var.mask_recon_map.mean()):.4f}")

    # request 0 against the same graph on the CPU (the plain path)
    var0, level0, mesh0 = outputs[0]
    cpu = Runner(opt, "cpu")
    cpu.graph = copy.deepcopy(runner.graph).cpu()
    cpu.graph_eval = cpu.graph.with_opt(runner.graph_eval.opt)
    t0 = time.perf_counter()
    ref, ref_level, _ = serve(cpu, opt, images[0])
    cpu_ms = (time.perf_counter() - t0) * 1e3
    errs = {}
    for key, tol in (("proj_latent_sdf", 1e-4), ("proj_latent_rgb", 1e-4),
                     ("pose", 1e-5), ("rgb_recon_map", 1e-3),
                     ("mask_recon_map", 1e-3), ("normal_recon_map", 1e-3),
                     ("depth_recon", 1e-3)):
        errs[key], ok = within(var0[key].cpu(), ref[key], tol, tol)
        if not ok:
            raise AssertionError(f"{key}: GPU vs CPU max abs err "
                                 f"{errs[key]} > {tol}")
    errs["level"], ok = within(level0.cpu(), ref_level, 1e-4, 0.0)
    if not ok:
        raise AssertionError(f"level grid: GPU vs CPU {errs['level']}")
    errs["turntable"] = max(float(np.abs(a - b).max()) for a, b in
                            zip(var0.rotating_imgs, ref.rotating_imgs))
    if errs["turntable"] > 1e-3:
        raise AssertionError(f"turntable GPU vs CPU {errs['turntable']}")
    log("[serve] request 0 GPU vs CPU plain path (CPU took "
        f"{cpu_ms:.0f} ms): " + ", ".join(f"{k}={v:.2e}"
                                          for k, v in errs.items()))

    log("[serve] steady stages (median of requests 2-4): " + ", ".join(
        f"{k} {statistics.median(v):.1f} ms" for k, v in stages.items()))
    profiled("profile", "one request", lambda: serve(runner, opt, images[1]),
             6)
    util_vis.dump_images(opt, var0.idx, "image_input", images[0],
                         folder="serve")
    util_vis.dump_meshes(opt, var0.idx, "mesh", [mesh0], folder="serve")
    steady = statistics.median(latencies[1:])
    log(f"[serve] {N_REQUESTS} requests: first {latencies[0]:.1f} ms, "
        f"steady (median of 2-{N_REQUESTS}) {steady:.1f} ms, all "
        + ", ".join(f"{t:.1f}" for t in latencies)
        + f" ms; peak device memory {peak_gib:.3f} GiB; launches {launches}")
    return launches, latencies, images[0]


def phase_cli(opt, image):
    """The CLI once, on the GPU, from request 0's image written as a PNG."""
    import PIL.Image
    from shapeclipper_torch import infer
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "request0.png")
    PIL.Image.fromarray((image[0] * 255).round().astype(np.uint8)).save(path)
    t0 = time.perf_counter()
    infer.main([f"--yaml={CONFIG}", f"--output_root={OUT_DIR}",
                "--name=cli", f"--image={path}", f"--n_rotate={N_VIEWS}",
                "--device=cuda"])
    out = os.path.join(OUT_DIR, opt.group, "cli", "infer")
    for f in ("0_image_recon.png", "0_mask_recon.png", "0_normal_recon.png",
              "0_mesh.ply", "0_image_rotate.gif"):
        if not os.path.isfile(os.path.join(out, f)):
            raise AssertionError(f"CLI did not write {f}")
    log(f"[cli] python -m shapeclipper_torch.infer wrote {out} in "
        f"{time.perf_counter() - t0:.1f} s (model build included)")


# --------------------------------------------------------------- phase 3
def k2_bytes(B, N):
    """Bytes K2 must move: points and the three cotangents read, the point
    gradient written, the weights and biases read and their gradients
    written, each once."""
    from shapeclipper_torch.ops.fused_sdf import BIAS_WIDTH, NUM_WEIGHTS
    return 4 * (B * N * (3 + 68 + 3) + 2 * NUM_WEIGHTS + 2 * B * BIAS_WIDTH)


def phase_backward():
    """K2 (through the K1 + K2 autograd Function) against plain autograd of
    the plain version: parameter, latent and point gradients of
    <cotangents, (sdf, feat, grad)>."""
    import torch
    from shapeclipper_torch.models.implicit import SDFNetwork
    from shapeclipper_torch.ops import fused_sdf as F

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(SEED)
    net = SDFNetwork(geometric_init=False, generator=g).to(dev)

    def grads(pts, lat, cots, kernel, model=net):
        model.zero_grad()
        p = pts.clone().requires_grad_(True)
        lt = lat.clone().requires_grad_(True)
        if kernel:
            out = F.fused_sdf_train(model, p, lt)
        else:
            kk, bb = F.prepare_fused_params(model, lt)
            out = F._forward_plain(kk, bb, p, *F._arch(model), True, True)
        sum((o * c).sum() for o, c in zip(out, cots)).backward()
        res = {n: q.grad.clone() for n, q in model.named_parameters()}
        res.update(points=p.grad.clone(), latent=lt.grad.clone())
        return res

    cases = [("render", 12, 32768, False), ("eikonal", 12, 1024, False),
             ("ragged", 2, 300, False), ("x=0 plane", 2, 300, True)]
    worst, shapes = 0.0, {}
    for label, B, N, plane in cases:
        pts = torch.rand(B, N, 3, generator=g) * 2 - 1
        if plane:
            pts[:, ::3, 0] = 0.0
        lat = torch.randn(B, 64, generator=g) * 0.3
        cots = [torch.randn(B, N, c, generator=g) for c in (1, 64, 3)]
        pts, lat = pts.to(dev), lat.to(dev)
        cots = [c.to(dev) for c in cots]
        got = grads(pts, lat, cots, True)
        want = grads(pts, lat, cots, False)
        torch.cuda.synchronize()
        errs, bad = {}, []
        for k, w in want.items():
            scale = max(float(w.abs().max()), 1e-3)
            errs[k], ok = within(got[k], w, BWD_ATOL * scale, BWD_RTOL)
            if not ok or not torch.isfinite(got[k]).all():
                bad.append(k)
        top = max(errs, key=errs.get)
        log(f"[k2] {label} B={B} N={N}: max abs err {errs[top]:.3e} "
            f"({top}), points {errs['points']:.3e}, latent "
            f"{errs['latent']:.3e} (tol atol {BWD_ATOL} x max|ref|, rtol "
            f"{BWD_RTOL})")
        if bad:
            raise AssertionError(f"K2 disagrees with plain autograd at "
                                 f"{label}: {bad}")
        worst = max(worst, max(errs.values()))
        shapes[label] = (pts, lat, cots)
        if label == "render":
            # both float32 results against the plain version in float64
            net64 = copy.deepcopy(net).double()
            ref = grads(pts.double(), lat.double(), [c.double() for c in cots],
                        False, net64)
            dk = max(float((got[k].double() - w).abs().max())
                     for k, w in ref.items())
            dp = max(float((want[k].double() - w).abs().max())
                     for k, w in ref.items())
            log(f"[k2] render against the float64 plain version: K2 max abs "
                f"err {dk:.3e}, float32 plain {dp:.3e}")
            del net64, ref

    def k2_args(label):
        pts, lat, cots = shapes[label]
        with torch.no_grad():
            weights, bias = F.pack_fused_params(
                *F.prepare_fused_params(net, lat))
        return (pts, weights, bias, cots[0][..., 0].contiguous(), cots[1],
                cots[2], True)

    # two launches on the same inputs are bitwise equal
    args = k2_args("render")
    first, second = F.BACKWARD.launch(*args), F.BACKWARD.launch(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("weights", "biases", "points"), first, second):
        if not torch.equal(a, b):
            raise AssertionError(f"two K2 launches differ in d {name}")
    usage = ptxas_usage(F.BACKWARD.ptxas_log, "fused_sdf_bwd_kernel")
    log(f"[k2] K2 ptxas: {usage[0]} registers, {usage[1]} bytes spill "
        f"stores, {usage[2]} bytes spill loads")
    if usage[1] or usage[2]:
        raise AssertionError(f"K2 spills registers: {usage}")
    log("[k2] two launches at the render shape: bitwise equal")

    # times at the eikonal shape, then at the render shape
    args = k2_args("eikonal")
    eik_ms = cuda_ms(lambda: F.BACKWARD.launch(*args), calls=SDF_TIMED_CALLS)
    B, N = args[0].shape[:2]
    eik_bound, eik_by = bound(FLOP_K2 * B * N, k2_bytes(B, N))
    pts_e, lat_e, cots_e = shapes["eikonal"]
    pe = pts_e.clone().requires_grad_(True)
    out = F._forward_plain(*F.prepare_fused_params(net, lat_e), pe,
                           *F._arch(net), True, True)
    eik_plain_ms = cuda_ms(lambda: torch.autograd.backward(
        out, cots_e, retain_graph=True))
    del out
    log(f"[k2] B={B} N={N} (eikonal): K2 alone {eik_ms:.4f} ms (bound "
        f"{eik_bound:.4f} ms, {eik_by}, {100 * eik_bound / eik_ms:.1f}% of "
        f"it reached), plain backward {eik_plain_ms:.4f} ms")
    args = k2_args("render")
    pts, lat, cots = shapes["render"]
    B, N = pts.shape[:2]
    k2_ms = cuda_ms(lambda: F.BACKWARD.launch(*args), calls=SDF_TIMED_CALLS)
    p = pts.clone().requires_grad_(True)

    def pair():
        out = F.fused_sdf_train(net, p, lat)
        torch.autograd.backward(out, cots)

    def plain():
        kk, bb = F.prepare_fused_params(net, lat)
        out = F._forward_plain(kk, bb, p, *F._arch(net), True, True)
        torch.autograd.backward(out, cots)

    pair_ms = cuda_ms(pair)
    plain_pair_ms = cuda_ms(plain)
    # the plain backward alone: autograd of one kept plain forward
    kk, bb = F.prepare_fused_params(net, lat)
    out = F._forward_plain(kk, bb, p, *F._arch(net), True, True)
    plain_ms = cuda_ms(lambda: torch.autograd.backward(out, cots,
                                                       retain_graph=True))
    del out
    flop = FLOP_K2 * B * N
    bound_ms, bound_by = bound(flop, k2_bytes(B, N))
    log(f"[k2] B={B} N={N}: K2 alone {k2_ms:.4f} ms ({flop / k2_ms / 1e9:.1f}"
        f" TFLOP/s of the function's FLOPs; bound {bound_ms:.4f} ms, "
        f"{bound_by}, {100 * bound_ms / k2_ms:.1f}% of it reached), plain backward "
        f"{plain_ms:.4f} ms ({plain_ms / k2_ms:.2f}x); K1 + K2 pair "
        f"{pair_ms:.4f} ms, plain forward + backward {plain_pair_ms:.4f} ms "
        f"({plain_pair_ms / pair_ms:.2f}x)")
    net.zero_grad()
    return dict(err=worst, ms=k2_ms, plain_ms=plain_ms, pair_ms=pair_ms,
                bound_ms=bound_ms, bound_by=bound_by, eikonal_ms=eik_ms)


# --------------------------------------------------------------- phase 5
def flagship_opt(batch_size=None, dtype="float32", merged=False):
    """options/pix3d/config.yaml with bench.py's overrides: synthetic data,
    224^2, batch 12 (or `batch_size`), seed 0, both `tpu.*_dtype` keys
    `dtype` (float32 unless a phase asks for the YAML's bfloat16), the three
    `tpu.merge_*` flags `merged` (false, the sequential step, unless a phase
    asks for the YAML's merged one), no TensorBoard."""
    from shapeclipper_torch.config import options
    from shapeclipper_torch.utils.easydict import EasyDict as edict
    opt = options.load_options(CONFIG)
    opt.tpu.update(encoder_dtype=dtype, implicit_dtype=dtype,
                   merge_encoders=merged, merge_flip_estimator=merged,
                   merge_nn_render=merged)
    if batch_size:
        opt.batch_size = batch_size
    opt.H, opt.W = opt.image_size
    opt.data.dataset = "synthetic"
    opt.data.num_workers = 0
    opt.data.max_img_cat = opt.batch_size
    opt.data.synthetic = edict(azim_range=[-180, 180], elev_range=[-90, 90],
                               theta_range=[-90, 90])
    opt.seed = SEED
    opt.tb = False
    opt.resume, opt.load = False, None
    opt.output_path = os.path.join(OUT_DIR, f"train_b{opt.batch_size}")
    return opt


def one_batch(opt, noise_images=False):
    """One pre-collated batch of the synthetic dataset (as bench.py), with
    uniform-noise input images when `noise_images`."""
    from shapeclipper_torch.data import synthetic
    from shapeclipper_torch.data.base import default_collate
    ds = synthetic.Dataset(opt, split="train")
    batch = default_collate([ds[i] for i in range(opt.batch_size)])
    if noise_images:
        rng = np.random.RandomState(SEED + 3)
        for key in ("rgb_input_map", "rgb_input_map_NN"):
            batch[key] = rng.uniform(0, 1, batch[key].shape).astype(
                np.float32)
    return batch


def train_runner(opt, device):
    from shapeclipper_torch.train.trainer import Runner
    runner = Runner(opt, device)
    runner.build_networks(opt)
    runner.setup_optimizer(opt)
    runner.restore_checkpoint(opt)
    return runner


def check_loss(label, loss):
    for k, v in loss.items():
        if k != "finite" and not np.isfinite(float(v)):
            raise AssertionError(f"{label}: loss {k} = {float(v)}")
    if not bool(loss.finite):
        raise AssertionError(f"{label}: loss.finite is False")


def phase_train():
    """Step 0 (camera) and N_FULL_STEPS full steps at the flagship config,
    on one pre-collated batch, with the launch counts of each step."""
    import torch
    from shapeclipper_torch.ops import fused_sdf as F
    from shapeclipper_torch.train.trainer import batch_to_var

    opt = flagship_opt()
    runner = train_runner(opt, "cuda")
    var = batch_to_var(one_batch(opt), runner.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times = []
    for step in range(1 + N_FULL_STEPS):
        k1, k2 = F.KERNEL.launches["grad"], F.BACKWARD.launches["float32"]
        t0 = time.perf_counter()
        loss = runner.train_iteration(opt, var)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        got = (F.KERNEL.launches["grad"] - k1,
               F.BACKWARD.launches["float32"] - k2)
        want = (3, 1) if step == 0 else (3, 3)
        if got != want:
            raise AssertionError(f"step {step}: launches K1/K2 {got}, "
                                 f"expected {want}")
        check_loss(f"step {step}", loss)
        log(f"[train] step {step} ({'camera' if step == 0 else 'full'}): "
            f"{times[-1]:.1f} ms, K1 {got[0]} / K2 {got[1]} launches, loss "
            + ", ".join(f"{k} {float(v):.4f}" for k, v in loss.items()
                        if k != "finite"))
    launches = read_launches()
    if launches["k1_bf16"] or launches["k2_bf16"]:
        raise AssertionError(f"the float32 step launched bf16 kernels: "
                             f"{launches}")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = statistics.median(times[2:])
    log(f"[train] flagship (batch {opt.batch_size}, {opt.H}x{opt.W}, "
        f"{opt.render.rand_sample} rays x {opt.render.n_samples_uniform} "
        f"samples, {opt.reg.n_views} NN view): camera step {times[0]:.1f} ms,"
        f" first full step {times[1]:.1f} ms, steady full step (median of "
        f"steps 2-{N_FULL_STEPS}) {steady:.1f} ms; peak device memory "
        f"{peak_gib:.3f} GiB; launches {launches}")
    profiled("train", "one full step",
             lambda: runner.train_iteration(opt, var), 8,
             share=("cuDNN (convolution kernels)", CONV_KERNELS))
    return launches


@contextlib.contextmanager
def counting_bn(graph):
    """A one-element list counting the BatchNorm module calls under `graph`
    inside the block."""
    from shapeclipper_torch.models.layers import BatchNorm
    calls = [0]

    def hook(*_):
        calls[0] += 1
    handles = [m.register_forward_pre_hook(hook) for m in graph.modules()
               if isinstance(m, BatchNorm)]
    try:
        yield calls
    finally:
        for h in handles:
            h.remove()


def _to(tree, device):
    from shapeclipper_torch.utils.easydict import EasyDict as edict
    if isinstance(tree, list):
        return [_to(t, device) for t in tree]
    return edict({k: v.to(device) for k, v in tree.items()})


def phase_gpu_vs_cpu_step(merged=False):
    """The first full step on the card and on the CPU plain path, from the
    same weights, optimizer state and draws, at batch 4 with noise input
    images; with `merged` the YAML's merged step (one ResNet34, one ResNet18
    and one render over 2 x 4 views, on the same draws re-sliced), in
    float32 as the rest. Tolerances as tests/test_torch_train.py's full
    step, with the
    MLPs' and beta's gradients held to MLP_GRAD_TOL: train-mode BatchNorm
    makes the encoders' gradients ill-conditioned in float32. At
    batch 2 the latent projections' BatchNorm normalises two samples per
    feature, and the two runs' encoder gradients differed by 2.8x their
    norm, which says nothing about the code; batch 4 is the smallest batch
    where the comparison means something."""
    import torch
    from shapeclipper_torch.train.trainer import batch_to_var
    from shapeclipper_torch.utils.easydict import EasyDict as edict

    opt = flagship_opt(batch_size=4, merged=merged)
    tag = "step-cmp-merged" if merged else "step-cmp"
    gpu = train_runner(opt, "cuda")
    cpu = train_runner(opt, "cpu")
    cpu.graph.load_state_dict(gpu.graph.state_dict())
    batch = one_batch(opt, noise_images=True)
    B, R, S = opt.batch_size, opt.render.rand_sample, opt.render.n_samples_uniform
    g = torch.Generator().manual_seed(SEED + 5)
    lo, hi = opt.arch.impl_sdf.eikonal_sample_range
    draws = edict(
        render=edict(t_rand=torch.rand(B, R, S, generator=g),
                     eik_idx=torch.randint(0, S, (B, R, 1), generator=g),
                     eik_uniform=lo + (hi - lo) * torch.rand(
                         B, R, 3, generator=g)),
        render_NN=[edict(t_rand=torch.rand(B, R, S, generator=g))
                   for _ in range(opt.reg.n_views)])
    losses = {}
    for role, r in (("gpu", gpu), ("cpu", cpu)):
        r.it = 1   # a full step from fresh optimizer states
        d = edict(render=_to(draws.render, r.device),
                  render_NN=_to(draws.render_NN, r.device))
        t0 = time.perf_counter()
        losses[role] = r.train_iteration(opt, batch_to_var(batch, r.device),
                                         draws=d)
        torch.cuda.synchronize()
        log(f"[{tag}] {role} full step at batch {B} "
            f"{1e3 * (time.perf_counter() - t0):.0f} ms")
    lr = float(opt.optim.lr)
    bad = []
    loss_err = {}
    for k, v in losses["cpu"].items():
        if k == "finite":
            continue
        e = abs(float(losses["gpu"][k]) - float(v))
        loss_err[k] = e / max(abs(float(v)), 1e-6)
        if e > 2e-3 * abs(float(v)) + 1e-6:
            bad.append(f"loss {k}")
    gp = dict(gpu.graph.named_parameters())
    grad_err, par_err, diffs = {}, {}, []
    for name, p in cpu.graph.named_parameters():
        q = gp[name]
        grad_err[name] = float((q.grad.cpu() - p.grad).norm()
                               / max(float(p.grad.norm()), 1e-30))
        d = (q.detach().cpu() - p.detach()).abs()
        par_err[name] = float(d.max()) / lr
        diffs.append(d.flatten())
        # the MLPs and beta see no BatchNorm: held 10x tighter
        grad_tol = MLP_GRAD_TOL if name.split(".")[0] in MLP_ROOTS else 0.1
        # + 1e-6: float32 rounding of parameter values up to ~8
        if grad_err[name] > grad_tol or float(d.max()) > 2 * lr + 1e-6:
            bad.append(name)
    mean_d = float(torch.cat(diffs).mean()) / lr
    if mean_d > 0.02:
        bad.append("mean parameter difference")
    gb = dict(gpu.graph.named_buffers())
    bn_err = 0.0
    for name, b in cpu.graph.named_buffers():
        if "running" in name:
            e = float((gb[name].cpu() - b).abs().max())
            scale = max(float(b.abs().max()), 1e-6)
            bn_err = max(bn_err, e / scale)
            if e > 1e-3 * scale:
                bad.append(name)
    top = sorted(grad_err.items(), key=lambda kv: -kv[1])[:4]
    mlp = max(v for k, v in grad_err.items()
              if k.split(".")[0] in MLP_ROOTS)
    log(f"[{tag}] first full step, GPU vs CPU plain path: loss terms max "
        f"rel {max(loss_err.values()):.2e} (tol 2e-3); gradients max "
        f"norm-rel {top[0][1]:.2e} (tol 0.1; worst "
        + ", ".join(f"{k} {v:.2e}" for k, v in top)
        + f"; SDF/RGB MLPs and beta {mlp:.2e}, tol {MLP_GRAD_TOL}); "
        f"post-Adam parameters max "
        f"{max(par_err.values()):.3f} lr (tol 2 lr), mean {mean_d:.4f} lr "
        f"(tol 0.02 lr); BN running stats max rel {bn_err:.2e} (tol 1e-3)")
    if bad:
        raise AssertionError(f"GPU vs CPU {tag} outside tolerance: {bad}")


# ------------------------------------------------------- phases 5a-5d: bf16
def phase_bf16_kernels(opt):
    """(a) K1-bf16, K3-bf16 and K2-bf16 against their bf16 plain versions
    (`mm_dtype="bfloat16"`) at the main path's shapes: K1 at the eval
    render's 262,144 points and the training render's 12 x 32,768, K3 at
    vox 64, K2 at 12 x 32,768 and 12 x 1,024 (eikonal); each also held
    under half its distance from the float32 kernel (the size of the
    precision change, logged), and timed beside the float32 kernel and the
    plain version in the same call. K3-bf16 lies on no CLI path (as in the
    JAX package): one `fused_sdf_forward(mm_dtype="bfloat16")` call, its
    API check, is counted -> dict of results and that count."""
    import torch
    from shapeclipper_torch.ops import fused_sdf as F

    dev = torch.device("cuda")
    net, cases = forward_cases(opt, dev)
    res = {}
    with torch.inference_mode():
        for key, cg, pts, latent in cases[:3]:
            B, N = pts.shape[:2]
            label = f"{'K1' if cg else 'K3'}-bf16 B={B} N={N}"
            if not cg:   # the API check: one launch through the wrapper
                reset_launches()
            k = F.fused_sdf_forward(net, pts, latent, cg, mm_dtype="bfloat16")
            if not cg:
                api = read_launches()["k3_bf16"]
            k32 = F.fused_sdf_forward(net, pts, latent, cg)
            torch.cuda.synchronize()
            r = F.fused_sdf_forward_reference(net, pts, latent, cg,
                                              mm_dtype="bfloat16")
            parts = ("sdf", "feat", "grad")[:3 if cg else 2]
            errs = check_bf16(dict(zip(parts, k)), dict(zip(parts, r)),
                              dict(zip(parts, k32)), f"({label})",
                              BF16_MAX_TOL, BF16_MEAN_TOL)
            kernels, biases = F.prepare_fused_params(net, latent)
            weights, bias = F.pack_fused_params(kernels, biases)
            frags = F.KERNEL.pack_bf16(weights)[0]

            def launch_bf16():
                return F.KERNEL.launch(pts, frags, bias, cg, True,
                                       "bfloat16")
            ms = cuda_ms(launch_bf16, calls=SDF_TIMED_CALLS)
            ms32 = cuda_ms(lambda: F.KERNEL.launch(pts, weights, bias, cg,
                                                   True),
                           calls=SDF_TIMED_CALLS)
            if (key, B) == ("grad", 12):
                prof_ms = kernel_device_ms(launch_bf16,
                                           "fused_sdf_fwd_bf16_kernel")
                log(f"[bf16] {label}: torch.profiler's device time "
                    + ("not measured (no device time in the trace)"
                       if prof_ms is None else f"{prof_ms:.4f} ms")
                    + f" a launch over {SDF_TIMED_CALLS} launches, CUDA "
                    f"events {ms:.4f} ms")
            plain_ms = cuda_ms(lambda: F._forward_plain(
                kernels, biases, pts, *F._arch(net), cg, True, "bfloat16"))
            flop, (bound_ms, bound_by) = forward_bound(B, N, cg, bf16=True)
            log(f"[bf16] {label}: against the bf16 plain version max / mean "
                "abs err " + ", ".join(f"{p} {e[0]:.3e} / {e[1]:.3e}"
                                       for p, e in errs.items())
                + f" (tol {BF16_MAX_TOL} / {BF16_MEAN_TOL}); mean abs "
                "distance from the float32 kernel " + ", ".join(
                    f"{p} {e[2]:.3e}" for p, e in errs.items())
                + f"; kernel {ms:.4f} ms, float32 kernel {ms32:.4f} ms "
                f"({ms32 / ms:.2f}x), plain bf16 {plain_ms:.4f} ms; bound "
                f"{bound_ms:.4f} ms ({bound_by}, {100 * bound_ms / ms:.1f}% "
                "of it reached)")
            res[(key, B)] = dict(err=max(e[0] for e in errs.values()), ms=ms,
                                 f32_ms=ms32, plain_ms=plain_ms,
                                 bound_ms=bound_ms, bound_by=bound_by)
        res["pack"] = check_bf16_pack(weights)

    for label, name in (("K1-bf16", "fused_sdf_fwd_bf16_kernelILb1E"),
                        ("K3-bf16", "fused_sdf_fwd_bf16_kernelILb0E")):
        regs, st, ld, stack = ptxas_usage(F.KERNEL.ptxas_log, name,
                                          stack=True)
        log(f"[bf16] {label} ptxas: {regs} registers, {stack} bytes stack "
            f"frame, {st} / {ld} bytes spill stores / loads")
    g = torch.Generator().manual_seed(SEED + 11)

    def grads(pts, lat, cots, kernel, mm):
        net.zero_grad()
        p = pts.clone().requires_grad_(True)
        lt = lat.clone().requires_grad_(True)
        if kernel:
            out = F.fused_sdf_train(net, p, lt, mm_dtype=mm)
        else:
            kk, bb = F.prepare_fused_params(net, lt)
            out = F._forward_plain(kk, bb, p, *F._arch(net), True, True, mm)
        sum((o * c).sum() for o, c in zip(out, cots)).backward()
        out = {n: q.grad.clone() for n, q in net.named_parameters()}
        out.update(points=p.grad.clone(), latent=lt.grad.clone())
        return out

    for label, B, N in (("eikonal", 12, 1024), ("render", 12, 32768)):
        pts = (torch.rand(B, N, 3, generator=g) * 2 - 1).to(dev)
        lat = (torch.randn(B, 64, generator=g) * 0.3).to(dev)
        cots = [torch.randn(B, N, c, generator=g).to(dev) for c in (1, 64, 3)]
        got = grads(pts, lat, cots, True, "bfloat16")
        want = grads(pts, lat, cots, False, "bfloat16")
        f32 = grads(pts, lat, cots, True, "float32")
        torch.cuda.synchronize()
        scale = {k: max(float(w.abs().max()), 1e-3) for k, w in want.items()}
        # the output bias's gradient sums the cotangents, which no product
        # rounds: the same in both precisions
        errs = check_bf16(got, want, f32, f"(K2-bf16 at {label})",
                          {k: BF16_K2_MAX * v for k, v in scale.items()},
                          {k: BF16_K2_MEAN * v for k, v in scale.items()},
                          no_gap=("lin5.bias",))
        with torch.no_grad():
            weights, bias = F.pack_fused_params(
                *F.prepare_fused_params(net, lat))
        w16 = weights.to(torch.bfloat16)
        args = (pts, bias, cots[0][..., 0].contiguous(), cots[1], cots[2])
        if label == "render":
            # two launches on the same inputs are bitwise equal; no spills
            a = F.BACKWARD.launch(args[0], w16, *args[1:], True, "bfloat16")
            b = F.BACKWARD.launch(args[0], w16, *args[1:], True, "bfloat16")
            torch.cuda.synchronize()
            for name, x, y in zip(("weights", "biases", "points"), a, b):
                if not torch.equal(x, y):
                    raise AssertionError(f"two K2-bf16 launches differ in d "
                                         f"{name}")
            usage = ptxas_usage(F.BACKWARD.ptxas_log,
                                "fused_sdf_bwd_bf16_kernel")
            log(f"[bf16] K2-bf16 two launches at B={B} N={N}: bitwise "
                f"equal; ptxas: {usage[0]} registers, {usage[1]} bytes spill "
                f"stores, {usage[2]} bytes spill loads")
            if usage[1] or usage[2]:
                raise AssertionError(f"K2-bf16 spills registers: {usage}")
        ms = cuda_ms(lambda: F.BACKWARD.launch(args[0], w16, *args[1:], True,
                                               "bfloat16"),
                     calls=SDF_TIMED_CALLS)
        ms32 = cuda_ms(lambda: F.BACKWARD.launch(args[0], weights, *args[1:],
                                                 True), calls=SDF_TIMED_CALLS)
        kk, bb = F.prepare_fused_params(net, lat)
        pp = pts.clone().requires_grad_(True)
        out = F._forward_plain(kk, bb, pp, *F._arch(net), True, True,
                               "bfloat16")
        plain_ms = cuda_ms(lambda: torch.autograd.backward(
            out, cots, retain_graph=True))
        del out
        flop = FLOP_K2 * B * N
        bound_ms, bound_by = bound(ELEM_K2 * B * N, k2_bytes(B, N),
                                   mm_flop=flop)
        rel = {k: (e[0] / scale[k], e[1] / scale[k], e[2] / scale[k])
               for k, e in errs.items()}
        top = max(rel, key=lambda k: rel[k][0])
        mean = max(e[1] for e in rel.values())
        log(f"[bf16] K2-bf16 {label} B={B} N={N}: against plain autograd "
            f"of the bf16 plain version, over max|ref|, max abs err "
            f"{rel[top][0]:.3e} ({top}), mean {mean:.3e} (tol {BF16_K2_MAX} "
            f"/ {BF16_K2_MEAN}); points max / mean {rel['points'][0]:.3e} / "
            f"{rel['points'][1]:.3e}, mean distance from the float32 pair "
            f"points {rel['points'][2]:.3e}, lin0.weight "
            f"{rel['lin0.weight'][2]:.3e}; K2-bf16 {ms:.4f} ms, float32 K2 "
            f"{ms32:.4f} ms ({ms32 / ms:.2f}x), plain bf16 backward "
            f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}, "
            f"{100 * bound_ms / ms:.1f}% of it reached)")
        res[("k2", label)] = dict(err=max(e[0] for e in errs.values()), ms=ms,
                                  f32_ms=ms32,
                                  plain_ms=plain_ms, bound_ms=bound_ms,
                                  bound_by=bound_by)
    net.zero_grad()
    return res, api


def check_bf16_pack(weights):
    """The bf16 weight pack (`FusedSdfKernel.pack_bf16`: K1-bf16 / K3-bf16's
    fragments and K2-bf16's plain copy, one launch where the cast was one)
    bitwise against its plain version, timed beside it and beside the cast
    it replaces -> its results."""
    import torch
    from shapeclipper_torch.ops import fused_sdf as F
    got = F.KERNEL.pack_bf16(weights)
    want = F.pack_bf16_reference(weights)
    torch.cuda.synchronize()
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, want))
    if not all(torch.equal(a.view(torch.int16), b.view(torch.int16))
               for a, b in zip(got, want)):
        raise AssertionError(f"the bf16 weight pack differs from its plain "
                             f"version (max abs {err:.3e})")
    ms = cuda_ms(lambda: F.KERNEL.pack_bf16(weights), calls=SDF_TIMED_CALLS)
    plain_ms = cuda_ms(lambda: F.pack_bf16_reference(weights))
    cast_ms = cuda_ms(lambda: weights.to(torch.bfloat16),
                      calls=SDF_TIMED_CALLS)
    # a launch this small is timed by the host's launch path: the
    # profiler's device time says what the kernel itself takes
    device_ms = kernel_device_ms(lambda: F.KERNEL.pack_bf16(weights),
                                 "pack_bf16_kernel")
    bound_ms, bound_by = bound(0, 4 * F.NUM_WEIGHTS
                               + 2 * (F.BF16_FRAG_ELEMS + F.NUM_WEIGHTS))
    log(f"[bf16] weight pack: bitwise its plain version; {ms:.4f} ms a call "
        f"(the cast it replaces {cast_ms:.4f} ms), device time "
        + ("not measured" if device_ms is None else f"{device_ms:.4f} ms")
        + f", plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}, "
        f"{100 * bound_ms / ms:.1f}% of it reached)")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, cast_ms=cast_ms, device_ms=device_ms)


def phase_train_bf16():
    """(b) The flagship training step at the YAML's own dtypes (bf16
    ResNets, K1-bf16 + K2-bf16 in every render, a bf16 RGB MLP): a camera
    step and N_BF16_STEPS full steps on one batch, launch counts per step
    (K1-bf16 3 / K2-bf16 1, then 3 / 3; the float32 K1 / K2 none), the
    steady step, peak memory, one step under the profiler with cuDNN's
    share of the busy time."""
    import torch
    from shapeclipper_torch.ops import fused_sdf as F
    from shapeclipper_torch.train.trainer import batch_to_var

    opt = flagship_opt(dtype="bfloat16")
    runner = train_runner(opt, "cuda")
    var = batch_to_var(one_batch(opt), runner.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times = []
    for step in range(1 + N_BF16_STEPS):
        before = read_launches()
        t0 = time.perf_counter()
        loss = runner.train_iteration(opt, var)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        now = read_launches()
        got = {k: now[k] - before[k] for k in now if now[k] != before[k]}
        # one weight pack for each K1-bf16 launch (it replaces the cast)
        want = dict(k1_bf16=3, k2_bf16=1 if step == 0 else 3, pack_bf16=3)
        if got != want:
            raise AssertionError(f"bf16 step {step}: launches {got}, "
                                 f"expected {want}")
        check_loss(f"bf16 step {step}", loss)
        log(f"[train-bf16] step {step} ({'camera' if step == 0 else 'full'}"
            f"): {times[-1]:.1f} ms, launches {got}, loss "
            + ", ".join(f"{k} {float(v):.4f}" for k, v in loss.items()
                        if k != "finite"))
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = statistics.median(times[2:])
    log(f"[train-bf16] flagship at tpu.encoder_dtype = tpu.implicit_dtype = "
        f"bfloat16: camera step {times[0]:.1f} ms, first full step "
        f"{times[1]:.1f} ms, steady full step (median of steps "
        f"2-{N_BF16_STEPS}) {steady:.1f} ms; peak device memory "
        f"{peak_gib:.3f} GiB; launches {launches}")
    summary = dict(steady=steady, peak_gib=peak_gib, per_step=got)
    with counting_bn(runner.graph) as bn:
        profiled("train-bf16", "one bf16 full step",
                 lambda: runner.train_iteration(opt, var), 8,
                 share=("cuDNN (convolution kernels)", CONV_KERNELS),
                 counts=summary)
    summary["bn_calls"] = bn[0]
    return launches, summary


def phase_serve_bf16():
    """(c) Single-image requests at the YAML's own dtypes: the bf16 ResNets,
    K1-bf16 for the eval render and the turntable, the float32 K3 for the
    grid; launch counts per request and the steady latency."""
    import torch
    from shapeclipper_torch.train.trainer import Runner

    opt = load_opt(dtype="bfloat16")
    runner = Runner(opt, "cuda")
    runner.build_networks(opt)
    runner.restore_checkpoint(opt)
    vox = opt.eval.vox_res
    per_request = dict(k1_bf16=1 + N_VIEWS, pack_bf16=1 + N_VIEWS,
                       k3=-(-(vox + 1) ** 3 // 131072))
    reset_launches()
    latencies = []
    for i in range(N_BF16_REQUESTS):
        image = request_image(i, opt.H, opt.W)
        before = read_launches()
        t0 = time.perf_counter()
        var, level, mesh = serve(runner, opt, image)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        now = read_launches()
        got = {k: now[k] - before[k] for k in now if now[k] != before[k]}
        if got != per_request:
            raise AssertionError(f"bf16 request {i}: launches {got}, "
                                 f"expected {per_request}")
        for key in ("rgb_recon_map", "normal_recon_map", "proj_latent_sdf"):
            check_finite(f"bf16 request {i} {key}", var[key])
        check_finite(f"bf16 request {i} level", level)
        if mesh.vertices.shape[0] == 0:
            raise AssertionError(f"bf16 request {i}: empty mesh")
    launches = read_launches()
    log(f"[serve-bf16] {N_BF16_REQUESTS} requests at the YAML's dtypes: "
        + ", ".join(f"{t:.1f}" for t in latencies) + " ms (steady median "
        f"{statistics.median(latencies[1:]):.1f} ms); launches per request "
        f"{per_request}, in all {launches}")
    return launches


def _grad_roots(runner):
    out = {}
    for name, p in runner.graph.named_parameters():
        out.setdefault(name.split(".")[0], []).append(
            p.grad.detach().flatten().cpu())
    import torch
    return {k: torch.cat(v) for k, v in out.items()}


def phase_gpu_vs_cpu_step_bf16():
    """(d) The first full step at batch 4 on the card and on the CPU plain
    path, from the same weights and draws, in bf16. Gate: with
    `tpu.implicit_dtype` bfloat16 (K1-bf16 + K2-bf16 and the bf16 RGB MLP
    on the card, their plain versions on the CPU) and float32 ResNets,
    every loss finite and each MLP root's gradient (SDF, RGB, beta) closer
    to the CPU's, in norm, than half its distance from the card's float32
    step (tests/test_torch_bf16*.py's rule). Reading: the same with both
    keys bfloat16; train-mode BatchNorm over 4 samples turns bf16 rounding
    flips into differences of the size of the bf16 effect
    (tests/test_torch_bf16_step.py), so it is logged, not gated."""
    import torch
    from shapeclipper_torch.train.trainer import batch_to_var
    from shapeclipper_torch.utils.easydict import EasyDict as edict

    base = flagship_opt(batch_size=4)
    batch = one_batch(base, noise_images=True)
    B, R, S = 4, base.render.rand_sample, base.render.n_samples_uniform
    g = torch.Generator().manual_seed(SEED + 5)
    lo, hi = base.arch.impl_sdf.eikonal_sample_range
    draws = edict(
        render=edict(t_rand=torch.rand(B, R, S, generator=g),
                     eik_idx=torch.randint(0, S, (B, R, 1), generator=g),
                     eik_uniform=lo + (hi - lo) * torch.rand(
                         B, R, 3, generator=g)),
        render_NN=[edict(t_rand=torch.rand(B, R, S, generator=g))
                   for _ in range(base.reg.n_views)])

    def step(enc, imp, device):
        opt = flagship_opt(batch_size=4)
        opt.tpu.update(encoder_dtype=enc, implicit_dtype=imp)
        opt.output_path = os.path.join(OUT_DIR, f"bf16_cmp_{device}")
        r = train_runner(opt, device)
        r.it = 1
        d = edict(render=_to(draws.render, r.device),
                  render_NN=_to(draws.render_NN, r.device))
        t0 = time.perf_counter()
        loss = r.train_iteration(opt, batch_to_var(batch, r.device), draws=d)
        torch.cuda.synchronize()
        check_loss(f"{enc}/{imp} step on {device}", loss)
        log(f"[step-cmp-bf16] encoders {enc}, implicit {imp} on {device}: "
            f"{1e3 * (time.perf_counter() - t0):.0f} ms")
        return {k: float(v) for k, v in loss.items() if k != "finite"}, \
            _grad_roots(r)

    ref_loss, ref = step("float32", "float32", "cuda")
    bad = []
    for enc, gate in (("float32", True), ("bfloat16", False)):
        lg, gg = step(enc, "bfloat16", "cuda")
        lc, gc = step(enc, "bfloat16", "cpu")
        rows = []
        for root in ("sdf_network", "rgb_network", "density", "encoder",
                     "estimator"):
            norm = max(float(gc[root].norm()), 1e-30)
            err = float((gg[root] - gc[root]).norm()) / norm
            gap = float((gg[root] - ref[root]).norm()) / norm
            rows.append(f"{root} {err:.2e} (gap {gap:.2e})")
            if gate and root in MLP_ROOTS and not err < 0.5 * gap:
                bad.append(f"{enc}: {root}")
        lerr = max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-6) for k in lc)
        lgap = max(abs(lg[k] - ref_loss[k]) / max(abs(lc[k]), 1e-6)
                   for k in lc)
        log(f"[step-cmp-bf16] {'gate' if gate else 'reading'}, encoders "
            f"{enc} + implicit bfloat16, card vs CPU: gradient norm-rel "
            + ", ".join(rows) + f"; loss terms max rel {lerr:.2e} (from the "
            f"card's float32 step {lgap:.2e})")
    if bad:
        raise AssertionError(f"bf16 card vs CPU step: {bad} not under half "
                             "the gap to float32")


# ----------------------------------------------- phase 5e: the merged step
def phase_train_merged(seq):
    """(e) The YAML's own step: bf16 and the three `tpu.merge_*` flags true
    (one ResNet34 over the query and the NN view, one ResNet18 over the
    query, its flip and the NN view, one render over 24 views): a camera
    step and N_MERGED_STEPS full steps on one batch with the launch counts
    of each (K1-bf16 2 / K2-bf16 1, then 2 / 2, a pack a K1-bf16 launch;
    the sequential step of 5b 3 / 1, then 3 / 3), the steady step, peak
    memory, and one profiled step with its BatchNorm calls, each beside
    phase 5b's sequential step (`seq`) -> the launch counts."""
    import torch
    from shapeclipper_torch.train.trainer import batch_to_var

    opt = flagship_opt(dtype="bfloat16", merged=True)
    runner = train_runner(opt, "cuda")
    var = batch_to_var(one_batch(opt), runner.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times = []
    for step in range(1 + N_MERGED_STEPS):
        before = read_launches()
        t0 = time.perf_counter()
        loss = runner.train_iteration(opt, var)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        now = read_launches()
        got = {k: now[k] - before[k] for k in now if now[k] != before[k]}
        want = dict(k1_bf16=2, k2_bf16=1 if step == 0 else 2, pack_bf16=2)
        if got != want:
            raise AssertionError(f"merged step {step}: launches {got}, "
                                 f"expected {want}")
        check_loss(f"merged step {step}", loss)
        log(f"[train-merged] step {step} ({'camera' if step == 0 else 'full'}"
            f"): {times[-1]:.1f} ms, launches {got}, loss "
            + ", ".join(f"{k} {float(v):.4f}" for k, v in loss.items()
                        if k != "finite"))
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = statistics.median(times[2:])
    mrg = dict(steady=steady, peak_gib=peak_gib, per_step=got)
    with counting_bn(runner.graph) as bn:
        profiled("train-merged", "one merged bf16 full step",
                 lambda: runner.train_iteration(opt, var), 8,
                 share=("cuDNN (convolution kernels)", CONV_KERNELS),
                 counts=mrg)
    mrg["bn_calls"] = bn[0]

    def busy(d):
        return "not measured" if d["busy"] is None else \
            f"{d['busy']:.1f} ms ({100 * d['busy'] / d['wall']:.1f}%)"
    log(f"[train-merged] the YAML's own step (bf16, merged) against phase "
        f"5b's sequential bf16 step, one call: steady full step (median of "
        f"steps 2-{N_MERGED_STEPS}) {steady:.1f} vs {seq['steady']:.1f} ms; "
        f"profiled busy {busy(mrg)} vs {busy(seq)}, device events "
        f"{mrg['device_events']} vs {seq['device_events']}; BatchNorm calls "
        f"a full step {mrg['bn_calls']} vs {seq['bn_calls']}; fused-SDF "
        f"launches a full step {mrg['per_step']} vs {seq['per_step']}; peak "
        f"device memory {peak_gib:.3f} vs {seq['peak_gib']:.3f} GiB; card "
        f"{card_line()}")
    return launches


def sdf_grads(net, pts, lat, cots, kernel, mm="float32", chunk=None):
    """Gradients of <cots, (sdf, feat, grad)> w.r.t. the SDF network's
    parameters, the points and the latent, through the K1 + K2 pair
    (`kernel`) or plain autograd of the plain version; with `chunk`, the
    plain version over row blocks of that many samples, the parameters'
    gradients summed (a float64 reference that would not fit whole)."""
    import torch
    from shapeclipper_torch.ops import fused_sdf as F
    B = pts.shape[0]
    rows = [slice(i, min(i + (chunk or B), B))
            for i in range(0, B, chunk or B)]
    params = dict(net.named_parameters())
    out = {n: torch.zeros_like(q) for n, q in params.items()}
    parts = {"points": [], "latent": []}
    for r in rows:
        net.zero_grad()
        p = pts[r].clone().requires_grad_(True)
        lt = lat[r].clone().requires_grad_(True)
        if kernel:
            res = F.fused_sdf_train(net, p, lt, mm_dtype=mm)
        else:
            kk, bb = F.prepare_fused_params(net, lt)
            res = F._forward_plain(kk, bb, p, *F._arch(net), True, True, mm)
        sum((o * c[r]).sum() for o, c in zip(res, cots)).backward()
        del res
        for n, q in params.items():
            out[n] += q.grad
        parts["points"].append(p.grad)
        parts["latent"].append(lt.grad)
    net.zero_grad()
    out.update({k: torch.cat(v) for k, v in parts.items()})
    return out


def phase_merged_kernels():
    """(e) K1-bf16 / K2-bf16 and K1 / K2 at the merged render's shape, 24 x
    32,768 points with 24 bias rows (the shape no sequential path gives
    them): K1 against its plain version at SDF_TOL / GRAD_TOL, in float32
    and float64 (phase 2's checks at the render shape); K2 against plain
    autograd of the plain version in float64 at BWD_ATOL / BWD_RTOL (summed
    over blocks of 6 samples; the float32 plain version, phase 3's gate,
    strays here by up to 0.18 on the points' gradient, outside that
    tolerance in most parameters, so it is a reading); K1-bf16 against
    its bf16 plain version and K2-bf16 against its bf16 plain version in
    float64 (the float32 one strays as K2's), both under `check_bf16`'s
    rule (phase 5a's bounds), K2-bf16 also bitwise over two launches;
    each timed over SDF_TIMED_CALLS launches beside its plain version and
    its bound -> {kernel: results}."""
    import torch
    from shapeclipper_torch.models.implicit import SDFNetwork
    from shapeclipper_torch.ops import fused_sdf as F

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(SEED + 14)
    net = SDFNetwork(geometric_init=False, generator=g).to(dev)
    B, N = MERGED_VIEWS, 32768
    pts = (torch.rand(B, N, 3, generator=g) * 2 - 1).to(dev)
    lat = (torch.randn(B, 64, generator=g) * 0.3).to(dev)
    cots = [torch.randn(B, N, c, generator=g).to(dev) for c in (1, 64, 3)]
    parts = ("sdf", "feat", "grad")
    res = {}
    with torch.inference_mode():
        kernels, biases = F.prepare_fused_params(net, lat)
        weights, bias = F.pack_fused_params(kernels, biases)
        frags = F.KERNEL.pack_bf16(weights)[0]
        k32 = F.fused_sdf_forward(net, pts, lat, True)
        torch.cuda.synchronize()
        errs = check_forward(k32, F.fused_sdf_forward_reference(
            net, pts, lat, True), f"at B={B} N={N}")
        forward_float64(net, pts, lat, k32)
        kb = F.fused_sdf_forward(net, pts, lat, True, mm_dtype="bfloat16")
        torch.cuda.synchronize()
        rb = F.fused_sdf_forward_reference(net, pts, lat, True,
                                           mm_dtype="bfloat16")
        errs_b = check_bf16(dict(zip(parts, kb)), dict(zip(parts, rb)),
                            dict(zip(parts, k32)), f"(K1-bf16 at B={B} N={N})",
                            BF16_MAX_TOL, BF16_MEAN_TOL)
        del k32, kb, rb
        for key, err, launch, mm in (
                ("k1", max(errs.values()),
                 lambda: F.KERNEL.launch(pts, weights, bias, True, True),
                 "float32"),
                ("k1_bf16", max(e[0] for e in errs_b.values()),
                 lambda: F.KERNEL.launch(pts, frags, bias, True, True,
                                         "bfloat16"), "bfloat16")):
            ms = cuda_ms(launch, calls=SDF_TIMED_CALLS)
            plain_ms = cuda_ms(lambda: F._forward_plain(
                kernels, biases, pts, *F._arch(net), True, True, mm))
            _, (bound_ms, bound_by) = forward_bound(B, N, True,
                                                    bf16=mm == "bfloat16")
            res[key] = dict(err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
    log(f"[merged-kernels] K1 at B={B} N={N}: max abs err "
        + ", ".join(f"{p}={e:.3e}" for p, e in errs.items())
        + f" (tol sdf/feat {SDF_TOL}, grad {GRAD_TOL}); K1-bf16 against the "
        "bf16 plain version max / mean abs err " + ", ".join(
            f"{p} {e[0]:.3e} / {e[1]:.3e}" for p, e in errs_b.items())
        + f" (tol {BF16_MAX_TOL} / {BF16_MEAN_TOL}), mean distance from "
        "the float32 kernel " + ", ".join(f"{p} {e[2]:.3e}"
                                          for p, e in errs_b.items()))

    # K2 against plain autograd of the plain version in float64 (here the
    # float32 plain version itself strays at a few points: a reading)
    got = sdf_grads(net, pts, lat, cots, True)
    want = sdf_grads(net, pts, lat, cots, False)
    net64 = copy.deepcopy(net).double()
    ref = sdf_grads(net64, pts.double(), lat.double(),
                    [c.double() for c in cots], False, chunk=6)
    torch.cuda.synchronize()
    errs, plain32, bad = {}, {}, []
    for k, w in ref.items():
        scale = max(float(w.abs().max()), 1e-3)
        errs[k], ok = within(got[k].double(), w, BWD_ATOL * scale, BWD_RTOL)
        plain32[k] = within(want[k].double(), w, BWD_ATOL * scale, BWD_RTOL)
        if not ok or not torch.isfinite(got[k]).all():
            bad.append(k)
    if bad:
        raise AssertionError(f"K2 disagrees with the float64 plain version "
                             f"at B={B} N={N}: {bad} {errs}")
    dk32 = max(float((got[k] - w).abs().max()) for k, w in want.items())
    # K2-bf16 against plain autograd of the bf16 plain version, in float64
    # as K2 (the float32 one strays too, by 3.2e-2 of max|ref| on the
    # points, and its mean reaches the mean gate's noise floor: a reading)
    got_b = sdf_grads(net, pts, lat, cots, True, "bfloat16")
    want_b = sdf_grads(net, pts, lat, cots, False, "bfloat16")
    ref_b = sdf_grads(net64, pts.double(), lat.double(),
                      [c.double() for c in cots], False, "bfloat16", chunk=6)
    torch.cuda.synchronize()
    scale = {k: max(float(w.abs().max()), 1e-3) for k, w in ref_b.items()}
    errs_b = check_bf16(got_b, ref_b, got, f"(K2-bf16 at B={B} N={N})",
                        {k: BF16_K2_MAX * v for k, v in scale.items()},
                        {k: BF16_K2_MEAN * v for k, v in scale.items()},
                        no_gap=("lin5.bias",))
    plain32_b = {k: (float((want_b[k].double() - w).abs().max()) / scale[k],
                     float((want_b[k].double() - w).abs().mean()) / scale[k])
                 for k, w in ref_b.items()}
    del net64, ref, got, want, got_b, want_b, ref_b
    torch.cuda.empty_cache()
    sbar = cots[0][..., 0].contiguous()
    w16 = weights.to(torch.bfloat16)
    a = F.BACKWARD.launch(pts, w16, bias, sbar, cots[1], cots[2], True,
                          "bfloat16")
    b = F.BACKWARD.launch(pts, w16, bias, sbar, cots[1], cots[2], True,
                          "bfloat16")
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("two K2-bf16 launches at the merged shape differ")
    del a, b
    rel = {k: e[0] / scale[k] for k, e in errs_b.items()}
    top = max(rel, key=rel.get)
    for key, mm, w in (("k2", "float32", weights),
                       ("k2_bf16", "bfloat16", w16)):
        ms = cuda_ms(lambda: F.BACKWARD.launch(pts, w, bias, sbar, cots[1],
                                               cots[2], True, mm),
                     calls=SDF_TIMED_CALLS)
        kk, bb = F.prepare_fused_params(net, lat)
        pp = pts.clone().requires_grad_(True)
        out = F._forward_plain(kk, bb, pp, *F._arch(net), True, True, mm)
        plain_ms = cuda_ms(lambda: torch.autograd.backward(
            out, cots, retain_graph=True))
        del out, kk, bb, pp
        torch.cuda.empty_cache()
        if mm == "bfloat16":
            bound_ms, bound_by = bound(ELEM_K2 * B * N, k2_bytes(B, N),
                                       mm_flop=FLOP_K2 * B * N)
        else:
            bound_ms, bound_by = bound(FLOP_K2 * B * N, k2_bytes(B, N))
        res[key] = dict(err=max(errs.values()) if mm == "float32"
                        else max(e[0] for e in errs_b.values()), ms=ms,
                        plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by)
    net.zero_grad()
    top2 = max(errs, key=errs.get)
    top32 = max(plain32, key=lambda k: plain32[k][0])
    log(f"[merged-kernels] K2 at B={B} N={N} against the float64 plain "
        f"version: max abs err {errs[top2]:.3e} ({top2}; tol atol {BWD_ATOL} "
        f"x max|ref|, rtol {BWD_RTOL}); the float32 plain version there "
        f"{plain32[top32][0]:.3e} ({top32}), within that tolerance in "
        f"{sum(ok for _, ok in plain32.values())} of {len(plain32)} parts; "
        f"K2 against the float32 plain version {dk32:.3e}; K2-bf16 against "
        f"the float64 bf16 plain version over max|ref| {rel[top]:.3e} "
        f"({top}), mean {max(e[1] / scale[k] for k, e in errs_b.items()):.3e}"
        f" (tol {BF16_K2_MAX} / {BF16_K2_MEAN}), two launches bitwise equal;"
        f" the float32 bf16 plain version there max "
        f"{max(v[0] for v in plain32_b.values()):.3e}, mean "
        f"{max(v[1] for v in plain32_b.values()):.3e}")
    for key, label in (("k1", "K1"), ("k1_bf16", "K1-bf16"), ("k2", "K2"),
                       ("k2_bf16", "K2-bf16")):
        r = res[key]
        log(f"[merged-kernels] {label} at B={B} N={N}: {r['ms']:.4f} ms "
            f"({SDF_TIMED_CALLS} launches between two events), plain "
            f"{r['plain_ms']:.4f} ms ({r['plain_ms'] / r['ms']:.2f}x), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}, "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of it reached)")
    log(f"[merged-kernels] card {card_line()}")
    return res


def check_profile_trace(run, window):
    """The Chrome trace that the train CLI's `--tpu.profile_iters` window
    wrote under `run/profile/` (`trace_iters_A-B.json` for the iterations
    `window`): one file, whose device kernels include the fused SDF pair
    (the forward and the backward)."""
    folder = os.path.join(run, "profile")
    traces = sorted(os.listdir(folder))
    name = f"trace_iters_{window[0]}-{window[1]}.json"
    if traces != [name]:
        raise AssertionError(f"profile window: traces {traces}, expected "
                             f"{name}")
    path = os.path.join(folder, name)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0) + 1
    sdf = {k: v for k, v in kernels.items() if "fused_sdf" in k}
    if not any("fused_sdf_fwd" in k for k in sdf) or \
            not any("fused_sdf_bwd" in k for k in sdf):
        raise AssertionError(f"the trace names no fused SDF kernel: "
                             f"{sorted(kernels)[:20]}")
    log(f"[cli] the profiler window's {name} "
        f"({os.path.getsize(path) / 2 ** 20:.1f} MiB, {len(events)} events, "
        f"{sum(kernels.values())} kernel launches); fused SDF kernels: "
        + "; ".join(f"{k[:60]} x{v}" for k, v in sorted(sdf.items())))


# --------------------------------------------------------------- phase 6
def phase_converge():
    """scripts/validate_training.py's run, N_CONVERGE steps, through
    load_dataset's loader, with `Runner.evaluate` (a training evaluation)
    before and after; the loss and the Chamfer distance must fall."""
    from shapeclipper_torch.config import options
    from shapeclipper_torch.train.trainer import batch_to_var
    opt = options.load_options(os.path.join(REPO, "options", "synthetic",
                                            "config.yaml"))
    opt.update(name="validate", seed=SEED, resume=False, load=None, tb=None,
               batch_size=8, image_size=[64, 64], max_epoch=10 ** 6)
    opt.tpu.update(encoder_dtype="float32", implicit_dtype="float32")
    opt.H, opt.W = opt.image_size
    opt.data.update(max_img_cat=32, num_workers=2)
    opt.render.update(rand_sample=256, n_samples_uniform=32)
    opt.eval.update(batch_size=2, image_size=[32, 32], vox_res=32,
                    num_points=8192, n_vis=1)
    opt.freq.update(scalar=10 ** 6, vis=10 ** 6, save_vis=10 ** 6,
                    ckpt_latest=10 ** 6, eval=10 ** 6)
    opt.output_path = os.path.join(OUT_DIR, "validate")
    runner = train_runner(opt, "cuda")
    runner.load_dataset(opt)
    cd_init = runner.evaluate(opt, ep=0, training=True)
    losses, epoch = [], 0
    t0 = time.perf_counter()
    while len(losses) < N_CONVERGE:
        runner.train_loader.set_epoch(epoch)
        for batch in runner.train_loader:
            loss = runner.train_iteration(opt,
                                          batch_to_var(batch, runner.device))
            losses.append(float(loss.all))
            if len(losses) >= N_CONVERGE:
                break
        epoch += 1
    train_s = time.perf_counter() - t0
    cd_final = runner.evaluate(opt, ep=1, training=True)
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    log(f"[converge] {N_CONVERGE} steps of options/synthetic/config.yaml "
        f"(scripts/validate_training.py overrides) in {train_s:.1f} s: "
        f"loss_first10 {first:.4f} -> loss_last10 {last:.4f}, CD "
        f"{cd_init:.4f} -> {cd_final:.4f} (the JAX record, bf16 and flax's "
        f"initialisation: loss 0.883 -> 0.341, CD 0.0947 -> 0.0496; compare "
        f"the direction only)")
    if not all(np.isfinite(losses)) or not last < first:
        raise AssertionError(f"loss did not fall: {first} -> {last}")
    if not np.isfinite(cd_final) or not cd_final < cd_init:
        raise AssertionError(f"CD did not fall: {cd_init} -> {cd_final}")


# --------------------------------------------------------------- phase 7
def nn_case(label, x1, x2):
    """K4 (distances) and K5 (with the argmin), both directions, against the
    plain version on the card -> (max abs err K4, K5, argmin near-ties)."""
    import torch
    from shapeclipper_torch.ops import chamfer as C
    with torch.no_grad():
        d = C.chamfer_dists_sq(x1, x2)
        k = C.chamfer_distance_sq(x1, x2)
        plain = [C.nn_plain(x1, x2, True, PLAIN_BLOCK_CARD),
                 C.nn_plain(x2, x1, True, PLAIN_BLOCK_CARD)]
    torch.cuda.synchronize()
    err4 = err5 = 0.0
    ties = 0
    for direction, (a, b) in enumerate(((x1, x2), (x2, x1))):
        pd, pi = plain[direction]
        for got, which in ((d[direction], 4), (k[direction], 5)):
            if got.shape != pd.shape or not torch.isfinite(got).all():
                raise AssertionError(f"K{which} {label}: shape "
                                     f"{tuple(got.shape)} or non-finite")
            e, ok = within(got, pd, NN_TOL["atol"], NN_TOL["rtol"])
            if not ok:
                raise AssertionError(f"K{which} disagrees with its plain "
                                     f"version at {label}: {e}")
            err4, err5 = (max(err4, e), err5) if which == 4 else (
                err4, max(err5, e))
        idx = k[2 + direction]
        differ = idx != pi
        n_differ = int(differ.sum())
        if n_differ > max(1, idx.numel() // NN_TIES_PER):
            raise AssertionError(f"K5 {label}: {n_differ} argmins differ "
                                 f"from the plain version's")
        if n_differ:
            chosen = torch.gather(b, 1, idx.long()[..., None].expand(-1, -1,
                                                                      3))
            d_chosen = ((a - chosen) ** 2).sum(-1)
            _, ok = within(d_chosen[differ], pd[differ], NN_TOL["atol"],
                           NN_TOL["rtol"])
            if not ok:
                raise AssertionError(f"K5 {label}: an argmin is not at a "
                                     f"minimum")
            ties += n_differ
    return err4, err5, ties


def cdist_min(a, b, rows=8192):
    """The library yardstick: torch.cdist (the |a|^2 + |b|^2 - 2 a.b form
    through a matrix product) and a min, over row chunks."""
    import torch
    return torch.cat([torch.cdist(a[:, s:s + rows], b).amin(2)
                      for s in range(0, a.shape[1], rows)], dim=1)


def phase_chamfer():
    import torch
    from shapeclipper_torch.ops import chamfer as C

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(SEED + 11)

    def clouds(B, N1, N2):
        return (torch.randn(B, N1, 3, generator=g).to(dev),
                torch.randn(B, N2, 3, generator=g).to(dev))

    worst4 = worst5 = 0.0
    for label, (B, N1, N2) in (("ragged 2 x (1,000 vs 3,001)", (2, 1000,
                                                                3001)),
                               ("4 x 8,192", (4, 8192, 8192))):
        e4, e5, ties = nn_case(label, *clouds(B, N1, N2))
        worst4, worst5 = max(worst4, e4), max(worst5, e5)
        log(f"[k4/k5] {label}: max abs err K4 {e4:.3e}, K5 {e5:.3e}, argmin "
            f"near-ties {ties} (tol {NN_TOL})")
    # exact ties: identical clouds, then every point twice plus one point
    # five more times
    x, _ = clouds(2, 3000, 1)
    with torch.no_grad():
        d1, d2, i1, i2 = C.chamfer_distance_sq(x, x)
        self_idx = torch.arange(3000, device=dev, dtype=torch.int32)
        if float(d1.abs().max()) != 0.0 or not torch.equal(
                i1, self_idx.expand(2, -1)):
            raise AssertionError("K5 identical clouds: distance or argmin "
                                 "is not exact")
        dup = torch.cat([x, x, x[:, 7:8].expand(2, 5, 3)], 1).contiguous()
        _, _, j1, j2 = C.chamfer_distance_sq(x, dup)
        want = torch.cat([self_idx, self_idx, torch.full(
            (5,), 7, device=dev, dtype=torch.int32)])
        if not (torch.equal(j1, self_idx.expand(2, -1))
                and torch.equal(j2, want.expand(2, -1))):
            raise AssertionError("K5 duplicated points: not the lowest index")
        if float(C.chamfer_dists_sq(x, x)[0].abs().max()) != 0.0:
            raise AssertionError("K4 identical clouds: distance is not 0")
    log("[k4/k5] identical clouds (distance 0, argmin = self) and "
        "duplicated points (lowest index; the copies in different chunks of "
        "the split sweep): exact")

    # a ragged split: B's cloud in chunks, the last one short
    x1, x2 = clouds(3, 257, 20_001)
    e4, e5, ties = nn_case("ragged split 3 x (257 vs 20,001)", x1, x2)
    worst4, worst5 = max(worst4, e4), max(worst5, e5)
    splits = split_vs_one(x1, x2, "3 x (257 vs 20,001)")
    log(f"[k4/k5] ragged split 3 x (257 vs 20,001): max abs err K4 "
        f"{e4:.3e}, K5 {e5:.3e}, argmin near-ties {ties}; splits {splits} "
        f"(A -> B, B -> A), bitwise equal to splits=1 and to a repeat")

    # the timing shape, then the evaluation's: 100,000 predicted points
    # against the synthetic GT's 2,048 (the 2,048-row direction splits);
    # phase 8 checks the clouds of the evaluated samples themselves
    x1, x2 = clouds(1, N_NN, N_NN)
    gt = clouds(1, N_GT, 1)[0]
    shapes = {"full": (x1, x2, f"1 x {N_NN:,} x {N_NN:,}"),
              "eval": (x1, gt, f"1 x {N_NN:,} x {N_GT:,} (the evaluation's "
                               "shape)")}
    times = {}
    for key, (a, b, label) in shapes.items():
        e4, e5, ties = nn_case(label, a, b)
        worst4, worst5 = max(worst4, e4), max(worst5, e5)
        splits = split_vs_one(a, b, label)
        if key == "eval" and splits[1] < 2:
            raise AssertionError(f"the {N_GT:,}-row direction at {label} "
                                 f"does not split: {splits}")
        log(f"[k4/k5] {label}: max abs err K4 {e4:.3e}, K5 {e5:.3e}, argmin "
            f"near-ties {ties}; splits {splits} (A -> B, B -> A), bitwise "
            f"equal to splits=1 and to a repeat")
        times[key] = split_ab(a, b)
    with torch.no_grad():
        plain_ms, lib_ms = {}, {}
        for key, (a, b, _) in shapes.items():
            for name, with_index in (("k4", False), ("k5", True)):
                plain_ms[key, name] = cuda_ms(lambda: (
                    C.nn_plain(a, b, with_index, PLAIN_BLOCK_CARD),
                    C.nn_plain(b, a, with_index, PLAIN_BLOCK_CARD)),
                    runs=3, warmup=1)
            lib_ms[key] = cuda_ms(lambda: (cdist_min(a, b), cdist_min(b, a)),
                                  runs=3, warmup=1)
    out = {}
    for name, err in (("k4", worst4), ("k5", worst5)):
        row = dict(err=err)
        for key, (a, b, label) in shapes.items():
            B, N1, N2 = a.shape[0], a.shape[1], b.shape[1]
            flop = NN_FLOP_PER_PAIR * B * N1 * N2          # each pair once
            nbytes = 4 * B * 4 * (N1 + N2) + (
                4 * B * (N1 + N2) if name == "k5" else 0)
            bound_ms, bound_by = bound(flop, nbytes)
            ms, one_ms = times[key][name]
            pre = "" if key == "full" else "eval_"
            row.update({f"{pre}shape": f"{label}, both directions",
                        f"{pre}ms": ms, f"{pre}splits1_ms": one_ms,
                        f"{pre}plain_ms": plain_ms[key, name],
                        f"{pre}bound_ms": bound_ms,
                        f"{pre}bound_by": bound_by,
                        f"{pre}library_ms": lib_ms[key]})
            log(f"[k4/k5] {name.upper()} at {label}, both directions: kernel "
                f"{ms:.4f} ms ({2 * flop / ms / 1e9:.1f} TFLOP/s of the two "
                f"sweeps' FLOPs), splits=1 {one_ms:.4f} ms ({one_ms / ms:.2f}x"
                f"), plain {plain_ms[key, name]:.4f} ms, torch.cdist + amin "
                f"{lib_ms[key]:.4f} ms (dot form, distances not squared); "
                f"bound {bound_ms:.4f} ms ({bound_by}, {NN_FLOP_PER_PAIR} FLOP "
                f"per pair counted once; the two sweeps do each pair twice), "
                f"{100 * bound_ms / ms:.1f}% of it reached")
        out[name] = row
    return out


def split_vs_one(a, b, label):
    """K4 and K5 in both directions with `nn_splits`'s chunks, bitwise
    equal to `splits=1` and to a repeat launch -> the chosen splits of
    (a -> b, b -> a)."""
    import torch
    from shapeclipper_torch.ops import chamfer as C
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    splits = []
    for x, y in ((a, b), (b, a)):
        splits.append(C.nn_splits(x.shape[0], x.shape[1], y.shape[1], sms))
        for with_index in (False, True):
            with torch.no_grad():
                runs = [C.KERNEL.launch(x, y, with_index),
                        C.KERNEL.launch(x, y, with_index, splits=1),
                        C.KERNEL.launch(x, y, with_index)]
            torch.cuda.synchronize()
            for d, i in runs[1:]:
                if not torch.equal(d, runs[0][0]) or (
                        with_index and not torch.equal(i, runs[0][1])):
                    raise AssertionError(
                        f"K{5 if with_index else 4} at {label}: "
                        f"{splits[-1]} chunks differ from splits=1 or from "
                        f"a repeat")
    return tuple(splits)


def split_ab(a, b):
    """K4 and K5, both directions through the kernel's wrapper: CUDA-event
    ms with `nn_splits`'s chunks and with `splits=1`, in turns (one, chosen,
    chosen, one), each the mean of its two turns -> {k4: (chosen, one),
    k5: (...)}."""
    import torch
    from shapeclipper_torch.ops import chamfer as C

    def sweeps(with_index, splits):
        return (C.KERNEL.launch(a, b, with_index, splits=splits),
                C.KERNEL.launch(b, a, with_index, splits=splits))

    out = {}
    with torch.no_grad():
        for name, with_index in (("k4", False), ("k5", True)):
            t = [cuda_ms(lambda: sweeps(with_index, splits),
                         calls=NN_TIMED_CALLS)
                 for splits in (1, None, None, 1)]
            out[name] = ((t[1] + t[2]) / 2, (t[0] + t[3]) / 2)
    return out


# --------------------------------------------------------------- phase 8
def eval_opt(name, vox=None, num_points=None, n_samples=None, dump=True):
    """options/pix3d/config.yaml (its eval settings: batch 1, 64^2 render,
    vox 64, 100,000 points, six thresholds) on the synthetic test split."""
    from shapeclipper_torch.utils.easydict import EasyDict as edict
    opt = load_opt()
    opt.data.dataset = "synthetic"
    opt.data.num_workers = 0
    opt.data.max_img_cat = n_samples
    opt.data.synthetic = edict(azim_range=[-180, 180], elev_range=[-90, 90],
                               theta_range=[-90, 90])
    opt.tb = False
    opt.resume, opt.load = False, None
    if vox:
        opt.eval.vox_res = vox
    if num_points:
        opt.eval.num_points = num_points
    opt.eval.dump = dump
    opt.output_path = os.path.join(OUT_DIR, name)
    return opt


def eval_runner(opt, device):
    from shapeclipper_torch.train.trainer import Runner
    runner = Runner(opt, device)
    runner.load_dataset(opt, eval_split="test")
    runner.build_networks(opt)
    runner.setup_optimizer(opt)
    runner.restore_checkpoint(opt)
    return runner


def evaluate_collect(runner, opt):
    """Runner.evaluate -> (mean CD, per-sample [acc, comp] from chamfer.txt,
    per-sample F-scores as handed to the report)."""
    f_scores = []
    write = runner._write_eval_reports

    def keep(o, acc_cat, comp_cat, counts_cat, fs):
        f_scores.extend(np.asarray(f) for f in fs)
        return write(o, acc_cat, comp_cat, counts_cat, fs)

    runner._write_eval_reports = keep
    try:
        cd = runner.evaluate(opt, ep=0)
    finally:
        runner._write_eval_reports = write
    with open(os.path.join(opt.output_path, "chamfer.txt")) as f:
        rows = np.array([[float(x) for x in line.split()[1:]]
                         for line in f if line.strip()])
    return cd, rows, np.concatenate(f_scores)


@contextlib.contextmanager
def wrapped(targets):
    """Replace each (owner, attribute) by wrap(its value) for the duration,
    then restore it."""
    saved = []
    try:
        for owner, name, wrap in targets:
            saved.append((owner, name, name in vars(owner),
                          vars(owner).get(name)))
            setattr(owner, name, wrap(getattr(owner, name)))
        yield
    finally:
        for owner, name, had, value in reversed(saved):
            if had:
                setattr(owner, name, value)
            else:
                delattr(owner, name)


def synced_timer(stages, stage):
    """A wrap for `wrapped`: each call is timed on the host clock between
    two device synchronisations, into stages[stage]."""
    import torch

    def wrap(fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stages.setdefault(stage, []).append(
                (time.perf_counter() - t) * 1e3)
            return out
        return timed
    return wrap


def phase_eval():
    import torch
    from shapeclipper_torch.eval3d import isosurface
    from shapeclipper_torch.eval3d import metrics as M
    from shapeclipper_torch.ops import chamfer as C
    from shapeclipper_torch.ops import fused_sdf as F

    opt = eval_opt("eval")
    runner = eval_runner(opt, "cuda")
    n = len(runner.test_data)
    runner.evaluate(opt, ep=0)                  # warm-up: cuDNN, allocator
    torch.cuda.synchronize()
    # the clouds each evaluated sample hands to K4, kept for the check below
    clouds = []

    def keep_clouds(fn):
        def record(x1, x2):
            clouds.append((x1, x2))
            return fn(x1, x2)
        return record

    reset_launches()
    with wrapped([(M, "chamfer_dists_sq", keep_clouds)]):
        t0 = time.perf_counter()
        cd, rows, fs = evaluate_collect(runner, opt)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    vox = opt.eval.vox_res
    k3_per = -(-(vox + 1) ** 3 // M.GRID_CHUNK)
    want = dict(k1=n, k3=k3_per * n, k2=0, k1_bf16=0, k3_bf16=0, k2_bf16=0,
                pack_bf16=0, k4=2 * n, k5=0, k6=0, k7=0, **GENERIC_NONE)
    if launches != want:
        raise AssertionError(f"evaluation launches {launches}, expected "
                             f"{want}")
    if rows.shape != (n, 2) or not np.isfinite(rows).all() or \
            not np.isfinite(cd) or fs.shape != (n, len(opt.eval.f_thresholds))\
            or not ((fs >= 0) & (fs <= 1)).all():
        raise AssertionError(f"evaluation outputs: CD {cd}, chamfer rows "
                             f"{rows.shape}, F-scores {fs.shape}")
    for f in ("cd_cat.txt", "f_score.txt", "chamfer.txt",
              "dump/0_mesh.ply", "dump/0_pointclouds_comp.ply",
              f"dump/{n - 1}_image_recon.png"):
        if not os.path.isfile(os.path.join(opt.output_path, f)):
            raise AssertionError(f"evaluate did not write {f}")
    log(f"[eval] Runner.evaluate, {n} synthetic test samples at the full "
        f"eval width (batch {opt.eval.batch_size}, {opt.eval.image_size[0]}^2"
        f" render, vox {vox}, {opt.eval.num_points:,} points, dumps on): "
        f"{wall_ms:.1f} ms, {wall_ms / n:.1f} ms per sample (steady: the "
        f"second evaluation of the process); launches {launches} = per "
        f"sample K1 {launches['k1'] // n}, K3 {launches['k3'] // n}, K4 "
        f"{launches['k4'] // n}; CD {cd:.5f} (acc "
        f"{rows[:, 0].mean():.5f}, comp {rows[:, 1].mean():.5f}); F-scores "
        + ", ".join(f"@{t * 100:g}: {v:.4f}" for t, v in
                    zip(opt.eval.f_thresholds, fs.mean(0))))

    # K4 and K5 on the clouds of the evaluated samples against the plain
    # version (after the counts were read)
    if len(clouds) != n:
        raise AssertionError(f"{len(clouds)} chamfer calls for {n} samples")
    err4 = err5 = 0.0
    ties = 0
    for i, (pred, gt) in enumerate(clouds):
        e4, e5, t = nn_case(f"evaluated sample {i}, {tuple(pred.shape)} vs "
                            f"{tuple(gt.shape)}", pred, gt)
        err4, err5, ties = max(err4, e4), max(err5, e5), ties + t
    log(f"[eval] K4 / K5 on the {n} evaluated samples' clouds "
        f"({tuple(clouds[0][0].shape)} vs {tuple(clouds[0][1].shape)}): max "
        f"abs err K4 {err4:.3e}, K5 {err5:.3e}, argmin near-ties {ties} (tol "
        f"{NN_TOL})")

    # stage split: Runner.evaluate again, each stage of the path it runs
    # timed between two synchronisations (so no stage overlaps another)
    stages = {}
    finish = "metric finish (wait, host stages, rotate, Chamfer, F, fetch)"
    host_mc, host_sample = "marching tets (host)", \
        f"sampling {opt.eval.num_points:,} points (host)"
    chamfer = "Chamfer (K4, both directions)"
    dumps = "dumps (PNGs, mesh and point-cloud PLYs)"
    with wrapped([
            (runner.graph_eval, "forward",
             synced_timer(stages, f"forward ({opt.eval.image_size[0]}^2 "
                                  f"render)")),
            (M, "compute_level_grid",
             synced_timer(stages, f"grid (K3, vox {vox})")),
            (isosurface, "marching_cubes_world",
             synced_timer(stages, host_mc)),
            (isosurface, "sample_surface", synced_timer(stages, host_sample)),
            (M, "chamfer_dists_sq", synced_timer(stages, chamfer)),
            (M, "eval_metrics_finish", synced_timer(stages, finish)),
            (runner, "dump_results", synced_timer(stages, dumps))]):
        runner.evaluate(opt, ep=0)
    rest = [f - m - s - c for f, m, s, c in zip(
        stages.pop(finish), stages[host_mc], stages[host_sample],
        stages[chamfer])]
    stages["rotate / normalize, F-scores, fetch"] = rest
    stages[dumps] = stages.pop(dumps)
    if any(len(v) != n for v in stages.values()):
        raise AssertionError(f"stage split: calls per stage "
                             f"{ {k: len(v) for k, v in stages.items()} }")
    log(f"[eval] stage split of Runner.evaluate, each stage synchronised "
        f"(median of samples 2-{n}): " + ", ".join(
            f"{k} {statistics.median(v[1:]):.1f} ms"
            for k, v in stages.items()))
    wall_p, busy_p = profiled("eval", f"Runner.evaluate over the {n} samples "
                              "(pipelined, as run)",
                              lambda: runner.evaluate(opt, ep=0), 8,
                              watch=("nn_kernel", "unpack_kernel"))
    if busy_p is not None:
        log(f"[eval] per sample under the profiler: wall {wall_p / n:.1f} "
            f"ms, device busy {busy_p / n:.2f} ms")

    # 2 samples at vox 32 / 8,192 points: the card against the CPU plain
    # path from the same weights (metrics only: eval.dump false)
    res = {}
    for device in ("cuda", "cpu"):
        o = eval_opt(f"eval_cmp_{device}", vox=32, num_points=8192,
                     n_samples=2, dump=False)
        r = eval_runner(o, device)
        r.graph.load_state_dict(runner.graph.state_dict())
        t0 = time.perf_counter()
        res[device] = evaluate_collect(r, o)
        log(f"[eval-cmp] {device}: {1e3 * (time.perf_counter() - t0):.0f} "
            f"ms for 2 samples")
    (_, rows_g, fs_g), (_, rows_c, fs_c) = res["cuda"], res["cpu"]
    cd_err = float(np.max(np.abs(rows_g - rows_c) / np.abs(rows_c)))
    f_err = float(np.max(np.abs(fs_g - fs_c)))
    log(f"[eval-cmp] 2 samples at vox 32 / 8,192 points, card vs CPU plain "
        f"path: per-sample CD max rel err {cd_err:.2e} (tol {EVAL_CD_RTOL}),"
        f" F-score max abs err {f_err:.2e} (tol {EVAL_F_ATOL})")
    if not cd_err <= EVAL_CD_RTOL or not f_err <= EVAL_F_ATOL:
        raise AssertionError("card vs CPU evaluation outside tolerance")
    return launches, err4, err5


def phase_chamfer_api():
    """K5's own path: the differentiable chamfer API (`chamfer_distance`,
    forward + backward) at the metric shape, 100,000 predicted points
    against 2,048; no CLI path calls it. Counts reset just before and read
    just after. The gradient is then held against autograd of the plain
    version on the same inputs, except at the rows a near-tie argmin
    touches."""
    import torch
    from shapeclipper_torch.ops import chamfer as C
    g = torch.Generator().manual_seed(SEED + 13)
    pred = torch.randn(1, N_NN, 3, generator=g).cuda().requires_grad_(True)
    gt = torch.randn(1, 2048, 3, generator=g).cuda()
    torch.cuda.synchronize()
    C.KERNEL.launches = {"dist": 0, "argmin": 0}
    l1, l2, i1, i2 = C.chamfer_distance(None, pred, gt)
    (l1.mean() + l2.mean()).backward()
    torch.cuda.synchronize()
    launches = dict(C.KERNEL.launches)
    if launches != {"dist": 0, "argmin": 2} or \
            not torch.isfinite(pred.grad).all():
        raise AssertionError(f"chamfer API: launches {launches} or "
                             "non-finite gradient")
    ref = pred.detach().clone().requires_grad_(True)
    d1, d2, j1, j2 = C.chamfer_distance_sq_reference(ref, gt)
    (d1.sqrt().mean() + d2.sqrt().mean()).backward()
    differ1, differ2 = i1 != j1, i2 != j2
    for name, differ in (("pred -> gt", differ1), ("gt -> pred", differ2)):
        if int(differ.sum()) > max(1, differ.numel() // NN_TIES_PER):
            raise AssertionError(f"chamfer API {name}: {int(differ.sum())} "
                                 "argmins differ from the plain version's")
    # rows whose gradient a differing argmin changes: the query row of
    # direction 1, both candidate rows of direction 2
    keep = ~differ1[0]
    keep[i2[differ2].long()] = False
    keep[j2[differ2].long()] = False
    err, ok = within(pred.grad[0][keep], ref.grad[0][keep],
                     NN_GRAD_TOL["atol"], NN_GRAD_TOL["rtol"])
    log(f"[k5] chamfer_distance forward + backward at 1 x {N_NN:,} vs 2,048:"
        f" launches {launches}, Chamfer-L1 {float(l1.detach().mean()):.4f} | "
        f"{float(l2.detach().mean()):.4f}, |grad| "
        f"{float(pred.grad.norm()):.4f}; gradient vs autograd of the plain "
        f"version: max abs err {err:.3e} (tol {NN_GRAD_TOL}), "
        f"{int((~keep).sum())} rows left out for near-tie argmins")
    if not ok:
        raise AssertionError(f"K5's gradient disagrees with autograd of the "
                             f"plain version: {err}")
    return launches


# -------------------------------------------------------------- phase 8b
def bumpy_level(M, extent=0.6):
    """tests/test_device_isosurface.py's bumpy ellipsoid on an M^3 grid."""
    g = np.linspace(-extent, extent, M).astype(np.float32)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    lv = (np.sqrt(X ** 2 + 1.4 * Y ** 2 + 0.7 * Z ** 2) - 0.42
          + 0.05 * np.sin(7 * X) * np.cos(5 * Y + 2 * Z))
    return lv.astype(np.float32)


def iso_bounds(level, cdf, faces):
    """(K6's, K7's) least ms from this run's data: K6 reads the grid,
    writes the float64 sums and computes every valid slot; K7 reads its
    draws, the searched CDF values and 8 corners a draw (each input at most
    once), writes the points (the evaluation keeps no face) and computes the
    walked cells' valid slots; `faces` (the checks') locate those cells."""
    import torch
    from shapeclipper_torch.eval3d import device_isosurface as D
    B, M = level.shape[0], level.shape[1]
    C = (M - 1) ** 3
    valid = torch.as_tensor(D._VALID, device=level.device)
    n_valid = sum(int(valid[D._tet_corner_data(lv, 0.0)[0]].sum())
                  for lv in level)
    k6 = bound(B * C * ISO_FLOP_CELL + n_valid * ISO_FLOP_SLOT,
               level.numel() * 4 + B * C * 8)
    n = faces.numel()
    steps = math.ceil(math.log2(C + 1))
    walked = sum(int(valid[D._cell_corner_data(lv, f // 12, 0.0)[0]].sum())
                 for lv, f in zip(level, faces))
    k7 = bound(n * (steps + ISO_FLOP_DRAW) + walked * ISO_FLOP_SLOT,
               n * (12 + 12) + min(n * 32, level.numel() * 4)
               + min(n * steps * 8, cdf.numel() * 8))
    return k6, k7


def iso_case(label, level, n_points, seed, timed=False):
    """K6 -> cumsum -> K7 against the plain versions on the same grid,
    CDF and draws (on the card) -> the errors, and with `timed` the times
    over SDF_TIMED_CALLS launches beside the plain versions' and the
    bounds."""
    import torch
    from shapeclipper_torch.eval3d import device_isosurface as D
    from shapeclipper_torch.ops import isosurface as I
    lo, hi = -0.6, 0.6
    sums = I.KERNEL.cell_areas(level)
    plain_sums = D.cell_area_sums_plain(level)
    area_err = float((sums - plain_sums).abs().max())
    scale = float(plain_sums.max())
    cdf = torch.cumsum(sums, dim=1)
    r, u, w = D.surface_draws(level.shape[0], n_points, seed, "cuda")
    pts, faces = I.KERNEL.draw(level, cdf, r, u, w, lo, hi, with_faces=True)
    plain_pts, plain_faces = D.draw_points_plain(level, cdf, r, u, w, lo, hi,
                                                 with_faces=True)
    bare = I.KERNEL.draw(level, cdf, r, u, w, lo, hi)    # no face stored
    torch.cuda.synchronize()
    same = faces == plain_faces
    off = int((~same).sum())
    pts_err = float((pts - plain_pts).abs().amax(-1)[same].max())
    total = float(cdf[:, -1].min())
    out = dict(area_err=area_err, faces_off=off, pts_err=pts_err)
    line = (f"[iso] {label}: grid {tuple(level.shape)}, {n_points:,} draws; "
            f"K6 vs plain max abs {area_err:.3e} (largest cell sum "
            f"{scale:.4e}), K7 faces identical {1 - off / faces.numel():.6f}"
            f" ({off} off), points max abs err {pts_err:.3e} at equal faces;"
            f" smallest total area {total:.4f}")
    if area_err > ISO_AREA_RTOL * scale or \
            off > max(1, faces.numel() // ISO_FACES_PER) or \
            not pts_err <= ISO_PTS_ATOL or not total > 0 or \
            not torch.isfinite(pts).all() or not torch.equal(bare, pts):
        raise AssertionError(line + "; without faces the points equal: "
                             f"{bool(torch.equal(bare, pts))}")
    if timed:
        t6 = cuda_ms(lambda: I.KERNEL.cell_areas(level), calls=SDF_TIMED_CALLS)
        t7 = cuda_ms(lambda: I.KERNEL.draw(level, cdf, r, u, w, lo, hi),
                     calls=SDF_TIMED_CALLS)
        p6 = cuda_ms(lambda: D.cell_area_sums_plain(level), runs=5, warmup=1)
        p7 = cuda_ms(lambda: D.draw_points_plain(level, cdf, r, u, w, lo, hi),
                     runs=5, warmup=1)
        (b6, by6), (b7, by7) = iso_bounds(level, cdf, faces)
        out.update(k6=dict(ms=t6, plain_ms=p6, bound_ms=b6, bound_by=by6),
                   k7=dict(ms=t7, plain_ms=p7, bound_ms=b7, bound_by=by7))
        line += (f"; K6 {t6:.4f} ms (plain {p6:.4f}, bound {b6:.4f} by "
                 f"{by6}), K7 {t7:.4f} ms (plain {p7:.4f}, bound {b7:.4f} "
                 f"by {by7})")
    log(line)
    return out


def stage_split(stages, n, parts, wall_ms, top):
    """stages: wrapped calls' ms lists; the rest of submit + finish beyond
    `parts` becomes 'rotate / normalize, F-scores, fetch', and the wall
    beyond the `top` stages, submit and finish (the loader, the batches'
    copies, the reports) a mean per sample. Median of samples 2-n of each
    stage."""
    other = (wall_ms - sum(sum(stages[k]) for k in (*top, "submit",
                                                    "finish"))) / n
    submit, finish = stages.pop("submit"), stages.pop("finish")
    rest = [a + b - sum(stages[p][i] for p in parts if p in stages)
            for i, (a, b) in enumerate(zip(submit, finish))]
    stages["rotate / normalize, F-scores, fetch"] = rest
    if any(len(v) != n for v in stages.values()):
        raise AssertionError(f"stage split: calls per stage "
                             f"{ {k: len(v) for k, v in stages.items()} }")
    return ", ".join(f"{k} {statistics.median(v[1:]):.2f} ms"
                     for k, v in stages.items()) + (
        f"; outside these stages (loader, batch copies, reports) "
        f"{other:.2f} ms a sample")


def phase_isosurface():
    """K6 / K7 (`csrc/isosurface.cu`) against their plain versions on the
    eval runner's vox-64 and vox-100 grids, the bumpy ellipsoid and an
    exact-ties grid, timed at vox 64 and vox 100; `Runner.evaluate` with
    eval.dump false at the full eval width on the host and the device path
    (tpu.device_isosurface) in turns, launch counts reset just before and
    read just after the device path's run; tpu.eval_pipeline true against
    false on each path, in turns; 2 samples at vox 32 / 8,192 points on the
    device path, card against CPU on the same draws."""
    import torch
    from shapeclipper_torch.eval3d import device_isosurface as D
    from shapeclipper_torch.eval3d import isosurface
    from shapeclipper_torch.eval3d import metrics as M
    from shapeclipper_torch.train.trainer import batch_to_var

    opts = {dev: eval_opt(f"iso_{'device' if dev else 'host'}", dump=False)
            for dev in (False, True)}
    for dev, o in opts.items():
        o.tpu.device_isosurface = dev
    runners = {dev: eval_runner(o, "cuda") for dev, o in opts.items()}
    runners[True].graph.load_state_dict(runners[False].graph.state_dict())
    n = len(runners[True].test_data)

    # 1. the kernels against their plain versions
    runner = runners[True]
    with runner._eval_mode():
        batch = next(iter(runner.test_loader))
        var = runner.graph_eval(batch_to_var(batch, runner.device),
                                render=False)
        grids = {vox: M.compute_level_grid(opts[True], runner.graph.sdf_network,
                                           var.proj_latent_sdf, N=vox)
                 for vox in ISO_VOX}
    n_pts = opts[True].eval.num_points
    iso = {}
    for vox, level in grids.items():
        iso[vox] = iso_case(f"the eval runner's vox-{vox} grid", level,
                            n_pts, SEED, timed=True)
    rng = np.random.RandomState(SEED)
    iso["bumpy"] = iso_case("bumpy ellipsoid, M = 65",
                            torch.from_numpy(bumpy_level(65))[None].cuda(),
                            n_pts, SEED + 1)
    ties = rng.randint(-2, 3, size=(2, 33, 33, 33)).astype(np.float32)
    iso["ties"] = iso_case("exact ties (randint(-2, 3)), 2 x 33^3",
                           torch.from_numpy(ties).cuda(), n_pts, SEED + 2)

    # 2. host against device path, the same weights, in turns
    counted = {}

    def count(name):
        def wrap(fn):
            def counting(*args, **kwargs):
                counted[name] = counted.get(name, 0) + 1
                return fn(*args, **kwargs)
            return counting
        return wrap

    res, launches, splits, busy = {}, {}, {}, {}
    for dev in (False, True, True, False):
        runner, o = runners[dev], opts[dev]
        if dev not in res:                       # warm-up
            runner.evaluate(o, ep=0)
            torch.cuda.synchronize()
            counted.clear()
            reset_launches()
            with wrapped([(isosurface, "marching_cubes_world",
                           count("marching tets")),
                          (isosurface, "sample_surface", count("sampling")),
                          (M, "_start_host_copy", count("grid copies"))]):
                t0 = time.perf_counter()
                out = evaluate_collect(runner, o)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            launches[dev] = read_launches()
            res[dev] = (wall,) + out
            res[dev, "host work"] = dict(counted)
            continue
        stages = {}
        grid = f"grid (K3, vox {o.eval.vox_res})"
        samp = ("sampling (K6, cumsum, K7)" if dev else
                f"sampling {o.eval.num_points:,} points (host)")
        targets = [
            (runner.graph_eval, "forward",
             synced_timer(stages, "forward (no render)")),
            (M, "compute_level_grid", synced_timer(stages, grid)),
            (M, "chamfer_dists_sq", synced_timer(stages, "Chamfer (K4)")),
            (M, "eval_metrics_submit", synced_timer(stages, "submit")),
            (M, "eval_metrics_finish", synced_timer(stages, "finish"))]
        if dev:
            targets.append((D, "sample_level_surface_batch",
                            synced_timer(stages, samp)))
        else:
            targets += [(isosurface, "marching_cubes_world",
                         synced_timer(stages, "marching tets (host)")),
                        (isosurface, "sample_surface",
                         synced_timer(stages, samp))]
        with wrapped(targets):
            t0 = time.perf_counter()
            runner.evaluate(o, ep=0)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        splits[dev] = stage_split(stages, n, (
            grid, samp, "Chamfer (K4)", "marching tets (host)"), wall,
            ("forward (no render)",))
        busy[dev] = profiled(f"iso-{'device' if dev else 'host'}",
                             f"Runner.evaluate, eval.dump false, "
                             f"{'device' if dev else 'host'} path",
                             lambda: runner.evaluate(o, ep=0), 6,
                             watch=("cell_area_kernel", "draw_kernel",
                                    "nn_kernel"))
    vox = opts[True].eval.vox_res
    k3_per = -(-(vox + 1) ** 3 // M.GRID_CHUNK)
    zero = dict(dict.fromkeys(("k1", "k2", "k1_bf16", "k3_bf16", "k2_bf16",
                               "pack_bf16", "k5"), 0), **GENERIC_NONE)
    want = {True: dict(zero, k3=k3_per * n, k4=2 * n, k6=n, k7=n),
            False: dict(zero, k3=k3_per * n, k4=2 * n, k6=0, k7=0)}
    for dev in (False, True):
        wall, cd, rows, fs = res[dev]
        path = "device" if dev else "host"
        b = busy[dev]
        log(f"[iso-eval] {path} path, Runner.evaluate, eval.dump false, "
            f"{n} samples at vox {vox} / {opts[dev].eval.num_points:,} "
            f"points: {wall:.1f} ms, {wall / n:.2f} ms per sample; launches "
            f"{launches[dev]} = per sample K3 {launches[dev]['k3'] // n}, K4 "
            f"{launches[dev]['k4'] // n}, K6 {launches[dev]['k6'] // n}, K7 "
            f"{launches[dev]['k7'] // n}, K1 {launches[dev]['k1'] // n}; host "
            f"isosurface calls {res[dev, 'host work']}; CD {cd:.5f}; stage "
            f"split (each stage synchronised) {splits[dev]}"
            + (f"; profiled wall {b[0] / n:.2f} ms, busy {b[1] / n:.2f} ms "
               f"per sample" if b[1] is not None else ""))
        if launches[dev] != want[dev]:
            raise AssertionError(f"{path} path launches {launches[dev]}, "
                                 f"expected {want[dev]}")
        if rows.shape != (n, 2) or not np.isfinite(rows).all() or \
                fs.shape != (n, len(opts[dev].eval.f_thresholds)):
            raise AssertionError(f"{path} path outputs: {rows.shape}, "
                                 f"{fs.shape}")
    if res[True, "host work"]:
        raise AssertionError(f"the device path ran host isosurface work or "
                             f"copied a grid: {res[True, 'host work']}")
    cd_h, cd_d = res[False][1], res[True][1]
    log(f"[iso-eval] device / host: {res[True][0] / res[False][0]:.3f}x the "
        f"wall; CD {cd_d:.5f} vs {cd_h:.5f} (rel {abs(cd_d - cd_h) / cd_h:.2e}"
        f", tol {ISO_CD_RTOL}); card {card_line()}")
    if not abs(cd_d - cd_h) <= ISO_CD_RTOL * cd_h:
        raise AssertionError("host and device paths disagree on the CD")

    # 2b. tpu.eval_pipeline: pipelined against serial on each path, in turns
    pipe = {}
    for dev in (False, True):
        runner, o = runners[dev], opts[dev]
        for pipelined in (True, False, False, True):
            o.tpu.eval_pipeline = pipelined
            t0 = time.perf_counter()
            cd = runner.evaluate(o, ep=0)
            torch.cuda.synchronize()
            pipe.setdefault((dev, pipelined), []).append(
                ((time.perf_counter() - t0) * 1e3 / n, cd))
        o.tpu.eval_pipeline = True
        cds = [cd for p in (True, False) for _, cd in pipe[dev, p]]
        spread = (max(cds) - min(cds)) / min(cds)
        ms = {p: [t for t, _ in pipe[dev, p]] for p in (True, False)}
        log(f"[iso-pipe] {'device' if dev else 'host'} path, Runner.evaluate"
            f" with tpu.eval_pipeline true / false in turns: "
            f"{statistics.mean(ms[True]):.2f} / "
            f"{statistics.mean(ms[False]):.2f} ms a sample (runs "
            f"{', '.join(f'{t:.2f}' for t in ms[True])} / "
            f"{', '.join(f'{t:.2f}' for t in ms[False])}), serial / "
            f"pipelined {statistics.mean(ms[False]) / statistics.mean(ms[True]):.3f}x;"
            f" CD spread over the four runs {spread:.2e} (tol {EVAL_CD_RTOL})")
        if not spread <= EVAL_CD_RTOL:
            raise AssertionError("serial and pipelined evaluations disagree "
                                 "on the CD")

    # 3. the device path at vox 32 / 8,192 points, card against CPU; the
    # CPU run samples each batch from the card's draws for its seed (a CPU
    # generator draws other numbers from the same seed)
    def card_draws(draw):
        return lambda B, n, seed=0, device="cpu": tuple(
            d.cpu() for d in draw(B, n, seed, "cuda"))

    cmp = {}
    for device in ("cuda", "cpu"):
        o = eval_opt(f"iso_cmp_{device}", vox=32, num_points=8192,
                     n_samples=2, dump=False)
        o.tpu.device_isosurface = True
        r = eval_runner(o, device)
        r.graph.load_state_dict(runners[True].graph.state_dict())
        with wrapped([(D, "surface_draws", card_draws)]
                     if device == "cpu" else []):
            cmp[device] = evaluate_collect(r, o)
    (_, rows_g, fs_g), (_, rows_c, fs_c) = cmp["cuda"], cmp["cpu"]
    cd_err = float(np.max(np.abs(rows_g - rows_c) / np.abs(rows_c)))
    f_err = float(np.max(np.abs(fs_g - fs_c)))
    log(f"[iso-cmp] device path, 2 samples at vox 32 / 8,192 points, card "
        f"(K6 / K7) vs CPU (plain versions), same draws: per-sample CD max "
        f"rel err {cd_err:.2e} (tol {EVAL_CD_RTOL}), F-score max abs err "
        f"{f_err:.2e} (tol {EVAL_F_ATOL})")
    if not cd_err <= EVAL_CD_RTOL or not f_err <= EVAL_F_ATOL:
        raise AssertionError("card vs CPU device-path evaluation outside "
                             "tolerance")
    err6 = max(v["area_err"] for v in iso.values())
    err7 = max(v["pts_err"] for v in iso.values())
    return launches[True], iso, err6, err7


DDP_STEPS = 3                   # a camera step, then two full steps
DDP_TIMED = 4                   # then full steps timed only (NCCL x 1)
DDP_TIMEOUT_S = 600
# the one-process reorderings of each BatchNorm block's rows whose largest
# difference from the loader's order is the gloo gate's float32 floor:
# (reversed, rotated by half a block)
DDP_REORDERINGS = ((True, False), (False, True), (True, True))


# --------------------------------------------------------------- phase 9
def run_cli(module, args, extra):
    """`python -m module *args *extra` in a subprocess on the card (the
    default device); fails on a non-zero exit or a guard's warning, logs
    the time with `extra` -> its standard output."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", module, *args, *extra],
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"{module} failed ({r.returncode}):\n"
                             f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    for w in GUARD_WARNINGS:
        if w in r.stdout or w in r.stderr:
            raise AssertionError(f"{module}: '{w}'")
    log(f"[cli] python -m {module} {' '.join(extra)}: "
        f"{time.perf_counter() - t0:.1f} s")
    return r.stdout


def phase_clis():
    """`python -m shapeclipper_torch.train` for one epoch at a tiny size
    (evaluated at epochs 0 and 1) with `--tpu.profile_iters=[1,3]` (the
    epoch's two iterations: the window opens before iteration 1 and closes
    when training ends; its trace must name the fused SDF kernels), then
    `python -m shapeclipper_torch.evaluate --resume`, on the card (the
    default)."""
    import shutil
    root = os.path.join(OUT_DIR, "clis")
    shutil.rmtree(root, ignore_errors=True)
    tiny = ["--yaml=options/synthetic/config.yaml", f"--output_root={root}",
            "--name=run", "--batch_size=2", "--image_size=[32,32]",
            "--render.rand_sample=32", "--render.n_samples_uniform=8",
            "--eval.vox_res=12", "--eval.num_points=512",
            "--eval.image_size=[16,16]", "--data.max_img_cat=4", "--tb!"]
    outs = [run_cli("shapeclipper_torch.train", tiny,
                    ["--max_epoch=1", "--freq.eval=1",
                     "--tpu.profile_iters=[1,3]", "--force_add"]),
            run_cli("shapeclipper_torch.evaluate", tiny, ["--resume"])]
    run = os.path.join(root, "synthetic_output", "run")
    if "profiler trace written" not in outs[0]:
        raise AssertionError("the train CLI wrote no profiler trace")
    check_profile_trace(run, (1, 1))
    for f in ("best.pt", "latest.pt", "checkpoint/ep1.pt", "cd_cat.txt",
              "f_score.txt", "chamfer.txt"):
        if not os.path.isfile(os.path.join(run, f)):
            raise AssertionError(f"the CLIs did not write {f}")
    with open(os.path.join(run, "chamfer.txt")) as f:
        rows = np.array([[float(x) for x in line.split()[1:]]
                         for line in f if line.strip()])
    best = [line for line in outs[0].splitlines() if "Best CD" in line]
    if rows.shape != (4, 2) or not np.isfinite(rows).all():
        raise AssertionError(f"chamfer.txt rows {rows}")
    log(f"[cli] {best[-1].strip() if best else 'no Best CD line'}; "
        f"evaluate --resume: CD {rows.mean():.5f} over {rows.shape[0]} "
        f"samples; best.pt, cd_cat.txt, f_score.txt, chamfer.txt written")


# -------------------------------------------------------------- phase 10
def reset_launches():
    from shapeclipper_torch.ops import chamfer as C
    from shapeclipper_torch.ops import fused_sdf as F
    from shapeclipper_torch.ops import isosurface as I
    for key in F.KERNEL.launches:
        F.KERNEL.launches[key] = 0
    for key in F.BACKWARD.launches:
        F.BACKWARD.launches[key] = 0
    for key in F.GENERIC.launches:
        F.GENERIC.launches[key] = 0
    C.KERNEL.launches = {"dist": 0, "argmin": 0}
    I.KERNEL.launches = {"area": 0, "draw": 0}


def read_launches():
    """Every kernel's launches since `reset_launches` (`_bf16`: the bf16
    instantiations; k8 / k8_nograd / k9: the generic pair)."""
    from shapeclipper_torch.ops import chamfer as C
    from shapeclipper_torch.ops import fused_sdf as F
    from shapeclipper_torch.ops import isosurface as I
    k, b, g = F.KERNEL.launches, F.BACKWARD.launches, F.GENERIC.launches
    return dict(k8=g["grad"], k8_bf16=g["grad_bf16"], k8_nograd=g["nograd"],
                k8_nograd_bf16=g["nograd_bf16"], k9=g["bwd"],
                k9_bf16=g["bwd_bf16"],
                k1=k["grad"], k3=k["nograd"], k2=b["float32"],
                k1_bf16=k["grad_bf16"], k3_bf16=k["nograd_bf16"],
                pack_bf16=k["pack_bf16"],
                k2_bf16=b["bfloat16"], k4=C.KERNEL.launches["dist"],
                k5=C.KERNEL.launches["argmin"], k6=I.KERNEL.launches["area"],
                k7=I.KERNEL.launches["draw"])


def pretrain_opt(batch_size=None):
    """options/pix3d/config.yaml on the synthetic dataset: batch 12 (or
    `batch_size`), 224^2, pre.sample_points 10,000, pre.density and
    pre.viewpoint on, seed 0, float32."""
    opt = flagship_opt(batch_size)
    opt.output_path = os.path.join(OUT_DIR, f"pretrain_b{opt.batch_size}")
    return opt


def pretrain_runner(opt, device):
    from shapeclipper_torch.train.pretrainer import Runner
    runner = Runner(opt, device)
    runner.build_networks(opt)
    runner.setup_optimizer(opt)
    return runner


def sphere_probe(graph, opt, device, step):
    """The SDF along r in [0.3, 0.9] on the x axis minus r - 0.5, max |.|,
    (a) for two fresh N(0, 1) latents through latent_proj_shape's
    train-mode BatchNorm with its statistics frozen (the codes the loss
    trains on) and (b) tests/test_pretrain.py's probe: one latent through
    the eval-mode BatchNorm. Leaves the graph in train mode."""
    import torch
    from shapeclipper_torch.models.layers import batch_stats_frozen
    r = torch.linspace(0.3, 0.9, 12)
    pts = torch.stack([r, torch.zeros_like(r), torch.zeros_like(r)], -1)
    pts = pts[None].to(device)
    errs = []
    g = torch.Generator().manual_seed(SEED + 100 + step)
    for batch, mode in ((2, "train"), (1, "eval")):
        latent = torch.randn(batch, opt.arch.latent_dim_shape, generator=g)
        graph.train(mode == "train")
        with torch.no_grad(), batch_stats_frozen(graph.latent_proj_shape):
            sdf = graph.sdf_network(pts.expand(batch, -1, -1),
                                    graph.latent_proj_shape(latent.to(device)))
        errs.append(float((sdf[..., 0].cpu() - (r - 0.5)).abs().max()))
    graph.train()
    return errs


def phase_pretrain():
    """The pretraining Runner on the card: N_PRE_WARM + N_PRE_TIMED steps
    at the flagship width on one batch of the loader, with the launch
    counts of the five kernels (none lies on this path: the sphere loss
    runs the plain SDF forward, as the JAX package); a step at batch
    PRE_CMP_BATCH on the card and on the CPU; the sphere fit of
    tests/test_pretrain.py."""
    import torch
    from shapeclipper_torch.utils.easydict import EasyDict as edict

    opt = pretrain_opt()
    runner = pretrain_runner(opt, "cuda")
    runner.load_dataset(opt)
    batch = next(iter(runner.pretrain_loader))
    var = edict(rgb_input_map=torch.from_numpy(
        np.asarray(batch["rgb_input_map"])).to(runner.device))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times = []
    for step in range(N_PRE_WARM + N_PRE_TIMED):
        t0 = time.perf_counter()
        loss = runner.train_iteration(opt, var)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        bad = [k for k, v in loss.items() if not np.isfinite(float(v))]
        if bad:
            raise AssertionError(f"pretrain step {step}: loss {bad} not "
                                 f"finite: {dict(loss)}")
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = statistics.median(times[N_PRE_WARM:])
    log(f"[pretrain] flagship (batch {opt.batch_size}, {opt.H}x{opt.W}, "
        f"{opt.pre.sample_points} points, density + viewpoint): first step "
        f"{times[0]:.1f} ms, median of steps {N_PRE_WARM}-"
        f"{N_PRE_WARM + N_PRE_TIMED - 1} {step_ms:.2f} ms/step; peak device "
        f"memory {peak_gib:.3f} GiB; last loss "
        + ", ".join(f"{k} {float(v):.5f}" for k, v in loss.items())
        + f"; kernel launches {launches} (no kernel on this path); card "
        f"{card_line()}")
    profiled("pretrain", "one step", lambda: runner.train_iteration(opt, var),
             8)
    phase_pretrain_gpu_vs_cpu()
    phase_sphere_fit()
    return dict(step_ms=step_ms, peak_gib=peak_gib)


def phase_pretrain_gpu_vs_cpu():
    """One pretraining step on the card and on the CPU from the same
    weights, fresh Adam and draws, at batch PRE_CMP_BATCH: the bounds of
    tests/test_torch_pretrain.py (loss.sdf rtol 1e-5, w_dist 2e-3,
    latent_proj_shape's running statistics 1e-3 of their scale, every
    trainable gradient 1e-4 in norm relative to its own norm, post-step
    parameters mean below 0.02 lr, the frozen ones bit-identical) and a
    tighter post-step maximum of 0.05 lr. Batch 4, not 2: at batch 2
    train-mode BatchNorm normalises two samples per feature and amplifies
    rounding where the two are close (tests/test_torch_pretrain.py)."""
    import torch
    from shapeclipper_torch.train.pretrainer import pretrain_trainable
    from shapeclipper_torch.utils.easydict import EasyDict as edict

    opt = pretrain_opt(PRE_CMP_BATCH)
    gpu = pretrain_runner(opt, "cuda")
    cpu = pretrain_runner(opt, "cpu")
    cpu.graph.load_state_dict(gpu.graph.state_dict())
    before = {k: v.detach().cpu().clone()
              for k, v in gpu.graph.named_parameters()}
    images = one_batch(opt)["rgb_input_map"]
    g = torch.Generator().manual_seed(SEED + 11)
    lo, hi = opt.pre.sample_range
    dim = opt.arch.latent_dim_shape + opt.arch.latent_dim_rgb
    draws = edict(
        latent=torch.randn(opt.batch_size, dim, generator=g)
        * opt.pre.latent_std,
        points=lo + (hi - lo) * torch.rand(opt.batch_size,
                                           opt.pre.sample_points, 3,
                                           generator=g))
    losses = {}
    for role, r in (("gpu", gpu), ("cpu", cpu)):
        var = edict(rgb_input_map=torch.from_numpy(images).to(r.device))
        losses[role] = r.train_iteration(
            opt, var, draws=edict({k: v.to(r.device)
                                   for k, v in draws.items()}))
    bad, err = [], {}
    for k, tol in (("sdf", 1e-5), ("w_dist", 2e-3)):
        a, b = float(losses["gpu"][k]), float(losses["cpu"][k])
        err[k] = abs(a - b) / abs(b)
        if err[k] > tol:
            bad.append(f"loss {k}")
    lr = float(opt.optim.lr)
    gp = dict(gpu.graph.named_parameters())
    par, grad_err, diffs = 0.0, 0.0, []
    for name, p in cpu.graph.named_parameters():
        q = gp[name].detach().cpu()
        d = (q - p.detach()).abs()
        par = max(par, float(d.max()) / lr)
        diffs.append(d.ravel())
        if float(d.max()) > 0.05 * lr + 1e-6:
            bad.append(name)
        if not pretrain_trainable(name):
            if not torch.equal(q, before[name]):
                bad.append(f"frozen {name} moved")
            continue
        zero = torch.zeros_like(p)
        want = zero if p.grad is None else p.grad
        got = zero if gp[name].grad is None else gp[name].grad.cpu()
        e = float((got - want).norm() / want.norm().clamp_min(1e-30))
        grad_err = max(grad_err, e)
        if e > 1e-4:
            bad.append(f"gradient of {name}")
    mean = float(torch.cat(diffs).mean()) / lr
    if mean > 0.02:
        bad.append("post-step parameters' mean difference")
    moved_fc = not torch.equal(gp["estimator.extr_fc.weight"].detach().cpu(),
                               before["estimator.extr_fc.weight"])
    if not moved_fc:
        bad.append("estimator.extr_fc.weight did not move")
    gb = dict(gpu.graph.named_buffers())
    bn = 0.0
    for name, b in cpu.graph.named_buffers():
        if name.startswith("latent_proj_shape") and "running" in name:
            scale = float(b.abs().max())
            e = float((gb[name].cpu() - b).abs().max())
            bn = max(bn, e / scale)
            if e > 1e-3 * scale:
                bad.append(name)
    log(f"[pretrain-cmp] step at batch {opt.batch_size}, GPU vs CPU: loss.sdf "
        f"rel {err['sdf']:.2e} (tol 1e-5), loss.w_dist rel "
        f"{err['w_dist']:.2e} (tol 2e-3); trainable gradients max "
        f"norm-relative {grad_err:.2e} (tol 1e-4); post-step parameters max "
        f"{par:.2e} lr (tol 0.05 lr), mean {mean:.2e} lr (tol 0.02 lr); "
        f"latent_proj_shape running stats max rel "
        f"{bn:.2e} (tol 1e-3); the frozen backbone and heads bit-identical, "
        f"extr_fc moved")
    if bad:
        raise AssertionError(f"pretraining GPU vs CPU step: {bad}")


def phase_sphere_fit():
    """tests/test_pretrain.py::test_pretrain_fits_sphere's run on the card:
    batch 2, 512 points, lr 1e-3, pre.viewpoint off, 300 steps; the last
    loss.sdf below half the first, and at the last step the SDF within 0.1
    of r - 0.5 both for that test's probe, one latent through the
    eval-mode BatchNorm (`sphere_probe` (b)), and for the codes the loss
    trains on (`sphere_probe` (a)). Both probes are logged every 100
    steps."""
    from shapeclipper_torch.utils.easydict import EasyDict as edict
    opt = pretrain_opt(2)
    opt.pre.update(sample_points=512, viewpoint=False)
    opt.optim.lr = 1e-3
    runner = pretrain_runner(opt, "cuda")
    losses, probes = [], {}
    t0 = time.perf_counter()
    for step in range(1, N_SPHERE + 1):
        losses.append(float(runner.train_iteration(opt, edict()).sdf))
        if step % 100 == 0:
            probes[step] = sphere_probe(runner.graph, opt, runner.device,
                                        step)
    log(f"[sphere] {N_SPHERE} steps in {time.perf_counter() - t0:.1f} s: "
        f"loss.sdf {losses[0]:.5f} -> {losses[-1]:.5f}; max |sdf - (r - "
        f"0.5)| (training codes / eval-mode probe): "
        + ", ".join(f"step {k} {a:.4f} / {b:.4f}"
                    for k, (a, b) in probes.items())
        + " (tol 0.1 on both at the last step)")
    if not losses[-1] < 0.5 * losses[0]:
        raise AssertionError(f"sphere fit: loss {losses[0]} -> {losses[-1]}")
    if not max(probes[N_SPHERE]) <= 0.1:
        raise AssertionError(f"sphere fit: error (training codes, eval-mode "
                             f"probe) {probes[N_SPHERE]}")


# -------------------------------------------------------------- phase 11
def phase_clip():
    """The CLIP annotator with ViT-L/14 at full width (24 layers, width
    1,024, 16 heads, 257 tokens; seeded weights) on CLIP_IMAGES synthetic
    images a split at 224^2, batch 32: images/s of encode_split (the
    second split, loader included) and of the tower alone on one batch,
    peak memory; 2 embeddings against the CPU; the top-k of one split
    against the CPU's; the three CSVs."""
    import torch
    from shapeclipper_torch.clipnn.annotator import Pix3DAnnotator
    from shapeclipper_torch.config import options
    from shapeclipper_torch.utils.easydict import EasyDict as edict

    opt = options.load_options(os.path.join(REPO, "options", "clip",
                                            "pix3d.yaml"))
    opt.seed = SEED
    opt.H, opt.W = opt.image_size
    opt.data.update(dataset="synthetic", max_img_cat=CLIP_IMAGES)
    opt.data.synthetic = edict(cat="synthetic")
    opt.output_path = os.path.join(OUT_DIR, "clip")
    opt.anno_root = os.path.join(OUT_DIR, "clip", "CLIP_NN")
    os.makedirs(opt.output_path, exist_ok=True)
    ann = Pix3DAnnotator(opt, "cuda")
    ann.load_dataset(opt)
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    feats = ann.encode_split(opt, ann.loaders["train"])
    t0 = time.perf_counter()
    ann.encode_split(opt, ann.loaders["val"])
    split_s = time.perf_counter() - t0
    n_val = len(ann.datasets["val"])
    x = torch.from_numpy(np.stack(
        [ann.datasets["val"][i]["rgb_input"]
         for i in range(opt.batch_size)])).cuda()
    with torch.no_grad():
        tower_ms = cuda_ms(lambda: ann.tower(x), runs=5, warmup=2)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    cpu_tower = copy.deepcopy(ann.tower).cpu()
    with torch.no_grad():
        got = ann.tower(x[:2]).cpu()
        want = cpu_tower(x[:2].cpu())
    emb_err = float(((got - want).norm(dim=-1)
                     / want.norm(dim=-1)).max())
    idx, _ = ann.calc_matches(opt, feats, k_nearest=opt.k_nearest)
    cpu_ann = object.__new__(Pix3DAnnotator)
    cpu_ann.device = torch.device("cpu")
    idx_cpu, _ = cpu_ann.calc_matches(opt, feats, k_nearest=opt.k_nearest)
    sims = torch.from_numpy(feats) @ torch.from_numpy(feats).T
    rows, cols = np.nonzero(idx != idx_cpu)
    gap = float(max((abs(float(sims[i, idx[i, j]] - sims[i, idx_cpu[i, j]]))
                     for i, j in zip(rows, cols)), default=0.0))
    t0 = time.perf_counter()
    ann.compute_NN(opt)
    nn_s = time.perf_counter() - t0
    launches = read_launches()
    csvs = [os.path.join(opt.anno_root, f"synthetic_{s}.csv")
            for s in ("train", "val", "test")]
    log(f"[clip] ViT-L/14 (seeded weights) at {opt.H}x{opt.W}, batch "
        f"{opt.batch_size}: encode_split {n_val / split_s:.1f} images/s "
        f"({n_val} images in {split_s:.2f} s, loader included); the tower "
        f"alone {tower_ms:.2f} ms a batch of {opt.batch_size} = "
        f"{1e3 * opt.batch_size / tower_ms:.1f} images/s; peak device "
        f"memory {peak_gib:.3f} GiB; 2 embeddings GPU vs CPU max "
        f"norm-relative {emb_err:.2e} (tol 1e-4); top-{opt.k_nearest} of "
        f"the train split: {len(rows)} of {idx.size} indices differ from "
        f"the CPU's, similarity gap {gap:.2e} (tol 1e-6); compute_NN of 3 "
        f"splits {nn_s:.1f} s; kernel launches {launches}; card "
        f"{card_line()}")
    if emb_err > 1e-4:
        raise AssertionError(f"CLIP embeddings GPU vs CPU: {emb_err}")
    if gap > 1e-6:
        raise AssertionError(f"CLIP top-k GPU vs CPU: gap {gap}")
    missing = [c for c in csvs if not os.path.isfile(c)]
    if missing:
        raise AssertionError(f"compute_NN did not write {missing}")
    return dict(images_s=n_val / split_s, tower_images_s=1e3 *
                opt.batch_size / tower_ms, peak_gib=peak_gib)


# -------------------------------------------------------------- phase 12
def phase_pretrain_clis():
    """`python -m shapeclipper_torch.pretrain` for 5 steps at the synthetic
    config, `python -m shapeclipper_torch.train --load=` its latest.pt for
    one tiny epoch, and `python -m shapeclipper_torch.clip_anno` with
    ViT-B/32 on 8 images a split, on the card (the default)."""
    import shutil
    root = os.path.join(OUT_DIR, "clis_pre")
    shutil.rmtree(root, ignore_errors=True)
    out = run_cli("shapeclipper_torch.pretrain",
                  ["--yaml=options/synthetic/config.yaml",
                   f"--output_root={root}", "--name=pre"], ["--pre.iter=5"])
    if "pretrain it 5/5" not in out:
        raise AssertionError("pretrain CLI: no 'pretrain it 5/5' line")
    pre = os.path.join(root, "synthetic_output", "pre", "latest.pt")
    out = run_cli("shapeclipper_torch.train", [
        "--yaml=options/synthetic/config.yaml", f"--output_root={root}",
        "--name=run", "--batch_size=2", "--image_size=[32,32]",
        "--render.rand_sample=32", "--render.n_samples_uniform=8",
        "--eval.vox_res=12", "--eval.num_points=512",
        "--eval.image_size=[16,16]", "--data.max_img_cat=4", "--tb!",
        "--max_epoch=1", "--freq.eval=1"], [f"--load={pre}"])
    for line in ("restoring sdf_network", "restoring latent_proj_shape",
                 "restoring estimator", "skipping encoder", "Best CD"):
        if line not in out:
            raise AssertionError(f"train --load: no '{line}' in its output")
    run_cli("shapeclipper_torch.clip_anno", [
        "--yaml=options/clip/pix3d.yaml", "--data.dataset=synthetic",
        "--data.synthetic.cat=synthetic", f"--output_root={root}",
        f"--anno_root={root}/CLIP_NN", "--data.max_img_cat=8"],
        ["--clip.model=vit_b32"])
    for split in ("train", "val", "test"):
        path = os.path.join(root, "CLIP_NN", f"synthetic_{split}.csv")
        with open(path) as f:
            n = sum(1 for _ in f)
        if n != 9:
            raise AssertionError(f"{path}: {n} lines, expected 9")
    log("[cli] pretrain -> train --load (restoring sdf_network, skipping "
        "encoder) -> clip_anno: synthetic_{train,val,test}.csv written")


# -------------------------------------------------------------- phase 13
def rows_of(tree, idx):
    """The rows `idx` of every array of a (nested) batch or draws tree."""
    import torch
    if torch.is_tensor(tree) or isinstance(tree, np.ndarray):
        return tree[idx]
    if isinstance(tree, list):
        return [rows_of(t, idx) for t in tree]
    return type(tree)({k: rows_of(v, idx) for k, v in tree.items()})


def global_draws(opt, batch, n_steps):
    """Each step's draws for the global batch, drawn on the CPU from a seed
    in the order a one-process step consumes them."""
    import torch
    from shapeclipper_torch.models.graph import step_draws
    from shapeclipper_torch.train.trainer import batch_to_var
    from shapeclipper_torch.utils.easydict import EasyDict as edict
    var = batch_to_var(batch, "cpu")
    g = torch.Generator().manual_seed(SEED + 11)
    return [step_draws(opt, var, edict(), g, "rgb_input_map_NN" in var)
            for _ in range(n_steps)]


def host_summary(prof, wall_ms, n_top=8):
    """A profiled step's wall and device busy time, its top host operators
    by self time (both threads: the forward's and autograd's) and every
    collective's host time."""
    import torch
    cpu, busy = [], 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation:
                busy += e.self_device_time_total / 1e3
        else:
            cpu.append(e)
    comm = [e for e in cpu if any(w in e.key.lower() for w in (
        "c10d", "nccl", "allreduce", "all_reduce", "broadcast", "gloo"))]

    def fmt(events):
        return "; ".join(f"{e.key[:48]} {e.self_cpu_time_total / 1e3:.2f} "
                         f"ms x{e.count}" for e in events) or "none"
    top = sorted(cpu, key=lambda e: -e.self_cpu_time_total)[:n_top]
    return (f"wall {wall_ms:.1f} ms, device busy {busy:.1f} ms; host self "
            f"time, top: {fmt(top)}; collectives: {fmt(comm)}")


def run_steps(opt, batch, draws, timed=0, profile=False):
    """DDP_STEPS steps (iteration 0 a camera step) of a fresh flagship
    Runner, then `timed` full steps on the last draws and, with `profile`,
    one more under torch.profiler -> (per compared step the loss terms, the
    gradients, the parameters and the BatchNorm statistics after it (rank
    0's, broadcast), its ms, its K1 / K2 launches and the step module's
    class; dict(timed=the timed steps' ms, profile=host_summary or
    None))."""
    import torch
    from shapeclipper_torch import parallel
    from shapeclipper_torch.ops import fused_sdf as F
    from shapeclipper_torch.train.trainer import batch_to_var
    runner = train_runner(opt, "cuda")
    var = batch_to_var(batch, runner.device)
    out = []
    for it, d in enumerate(draws):
        runner.it = it
        k1, k2 = F.KERNEL.launches["grad"], F.BACKWARD.launches["float32"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = runner.train_iteration(opt, var,
                                      draws=_to_tree(d, runner.device))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        check_loss(f"{opt.tpu.bn_mode} step {it}", loss)
        g = runner.graph
        parallel.broadcast_buffers(g)
        out.append(dict(
            loss={k: float(v) for k, v in loss.items() if k != "finite"},
            grads={n: p.grad.clone() for n, p in g.named_parameters()},
            params={n: p.detach().clone() for n, p in g.named_parameters()},
            stats={n: b.clone() for n, b in g.named_buffers()
                   if "running" in n},
            ms=ms, launches=(F.KERNEL.launches["grad"] - k1,
                             F.BACKWARD.launches["float32"] - k2),
            wrapper=type(runner.step_model).__name__))
    timed_ms = []
    d = _to_tree(draws[-1], runner.device)
    for it in range(len(draws), len(draws) + timed):
        runner.it = it
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.train_iteration(opt, var, draws=d)
        torch.cuda.synchronize()
        timed_ms.append(1e3 * (time.perf_counter() - t0))
    summary = None
    if profile:
        from torch.profiler import ProfilerActivity
        runner.it = len(draws) + timed
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            runner.train_iteration(opt, var, draws=d)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        summary = host_summary(prof, wall_ms)
    return out, dict(timed=timed_ms, profile=summary)


def _to_tree(tree, device):
    import torch
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, list):
        return [_to_tree(t, device) for t in tree]
    return type(tree)({k: _to_tree(v, device) for k, v in tree.items()})


def step_errors(got, want, lr):
    """One step of a run against another: loss terms (max relative),
    gradients (per parameter norm-relative: max and its name), post-step
    parameters (max |difference| and mean, in lr), running statistics (max
    relative to their scale), and whether all of it is bitwise equal."""
    import torch
    loss = max(abs(got["loss"][k] - v) / max(abs(v), 1e-12)
               for k, v in want["loss"].items())
    grad = {n: float((got["grads"][n] - w).norm()
                     / w.norm().clamp(min=1e-30))
            for n, w in want["grads"].items()}
    diffs = [(got["params"][n] - w).abs().reshape(-1)
             for n, w in want["params"].items()]
    stats = max(float((got["stats"][n] - w).abs().max()
                      / w.abs().max().clamp(min=1e-30))
                for n, w in want["stats"].items())
    worst = max(grad, key=grad.get)
    bitwise = (all(got["loss"][k] == v for k, v in want["loss"].items())
               and all(torch.equal(got[part][n], w)
                       for part in ("grads", "params", "stats")
                       for n, w in want[part].items()))
    return dict(loss=loss, grad=grad[worst], grad_name=worst,
                param_max=float(max(d.max() for d in diffs)) / lr,
                param_mean=float(torch.cat(diffs).mean()) / lr, stats=stats,
                bitwise=bitwise)


STEP_ERROR_KEYS = ("loss", "grad", "param_max", "param_mean", "stats")


def envelope(errs):
    """The largest of several step_errors readings, key by key (the
    gradient's name from the reading with the largest gradient error)."""
    worst = max(errs, key=lambda e: e["grad"])
    return dict({k: max(e[k] for e in errs) for k in STEP_ERROR_KEYS},
                grad_name=worst["grad_name"],
                bitwise=all(e["bitwise"] for e in errs))


def ddp_worker(kind):
    """One rank of `python -m torch.distributed.run ... chip_smoke.py
    --ddp-worker KIND`: `nccl` joins torchrun's NCCL group on its own card;
    `gloo` puts every rank on card 0 and joins through gloo. Each rank
    takes DDP_STEPS steps on its rows of the flagship global batch (noise
    input images) and the global draws, in each BatchNorm mode of the kind;
    then rank 0 leaves the group, takes the same steps in one process at
    the global batch on the same card, and writes the comparison to
    OUT_DIR/ddp_KIND.json. Under NCCL the one-process steps run before the
    group is joined and again after it is left (the card's own noise, and
    step times on either side of DDP's), each followed by DDP_TIMED timed
    full steps."""
    import torch
    sys.path.insert(0, REPO)
    from shapeclipper_torch import parallel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # deterministic cuDNN: one rank under DDP against no DDP is then a
    # question of DDP's arithmetic alone, and two ranks against one process
    # read the same from one run to the next
    torch.backends.cudnn.deterministic = True
    # the global batch's draws, before the process group (whose world
    # size would make them this rank's)
    base = flagship_opt()
    batch = one_batch(base, noise_images=True)
    draws = global_draws(base, batch, DDP_STEPS)
    env = os.environ
    W = int(env["WORLD_SIZE"])
    # NCCL: the sequential step and the merged one ("merged": the three
    # tpu.merge_* flags true, global BatchNorm, the same draws re-sliced)
    modes = ("global", "merged") if kind == "nccl" else ("global",
                                                         "per_replica")

    def mode_opt(mode, tag):
        opt = flagship_opt(merged=mode == "merged")
        bn_mode = "global" if mode == "merged" else mode
        opt.tpu.update(bn_mode=bn_mode,
                       bn_replicas=2 if bn_mode == "per_replica" else None)
        opt.output_path = os.path.join(OUT_DIR, f"ddp_{kind}_{tag}")
        return opt

    timed = DDP_TIMED if kind == "nccl" else 0
    prof = kind == "nccl"
    if kind == "nccl":
        before = {mode: run_steps(mode_opt(mode, f"one_before_{mode}"),
                                  batch, draws, timed, prof)
                  for mode in modes}
        parallel.init_from_env("cuda")
    else:
        parallel.init(int(env["RANK"]), int(env["WORLD_SIZE"]),
                      f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                      "cuda", backend="gloo", local_rank=0)
    rank = parallel.rank()
    mine = slice(rank, None, W)
    ddp, ddp_extra = {}, {}
    for mode in modes:
        ddp[mode], ddp_extra[mode] = run_steps(
            mode_opt(mode, f"r{rank}_{mode}"), rows_of(batch, mine),
            [rows_of(d, mine) for d in draws], timed, prof)
    parallel.barrier()
    parallel.destroy()
    if rank != 0:
        return 0
    lr = float(base.optim.lr)
    arranged = [i for r in range(W) for i in range(r, base.batch_size, W)]
    report = dict(world=W, lr=lr, card=card_line(), modes={}, floor={},
                  timed={}, profile={})
    for mode in modes:
        # one process at the global batch: the global mode in the loader's
        # order, per_replica with the rows arranged [rank 0's; rank 1's]
        # (its contiguous blocks are the ranks' batches)
        order = list(range(base.batch_size)) if mode == "global" \
            else arranged
        ref, ref_extra = run_steps(mode_opt(mode, f"one_{mode}"),
                                   rows_of(batch, order),
                                   [rows_of(d, order) for d in draws], timed,
                                   prof)
        report["modes"][mode] = [
            dict(step_errors(g, w, lr), ms=g["ms"], one_ms=w["ms"],
                 launches=g["launches"], one_launches=w["launches"],
                 wrapper=g["wrapper"], one_wrapper=w["wrapper"])
            for g, w in zip(ddp[mode], ref)]
        # the float32 noise of the same steps: one process before the group
        # (NCCL), or summed in other orders, every BatchNorm block's rows
        # reordered in each of DDP_REORDERINGS (the largest difference of
        # each step, and each reordering's)
        if kind == "nccl":
            other, other_extra = before[mode]
            report["floor"][mode] = [step_errors(p, w, lr)
                                     for p, w in zip(other, ref)]
        else:
            block = base.batch_size // (2 if mode == "per_replica" else 1)
            each = []
            for rev, rot in DDP_REORDERINGS:
                within = [(block - 1 - i if rev else i) for i in range(block)]
                within = [within[(i + block // 2 * rot) % block]
                          for i in range(block)]
                perm = [order[b + i] for b in range(0, base.batch_size, block)
                        for i in within]
                other, _ = run_steps(
                    mode_opt(mode, f"one_{mode}_perm"), rows_of(batch, perm),
                    [rows_of(d, perm) for d in draws])
                each.append([step_errors(p, w, lr)
                             for p, w in zip(other, ref)])
            report["floor"][mode] = [envelope(s) for s in zip(*each)]
            report.setdefault("floor_each", {})[mode] = each
        if kind == "nccl":
            extra = dict(before=other_extra, ddp=ddp_extra[mode],
                         after=ref_extra)
            report["timed"][mode] = {k: v["timed"] for k, v in extra.items()}
            report["profile"][mode] = {k: v["profile"]
                                       for k, v in extra.items()}
    with open(os.path.join(OUT_DIR, f"ddp_{kind}.json"), "w") as f:
        json.dump(report, f)
    return 0


def run_ddp(kind, n):
    """torchrun with `n` ranks of ddp_worker(kind) -> its report."""
    path = os.path.join(OUT_DIR, f"ddp_{kind}.json")
    if os.path.exists(path):
        os.remove(path)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run",
                        "--standalone", f"--nproc_per_node={n}",
                        os.path.join(REPO, "chip_smoke.py"), "--ddp-worker",
                        kind], cwd=REPO, capture_output=True, text=True,
                       timeout=DDP_TIMEOUT_S)
    if r.returncode != 0:
        raise AssertionError(f"torchrun {kind} x {n} failed "
                             f"({r.returncode}):\n{r.stdout[-3000:]}\n"
                             f"{r.stderr[-3000:]}")
    with open(path) as f:
        report = json.load(f)
    log(f"[ddp] torchrun --nproc_per_node={n} ({kind}): "
        f"{time.perf_counter() - t0:.1f} s in all, processes included")
    return report


def describe(e):
    return (f"loss max rel {e['loss']:.2e}, gradient max norm-rel "
            f"{e['grad']:.2e} ({e['grad_name']}), parameters max "
            f"{e['param_max']:.4f} lr / mean {e['param_mean']:.5f} lr, BN "
            f"stats max rel {e['stats']:.2e}"
            + (", bitwise equal" if e["bitwise"] else ""))


def phase_ddp_nccl():
    """Phase 13 (1): one NCCL rank under torchrun, its Runner wrapped in
    DDP (the reducer's buckets, the unused-parameter search, NCCL
    all-reduces of the gradients, the global BatchNorm moments and the
    coupled losses' rows), against the Runner without a process group
    before and after it, in the sequential and the merged step; the
    flagship config, DDP_STEPS steps (a camera step, then full steps), the
    same batch and draws. K1 / K2 launches per step, step times."""
    rep = run_ddp("nccl", 1)
    for mode, steps in rep["modes"].items():
        # the merged step (phase 5e's, float32 here): one render, K1 twice
        k1 = 2 if mode == "merged" else 3
        for it, e in enumerate(steps):
            phase = "camera" if it == 0 else "full"
            want = (k1, 1) if it == 0 else (k1, k1)
            if (tuple(e["launches"]) != want
                    or tuple(e["one_launches"]) != want):
                raise AssertionError(f"NCCL {mode} step {it}: launches K1/K2 "
                                     f"{e['launches']} / {e['one_launches']}"
                                     f", expected {want}")
            if (e["wrapper"], e["one_wrapper"]) != ("DistributedDataParallel",
                                                    "TrainStep"):
                raise AssertionError(f"NCCL {mode} step {it}: step modules "
                                     f"{e['wrapper']} / {e['one_wrapper']}")
            log(f"[ddp] NCCL x 1 under DDP, {mode} step {it} ({phase}), vs "
                f"the Runner without a process group: {describe(e)}; "
                f"{e['ms']:.1f} ms vs {e['one_ms']:.1f} ms; K1/K2 launches "
                f"{e['launches'][0]}/{e['launches'][1]}")
            f = rep["floor"][mode][it]
            log(f"[ddp]   the Runner without a process group, before "
                f"against after (the card's own run-to-run noise): "
                f"{describe(f)}")
            # bitwise, or within 1e-6 (parameters: 1e-6 absolute), or within
            # twice the card's own repeat noise
            tol = dict(loss=1e-6, grad=1e-6, param_max=1e-6 / rep["lr"],
                       stats=1e-6)
            off = {k: e[k] for k, t in tol.items() if e[k] > max(t, 2 * f[k])}
            if not e["bitwise"] and off:
                raise AssertionError(f"NCCL x 1 {mode} step {it} differs "
                                     f"from the Runner without DDP: {off}")
        t = {k: statistics.median(v) for k, v in rep["timed"][mode].items()}
        log(f"[ddp] NCCL x 1, {mode}: median of {DDP_TIMED} full steps, the "
            f"Runner without a process group {t['before']:.1f} ms (before), "
            f"under DDP {t['ddp']:.1f} ms, without {t['after']:.1f} ms "
            f"(after): DDP {t['ddp'] / ((t['before'] + t['after']) / 2):.3f}x "
            f"their mean; all: {json.dumps(rep['timed'][mode])}; "
            f"card {rep['card']}")
        for k, line in rep["profile"][mode].items():
            log(f"[ddp] NCCL x 1, {mode}, one more full step profiled ({k}): "
                f"{line}")


def phase_ddp_gloo():
    """Phase 13 (2): two ranks on the one card through gloo, in global and
    per_replica BatchNorm, against one process at the global batch of 12,
    as (1)."""
    rep = run_ddp("gloo", 2)
    lr_tol = dict(loss=1e-5, grad=1e-4, param_max=2.0, param_mean=0.02,
                  stats=1e-5)
    bad = []
    for mode, steps in rep["modes"].items():
        for it, e in enumerate(steps):
            f = rep["floor"][mode][it]
            want = (3, 1) if it == 0 else (3, 3)
            # the camera step and the first full step are held to the CPU
            # test's bounds (tests/test_torch_ddp.py), or twice the float32
            # noise of one process under the largest of DDP_REORDERINGS of
            # the batch; by the second full step that noise is as large as
            # the signal, so it is a reading only
            gated = it < 2
            spread = "; ".join(
                f"{k} " + "/".join(f"{s[it][k]:.2e}" for s in
                                   rep["floor_each"][mode])
                for k in STEP_ERROR_KEYS)
            log(f"[ddp] gloo x 2 on one card, {mode} BN, step {it} "
                f"({'camera' if it == 0 else 'full'}"
                f"{'' if gated else ', a reading, not gated'}) vs one "
                f"process at batch 12: {describe(e)}; one process reordered "
                f"{len(DDP_REORDERINGS)} ways (the float32 floor, the largest "
                f"of each): {describe(f)} [each: {spread}]; rank 0 "
                f"{e['ms']:.1f} ms (6 samples) vs {e['one_ms']:.1f} ms (12); "
                f"K1/K2 launches {e['launches'][0]}/{e['launches'][1]} per "
                f"rank")
            if tuple(e["launches"]) != want:
                bad.append(f"{mode} step {it} launches {e['launches']}")
            if e["wrapper"] != "DistributedDataParallel":
                bad.append(f"{mode} step {it} ran {e['wrapper']}")
            if gated:
                tol = {k: max(v, 2 * f[k]) for k, v in lr_tol.items()}
                bad += [f"{mode} step {it} {k} {e[k]:.3e} > {t:.3e}"
                        for k, t in tol.items() if e[k] > t]
    log("[ddp] gloo x 2: two processes share one card and exchange every "
        "gradient bucket through host memory (gloo): a check of the "
        "arithmetic, not a scaling figure")
    if bad:
        raise AssertionError(f"two ranks vs one process: {bad}")


def phase_k1_k2_half():
    """K1 and K2 at a rank's share of the flagship batch under two ranks
    (6 x 32,768) beside the whole batch (12 x 32,768): CUDA-event times,
    their plain versions' and bounds scaled to the work."""
    import torch
    from shapeclipper_torch.models.implicit import SDFNetwork
    from shapeclipper_torch.ops import fused_sdf as F
    g = torch.Generator().manual_seed(SEED + 2)
    net = SDFNetwork(geometric_init=False, generator=g).cuda()
    out = {}
    for B in (6, 12):
        N = 32768
        pts = (torch.rand(B, N, 3, generator=g) * 2 - 1).cuda()
        lat = (torch.randn(B, 64, generator=g) * 0.3).cuda()
        cots = [torch.randn(B, N, c, generator=g).cuda() for c in (1, 64, 3)]
        with torch.no_grad():
            kk, bb = F.prepare_fused_params(net, lat)
            weights, bias = F.pack_fused_params(kk, bb)
        k1 = cuda_ms(lambda: F.KERNEL.launch(pts, weights, bias, True, True),
                     calls=SDF_TIMED_CALLS)
        sbar = cots[0][..., 0].contiguous()
        k2 = cuda_ms(lambda: F.BACKWARD.launch(
            pts, weights, bias, sbar, cots[1], cots[2], True),
            calls=SDF_TIMED_CALLS)
        # the plain versions: the forward with tangents, and the backward
        # alone (autograd of one kept plain forward), as phases 2 and 3
        with torch.inference_mode():
            k1_plain = cuda_ms(lambda: F._forward_plain(
                kk, bb, pts, *F._arch(net), True, True))
        p = pts.clone().requires_grad_(True)
        fwd = F._forward_plain(*F.prepare_fused_params(net, lat), p,
                               *F._arch(net), True, True)
        k2_plain = cuda_ms(lambda: torch.autograd.backward(
            fwd, cots, retain_graph=True))
        del fwd
        _, (b1, by1) = forward_bound(B, N, True)
        b2, by2 = bound(FLOP_K2 * B * N, k2_bytes(B, N))
        out[B] = dict(k1=k1, k2=k2, k1_bound=b1, k2_bound=b2,
                      k1_plain=k1_plain, k2_plain=k2_plain)
        log(f"[ddp] K1 at {B} x {N}: {k1:.4f} ms (bound {b1:.4f} ms, {by1}, "
            f"{100 * b1 / k1:.1f}%; plain {k1_plain:.4f} ms); K2: {k2:.4f} "
            f"ms (bound {b2:.4f} ms, {by2}, {100 * b2 / k2:.1f}%; plain "
            f"backward {k2_plain:.4f} ms)")
    log(f"[ddp] a rank's half batch: K1 {out[6]['k1'] / out[12]['k1']:.3f}x "
        f"and K2 {out[6]['k2'] / out[12]['k2']:.3f}x the whole batch's time; "
        f"card {card_line()}")
    return out


# -------------------------------------------------------------- phase 14
def phase_ddp_cli():
    """(a) `python -m torch.distributed.run --standalone --nproc_per_node=1
    -m shapeclipper_torch.train --distributed` (one NCCL rank) and the same
    run without `--distributed`, one tiny epoch each with its evaluations,
    then `evaluate --resume` of each, the distributed run's through
    `evaluate --distributed` under torchrun (one NCCL rank): cd_cat.txt,
    f_score.txt, chamfer.txt and the `Best CD` line must be equal. As
    tests/test_torch_ddp_cli.py, `optim.lr=0` and camera steps only, so
    that both runs evaluate the same weights and the reports compare the
    distributed loop. (b) `phase_eval_ranks`."""
    import shutil
    root = os.path.join(OUT_DIR, "clis_ddp")
    shutil.rmtree(root, ignore_errors=True)
    tiny = ["--yaml=options/synthetic/config.yaml", "--name=run",
            "--batch_size=2", "--image_size=[32,32]",
            "--render.rand_sample=32", "--render.n_samples_uniform=8",
            "--eval.vox_res=12", "--eval.num_points=512",
            "--eval.image_size=[16,16]", "--data.max_img_cat=4", "--tb!",
            "--eval.dump!", "--tpu.encoder_dtype=float32",
            "--tpu.implicit_dtype=float32"]
    train = ["--max_epoch=1", "--freq.eval=1", "--optim.lr=0",
             "--optim.iter_camera=1000"]
    best, reports = [], []
    for tag, launch in (("one", []), ("ddp", [
            "--standalone", "--nproc_per_node=1", "-m"])):
        out_root = f"--output_root={os.path.join(root, tag)}"
        if launch:
            out = run_cli("torch.distributed.run", launch + [
                "shapeclipper_torch.train", "--distributed"] + tiny
                + [out_root], train)
            run_cli("torch.distributed.run", launch + [
                "shapeclipper_torch.evaluate", "--distributed"] + tiny
                + [out_root], ["--resume"])
        else:
            out = run_cli("shapeclipper_torch.train", tiny + [out_root],
                          train)
            run_cli("shapeclipper_torch.evaluate", tiny + [out_root],
                    ["--resume"])
        best.append([ln for ln in out.splitlines()
                     if ln.startswith("Best CD")])
        reports.append(read_reports(os.path.join(root, tag,
                                                 "synthetic_output", "run")))
    if len(best[0]) != 1 or best[0] != best[1]:
        raise AssertionError(f"Best CD lines differ: {best}")
    differ = [n for n in reports[0] if reports[0][n] != reports[1][n]]
    if differ:
        raise AssertionError(f"train / evaluate --distributed reports "
                             f"differ: {differ}")
    log(f"[ddp-cli] train --distributed and evaluate --distributed (one "
        f"NCCL rank each) against train and evaluate: '{best[0][0]}' both; "
        f"cd_cat.txt, f_score.txt, chamfer.txt equal")
    return phase_eval_ranks()


def read_reports(run):
    texts = {}
    for name in ("cd_cat.txt", "f_score.txt", "chamfer.txt"):
        with open(os.path.join(run, name)) as f:
            texts[name] = f.read()
    return texts


def phase_eval_ranks():
    """Phase 14 (b): the full evaluation width of options/pix3d/config.yaml
    (its own precision, eval.dump and tpu.device_isosurface) over the 8
    synthetic test samples: seeded weights saved as a run's best.pt, then
    `evaluate --resume` in this process and `evaluate --distributed
    --resume` as one NCCL rank under torchrun (`--eval-worker`), each
    through `evaluate_counted`. The reports must be byte-equal, the dumps
    the same files, the launches the same and the path's."""
    import shutil
    import torch
    from shapeclipper_torch.eval3d import metrics as M
    from shapeclipper_torch.models.graph import Graph
    from shapeclipper_torch.utils import checkpoint as ckpt
    root = os.path.join(OUT_DIR, "eval_ranks")
    shutil.rmtree(root, ignore_errors=True)
    opt = load_opt()
    state = Graph(opt, generator=torch.Generator().manual_seed(SEED)
                  ).state_dict()
    n, vox = 8, opt.eval.vox_res
    args = ["--yaml=options/pix3d/config.yaml", "--group=eval_ranks",
            "--name=run", "--data.dataset=synthetic", "--data.num_workers=0",
            "--data.synthetic={azim_range: [-180, 180], elev_range: [-90, "
            "90], theta_range: [-90, 90]}", "--force_add", "--tb!",
            "--resume"]
    res = {}
    for tag in ("one", "ddp"):
        out = os.path.join(root, tag)
        run = os.path.join(out, "eval_ranks", "run")
        os.makedirs(run)
        ckpt.write_checkpoint(os.path.join(run, "best.pt"), state)
        t0 = time.perf_counter()
        if tag == "one":
            res[tag] = evaluate_counted(args + [f"--output_root={out}"])
        else:
            report = os.path.join(root, "ddp.json")
            r = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc_per_node=1",
                 os.path.join(REPO, "chip_smoke.py"), "--eval-worker", report,
                 "--distributed", *args, f"--output_root={out}"],
                cwd=REPO, capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                raise AssertionError(f"evaluate --distributed failed "
                                     f"({r.returncode}):\n{r.stdout[-3000:]}"
                                     f"\n{r.stderr[-3000:]}")
            with open(report) as f:
                res[tag] = json.load(f)
        res[tag].update(wall_s=time.perf_counter() - t0,
                        reports=read_reports(run),
                        dumps=sorted(os.listdir(os.path.join(run, "dump"))))
    one, ddp = res["one"], res["ddp"]
    differ = [k for k in one["reports"]
              if one["reports"][k] != ddp["reports"][k]]
    if differ:
        raise AssertionError(f"evaluate --distributed at the full width: "
                             f"reports differ: {differ}")
    if one["dumps"] != ddp["dumps"] or f"{n - 1}_mesh.ply" not in one["dumps"]:
        raise AssertionError(f"dump files: {one['dumps']} vs {ddp['dumps']}")
    k3_per = -(-(vox + 1) ** 3 // M.GRID_CHUNK)
    want = dict(k1=0, k3=k3_per * n, k2=0, k1_bf16=n, k3_bf16=0, k2_bf16=0,
                pack_bf16=n, k4=2 * n, k5=0, k6=0, k7=0, **GENERIC_NONE)
    for tag in res:
        if res[tag]["launches"] != want or res[tag]["n"] != n:
            raise AssertionError(f"evaluate ({tag}): {res[tag]['n']} "
                                 f"samples, launches {res[tag]['launches']}, "
                                 f"expected {want}")
    rows = np.array([[float(x) for x in line.split()[1:]] for line in
                     one["reports"]["chamfer.txt"].splitlines()])
    if rows.shape != (n, 2) or not np.isfinite(rows).all():
        raise AssertionError(f"chamfer.txt rows {rows}")
    log(f"[eval-ranks] evaluate --resume at the full eval width of "
        f"options/pix3d/config.yaml ({opt.eval.image_size[0]}^2 render, vox "
        f"{vox}, {opt.eval.num_points:,} points, dumps on, bf16 per the "
        f"YAML) over {n} synthetic test samples, ms per sample steady "
        f"(samples 2-{n}) / whole Runner.evaluate: one process (this one) "
        f"{one['steady_ms']:.2f} / {one['evaluate_ms'] / n:.2f}, one NCCL "
        f"rank under torchrun (evaluate --distributed, a fresh process) "
        f"{ddp['steady_ms']:.2f} / {ddp['evaluate_ms'] / n:.2f} "
        f"({one['wall_s']:.1f} / {ddp['wall_s']:.1f} s in all); cd_cat.txt, "
        f"f_score.txt, chamfer.txt byte-equal, dumps the same "
        f"{len(one['dumps'])} files; launches {one['launches']} both; CD "
        f"{rows.mean():.5f}; card {card_line()}")
    return ddp["launches"]


def evaluate_counted(argv):
    """`shapeclipper_torch.evaluate.main(argv)` with every kernel's launch
    count reset just before it and read just after, and cuDNN
    deterministic (so that two runs' reports compare byte for byte) ->
    the launches, the whole Runner.evaluate's ms (between two
    synchronisations), its steady ms a batch (from the second batch's
    submit to the end), the number of test samples and the rank."""
    import torch
    from shapeclipper_torch import evaluate, parallel
    from shapeclipper_torch.eval3d import metrics as M
    from shapeclipper_torch.train.trainer import Runner
    timed, submits = {}, []

    def timer(fn):
        def run(self, *args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(self, *args, **kwargs)
            torch.cuda.synchronize()
            timed.update(t=t, end=time.perf_counter(), rank=parallel.rank(),
                         n=len(self.test_data))
            return out
        return run

    def stamp(fn):
        def submit(*args, **kwargs):
            submits.append(time.perf_counter())
            return fn(*args, **kwargs)
        return submit

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    reset_launches()
    try:
        with wrapped([(Runner, "evaluate", timer),
                      (M, "eval_metrics_submit", stamp)]):
            evaluate.main(argv)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    launches = read_launches()
    n = timed["n"]
    return dict(launches=launches, n=n, rank=timed["rank"],
                evaluate_ms=(timed["end"] - timed["t"]) * 1e3,
                steady_ms=(timed["end"] - submits[1]) * 1e3 / (n - 1))


def eval_worker(report, argv):
    """`python chip_smoke.py --eval-worker REPORT ARGS...`, a rank under
    torchrun (ARGS with `--distributed`): `evaluate_counted(ARGS)` with the
    TF32 switches off, as in this script's own process; rank 0 writes its
    result to REPORT."""
    import torch
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = evaluate_counted(argv)
    if res["rank"] == 0:
        with open(report, "w") as f:
            json.dump(res, f)
    return 0


def phase_category_reg():
    """`loss_weight.category_reg=1` (nine category centres): the first full
    step at batch 4 on the card and on the CPU plain path from the same
    weights and draws: the loss term, the centres' gradient and the
    post-step centres: the loss 1e-4 relative, the gradient 1e-3
    norm-relative (the centres read the train-mode BatchNorm'd codes), the
    post-step centres 0.05 lr at most and 0.02 lr on the mean, as phase
    10's card-vs-CPU step (Adam's first update moves a parameter by at most
    lr, so a bound of lr or more holds nothing)."""
    import torch
    from shapeclipper_torch.train.trainer import batch_to_var
    opt = flagship_opt(batch_size=4)
    opt.loss_weight.category_reg = 1.0
    opt.data.num_classes = 9
    opt.output_path = os.path.join(OUT_DIR, "category_reg")
    gpu = train_runner(opt, "cuda")
    cpu = train_runner(opt, "cpu")
    cpu.graph.load_state_dict(gpu.graph.state_dict())
    c0 = cpu.graph.category_centers.detach().clone()
    batch = one_batch(opt, noise_images=True)
    draws = global_draws(opt, batch, 1)[0]
    res = {}
    for role, r in (("gpu", gpu), ("cpu", cpu)):
        r.it = 1
        loss = r.train_iteration(opt, batch_to_var(batch, r.device),
                                 draws=_to_tree(draws, r.device))
        c = r.graph.category_centers
        res[role] = (float(loss.category_reg), c.grad.detach().cpu(),
                     c.detach().cpu())
    lr = float(opt.optim.lr)
    (lg, gg, cg), (lc, gc, cc) = res["gpu"], res["cpu"]
    loss_err = abs(lg - lc) / abs(lc)
    grad_err = float((gg - gc).norm() / gc.norm())
    par = float((cg - cc).abs().max()) / lr
    mean = float((cg - cc).abs().mean()) / lr
    moved = float((cc - c0).abs().max()) / lr
    log(f"[category_reg] batch 4 full step, card vs CPU: loss term "
        f"{lg:.6f} vs {lc:.6f} (rel {loss_err:.2e}, tol 1e-4); centres' "
        f"gradient norm-rel {grad_err:.2e} (tol 1e-3), |grad| "
        f"{float(gc.norm()):.3e}; post-step centres max {par:.2e} lr (tol "
        f"0.05 lr), mean {mean:.2e} lr (tol 0.02 lr), the step moved them "
        f"{moved:.3f} lr; card {card_line()}")
    if not (lc > 0 and float(gc.norm()) > 0 and moved > 0.5):
        raise AssertionError("category_reg: zero loss, gradient or step")
    if loss_err > 1e-4 or grad_err > 1e-3 or par > 0.05 or mean > 0.02:
        raise AssertionError(f"category_reg card vs CPU: loss {loss_err}, "
                             f"gradient {grad_err}, post-step max {par} / "
                             f"mean {mean} lr")


# --------------------------------------------------------------- phase 16
def generic_flop(arch, kind):
    """FLOPs a point needs in K8 ('grad'), K8-nograd ('nograd') or K9
    ('bwd'): twice the function's multiply-adds, the tangent rows' zeros not
    counted (as MAC_TANGENT): without tangents every weight once; with them
    a posenc product 2 D rows' worth (a tangent row is non-zero at D / 3
    features), a hidden product 4 rows, the output layer's tangent rows its
    sdf column alone; K9 three times the forward with tangents (as K2)."""
    if kind == "nograd":
        return 2 * arch.num_weights
    mac = 0
    for l, (ka, kb) in enumerate(arch.layer_shapes()):
        last = l == arch.n_hidden
        if l > 0:
            mac += ka[0] * ka[1] + 3 * ka[0] if last else 4 * ka[0] * ka[1]
        pe = ka if l == 0 else kb
        if pe is not None:
            mac += pe[0] * pe[1] + pe[0] if last else 2 * pe[0] * pe[1]
    return 2 * mac * (3 if kind == "bwd" else 1)


def generic_bound(arch, B, N, kind, bf16=False):
    """(FLOPs, (bound ms, 'operations' or 'bytes')) of K8 / K8-nograd / K9
    at B x N: the FLOPs of `generic_flop`; the bytes of points, outputs,
    cotangents and point gradient once a point, the float32 weights and
    biases once (K9 also writes their gradients); with `bf16` the products
    at the bf16 peak and the elementwise FLOPs (ELEM_K*'s count for this
    architecture) at the fp32 one."""
    L, W, F_ = arch.n_hidden, arch.width, arch.n_freqs
    flop = generic_flop(arch, kind) * B * N
    per_point = dict(nograd=4 + W, grad=7 + W, bwd=10 + W)[kind]
    params = (arch.num_weights + B * arch.bias_width) * (
        2 if kind == "bwd" else 1)
    nbytes = 4 * (B * N * per_point + params)
    if not bf16:
        return flop, bound(flop, nbytes)
    elem = L * W * 11 + 9 * F_ + W + 1
    if kind != "nograd":
        elem += L * W * 3 + 12 * F_
    if kind == "bwd":
        elem += L * W * 14 + arch.bias_width
    return flop, bound(elem * B * N, nbytes, mm_flop=flop)


def generic_case(spec, B, N, seed, points=None):
    """An SDF network of `spec` (nn.Linear's default init, so that every
    layer's posenc and latent rows are dense), a latent, points in [-1, 1]^3
    (or `points`) and cotangents, all on the card, with the packed operands
    of the generic pair."""
    import torch
    from types import SimpleNamespace
    from shapeclipper_torch.models.implicit import SDFNetwork
    from shapeclipper_torch.ops import fused_sdf as F
    n_freqs, skips, hidden, width, latent, sym = spec
    g = torch.Generator().manual_seed(seed)
    net = SDFNetwork(proj_latent_dim=latent, n_hidden=hidden,
                     n_channels=width, skip_in=skips, posenc_res=n_freqs,
                     force_symmetry=sym, geometric_init=False, generator=g)
    lat = torch.randn(B, latent, generator=g) * 0.3
    with torch.no_grad():
        w, b = F.pack_fused_params(*F.prepare_fused_params(net, lat))
    dev = torch.device("cuda")
    gd = torch.Generator(device=dev).manual_seed(seed)
    if points is None:
        points = torch.rand(B, N, 3, device=dev, generator=gd) * 2 - 1
    cots = [torch.randn(B, N, *c, device=dev, generator=gd)
            for c in ((), (width,), (3,))]
    return SimpleNamespace(arch=F.sdf_arch(net), sym=sym, B=B, N=N,
                           pts=points.to(dev).contiguous(), w=w.to(dev),
                           b=b.to(dev), cots=cots)


def generic_forward_plain(c, grad, mm, rows=None):
    """The plain version of K8 / K8-nograd on case `c` (float32), over
    blocks of `rows` batch rows."""
    import torch
    from shapeclipper_torch.ops import fused_sdf as F
    rows = rows or c.B
    with torch.inference_mode():
        parts = [F.generic_forward_reference(
            c.pts[i:i + rows], c.w, c.b[i:i + rows], c.arch, grad, c.sym, mm)
            for i in range(0, c.B, rows)]
    return tuple(None if p[0] is None else torch.cat(p) for p in zip(*parts))


def generic_backward_plain(c, mm, dtype, rows, points):
    """The plain version of K9 on case `c` in `dtype`, over blocks of `rows`
    batch rows x `points` points: the weights' gradient summed over the
    blocks, the biases' over each row's blocks."""
    import torch
    from shapeclipper_torch.ops import fused_sdf as F
    dev = c.w.device
    w = c.w.to(dtype)
    dw = torch.zeros(c.w.shape, dtype=dtype, device=dev)
    db = torch.zeros(c.b.shape, dtype=dtype, device=dev)
    dp = torch.empty(c.pts.shape, dtype=dtype, device=dev)
    for i in range(0, c.B, rows):
        r = slice(i, i + rows)
        for n in range(0, c.N, points):
            q = slice(n, n + points)
            gw, gb, gp = F.generic_backward_reference(
                c.pts[r, q].to(dtype), w, c.b[r].to(dtype), c.arch,
                *(t[r, q].to(dtype) for t in c.cots), c.sym, mm)
            dw += gw
            db[r] += gb
            dp[r, q] = gp
    return dw, db, dp


def generic_check_bwd(got, want, where):
    """K9's (d weights, d biases, d points) against the float64 plain
    version at BWD_ATOL x max|ref| / BWD_RTOL -> {part: max abs err}."""
    import torch
    errs, bad = {}, []
    for part, g, w in zip(("weights", "biases", "points"), got, want):
        scale = max(float(w.abs().max()), 1e-3)
        errs[part], ok = within(g.double(), w, BWD_ATOL * scale, BWD_RTOL)
        if not ok or not torch.isfinite(g).all():
            bad.append(part)
    if bad:
        raise AssertionError(f"K9 disagrees with the float64 plain version "
                             f"{where} in {bad}: {errs}")
    return errs


def with_wide_sdf(opt):
    """`opt` with GENERIC_WIDE_ARGS applied as the CLIs apply them."""
    from shapeclipper_torch.config import options
    return options.override_options(
        opt, options.parse_arguments(GENERIC_WIDE_ARGS), key_stack=[],
        safe_check=True)


def phase_generic_kernels(opt):
    """K8, K8-nograd and K9 (`csrc/fused_sdf_generic.cu`) against their
    plain versions, float32 (SDF_TOL / GRAD_TOL; K9 against the float64
    plain version at BWD_ATOL / BWD_RTOL, as K2 at the render shapes) and
    bf16 (`check_bf16`'s rule against the bf16 plain version, K9's in
    float64, beside the float32 kernel): at the narrow architecture at 12 x
    1,024; at the wide one at the eikonal's 12 x 1,024, at 12 x 32,768 (K9
    also bitwise over two launches), the merged render's 24 x 32,768 and
    the vox-64 grid's 274,625 (K8-nograd); each timed over SDF_TIMED_CALLS
    launches between two events (once at the wide render shapes, whose
    launches take 0.1-1 s) beside its plain version (over blocks of
    GENERIC_PLAIN_ROWS batch rows where it would not fit whole) and its
    bound -> {key: results at the main path's shape}, with `narrow_*` and
    `eikonal_*` readings."""
    import torch
    from shapeclipper_torch.eval3d.metrics import dense_grid_points
    from shapeclipper_torch.ops import fused_sdf as F

    G = F.GENERIC
    for label, name in (("K8", "fwd_kernelILb1ELb0E"),
                        ("K8-bf16", "fwd_kernelILb1ELb1E"),
                        ("K8-nograd", "fwd_kernelILb0ELb0E"),
                        ("K8-nograd-bf16", "fwd_kernelILb0ELb1E"),
                        ("K9", "bwd_kernelILb0E"), ("K9-bf16", "bwd_kernelILb1E")):
        regs, st, ld, stack = ptxas_usage(G.ptxas_log, "sdf_generic_" + name,
                                          stack=True)
        log(f"[generic] {label} ptxas: {regs} registers, {st} / {ld} bytes "
            f"spill stores / loads, {stack} bytes stack")
        if st or ld:
            raise AssertionError(f"{label} spills registers: {st} / {ld}")
    parts = ("sdf", "feat", "grad")
    res = {}

    def fwd(c, grad, mm):
        return G.forward(c.pts, c.w, c.b, c.arch, grad, c.sym, mm)

    def bwd(c, mm):
        return G.backward(c.pts, c.w, c.b, c.arch, *c.cots, c.sym, mm)

    def timed(fn, wide):
        return cuda_ms(fn, runs=1 if wide else 10, warmup=0 if wide else 3,
                       calls=SDF_TIMED_CALLS)

    def forward_case(tag, c, grad, wide=False, rows=None, time_it=True):
        kind = "grad" if grad else "nograd"
        with torch.inference_mode():
            k32 = fwd(c, grad, "float32")
            k16 = fwd(c, grad, "bfloat16")
            torch.cuda.synchronize()
            errs = check_forward(k32, generic_forward_plain(
                c, grad, "float32", rows), f"(K8 {kind}, {tag})")
            errs_b = check_bf16(
                {p: t for p, t in zip(parts, k16) if t is not None},
                dict(zip(parts, generic_forward_plain(c, grad, "bfloat16",
                                                      rows))),
                dict(zip(parts, k32)), f"(K8-bf16 {kind}, {tag})",
                BF16_MAX_TOL, BF16_MEAN_TOL)
            del k32, k16
            out = {}
            for mm in (("float32", "bfloat16") if time_it else ()):
                ms = timed(lambda: fwd(c, grad, mm), wide)
                plain_ms = cuda_ms(lambda: generic_forward_plain(
                    c, grad, mm, rows), runs=1 if wide else 5, warmup=1)
                _, (bound_ms, bound_by) = generic_bound(
                    c.arch, c.B, c.N, kind, mm == "bfloat16")
                out[mm] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by)
        err32 = max(errs.values())
        err16 = max(e[0] for e in errs_b.values())
        log(f"[generic] K8 {kind} {tag} B={c.B} N={c.N}: max abs err "
            + ", ".join(f"{p}={e:.3e}" for p, e in errs.items())
            + f" (tol sdf/feat {SDF_TOL}, grad {GRAD_TOL}); bf16 max / mean "
            "/ mean distance from float32 " + ", ".join(
                f"{p} {e[0]:.3e} / {e[1]:.3e} / {e[2]:.3e}"
                for p, e in errs_b.items()))
        for mm, r in out.items():
            log(f"[generic]   {mm}: {r['ms']:.4f} ms ({SDF_TIMED_CALLS} "
                f"launches between two events), plain {r['plain_ms']:.4f} ms"
                f" ({r['plain_ms'] / r['ms']:.2f}x), bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}, "
                f"{100 * r['bound_ms'] / r['ms']:.1f}% of it reached)")
        return err32, err16, out

    def backward_case(tag, c, wide=False, bf16=True, repeat=False,
                      time_it=True):
        got = bwd(c, "float32")
        torch.cuda.synchronize()
        ref = generic_backward_plain(c, "float32", torch.float64,
                                     GENERIC_PLAIN_ROWS, GENERIC_F64_POINTS)
        errs = generic_check_bwd(got, ref, f"({tag} B={c.B} N={c.N})")
        del ref
        err16, line16 = None, ""
        if bf16:
            got16 = bwd(c, "bfloat16")
            ref16 = generic_backward_plain(c, "bfloat16", torch.float64,
                                           GENERIC_PLAIN_ROWS,
                                           GENERIC_F64_POINTS)
            names = ("weights", "biases", "points")
            scale = {p: max(float(r.abs().max()), 1e-3)
                     for p, r in zip(names, ref16)}
            errs_b = check_bf16(
                dict(zip(names, got16)), dict(zip(names, ref16)),
                dict(zip(names, got)), f"(K9-bf16 {tag} B={c.B} N={c.N})",
                {p: BF16_K2_MAX * v for p, v in scale.items()},
                {p: BF16_K2_MEAN * v for p, v in scale.items()})
            err16 = max(e[0] for e in errs_b.values())
            line16 = "; K9-bf16 against the float64 bf16 plain version " \
                "over max|ref|: max / mean " + ", ".join(
                    f"{p} {e[0] / scale[p]:.3e} / {e[1] / scale[p]:.3e}"
                    for p, e in errs_b.items()) + \
                f" (tol {BF16_K2_MAX} / {BF16_K2_MEAN})"
            del got16, ref16
        if repeat:
            again = bwd(c, "float32")
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"two K9 launches differ at {tag}")
            line16 += "; two launches bitwise equal"
        del got
        torch.cuda.empty_cache()
        log(f"[generic] K9 {tag} B={c.B} N={c.N} against the float64 plain "
            "version: max abs err " + ", ".join(
                f"{p}={e:.3e}" for p, e in errs.items())
            + f" (tol atol {BWD_ATOL} x max|ref|, rtol {BWD_RTOL})" + line16)
        out = {}
        for mm in (("float32", "bfloat16") if time_it else ()):
            ms = timed(lambda: bwd(c, mm), wide)
            plain_ms = cuda_ms(lambda: generic_backward_plain(
                c, mm, torch.float32, GENERIC_PLAIN_ROWS if wide else c.B,
                c.N), runs=1 if wide else 5, warmup=1)
            torch.cuda.empty_cache()
            _, (bound_ms, bound_by) = generic_bound(c.arch, c.B, c.N, "bwd",
                                                    mm == "bfloat16")
            out[mm] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by)
            log(f"[generic]   {mm}: {ms:.4f} ms ({SDF_TIMED_CALLS} launches "
                f"between two events), plain {plain_ms:.4f} ms "
                f"({plain_ms / ms:.2f}x), bound {bound_ms:.4f} ms "
                f"({bound_by}, {100 * bound_ms / ms:.1f}% of it reached)")
        return max(errs.values()), err16, out

    def entry(key, err, timing, **extra):
        res.setdefault(key, dict(err=0.0))
        res[key]["err"] = max(res[key]["err"], err)
        res[key].update(timing, **extra)

    narrow = generic_case(GENERIC_NARROW, 12, 1024, SEED + 16)
    for grad, key in ((True, "k8"), (False, "k8_nograd")):
        e32, e16, t = forward_case("narrow", narrow, grad)
        entry(key, e32, {f"narrow_{k}": v for k, v in t["float32"].items()})
        if grad:
            entry("k8_bf16", e16, {f"narrow_{k}": v
                                   for k, v in t["bfloat16"].items()})
        else:
            res["k8_nograd"]["err"] = max(res["k8_nograd"]["err"], e16)
    e32, e16, t = backward_case("narrow", narrow, repeat=True)
    entry("k9", e32, {f"narrow_{k}": v for k, v in t["float32"].items()})
    entry("k9_bf16", e16, {f"narrow_{k}": v
                           for k, v in t["bfloat16"].items()})
    del narrow

    eik = generic_case(GENERIC_WIDE, 12, 1024, SEED + 17)
    e32, e16, t = forward_case("wide, eikonal", eik, True)
    entry("k8", e32, {f"eikonal_{k}": v for k, v in t["float32"].items()})
    entry("k8_bf16", e16, {f"eikonal_{k}": v
                           for k, v in t["bfloat16"].items()})
    e32, e16, t = backward_case("wide, eikonal", eik)
    entry("k9", e32, {f"eikonal_{k}": v for k, v in t["float32"].items()})
    entry("k9_bf16", e16, {f"eikonal_{k}": v
                           for k, v in t["bfloat16"].items()})
    del eik

    c12 = generic_case(GENERIC_WIDE, 12, 32768, SEED + 18)
    e32, e16, _ = forward_case("wide, render", c12, True, wide=True,
                               time_it=False)
    entry("k8", e32, {})
    entry("k8_bf16", e16, {})
    e32, _, _ = backward_case("wide, render", c12, wide=True, bf16=False,
                              repeat=True, time_it=False)
    entry("k9", e32, {})
    del c12
    torch.cuda.empty_cache()

    c24 = generic_case(GENERIC_WIDE, MERGED_VIEWS, 32768, SEED + 19)
    e32, e16, t = forward_case("wide, merged render", c24, True, wide=True,
                               rows=4)
    entry("k8", e32, t["float32"], shape=f"{c24.B}x{c24.N}")
    entry("k8_bf16", e16, dict(t["bfloat16"], f32_ms=t["float32"]["ms"]),
          shape=f"{c24.B}x{c24.N}")
    e32, e16, t = backward_case("wide, merged render", c24, wide=True)
    entry("k9", e32, t["float32"], shape=f"{c24.B}x{c24.N}")
    entry("k9_bf16", e16, dict(t["bfloat16"], f32_ms=t["float32"]["ms"]),
          shape=f"{c24.B}x{c24.N}")
    del c24
    torch.cuda.empty_cache()

    grid = dense_grid_points(opt, 64, torch.device("cuda"))[None]
    cg = generic_case(GENERIC_WIDE, 1, grid.shape[1], SEED + 20, points=grid)
    e32, e16, t = forward_case("wide, vox-64 grid", cg, False)
    entry("k8_nograd", max(e32, e16),
          dict(t["float32"], bf16_ms=t["bfloat16"]["ms"]),
          shape=f"1x{cg.N}")
    del cg
    torch.cuda.empty_cache()
    log(f"[generic] card {card_line()}")
    return res


def phase_generic_paths():
    """The wide SDF MLP (GENERIC_WIDE_ARGS on options/pix3d/config.yaml)
    through the port's entry points, launch counts reset just before and
    read just after each: the YAML's own step (bf16, merged; batch 12,
    224^2, 512 rays x 64 samples) for a camera and N_GENERIC_STEPS full
    steps (K8-bf16 2 / K9-bf16 1, then 2 / 2), a float32 camera and full
    step (K8 2 / K9 1, then 2 / 2), two requests at the YAML's dtypes (K8-bf16
    1 + N_VIEWS, K8-nograd 3 a request) and `Runner.evaluate` over 2
    synthetic test samples at the full eval width pinned to float32 as
    phase 8 (K8 1, K8-nograd 3, K4 2 a sample); K1 / K2 / K3, their bf16
    forms and the pack never -> the launches of each path."""
    import torch
    from shapeclipper_torch.eval3d import metrics as M
    from shapeclipper_torch.ops import fused_sdf as F
    from shapeclipper_torch.train.trainer import Runner, batch_to_var

    launches = {}

    def counted(tag, fn, want):
        before = read_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        now = read_launches()
        got = {k: now[k] - before[k] for k in now if now[k] != before[k]}
        if got != want:
            raise AssertionError(f"{tag}: launches {got}, expected {want}")
        return out, ms

    for dtype, steps, k8, k9 in (("bfloat16", N_GENERIC_STEPS, "k8_bf16",
                                  "k9_bf16"), ("float32", 1, "k8", "k9")):
        opt = with_wide_sdf(flagship_opt(dtype=dtype, merged=True))
        runner = train_runner(opt, "cuda")
        if F.sdf_route(runner.graph.sdf_network) != "generic":
            raise AssertionError("the wide SDF MLP took the flagship route")
        var = batch_to_var(one_batch(opt), runner.device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        times = []
        for step in range(1 + steps):
            loss, ms = counted(
                f"wide {dtype} step {step}",
                lambda: runner.train_iteration(opt, var),
                {k8: 2, k9: 1 if step == 0 else 2})
            check_loss(f"wide {dtype} step {step}", loss)
            times.append(ms)
            log(f"[generic-train] {dtype} step {step} ({'camera' if step == 0 else 'full'}): "
                f"{ms:.1f} ms, loss " + ", ".join(
                    f"{k} {float(v):.4f}" for k, v in loss.items()
                    if k != "finite"))
        launches[f"train_{dtype}"] = read_launches()
        log(f"[generic-train] {F.route_note(F.arch_from_opt(opt))}, "
            f"{dtype}: steady full step {statistics.median(times[2:] or times[1:]):.1f} ms"
            f" (median of full steps {2 if steps > 1 else 1}-{steps}), peak "
            f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f}"
            f" GiB; launches {launches[f'train_{dtype}']}; card {card_line()}")
        del runner, var
        torch.cuda.empty_cache()

    opt = with_wide_sdf(load_opt(dtype="bfloat16"))
    runner = Runner(opt, "cuda")
    runner.build_networks(opt)
    runner.restore_checkpoint(opt)
    vox = opt.eval.vox_res
    per_request = dict(k8_bf16=1 + N_VIEWS,
                       k8_nograd=-(-(vox + 1) ** 3 // M.GRID_CHUNK))
    reset_launches()
    latencies = []
    for i in range(2):
        (var, level, mesh), ms = counted(
            f"wide request {i}", lambda: serve(
                runner, opt, request_image(i, opt.H, opt.W)), per_request)
        latencies.append(ms)
        for key in ("rgb_recon_map", "normal_recon_map", "proj_latent_sdf"):
            check_finite(f"wide request {i} {key}", var[key])
        check_finite(f"wide request {i} level", level)
    launches["serve"] = read_launches()
    log(f"[generic-serve] 2 requests, wide SDF MLP, the YAML's dtypes: "
        + ", ".join(f"{t:.1f}" for t in latencies) + f" ms; launches per "
        f"request {per_request}; mesh of the last {mesh.vertices.shape[0]} "
        "vertices")
    del runner

    n = 2
    opt = with_wide_sdf(eval_opt("generic_eval", n_samples=n))
    runner = eval_runner(opt, "cuda")
    reset_launches()
    (cd, rows, fs), ms = counted(
        "wide evaluation", lambda: evaluate_collect(runner, opt),
        dict(k8=n, k8_nograd=-(-(opt.eval.vox_res + 1) ** 3 // M.GRID_CHUNK)
             * n, k4=2 * n))
    if rows.shape != (n, 2) or not np.isfinite(rows).all() or \
            not np.isfinite(cd):
        raise AssertionError(f"wide evaluation: CD {cd}, chamfer rows "
                             f"{rows.shape}")
    launches["eval"] = read_launches()
    log(f"[generic-eval] {n} samples at the full eval width, wide SDF MLP "
        f"(float32): {ms:.1f} ms, CD {cd:.5f}, F-scores "
        f"{np.round(fs.mean(0), 4).tolist()}; launches {launches['eval']}")
    del runner
    torch.cuda.empty_cache()
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this "
              "script runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "shapeclipper_torch")):
        print("chip_smoke.py: run it from a checkout of the repository "
              "(shapeclipper_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from shapeclipper_torch.ops import cuda_lib
    from shapeclipper_torch.utils.log import log as port_log

    # phase 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    t_start = time.perf_counter()
    log(f"[setup] torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"python {sys.version.split()[0]}")
    log(f"[setup] device {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")
    log(f"[setup] allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    # compiled afresh even where `build/` holds them, so that phases 2 and 3
    # read this run's ptxas log
    cuda_lib.build_kernels(force=True)
    log(f"[setup] kernels built from {SOURCE}, {SOURCE_BWD} with "
        f"{SOURCE_BWD_BF16}, {SOURCE_GENERIC}, {SOURCE_NN} and {SOURCE_ISO} "
        f"(five nvcc runs at once) in {time.perf_counter() - t0:.2f} s")
    for lib in cuda_lib.libraries():
        log(lib.ptxas_log.strip())
    warnings = []
    port_warn = port_log.warn

    def record_warning(message):
        warnings.append(str(message))
        port_warn(message)

    port_log.warn = record_warning

    seconds = {}

    def run(fn, *args, **kwargs):   # a phase function, its seconds kept
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        name = fn.__name__ + ("_merged" if kwargs.get("merged") else "")
        seconds[name] = round(time.perf_counter() - t, 1)
        return out

    opt = load_opt()
    kern = run(phase_kernels, opt)                      # phase 2
    bwd = run(phase_backward)                           # phase 3
    serve_launches, _, image0 = run(phase_serve, opt)   # phase 4
    run(phase_cli, opt, image0)
    train_launches = run(phase_train)                   # phase 5
    run(phase_gpu_vs_cpu_step)
    bf16, k3_bf16_api = run(phase_bf16_kernels, opt)    # phase 5a
    bf16_launches, seq_bf16 = run(phase_train_bf16)     # phase 5b
    run(phase_serve_bf16)                               # phase 5c
    run(phase_gpu_vs_cpu_step_bf16)                     # phase 5d
    merged_launches = run(phase_train_merged, seq_bf16)  # phase 5e
    run(phase_gpu_vs_cpu_step, merged=True)
    merged = run(phase_merged_kernels)
    run(phase_converge)                                 # phase 6
    nn = run(phase_chamfer)                             # phase 7
    eval_launches, err4, err5 = run(phase_eval)         # phase 8
    nn["k4"]["err"] = max(nn["k4"]["err"], err4)
    nn["k5"]["err"] = max(nn["k5"]["err"], err5)
    api_launches = run(phase_chamfer_api)
    iso_launches, iso, err6, err7 = run(phase_isosurface)  # phase 8b
    run(phase_clis)                                     # phase 9
    run(phase_pretrain)                                 # phase 10
    run(phase_clip)                                     # phase 11
    run(phase_pretrain_clis)                            # phase 12
    run(phase_ddp_nccl)                                 # phase 13
    run(phase_ddp_gloo)
    run(phase_k1_k2_half)
    run(phase_ddp_cli)                                  # phase 14
    run(phase_category_reg)                             # phase 15
    gen = run(phase_generic_kernels, opt)               # phase 16
    gen_launches = run(phase_generic_paths)
    log(f"[done] seconds by phase function: {json.dumps(seconds)}")
    guarded = [w for w in warnings if w.startswith(GUARD_WARNINGS)]
    if guarded:
        raise AssertionError(f"a guard swallowed a failure: {guarded}")

    k1, k3 = kern["grad"][1], kern["nograd"][0]

    def at_merged_shape(key):   # phase 5e's times at 24 x 32,768
        return {f"{k}_24x32768": merged[key][k]
                for k in ("ms", "plain_ms", "bound_ms", "bound_by")}

    summary = [
        dict(name="fused_sdf_fwd (K1, compute_grad=True)", route="cuda",
             source=SOURCE, replaces=REPLACES,
             launches=train_launches["k1"],
             max_abs_err=max([r["err"] for r in kern["grad"]]
                             + [merged["k1"]["err"]]), ms=k1["ms"],
             plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None,
             **at_merged_shape("k1")),
        dict(name="fused_sdf_fwd (K3, compute_grad=False)", route="cuda",
             source=SOURCE, replaces=REPLACES,
             launches=serve_launches["nograd"],
             max_abs_err=max(r["err"] for r in kern["nograd"]), ms=k3["ms"],
             plain_ms=k3["plain_ms"], bound_ms=k3["bound_ms"],
             bound_by=k3["bound_by"], library_ms=None),
        dict(name="fused_sdf_bwd (K2)", route="cuda", source=SOURCE_BWD,
             replaces=REPLACES_BWD, launches=train_launches["k2"],
             max_abs_err=max(bwd["err"], merged["k2"]["err"]), ms=bwd["ms"],
             plain_ms=bwd["plain_ms"], bound_ms=bwd["bound_ms"],
             bound_by=bwd["bound_by"], library_ms=None,
             **at_merged_shape("k2")),
        dict(name="fused_sdf_fwd (K1-bf16, compute_grad=True, bf16 "
             "products)", route="cuda", source=SOURCE, replaces=REPLACES,
             launches=merged_launches["k1_bf16"],
             sequential_launches=bf16_launches["k1_bf16"],
             max_abs_err=max(bf16[("grad", 1)]["err"],
                             bf16[("grad", 12)]["err"],
                             merged["k1_bf16"]["err"]),
             **{k: bf16[("grad", 12)][k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "f32_ms")},
             library_ms=None, **at_merged_shape("k1_bf16")),
        dict(name="fused_sdf_fwd (K3-bf16, compute_grad=False, bf16 "
             "products)", route="cuda", source=SOURCE, replaces=REPLACES,
             launches=k3_bf16_api, max_abs_err=bf16[("nograd", 1)]["err"],
             **{k: bf16[("nograd", 1)][k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "f32_ms")},
             library_ms=None),
        dict(name="fused_sdf_pack_bf16 (K1-bf16 / K3-bf16's weights as bf16 "
             "B fragments, with K2-bf16's plain copy)", route="cuda",
             source=SOURCE, replaces=REPLACES,
             launches=merged_launches["pack_bf16"],
             sequential_launches=bf16_launches["pack_bf16"],
             max_abs_err=bf16["pack"]["err"], **{k: bf16["pack"][k] for k in (
                     "ms", "plain_ms", "bound_ms", "bound_by", "device_ms")},
             library_ms=None),
        dict(name="fused_sdf_bwd_bf16 (K2-bf16, bf16 products on the tensor "
             "cores)", route="cuda", source=SOURCE_BWD_BF16,
             replaces=REPLACES_BWD,
             launches=merged_launches["k2_bf16"],
             sequential_launches=bf16_launches["k2_bf16"],
             max_abs_err=max(bf16[("k2", "render")]["err"],
                             bf16[("k2", "eikonal")]["err"],
                             merged["k2_bf16"]["err"]),
             **{k: bf16[("k2", "render")][k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "f32_ms")},
             library_ms=None, **at_merged_shape("k2_bf16")),
        dict(name="chamfer_nn (K4, distances)", route="cuda",
             source=SOURCE_NN, replaces=REPLACES_K4,
             launches=eval_launches["k4"], max_abs_err=nn["k4"].pop("err"),
             **nn["k4"]),
        dict(name="chamfer_nn (K5, with argmin)", route="cuda",
             source=SOURCE_NN, replaces=REPLACES_K5,
             launches=api_launches["argmin"], max_abs_err=nn["k5"].pop("err"),
             **nn["k5"]),
        dict(name="isosurface cell_area_kernel (K6, marching tetrahedra to "
             "per-cell areas)", route="cuda", source=SOURCE_ISO,
             replaces=REPLACES_K6, launches=iso_launches["k6"],
             max_abs_err=err6, **iso[ISO_VOX[0]]["k6"], library_ms=None,
             **{f"{k}_vox100": v for k, v in iso[ISO_VOX[1]]["k6"].items()}),
        dict(name="isosurface draw_kernel (K7, area-weighted surface "
             "sampling)", route="cuda", source=SOURCE_ISO,
             replaces=REPLACES_K7, launches=iso_launches["k7"],
             max_abs_err=err7, **iso[ISO_VOX[0]]["k7"], library_ms=None,
             **{f"{k}_vox100": v for k, v in iso[ISO_VOX[1]]["k7"].items()}),
    ]
    def generic_entry(key, name, path, **more):
        r = gen[key]
        return dict(name=name, route="cuda", source=SOURCE_GENERIC,
                    replaces=REPLACES_BWD if key.startswith("k9")
                    else REPLACES, launches=gen_launches[path][key],
                    max_abs_err=r.pop("err"), **r, library_ms=None, **more)

    summary += [
        generic_entry("k8", "fused_sdf_generic_fwd (K8, compute_grad=True, "
                      "SDF MLPs off the flagship)", "eval",
                      train_launches=gen_launches["train_float32"]["k8"]),
        generic_entry("k8_bf16", "fused_sdf_generic_fwd (K8-bf16, "
                      "compute_grad=True, bf16 products)", "train_bfloat16",
                      serve_launches=gen_launches["serve"]["k8_bf16"]),
        generic_entry("k8_nograd", "fused_sdf_generic_fwd (K8-nograd, "
                      "compute_grad=False)", "eval",
                      serve_launches=gen_launches["serve"]["k8_nograd"]),
        generic_entry("k9", "fused_sdf_generic_bwd (K9)", "train_float32"),
        generic_entry("k9_bf16", "fused_sdf_generic_bwd (K9-bf16, bf16 "
                      "products)", "train_bfloat16"),
    ]
    for k in summary:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} never launched on its path")
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": summary}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-worker"]:
        sys.exit(ddp_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--eval-worker"]:
        sys.exit(eval_worker(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
