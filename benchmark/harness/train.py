"""The `train` traffic kind: full training steps of the program's
`Runner.train_iteration` over a pool of host batches, each step's batch
copied to the card by `batch_to_var` inside the step's time, as users
pay it, with the step's draws made by the benchmark.

Set-up builds one Runner, loads the benchmark's weights, and drives it
through `compare_steps` full steps on batches that all differ, whose
losses, first gradients and parameter changes the reference follows, then
`warmup_steps` more. The window then runs full steps until `--seconds` have
passed and ends at a synchronise after the last. Iteration 0 of a run, the
camera step, runs once a training run and is not part of this traffic: the
Runner starts at iteration 1."""

from __future__ import annotations

import gc
import sys
import time

import torch

from . import check, inputs, program
from .. import work
from ..reference import model as ref_model
from ..reference import step as ref_step

METRIC = "train_img_per_s"


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(cell, seed, seconds, trace, device, t_start, hooks=None):
    from shapeclipper_torch.train.trainer import batch_to_var
    from shapeclipper_torch.utils.easydict import EasyDict as edict
    from torch.profiler import record_function
    from . import trace as tracing
    hooks = hooks or {}
    cfg, tr = cell.cfg, cell.traffic
    runner, opt, weights, buffers = program.build_runner(cfg, cell.name, seed,
                                                         device)
    runner.it = 1
    if "runner" in hooks:
        hooks["runner"](runner)
    pool = inputs.train_batches(cfg, tr, seed)
    draws = inputs.train_draws(cfg, tr, seed, device)
    params = dict(runner.graph.named_parameters())
    beta1 = runner.optim_full.param_groups[0]["betas"][0]
    B = cfg["batch_size"]

    def step(i):
        with record_function("bench.batch_to_var"):
            var = batch_to_var(pool[i % len(pool)], device)
        d = edict(render=edict(draws[i % len(draws)]))
        if "step" in hooks:
            var, d = hooks["step"](var, d)
        with record_function("bench.train_iteration"):
            return runner.train_iteration(opt, var, draws=d)

    n_cmp = tr["compare_steps"]
    losses, grad = [], None
    for i in range(n_cmp):
        loss = step(i)
        losses.append(loss["all"])
        if i == 0:
            terms = {k: v for k, v in loss.items() if k not in ("all",
                                                                "finite")}
            state = runner.optim_full.state
            first = {k: (state[p]["exp_avg"] / (1 - beta1)
                         if "exp_avg" in state.get(p, {})
                         else torch.zeros_like(p)).cpu()
                     for k, p in params.items()}
            grad = {k: torch.linalg.vector_norm(g.double())
                    for k, g in first.items()}
    change = {k: torch.linalg.vector_norm(
        (p.detach() - weights[k].to(p.device)).double())
        for k, p in params.items()}
    i = n_cmp
    for _ in range(tr["warmup_steps"]):
        step(i)
        i += 1
    _sync(device)
    setup_s = time.time() - t_start
    peak = _peak(device)
    _reset_peak(device)

    steps, t0 = 0, time.perf_counter()
    marks = [t0]
    while marks[-1] - t0 < seconds:
        step(i)
        i += 1
        steps += 1
        marks.append(time.perf_counter())
    _sync(device)
    window_s = time.perf_counter() - t0
    program.report_pace("step", marks)
    peak_window = _peak(device)

    summary = None
    if trace:
        with tracing.profiled(lambda: _sync(device)) as events:
            for _ in range(tr["profile_steps"]):
                step(i)
                i += 1
        V = cfg["reg"]["n_views"]
        R, S = cfg["render"]["rand_sample"], cfg["render"]["n_samples_uniform"]
        shape = work.sdf_shape(cfg["arch"]["impl_sdf"])
        calls = [((1 + V) * B, R * S), (B, 2 * R)]
        summary = tracing.Summary(events, dict(
            units=tr["profile_steps"], window_units=steps, window_s=window_s,
            flop_per_unit=work.train_step_flop(cfg, B, V),
            peak_mem_bytes=peak_window,
            sdf=dict(shape=tuple(shape), route=_route(shape),
                     mm=cfg["tpu"].get("implicit_dtype") or "float32",
                     mm_grid="float32", fwd=calls, bwd=calls)))
    peak = max(peak, _peak(device))

    prog = dict(loss=[float(x) for x in losses],
                terms={k: float(v.mean()) for k, v in terms.items()},
                grad={k: float(v) for k, v in grad.items()},
                change={k: float(v) for k, v in change.items()})
    compared = [inputs.to_device(pool[j % len(pool)], device)
                for j in range(n_cmp)]
    compared_draws = [draws[j % len(draws)] for j in range(n_cmp)]
    del runner, params, step
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference(weights, buffers, cfg, compared, compared_draws,
                    ref_model.FLOAT32, tr["reference_block"], first)
    prog["grad_diff"] = ref.pop("grad_diff")
    print(f"reference: {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    return dict(e2e={METRIC: B * steps / window_s, "setup_s": setup_s},
                attempted=steps, failed=0, peak_bytes=peak, summary=summary,
                numbers=check.train_numbers(prog, ref))


def reference(weights, buffers, cfg, batches, draws, prec, block,
              judged=None):
    """The reference's steps -> {'loss', 'grad', 'change'} as floats, and
    with `judged` (another first gradient, {leaf: tensor}) 'grad_diff',
    the norm of each leaf's difference from the reference's."""
    dev = batches[0]["rgb_input_map"].device
    weights = {k: v.to(dev) for k, v in weights.items()}
    buffers = {k: v.to(dev) for k, v in buffers.items()}
    with _no_tf32():
        out = ref_step.train_steps(weights, buffers, cfg, batches, draws, prec,
                                   block)
    res = dict(loss=out["loss"], terms=out["terms"][0],
               grad=check.norms(out["grad"]),
               change=check.norms(out["change"]))
    if judged is not None:
        res["grad_diff"] = check.norms({k: judged[k].to(dev) - g
                                        for k, g in out["grad"].items()})
    return res


class _no_tf32:
    """Float32 products as float32: TF32 off for cuBLAS and cuDNN."""

    def __enter__(self):
        b = torch.backends
        self.saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
        b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        b = torch.backends
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = self.saved


def _route(shape):
    return "flagship" if shape == work.FLAGSHIP else "generic"


def _peak(device):
    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated())


def _reset_peak(device):
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
