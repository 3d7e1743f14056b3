"""The readings that a cell's limits of `correct` are set from, in one
process on the card:

    python3 benchmark/readings.py --workload <cell> --seconds <s> \
        --seeds 1,2,... [--control-seeds 7,8,9] [--fault half_batch] \
        [--fault-seeds 4,5,6]

prints one JSON line a reading: the program's numbers on each of `--seeds`
(a short run of the cell: set-up, a window of `--seconds`, the comparison);
the control's on each of `--control-seeds` (the reference in the program's
place, its products one precision below the configuration's: fp8 e4m3, with
e5m2 cotangents, for the bf16 encoders and implicit MLPs, TF32 for every
float32 product, compared with the float32 reference on the same inputs;
`--control bf16` puts the configuration's own precision there instead, a
witness of what rounding alone moves); and the program's
with a fault planted on each of `--fault-seeds`. The benchmark's own runs
never run the control or a fault."""

import argparse
import contextlib
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTROLS = {"fp8": dict(enc="fp8", imp="fp8", f32="tf32"),
            # not a control: the configuration's own precision in the
            # reference, the witness of what rounding alone moves
            "bf16": dict(enc="bfloat16", imp="bfloat16", f32="float32")}


def half_batch():
    """A training step that leaves out the second half of the batch, the
    mean taken over the rest."""
    def step(var, draws):
        B = var.rgb_input_map.shape[0]
        h = B // 2
        var = type(var)({k: v[:h] if hasattr(v, "shape") and v.shape
                         and v.shape[0] == B else v for k, v in var.items()})
        r = draws.render
        r = type(r)(t_rand=r.t_rand[list(range(h)) + list(range(B, B + h))],
                    eik_idx=r.eik_idx[list(range(h)) + list(range(B, B + h))],
                    eik_uniform=r.eik_uniform[:h])
        return var, type(draws)(render=r)
    return {"step": step}


def frozen():
    """A training step that leaves the parameters and the optimizer's state
    as they were."""
    def runner(r):
        r.optim_full.step = lambda *a, **k: None
    return {"runner": runner}


def altered_answer():
    """A request whose turntable views are altered where they are made."""
    def runner(r):
        inner = r.vis_rotate

        def vis_rotate(*a, **k):
            var = inner(*a, **k)
            var.rotating_imgs = [x * 0.98 + 0.01 for x in var.rotating_imgs]
            return var
        r.vis_rotate = vis_rotate
    return {"runner": runner}


FAULTS = {"half_batch": half_batch, "frozen": frozen,
          "altered_answer": altered_answer}


def control_numbers(cell, seed, device, precision="fp8"):
    """The control (or with `precision` 'bf16' the witness) against the
    reference on the cell's inputs from `seed`."""
    import numpy as np
    import torch
    from benchmark.harness import check, infer, inputs, train, weights
    from benchmark.reference import model as M
    from benchmark.reference import step as ref_step
    cfg, tr = cell.cfg, cell.traffic
    w, b = weights.make(cfg, seed, device)
    control = M.Precision(**CONTROLS[precision])
    host_w = {k: v.cpu() for k, v in w.items()}
    host_b = {k: v.cpu() for k, v in b.items()}
    if tr["kind"] == "train":
        n = tr["compare_steps"]
        pool = inputs.train_batches(cfg, tr, seed)
        batches = [inputs.to_device(pool[i % len(pool)], device)
                   for i in range(n)]
        draws = inputs.train_draws(cfg, tr, seed, device)[:n]
        with train._no_tf32():
            got = ref_step.train_steps(w, b, cfg, batches, draws, control,
                                       tr["reference_block"])
        judged = dict(loss=got["loss"], terms=got["terms"][0],
                      grad=check.norms(got["grad"]),
                      change=check.norms(got["change"]))
        ref = train.reference(host_w, host_b, cfg, batches, draws, M.FLOAT32,
                              tr["reference_block"], got["grad"])
        judged["grad_diff"] = ref.pop("grad_diff")
        return check.train_numbers(judged, ref)
    from benchmark.reference import mesh
    images = inputs.request_images(cfg, tr, seed)
    rng = np.random.default_rng([int(seed), 5])
    views = sorted(rng.choice(tr["views"], tr["compare_views"], replace=False))
    lo, hi = cfg["eval"]["range"]
    out = []
    for image in images[:tr["compare_requests"]]:
        ref = infer.reference(host_w, host_b, cfg, image, tr["views"], views,
                              device, M.FLOAT32)
        got = infer.reference(host_w, host_b, cfg, image, tr["views"], views,
                              device, control)
        got["triangles"] = mesh.triangles(got["level"], lo, hi)
        out.append(infer.compare(got, ref, lo, hi))
    torch.cuda.empty_cache()
    return check.merge(out)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--control", choices=sorted(CONTROLS), default="fp8")
    p.add_argument("--fault", choices=sorted(FAULTS))
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, REPO)
    from benchmark.harness import main as harness
    from benchmark.harness import spec
    cell = spec.Cell(args.workload)
    with contextlib.redirect_stdout(sys.stderr):
        run(args, cell, harness)


def run(args, cell, harness):

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    def emit(kind, seed, numbers, extra=None):
        sys.__stdout__.write(json.dumps(dict(kind=kind, seed=seed,
                                             numbers=numbers,
                                             **(extra or {}))) + "\n")
        sys.__stdout__.flush()

    for seed in seeds(args.seeds):
        r = harness.run(args.workload, seed, args.seconds, False, args.device,
                        time.time())
        emit("program", seed, dict(r["numbers"], **{
            k: c["value"] for k, c in r["checks"].items()}),
             dict(metrics={k: m["value"] for k, m in r["metrics"].items()}))
    for seed in seeds(args.control_seeds):
        emit("control:" + args.control, seed,
             control_numbers(cell, seed, args.device, args.control))
    for seed in seeds(args.fault_seeds):
        r = harness.run(args.workload, seed, args.seconds, False, args.device,
                        time.time(), hooks=FAULTS[args.fault]())
        emit("fault:" + args.fault, seed, dict(r["numbers"], **{
            k: c["value"] for k, c in r["checks"].items()}))


if __name__ == "__main__":
    sys.exit(main())
