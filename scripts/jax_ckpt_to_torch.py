"""Convert a JAX checkpoint to the PyTorch port's checkpoint format.

Runs where JAX is installed: reads a `.ckpt` (msgpack, the JAX package's
format) and writes the port's `.pt` through `shapeclipper_torch.bridge`:

    python scripts/jax_ckpt_to_torch.py RUN_DIR/latest.ckpt RUN_DIR/latest.pt

The graph's children are converted as far as the checkpoint holds them (a
pretraining checkpoint keeps sdf_network, latent_proj_shape and maybe
estimator), and so are the optax Adam states (`optim_full` and `optim_V` of
a training run, `optim` of a pretraining run): moments, step counts and the
parameter order of the port's optimizers, whose Graph is built from
RUN_DIR/options.yaml. `python -m shapeclipper_torch.train ... --resume`
then continues the run from RUN_DIR/latest.pt (or evaluates best.pt), and
`--load=RUN_DIR/latest.pt` starts a training run from a pretraining one.
"""

import math
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))

OPTIMIZERS = ("optim_full", "optim_V", "optim")


def optimizer_params(graph):
    """The port's parameter list, as (state_dict name, parameter), of each
    optimizer a checkpoint may hold, in the optimizer's order."""
    from shapeclipper_torch.train.pretrainer import pretrain_trainable
    named = list(graph.named_parameters())
    return dict(optim_full=named,
                optim_V=[(n, p) for n, p in named
                         if n.startswith("estimator.")],
                optim=[(n, p) for n, p in named if pretrain_trainable(n)])


def convert(src, dst):
    from shapeclipper_tpu.utils.checkpoint import load_raw
    from shapeclipper_torch.bridge import (adam_state_from_optax,
                                           state_dict_from_flax)
    from shapeclipper_torch.utils.checkpoint import write_checkpoint

    ckpt = load_raw(src)
    graph = ckpt["graph"]
    state = state_dict_from_flax(graph["params"], graph["batch_stats"])
    optim_states = {}
    names = [n for n in OPTIMIZERS if n in ckpt]
    if names:
        from shapeclipper_torch.config.options import load_options
        from shapeclipper_torch.models.graph import Graph
        from shapeclipper_torch.train.pretrainer import make_optimizer
        opt = load_options(os.path.join(os.path.dirname(src), "options.yaml"))
        params = optimizer_params(Graph(opt))
        for name in names:
            named = params[name]
            optim_states[name] = adam_state_from_optax(
                ckpt[name], [n for n, _ in named],
                make_optimizer(opt, [p for _, p in named]))
    best_val = ckpt.get("best_val")
    write_checkpoint(dst, state, ep=ckpt.get("epoch", 0),
                     it=ckpt.get("iter", 0),
                     best_val=math.inf if best_val is None else best_val,
                     optim_states=optim_states)
    print(f"wrote {len(state)} tensors and the optimizer states "
          f"{names} -> {dst}")


if __name__ == "__main__":
    convert(sys.argv[1], sys.argv[2])
