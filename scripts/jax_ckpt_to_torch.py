"""Convert a JAX checkpoint to the PyTorch port's checkpoint format.

Runs where JAX is installed: reads `best.ckpt` / `latest.ckpt` (msgpack, the
JAX package's format) and writes the port's `best.pt` through
`shapeclipper_torch.bridge`:

    python scripts/jax_ckpt_to_torch.py RUN_DIR/best.ckpt RUN_DIR/best.pt

`python -m shapeclipper_torch.infer ... --resume` then restores RUN_DIR/best.pt.
"""

import math
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))


def convert(src, dst):
    from shapeclipper_tpu.utils.checkpoint import load_raw
    from shapeclipper_torch.bridge import state_dict_from_flax
    from shapeclipper_torch.utils.checkpoint import write_checkpoint

    ckpt = load_raw(src)
    graph = ckpt["graph"]
    state = state_dict_from_flax(graph["params"], graph["batch_stats"])
    best_val = ckpt.get("best_val")
    write_checkpoint(dst, state, ep=ckpt.get("epoch", 0),
                     it=ckpt.get("iter", 0),
                     best_val=math.inf if best_val is None else best_val)
    print(f"wrote {len(state)} tensors -> {dst}")


if __name__ == "__main__":
    convert(sys.argv[1], sys.argv[2])
