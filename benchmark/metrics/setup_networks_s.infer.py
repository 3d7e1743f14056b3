"""setup_networks_s.infer: host seconds of the program's
`timed("setup.networks")` (train/trainer.py::Runner.build_networks: the
Graph's weights drawn on the host, the move to the card) in this process.
Moves setup_s."""

from benchmark.harness.program_spans import setup_seconds


def read(t):
    return setup_seconds("setup.networks")
