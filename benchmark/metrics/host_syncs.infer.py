"""host_syncs.infer: host synchronisations a request, counted as the
program's `sc.sync.*` ranges (shapeclipper_torch/utils/trace.py: one range
a device-to-host copy or blocking read) inside the traced window: the
turntable's rgb, mask and normal copies (3 a view), the intrinsics'
inverse of each render (its error flags read on the host) and 3 host
constants copied to the card. Moves infer_ms."""

from benchmark.harness.program_spans import range_count


def read(t):
    return range_count(t, "sc.sync.")
