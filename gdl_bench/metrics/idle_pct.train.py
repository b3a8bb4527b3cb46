"""Share of the profiled stretch of train steps in which no kernel, copy
or fill ran on the device (the union of their intervals)."""

from gdl_bench import readers

SOURCE = "device_trace"
LAYER = "device"
MOVES = "train_patches_per_s"
OPS = ()


def read(rec, ctx):
    return readers.idle_pct(rec) if rec["kind"] == "train" else None
