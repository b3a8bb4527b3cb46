"""Share of the profiled stretch of scenes in which no kernel, copy or
fill ran on the device (the union of their intervals)."""

from gdl_bench import readers

SOURCE = "device_trace"
LAYER = "device"
MOVES = "scene_mpx_per_s"
OPS = ()


def read(rec, ctx):
    return readers.idle_pct(rec) if rec["kind"] == "scene" else None
