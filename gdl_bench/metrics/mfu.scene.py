"""Whole scene forward: the model operations of every tile forward of
every scene of the unprofiled window over its seconds and the bf16 peak."""

from gdl_bench import readers

SOURCE = "host_clock"
LAYER = "inference.sliding_window"
MOVES = "scene_mpx_per_s"
OPS = ()


def read(rec, ctx):
    return readers.mfu(rec, ctx) if rec["kind"] == "scene" else None
