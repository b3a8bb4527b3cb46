"""Whole train step: the configuration's model operations of every step
of the unprofiled window (``counts/<family>.py``, forward and backward,
counted once) over the window's seconds and the H100's bf16 peak."""

from gdl_bench import readers

SOURCE = "host_clock"
LAYER = "training.loop"
MOVES = "train_patches_per_s"
OPS = ()


def read(rec, ctx):
    return readers.mfu(rec, ctx) if rec["kind"] == "train" else None
