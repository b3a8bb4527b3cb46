"""Host ms from the call of ``to_device`` of a batch to the return of the
train step, with no synchronise, over every step of the unprofiled
window."""

from gdl_bench import readers

SOURCE = "host_clock"
LAYER = "training.loop"
MOVES = "train_patches_per_s"
OPS = ()


def read(rec, ctx):
    return readers.enqueue_ms(rec) if rec["kind"] == "train" else None
