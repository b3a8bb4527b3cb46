"""Device-idle ms a train step in the gaps that began while the innermost
``gdl.`` span open on the main thread was ``gdl.train.clip`` or
``gdl.train.optimizer``."""

from gdl_bench import spans

SOURCE = "program_span"
LAYER = "training.loop"
MOVES = "train_patches_per_s"
OPS = ()
SPANS = ("gdl.train.clip", "gdl.train.optimizer")


def read(rec, ctx):
    return spans.idle_ms(rec, "train", SPANS)
