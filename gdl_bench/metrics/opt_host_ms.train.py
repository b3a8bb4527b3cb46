"""Host ms a train step inside ``gdl.train.clip`` (model-group average,
accumulation mean, global-norm clip) and ``gdl.train.optimizer`` (LR,
``optimizer.step()``, ``zero_grad``), in the traced stretch, the
profiler's own cost included."""

from gdl_bench import spans

SOURCE = "program_span"
LAYER = "training.loop"
MOVES = "train_patches_per_s"
OPS = ()
SPANS = ("gdl.train.clip", "gdl.train.optimizer")


def read(rec, ctx):
    return spans.host_ms(rec, "train", SPANS)
