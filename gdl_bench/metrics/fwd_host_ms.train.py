"""Host ms a train step inside ``gdl.train.forward`` (``training/steps.py``:
K1, augmentation, the forward and the loss being issued), on the main
thread of the traced stretch, the profiler's own cost included."""

from gdl_bench import spans

SOURCE = "program_span"
LAYER = "training.loop"
MOVES = "train_patches_per_s"
OPS = ()
SPANS = ("gdl.train.forward",)


def read(rec, ctx):
    return spans.host_ms(rec, "train", SPANS)
