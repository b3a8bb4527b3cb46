"""Host ms a train step inside ``gdl.train.backward``: the main thread in
``loss.backward()`` while the autograd engine's thread issues the
backward, in the traced stretch, the profiler's own cost included."""

from gdl_bench import spans

SOURCE = "program_span"
LAYER = "training.loop"
MOVES = "train_patches_per_s"
OPS = ()
SPANS = ("gdl.train.backward",)


def read(rec, ctx):
    return spans.host_ms(rec, "train", SPANS)
