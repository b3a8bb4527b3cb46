"""How far the device runs behind the host: for each step of the traced
stretch, the ms from the host's return from ``gdl.train.step`` to the end
of the last kernel launched inside it (0 where the device finished
first), the median over the steps. Near 0: the host paces the step; tens
of ms: a full launch queue."""

from gdl_bench import spans

SOURCE = "program_span"
LAYER = "training.loop"
MOVES = "train_patches_per_s"
OPS = ()


def read(rec, ctx):
    return spans.lead_ms(rec)
