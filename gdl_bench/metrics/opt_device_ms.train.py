"""Device ms a train step of the kernels launched under ``gdl.train.clip``
or ``gdl.train.optimizer``: the clip's norm and scale and Adam's update."""

from gdl_bench import spans

SOURCE = "program_span"
LAYER = "training.loop"
MOVES = "train_patches_per_s"
OPS = (r"^gdl\.train\.clip$", r"^gdl\.train\.optimizer$")


def read(rec, ctx):
    return spans.device_ms(rec, "train", OPS)
