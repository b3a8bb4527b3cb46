"""The blocks' attention in training (K4 forward, K7 backward): the least
time of its work at the copied counts (``counts/kernels.py``, from the
heads and ``[B, L, 3D]``) over the device time of every kernel launched
under the attention operators, forward and backward."""

from gdl_bench import readers

SOURCE = "device_trace"
LAYER = "ops.cuda"
MOVES = "train_patches_per_s"
OPS = (r"^gdl::attention_fwd_packed$", r"^gdl::attention_bwd_packed$",
       r"^gdl::attention_fwd_hm$", r"^gdl::attention_bwd_hm$")


def read(rec, ctx):
    return readers.roofline(rec, ctx, OPS, True) if rec["kind"] == "train" else None
