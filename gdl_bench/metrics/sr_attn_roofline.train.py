"""The MiT's spatial-reduction attention in training (K10's forward and
its registered backward, the kernel ``gdl::sr_attention_bwd``, counted as
five bf16 products whatever runs them): the least time of its forward and
backward work from its shapes (``counts/kernels.py``) over the device
time of every kernel launched under ``gdl::sr_attention_fwd`` and under
the autograd node of its backward."""

from gdl_bench import readers

SOURCE = "device_trace"
LAYER = "ops.cuda"
MOVES = "train_patches_per_s"
OPS = (r"^gdl::sr_attention_fwd$", r"^GeneratedBackwardFor_gdl_sr_attention_fwd_\w*Backward$")


def read(rec, ctx):
    return readers.roofline(rec, ctx, OPS, True) if rec["kind"] == "train" else None
