"""The blocks' attention forward (K4) in scene serving: the least time of
its work at the copied counts over the device time of every kernel
launched under the attention operators."""

from gdl_bench import readers

SOURCE = "device_trace"
LAYER = "ops.cuda"
MOVES = "scene_mpx_per_s"
OPS = (r"^gdl::attention_fwd_packed$", r"^gdl::attention_fwd_hm$")


def read(rec, ctx):
    return readers.roofline(rec, ctx, OPS, False) if rec["kind"] == "scene" else None
