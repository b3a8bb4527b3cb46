"""Device ms a train step of the kernels outside the copied families
(``counts/peaks.py``: the port's kernels, convolutions, GEMMs): the
elementwise, copy, norm and reduction kernels of ``models``."""

from gdl_bench.counts import peaks

SOURCE = "device_trace"
LAYER = "models"
MOVES = "train_patches_per_s"
OPS = ()


def read(rec, ctx):
    tr = rec["trace"]
    if rec["kind"] != "train" or tr is None or not tr.device:
        return None
    us = sum(b - a for a, b, name, cat, _ in tr.clipped()
             if cat == "kernel" and peaks.family(name) == "other")
    return us / 1e3 / rec["stretch_steps"]
