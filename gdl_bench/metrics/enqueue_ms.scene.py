"""Host ms to issue one scene, from its H2D copy to the D2H copy of its
map being issued, over every scene of the unprofiled window."""

from gdl_bench import readers

SOURCE = "host_clock"
LAYER = "inference.sliding_window"
MOVES = "scene_mpx_per_s"
OPS = ()


def read(rec, ctx):
    return readers.enqueue_ms(rec) if rec["kind"] == "scene" else None
