"""Device-idle ms a scene in the gaps that began while the innermost
``gdl.`` span open on the main thread was ``gdl.scene.forward``: the
model's own launches of a tile batch."""

from gdl_bench import spans

SOURCE = "program_span"
LAYER = "inference.sliding_window"
MOVES = "scene_mpx_per_s"
OPS = ()
SPANS = ("gdl.scene.forward",)


def read(rec, ctx):
    return spans.idle_ms(rec, "scene", SPANS)
