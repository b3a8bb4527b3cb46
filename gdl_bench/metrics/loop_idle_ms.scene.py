"""Device-idle ms a scene in the gaps that began while the innermost
``gdl.`` span open on the main thread was ``gdl.scene.plan``,
``gdl.scene.gather``, ``gdl.scene.blend`` or ``gdl.scene.tiles`` itself
(between its children, and the final division): the host's own loop."""

from gdl_bench import spans

SOURCE = "program_span"
LAYER = "inference.sliding_window"
MOVES = "scene_mpx_per_s"
OPS = ()
SPANS = ("gdl.scene.plan", "gdl.scene.gather", "gdl.scene.blend", "gdl.scene.tiles")


def read(rec, ctx):
    return spans.idle_ms(rec, "scene", SPANS)
