"""Host ms a scene inside ``gdl.scene.blend`` (``inference/sliding_window.py``:
the per-tile canvas and weight adds of every tile batch), in the traced
stretch, the profiler's own cost included."""

from gdl_bench import spans

SOURCE = "program_span"
LAYER = "inference.sliding_window"
MOVES = "scene_mpx_per_s"
OPS = ()
SPANS = ("gdl.scene.blend",)


def read(rec, ctx):
    return spans.host_ms(rec, "scene", SPANS)
