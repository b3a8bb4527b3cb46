"""Device ms a scene of the kernels launched under ``gdl.scene.blend``:
the per-tile canvas and weight adds."""

from gdl_bench import spans

SOURCE = "program_span"
LAYER = "inference.sliding_window"
MOVES = "scene_mpx_per_s"
OPS = (r"^gdl\.scene\.blend$",)


def read(rec, ctx):
    return spans.device_ms(rec, "scene", OPS)
