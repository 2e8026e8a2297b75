"""The whole frame's share of the card's f32 peak, %: the projection of every
Gaussian and the blend the traced frames need, over the time as many
frames take outside the profiler, at 67 TFLOP/s (moves render_fps)."""
from gsbench.readings import mfu_pct


def read(ctx):
    return mfu_pct(ctx, "view")
