"""Share of a frame's wall time in which no kernel or copy runs on the
card, %: as device_idle.train, per frame (moves render_fps)."""
from gsbench.readings import idle_pct


def read(ctx):
    return idle_pct(ctx, "view")
