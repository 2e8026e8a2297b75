"""Device ms per frame under `render/projection` (moves render_fps)."""
from gsbench.readings import stage_ms


def read(ctx):
    return stage_ms(ctx, "view", "render/projection")
