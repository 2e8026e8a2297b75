"""Device ms per frame under `render/binning`: the pair expansion, the
sort and the tile ranges (moves render_fps)."""
from gsbench.readings import stage_ms


def read(ctx):
    return stage_ms(ctx, "view", "render/binning")
