"""The inference forward kernel's share of its roofline, % (as
raster_fwd_roofline.train, 32x16 tiles; moves render_fps)."""
from gsbench.readings import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "view", backward=False)
