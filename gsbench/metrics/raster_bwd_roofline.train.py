"""The rasterizer backward's share of its roofline, %: K3 and the segment
sum together, least time over their kernels' time by name (moves
train_it_per_s)."""
from gsbench.readings import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "train", backward=True)
