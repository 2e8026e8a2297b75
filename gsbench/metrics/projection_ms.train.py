"""Device ms per training step under the port's `render/projection` range:
the projection and SH colours of every Gaussian (moves train_it_per_s)."""
from gsbench.readings import stage_ms


def read(ctx):
    return stage_ms(ctx, "train", "render/projection")
