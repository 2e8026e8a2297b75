"""Device ms per training step under `step/adam`: Adam over every
parameter and the exposure Adam (moves train_it_per_s)."""
from gsbench.readings import stage_ms


def read(ctx):
    return stage_ms(ctx, "train", "step/adam")
