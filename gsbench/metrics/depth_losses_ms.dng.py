"""Device ms per DNGaussian iteration under `step/depth_losses`: the hard
and soft passes' local and global patch-normalised margin MSE and the
edge-aware smoothness, forward (moves train_it_per_s)."""
from gsbench.readings import stage_ms


def read(ctx):
    return stage_ms(ctx, "dng", "step/depth_losses")
