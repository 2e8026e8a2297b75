"""Share of a DNGaussian iteration's wall time in which no kernel or copy
runs on the card, %: as device_idle.train, per iteration (moves
train_it_per_s)."""
from gsbench.readings import idle_pct


def read(ctx):
    return idle_pct(ctx, "dng")
