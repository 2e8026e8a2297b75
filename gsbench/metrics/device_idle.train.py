"""Share of a training step's wall time in which no kernel or copy runs on
the card, %: the card's busy time per traced step over the time a step
takes outside the profiler, so the profiler's own host work does not
count (moves train_it_per_s)."""
from gsbench.readings import idle_pct


def read(ctx):
    return idle_pct(ctx, "train")
