"""The whole training step's share of the card's f32 peak, %: the f32
operations the traced steps need (gsbench/work/step.py) over the time as
many steps take outside the profiler, at 67 TFLOP/s (moves
train_it_per_s)."""
from gsbench.readings import mfu_pct


def read(ctx):
    return mfu_pct(ctx, "train")
