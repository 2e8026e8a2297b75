"""The training forward kernel's share of its roofline, %: the least time
of the traced steps' forwards (operations of the contributing evaluations
and stops counted by the reference's replay, bytes read and written
once, at the f32 peak or the HBM rate) over the kernel's time by name
(moves train_it_per_s)."""
from gsbench.readings import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "train", backward=False)
