"""The neural field's share of its roofline, %: the least time of the
traced iterations' forward evaluations of the field (three an iteration
with the soft pass; the table's corner bytes at the HBM rate or the f32
operations at the f32 peak, gsbench/work/dng.py) over the device time
under `step/field` (moves train_it_per_s)."""
from gsbench.work.dng import field_bound


def read(ctx):
    tr, passes = ctx.get("trace"), ctx.get("passes")
    if ctx.get("kind") != "dng" or tr is None or not tr.calls or not passes \
            or "step/field" not in tr.stages:
        return None
    spent = tr.stages["step/field"][1]
    if spent <= 0:
        return None
    evals = tr.calls * (("soft" in passes) + 2 * ("photo" in passes))
    return 100.0 * evals * field_bound(ctx["P"], ctx["field"])[0] / spent
