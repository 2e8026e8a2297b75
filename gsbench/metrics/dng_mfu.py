"""The whole DNGaussian iteration's share of the card's f32 peak, %: the
f32 operations the traced iterations need (gsbench/work/dng.py: the three
projections and blends, forward and backward, per contributing
evaluation from the reference's replay of each pass's render; the field
three times each way; the depth losses, L1 and SSIM; Adam over every
value in each of its calls) over the time as many iterations take outside
the profiler, at 67 TFLOP/s (moves train_it_per_s)."""
from gsbench.work import dng
from gsbench.work.peaks import PEAK_F32_OPS


def read(ctx):
    work, passes, call_s = ctx.get("work"), ctx.get("passes"), \
        ctx.get("call_s")
    if ctx.get("kind") != "dng" or not work or not passes or not call_s:
        return None
    k = len(passes)
    iters = [work[i:i + k] for i in range(0, len(work), k)]
    f = ctx["field"]
    ops = sum(dng.iteration_ops(ctx["P"], ctx["n_values"],
                                dng.field_values(f), ctx["width"],
                                ctx["height"], f, w, passes)
              for w in iters)
    return 100.0 * ops / (len(iters) * call_s * PEAK_F32_OPS)
