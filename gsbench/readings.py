"""What the per-layer readers (`gsbench/metrics/<name>.py`) share.

A reader takes the traced run's context: `kind` ("train" or "view"),
`trace` (`trace.Trace` of the traced block), `call_s` (the host clock's
seconds per call outside the traced block, free of the profiler's own
host work), `work` (per traced call the reference's replay of its view:
(`Work`, pairs, tiles)), `P` Gaussians, `width`, `height`, `C` channels,
and for training `dwt` and `n_values` (parameter values). It returns a number, or None where it finds nothing
to read: a share of a roofline or of a peak is never given as 0.
"""

from __future__ import annotations

from .work import raster, step
from .work.peaks import PEAK_F32_OPS

FWD_KERNEL = "raster_fwd_kernel"
BWD_KERNELS = ("raster_bwd_kernel", "segment_sum_kernel")


def per_call_ms(ctx: dict, seconds: float):
    n = ctx["trace"].calls if ctx.get("trace") else 0
    return 1e3 * seconds / n if n else None


def stage_ms(ctx: dict, kind: str, stage: str):
    """Device ms per call under one of the program's ranges."""
    tr = ctx.get("trace")
    if ctx.get("kind") != kind or tr is None or stage not in tr.stages:
        return None
    return per_call_ms(ctx, tr.stages[stage][1])


def kernel_s(ctx: dict, names) -> float:
    names = (names,) if isinstance(names, str) else names
    return sum(s for k, s in ctx["trace"].kernels.items()
               if any(n in k for n in names))


def idle_pct(ctx: dict, kind: str):
    """100 × the share of a call's wall time outside the profiler in which
    the card is not busy, its busy time per call taken from the trace."""
    tr, call_s = ctx.get("trace"), ctx.get("call_s")
    if ctx.get("kind") != kind or tr is None or not tr.calls or not call_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.calls / call_s)


def roofline_pct(ctx: dict, kind: str, backward: bool):
    """100 × the least time of the traced calls' forward (or K3 and the
    segment sum) over the kernels' time by name in the trace."""
    tr, work = ctx.get("trace"), ctx.get("work")
    if ctx.get("kind") != kind or tr is None or not work:
        return None
    spent = kernel_s(ctx, BWD_KERNELS if backward else FWD_KERNEL)
    if spent <= 0:
        return None
    P, C, W, H = ctx["P"], ctx["C"], ctx["width"], ctx["height"]
    least = 0.0
    for w, n_pairs, tiles in work:
        if backward:
            least += (raster.bwd_bound(P, C, n_pairs, tiles, W, H,
                                       w.contrib)[0]
                      + raster.segsum_bound(P, C + 8, n_pairs)[0])
        else:
            least += raster.fwd_bound(P, C, n_pairs, tiles, W, H, w.contrib,
                                      w.stops, training=kind == "train")[0]
    return 100.0 * least / spent


def mfu_pct(ctx: dict, kind: str):
    """100 × the f32 operations the traced calls need over the seconds that
    as many calls take outside the profiler, at the f32 peak."""
    work, call_s = ctx.get("work"), ctx.get("call_s")
    if ctx.get("kind") != kind or not work or not call_s:
        return None
    if kind == "train":
        ops = sum(step.train_step_ops(ctx["P"], ctx["n_values"], ctx["width"],
                                      ctx["height"], ctx["dwt"], w.contrib,
                                      w.stops, n_pairs, ctx["C"])
                  for w, n_pairs, _ in work)
    else:
        ops = sum(step.frame_ops(ctx["P"], w.contrib, w.stops, ctx["C"])
                  for w, _, _ in work)
    return 100.0 * ops / (len(work) * call_s * PEAK_F32_OPS)
