"""Device ms per DNGaussian iteration under `step/backward` (the three
passes' backwards), less the rasterizer's backward kernels in it (K3 and
the segment sum): the gradients of the field, the projection and the
losses (moves train_it_per_s)."""
from gsbench.readings import BWD_KERNELS, per_call_ms


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "dng" or tr is None \
            or "step/backward" not in tr.stages:
        return None
    raster = sum(s for k, s in tr.stage_kernels["step/backward"].items()
                 if any(n in k for n in BWD_KERNELS))
    return per_call_ms(ctx, tr.stages["step/backward"][1] - raster)
