"""Device ms per training step under `step/backward`, less the rasterizer's
backward kernels in it (K3 and the segment sum, which
`raster_bwd_roofline.train` reads): the gradients of the losses and of the
projection (moves train_it_per_s)."""
from gsbench.readings import BWD_KERNELS, per_call_ms


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "train" or tr is None \
            or "step/backward" not in tr.stages:
        return None
    raster = sum(s for k, s in tr.stage_kernels["step/backward"].items()
                 if any(n in k for n in BWD_KERNELS))
    return per_call_ms(ctx, tr.stages["step/backward"][1] - raster)
