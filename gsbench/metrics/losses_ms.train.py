"""Device ms per training step under `step/losses`: L1, SSIM and, for
LGDWT-GS, the DWT subbands and the ELF-patch DWT (moves train_it_per_s)."""
from gsbench.readings import stage_ms


def read(ctx):
    return stage_ms(ctx, "train", "step/losses")
