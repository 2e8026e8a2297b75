"""Device ms per DNGaussian iteration under `step/field`: the neural
field's forward evaluations, three an iteration (the hash encode, both
MLPs and the opacity product; moves train_it_per_s)."""
from gsbench.readings import stage_ms


def read(ctx):
    return stage_ms(ctx, "dng", "step/field")
