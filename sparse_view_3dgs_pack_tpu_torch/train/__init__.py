"""Training of the 3DGS / LGDWT-GS family: step, optimizer, densification,
host loop, recipes, checkpoints, the debug snapshot; `python -m
sparse_view_3dgs_pack_tpu_torch.train` is the CLI (`train/__main__.py`)."""
