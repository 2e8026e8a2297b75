"""Probe entry points: the program's own way to bisect a rasterizer fault on
the card, down to the primitive that is wrong.

  python -m sparse_view_3dgs_pack_tpu_torch.probes.prims [--device cuda]
      P1-P4 (`ops/probes.py`) on the inputs of `scripts/tpu_prims.py`
  python -m sparse_view_3dgs_pack_tpu_torch.probes.fwd_bisect \\
      [--width --height --points --device]
      D1, D2 and the forward kernel against plain versions on the scene of
      `scripts/tpu_dbg.py`

Both exit non-zero when a probe fails. `--device cpu` runs the plain
PyTorch versions (a check of the probes' own logic, no kernel runs).
"""
