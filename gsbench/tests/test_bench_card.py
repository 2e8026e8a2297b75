"""On the card (`python -m pytest gsbench/tests -m cuda`): each cell's
control, the reference one precision below the configuration's (TF32
for float32 with TF32 off) put in the program's place, comes out not
correct under the cell's limits, while the program comes out correct, at
a tenth of the cell's Gaussians and its own frame, on three seeds. The
readings at the cell's own size are `gsbench.calibrate`'s (PERF.md)."""

from __future__ import annotations

import importlib
import time

import pytest
import torch

from gsbench import calibrate, cell as cell_mod
from gsbench.tests.tiny import WORKLOADS


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct_and_the_program_is(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from gsbench import program
    program.build_kernels()
    c = cell_mod.load(workload)
    c = c._replace(cfg={**c.cfg, "n_gaussians": c.cfg["n_gaussians"] // 10})
    entry = importlib.import_module(f"gsbench.entries.{c.traffic['entry']}")
    dev = torch.device("cuda", 0)
    seconds = 1.5 if c.traffic["entry"] == "view" else 0.0
    for seed in (2 ** 33 + 1, 2 ** 33 + 2, 2 ** 33 + 3):
        got = entry.program_side(c, seed, seconds, False, dev,
                                 time.perf_counter())
        control, ref = calibrate._control(entry, c, seed, dev, got)
        mine = (entry.compare(got, ref) if c.traffic["entry"] == "train"
                else {"frame_gap": ref["frame_gap"]})
        assert all(v <= c.limits[k] for k, v in mine.items()), (seed, mine)
        assert any(v > c.limits[k] for k, v in control.items()), (seed,
                                                                  control)
