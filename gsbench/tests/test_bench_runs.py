"""Each cell's whole run at a tiny size on the CPU, through the port's plain
path: the result line's keys, `correct` on the sound program, and
`correct` false with each fault that the cell can have planted in its
timed path (the look for a card is skipped: `run_cell` is what `main`
calls once it has found one)."""

from __future__ import annotations

import json
import time

import pytest
import torch

from gsbench import run
from gsbench.tests.tiny import WORKLOADS, tiny

CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345       # larger than 32 signed bits hold
FAULTS = {"lgdwt_m360_garden.refine": ("state_unchanged", "half_batch"),
          "3dgs_m360_bicycle.refine": ("state_unchanged", "half_batch"),
          "lgdwt_m360_garden.view1080": ("answer_altered",)}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_correct_with_its_line(workload):
    cell = tiny(workload)
    res = run.run_cell(cell, SEED, 1.0, False, CPU, time.perf_counter())
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    names = {m["name"] for m in cell.end_to_end}
    assert set(res["metrics"]) == names and "setup_s" in names
    for m in cell.end_to_end:
        v = res["metrics"][m["name"]]
        assert v["unit"] == m["unit"] and v["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(res["checks"]) == set(cell.limits)
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]
    json.loads(json.dumps(res))


@pytest.mark.parametrize("workload,fault", [(w, f) for w in WORKLOADS
                                            for f in FAULTS[w]])
def test_fault_in_the_timed_path_is_not_correct(workload, fault):
    res = run.run_cell(tiny(workload), SEED, 1.0, False, CPU,
                       time.perf_counter(), faults=(fault,))
    assert res["correct"] is False, res["checks"]


def test_same_seed_same_inputs_and_readings():
    a = run.run_cell(tiny(WORKLOADS[0]), 7, 0.2, False, CPU,
                     time.perf_counter())
    b = run.run_cell(tiny(WORKLOADS[0]), 7, 0.2, False, CPU,
                     time.perf_counter())
    assert a["checks"] == b["checks"]
