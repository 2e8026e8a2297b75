"""The harness is driven by data: a configuration, a traffic mix, a cell's
limits and a per-layer metric added as new files in a copy of the
benchmark are found by name and run with no edit; every per-layer metric
of `BENCHMARK.json` has its reader."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import gsbench
from gsbench import run
from gsbench.cell import ROOT, load

REPO = os.path.dirname(os.path.dirname(gsbench.__file__))

_SCRIPT = r"""
import json, sys, time, torch
torch.set_num_threads(2)
from gsbench import cell, run
c = cell.load("tiny_cfg.tiny_mix")
assert run.__file__.startswith(sys.argv[1]), run.__file__
res = run.run_cell(c, 99, 0.3, False, torch.device("cpu"), time.perf_counter())
ctx = {"kind": "train", "trace": None, "work": [], "P": 1}
print(json.dumps({"result": res, "layer": run.per_layer(c, ctx)}))
"""


def test_new_files_are_found_and_run(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(os.path.join(REPO, "gsbench"), root / "gsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "gsbench" / "configs" /
                      "lgdwt_m360_garden.json").read_text())
    cfg.update(name="tiny_cfg", n_gaussians=2000, width=48, height=32,
               n_train_views=5, focal_px=40.0)
    cfg["opt"]["patch_size"] = 16
    (root / "gsbench" / "configs" / "tiny_cfg.json").write_text(
        json.dumps(cfg))
    (root / "gsbench" / "traffic" / "tiny_mix.json").write_text(json.dumps(
        {"entry": "train", "checked_steps": 2, "warm_steps": 1,
         "traced_steps": 2}))
    (root / "gsbench" / "limits" / "tiny_cfg.tiny_mix.json").write_text(
        json.dumps({"loss_gap": 1e-3, "grad_gap": 1e-3, "delta_gap": 1e-3}))
    (root / "gsbench" / "metrics" / "gaussians_held.tiny.py").write_text(
        '"""A new reader."""\n\ndef read(ctx):\n    return ctx["P"]\n')
    bench["configs"].append({"name": "tiny_cfg", "source": "a test",
                             "file": "gsbench/configs/tiny_cfg.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny_cfg.tiny_mix",
                               "config": "tiny_cfg", "traffic": "tiny_mix",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_it_per_s":
            m["workloads"].append("tiny_cfg.tiny_mix")
    bench["per_layer"].append({"name": "gaussians_held.tiny", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "host loop",
                               "moves": "train_it_per_s",
                               "workloads": ["tiny_cfg.tiny_mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{REPO}")
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(root)],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["result"]["correct"] is True
    assert set(out["result"]["metrics"]) == {"train_it_per_s", "setup_s"}
    assert out["layer"] == {"gaussians_held.tiny": {"value": 1, "unit": "1"}}


def test_every_metric_and_cell_has_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert callable(run._reader(m["name"])), m["name"]
    for w in bench["workloads"]:
        c = load(w["name"])
        assert c.per_layer and c.end_to_end and c.limits
        for m in c.per_layer:
            assert m["moves"] in {e["name"] for e in c.end_to_end}
