"""A cell as the benchmark's data describe it: its entry in
`BENCHMARK.json`, its configuration file, its traffic mix
(`gsbench/traffic/<traffic>.json`) and its limits
(`gsbench/limits/<workload>.json`). The harness finds each file by the
name in `BENCHMARK.json`, so a later change adds a cell, a configuration,
a mix or a metric as new files and edits none."""

from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    chips: int
    cfg: dict        # the configuration as it is run
    traffic: dict    # the mix's parameters; "entry" names its entry
    limits: dict     # compared number → limit
    end_to_end: list   # BENCHMARK.json's metric entries that this cell reports
    per_layer: list


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(workload: str, root: Path = ROOT) -> Cell:
    bench = _load(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"has {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    # an end-to-end metric without `workloads` is every cell's (setup_s);
    # a per-layer metric always names its cells
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    per_layer = [m for m in bench["per_layer"] if workload in m["workloads"]]
    return Cell(workload, w["chips"], _load(root / conf["file"]),
                _load(root / "gsbench" / "traffic" / f"{w['traffic']}.json"),
                _load(root / "gsbench" / "limits" / f"{workload}.json"),
                e2e, per_layer)
