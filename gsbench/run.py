"""One run of one cell: load, warm up, measure, check, print one line.

    python3 -m gsbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic mix, limits
and metrics are found by the names in `BENCHMARK.json`
(`gsbench/cell.py`); the mix's `"entry"` names the module of
`gsbench/entries/` that drives the program. With `--trace 0` the line's
metrics are the cell's end-to-end metrics; with `--trace 1`, its
per-layer metrics, each read by `gsbench/metrics/<name>.py` from the
traced block of the window (a reader that finds nothing returns None and
its metric is left out).

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` also
`breakdown`, and last `checks`, each compared number beside its limit;
the same numbers are the last lines of standard error. The run exits
non-zero, with no result, when the card or the port is missing, or when
`jax`, `jaxlib`, `flax` or the JAX package is loaded once the window has
closed.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "sparse_view_3dgs_pack_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: the port's name begins with the JAX
    package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def _fail(msg: str, code: int = 2):
    print(f"gsbench: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(code)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or "not read"


def _reader(name: str):
    from .cell import HERE
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "gsbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer(cell, ctx: dict) -> dict:
    """Each per-layer metric of the cell that its reader finds, by name."""
    out = {}
    for m in cell.per_layer:
        value = _reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def breakdown(tr) -> dict:
    from .trace import top
    return {"device_ops": top(tr.kernels), "idle_gaps": top(tr.idle_gaps)}


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t0: float, faults=()) -> dict:
    """The result of one run of `cell` on `device` (the line's fields, and
    `checks` with each compared number beside its limit)."""
    entry = importlib.import_module(f"gsbench.entries.{cell.traffic['entry']}")
    out = entry.run(cell, seed, seconds, trace, device, t0, faults)
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in out.checks.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    if trace:
        metrics = per_layer(cell, out.trace)
    else:
        metrics = {m["name"]: {"value": out.end_to_end[m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": _kind(device), "count": cell.chips,
           "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": dev}
    if trace:
        tr = out.trace["trace"]
        if tr is None:
            _fail("the traced block recorded no device activity in 3 tries",
                  4)
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = breakdown(tr)
        print("traced calls: pairs " + ", ".join(
            str(p) for _, p, _ in out.trace["work"]) + "; contributing "
            "evaluations " + ", ".join(str(w.contrib) for w, _, _ in
                                       out.trace["work"]), file=sys.stderr)
    result["checks"] = checks
    print("set-up: " + ", ".join(f"{k} by {v:.3f} s" for k, v in out.setup),
          file=sys.stderr)
    return result


def _kind(device) -> str:
    import torch
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def main(argv=None, t0: float | None = None) -> None:
    t0 = time.perf_counter() if t0 is None else t0
    p = argparse.ArgumentParser(prog="gsbench", description=__doc__.split(
        "\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    from .cell import load
    cell = load(a.workload)
    import torch
    marks = [("torch imported", time.perf_counter() - t0)]
    if not torch.cuda.is_available():
        _fail("no CUDA card (torch.cuda.is_available() is False)")
    if torch.cuda.device_count() < cell.chips:
        _fail(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present")
    try:
        from . import program
        program.build_kernels()
    except ImportError as e:
        _fail(f"the port is not in this checkout ({e})")
    marks.append(("kernels built", time.perf_counter() - t0))
    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.reset_peak_memory_stats(device)
    torch.zeros(1, device=device)
    marks.append(("card ready", time.perf_counter() - t0))
    print("start-up: " + ", ".join(f"{k} by {v:.3f} s" for k, v in marks),
          file=sys.stderr)
    result = run_cell(cell, a.seed, a.seconds, bool(a.trace), device, t0)

    found = forbidden_modules()
    if found:
        _fail("modules of JAX or the JAX package are loaded: "
              + ", ".join(found), 3)
    print(f"card: {_power_limit()}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
