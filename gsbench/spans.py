"""The port's finer spans in a traced block, and a tool that prints them
for a cell:

    python3 -m gsbench.spans --workload <name> --seed <n> [--seconds S]

The port names the work inside a step and a frame with spans of three
prefixes (`sparse_view_3dgs_pack_tpu_torch/utils/tracing.py`): `grad/`
(a layer's part of the backward), `sync/` (a point where the host waits
for the card) and `host/` (host code between the stages, `host/step`
around all of `Trainer.step` and `host/frame` around all of
`renderer.render`). `read` takes from a traced block, per span name: its
host seconds, the device seconds of the kernels launched inside it (each
kernel to the innermost such span around the runtime call that launched
it, matched by correlation id), its occurrences and the kernel launches
inside it (runtime launch calls, nested spans' included); and the
calls' idle seconds (the gaps whose midpoint lies in one of the
benchmark's call ranges) by the innermost program span, a stage of
`trace.PROGRAM_PREFIXES` or one of these, open at the midpoint
(`_outside_spans_` where none is). These spans leave no
device-side copy in a trace, so they take nothing from `trace.read`'s
readings.

The tool runs a cell's program side as a benchmark run does (set-up,
warm-up, a window whose traced block starts a second in) and prints one
JSON object of the traced block's spans per call, with the waits left
unnamed, the launches and device ms of each stage, and the busy ms. No
benchmark run calls any of this.
"""

from __future__ import annotations

import argparse
import bisect
import json
from typing import NamedTuple

from . import trace

SPAN_PREFIXES = ("grad/", "sync/", "host/")
OUTSIDE = "_outside_spans_"


class Spans(NamedTuple):
    calls: int     # the benchmark's call ranges in the window
    spans: dict    # span name → [host s, device s, occurrences, launches]
    idle: dict     # innermost program span at a call's idle gap → s


def is_launch(name: str) -> bool:
    """A CUDA API call (`cuda*` or `cu*`) that launches a kernel or a
    graph."""
    return name.startswith("cu") and "Launch" in name


class _Innermost:
    """The innermost (latest started) of a set of ranges open at a time;
    of two that start together, the one that ends first."""

    def __init__(self, ranges):
        self.ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
        self.starts = [s for s, _, _ in self.ranges]

    def at(self, t):
        for j in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            if self.ranges[j][1] >= t:
                return self.ranges[j][2]
        return None


def read(events, call: str = trace.OWN_PREFIX + "call") -> Spans | None:
    """The spans of the traced block `events` (`prof.events()`) inside the
    benchmark's window range; None when it holds no window or no device
    event."""
    from torch.autograd import DeviceType
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not trace._is_range(e.name)
           and not e.name.startswith(SPAN_PREFIXES)]
    win = [e for e in cpu if e.name == trace.WINDOW]
    if not dev or not win:
        return None
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    inside = [e for e in cpu if w0 <= e.time_range.start
              and e.time_range.end <= w1]
    calls = sum(e.name == call for e in inside)
    mine = [(e.time_range.start, e.time_range.end, e.name) for e in inside
            if e.name.startswith(SPAN_PREFIXES)]
    launches = sorted(e.time_range.start for e in inside
                      if is_launch(e.name))
    spans: dict = {}
    for s, e, name in mine:
        row = spans.setdefault(name, [0.0, 0.0, 0, 0])
        row[0] += (e - s) / 1e6
        row[2] += 1
        row[3] += (bisect.bisect_right(launches, e)
                   - bisect.bisect_left(launches, s))

    launched = {e.id: e.time_range.start for e in cpu if e.name.startswith(
        "cu")}
    innermost = _Innermost(mine)
    for k in dev:
        t = launched.get(k.id)
        name = innermost.at(t) if t is not None else None
        if name is not None:
            spans[name][1] += (k.time_range.end - k.time_range.start) / 1e6

    busy = sorted((max(e.time_range.start, w0), min(e.time_range.end, w1))
                  for e in dev if e.time_range.end > w0
                  and e.time_range.start < w1)
    gaps, end = [], w0
    for s, e in busy:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if w1 > end:
        gaps.append((end, w1))
    program = _Innermost([
        (e.time_range.start, e.time_range.end, e.name) for e in inside
        if e.name.startswith(trace.PROGRAM_PREFIXES + SPAN_PREFIXES)])
    in_call = _Innermost([(e.time_range.start, e.time_range.end, e.name)
                          for e in inside if e.name == call])
    idle: dict = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        if in_call.at(mid) is None:
            continue     # the caller's own time between calls
        name = program.at(mid) or OUTSIDE
        idle[name] = idle.get(name, 0.0) + (e - s) / 1e6
    return Spans(calls, spans, idle)


def is_sync(name: str) -> bool:
    """A runtime call in which the host waits for the card."""
    return name in trace.SYNC_CALLS or (name.startswith("cudaMemcpy")
                                        and not name.endswith("Async"))


def unnamed_syncs(events) -> dict:
    """The waits for the card inside a call of the program (`host/step`,
    `host/frame`) outside every `sync/` span, by the innermost host event
    around each (the operator that made it): empty where every wait is
    named."""
    from torch.autograd import DeviceType
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    calls = [(e.time_range.start, e.time_range.end) for e in cpu
             if e.name in ("host/step", "host/frame")]
    syncs = [(e.time_range.start, e.time_range.end) for e in cpu
             if e.name.startswith("sync/")]
    around = _Innermost([(e.time_range.start, e.time_range.end, e.name)
                         for e in cpu if not e.name.startswith("cu")])
    out: dict = {}
    for e in cpu:
        t = e.time_range.start
        if (is_sync(e.name) and any(s <= t <= f for s, f in calls)
                and not any(s <= t <= f for s, f in syncs)):
            key = f"{e.name} in {around.at(t)}"
            out[key] = out.get(key, 0) + 1
    return out


def stage_launches(events) -> dict:
    """Kernel launches inside each stage range (`trace.PROGRAM_PREFIXES`),
    nested ones' included, by name."""
    from torch.autograd import DeviceType
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    launches = sorted(e.time_range.start for e in cpu if is_launch(e.name))
    out: dict = {}
    for e in cpu:
        if e.name.startswith(trace.PROGRAM_PREFIXES):
            out[e.name] = out.get(e.name, 0) + (
                bisect.bisect_right(launches, e.time_range.end)
                - bisect.bisect_left(launches, e.time_range.start))
    return out


def per_call(sp: Spans) -> dict:
    """Each span's host ms, device ms, occurrences and launches per call,
    and idle ms per call by span; the syncs and launches of a call."""
    n = sp.calls
    rows = {k: {"host_ms": 1e3 * h / n, "device_ms": 1e3 * d / n,
                "count": c / n, "launches": la / n}
            for k, (h, d, c, la) in sorted(sp.spans.items())}
    outer = [k for k in ("host/step", "host/frame") if k in sp.spans]
    return {
        "calls": n,
        "syncs": sum(c for k, (_, _, c, _) in sp.spans.items()
                     if k.startswith("sync/")) / n,
        "launches": sp.spans[outer[0]][3] / n if outer else None,
        "spans": rows,
        "idle_ms": {k: 1e3 * v / n for k, v in
                    sorted(sp.idle.items(), key=lambda kv: -kv[1])}}


def capture(entry, cell, seed: int, seconds: float, device):
    """Run `entry`'s program side of `cell` with a traced block, as a
    benchmark run does, and return (the block's events, its
    `trace.Trace`)."""
    import time

    from .entries import Patches
    kept = []
    read_trace = trace.read

    def keep(events, call):
        events = list(events)
        kept.append(events)
        return read_trace(events, call)
    with Patches() as patches:
        patches.setattr(trace, "read", keep)
        got = entry.program_side(cell, seed, seconds, True, device,
                                 time.perf_counter())
    tr = got["window"].trace
    return (kept[-1] if kept else []), tr


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="gsbench.spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    a = p.parse_args(argv)
    import importlib

    import torch

    from . import program
    from .cell import load
    cell = load(a.workload)
    program.build_kernels()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    entry = importlib.import_module(f"gsbench.entries.{cell.traffic['entry']}")
    events, tr = capture(entry, cell, a.seed, a.seconds, device)
    sp = read(events)
    out = {"workload": cell.name, "seed": a.seed, **per_call(sp),
           "unnamed_syncs": unnamed_syncs(events),
           "stage_launches": {k: v / tr.calls for k, v in
                              stage_launches(events).items()},
           "stages_device_ms": {k: 1e3 * v[1] / tr.calls
                                for k, v in tr.stages.items()},
           "busy_ms": 1e3 * tr.busy_s / tr.calls}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
