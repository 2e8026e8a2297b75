"""The traced run's reading of a `torch.profiler` trace.

The profiler records the host's ranges (the program's `record_function`
ranges `render/…`, `step/…`, and the benchmark's own `gsbench/…` around
each call into the program) and the card's kernels. From them this module
takes, for the traced block of calls: the window (the benchmark's
`gsbench/window` range), each call's host time and the part of it spent
waiting for the card in a synchronising runtime call, the card's busy
time (the union of its kernels and copies in the window), each kernel's
time by name, each program range's host and device time (a kernel counts
under the innermost range around the host call that launched it, matched
by correlation id; copied from `chip_smoke.py::_stages`), and the idle
gaps by what the host was doing. A trace that comes back with no device
event (CUPTI now and then drops the whole buffer) is taken again by the
caller.
"""

from __future__ import annotations

import bisect
from typing import NamedTuple

PROGRAM_PREFIXES = ("render/", "step/", "dp/")
# the CUDA runtime calls in which the host waits for the card
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
OWN_PREFIX = "gsbench/"
WINDOW = OWN_PREFIX + "window"


class Trace(NamedTuple):
    window_s: float          # the traced block's length
    busy_s: float            # seconds with a kernel or copy running
    calls: int               # benchmark ranges named `call` in the window
    call_host_s: list        # their host durations
    call_wait_s: list        # of each, the host's time in SYNC_CALLS
    kernels: dict            # kernel name → device seconds
    stages: dict             # range name → [host s, device s]
    stage_kernels: dict      # range name → {kernel name: device s}
    idle_gaps: dict          # what the host was doing → idle seconds


def _is_range(name: str) -> bool:
    return name.startswith(PROGRAM_PREFIXES) or name.startswith(OWN_PREFIX)


def read(events, call: str) -> Trace | None:
    """The summary of one traced block (`events`: `prof.events()`), whose
    calls are the benchmark's ranges named `call`; None when the trace
    holds no device event or no window."""
    from torch.autograd import DeviceType
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not _is_range(e.name)]
    win = [e for e in cpu if e.name == WINDOW]
    if not dev or not win:
        return None
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    calls = [e for e in cpu if e.name == call and w0 <= e.time_range.start
             and e.time_range.end <= w1]
    waits = [e.time_range for e in cpu if e.name in SYNC_CALLS]

    spans = sorted((max(e.time_range.start, w0), min(e.time_range.end, w1))
                   for e in dev if e.time_range.end > w0
                   and e.time_range.start < w1)
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)

    kernels: dict = {}
    for e in dev:
        kernels[e.name] = kernels.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e6

    ranges = [(e.time_range.start, e.time_range.end, e.name) for e in cpu
              if e.name.startswith(PROGRAM_PREFIXES)]
    runtime = {e.id: e.time_range.start for e in cpu
               if e.name.startswith("cu")}
    stages = {name: [0.0, 0.0] for _, _, name in ranges}
    stages["other"] = [0.0, 0.0]
    stage_kernels: dict = {name: {} for name in stages}
    for s, e, name in ranges:
        stages[name][0] += (e - s) / 1e6
    for k in dev:
        t = runtime.get(k.id)
        inner = max(((s, name) for s, e, name in ranges
                     if t is not None and s <= t <= e), default=None)
        name = inner[1] if inner else "other"
        d = (k.time_range.end - k.time_range.start) / 1e6
        stages[name][1] += d
        stage_kernels[name][k.name] = stage_kernels[name].get(k.name, 0.0) + d

    return Trace(window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6,
                 calls=len(calls),
                 call_host_s=[(e.time_range.end - e.time_range.start) / 1e6
                              for e in calls],
                 call_wait_s=[sum(r.end - r.start for r in waits
                                  if e.time_range.start <= r.start
                                  and r.end <= e.time_range.end) / 1e6
                              for e in calls],
                 kernels=kernels, stages=stages, stage_kernels=stage_kernels,
                 idle_gaps=_idle_gaps(cpu, merged, w0, w1))


def _idle_gaps(cpu, merged, w0, w1, reach: int = 256) -> dict:
    """Idle seconds of the window by the innermost host event (latest
    start) under way at each gap's midpoint, the benchmark's own ranges
    left out; "_no_host_event_" where none is."""
    evs = sorted((e.time_range.start, e.time_range.end, e.name) for e in cpu
                 if not e.name.startswith(OWN_PREFIX))
    starts = [s for s, _, _ in evs]
    edges = [w0] + [x for s, e in merged for x in (s, e)] + [w1]
    out: dict = {}
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid) - 1
        name = "_no_host_event_"
        for j in range(i, max(i - reach, -1), -1):
            if evs[j][1] >= mid:
                name = evs[j][2]
                break
        out[name] = out.get(name, 0.0) + (e - s) / 1e6
    return out


def short(name: str, width: int = 96) -> str:
    """A kernel's name without its argument list (its last parenthesis
    outside template brackets), cut to `width`."""
    name = name.removeprefix("void ")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i:
            cut = i
    return name[:cut][:width]


def top(d: dict, n: int = 10) -> list:
    """The `n` largest entries of name → seconds, as [short name,
    seconds]."""
    return [[short(k), v]
            for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
