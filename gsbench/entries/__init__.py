"""The general code that a traffic mix drives: one module per entry point of
the program, named by a mix's `"entry"`. Each has `run(cell, seed,
seconds, trace, device, t0, faults=())` that sets the cell up, measures
its window, checks what the window produced against the reference, and
returns an `Outcome`. `faults` plants the named faults in the timed path
(the tests' and `gsbench.calibrate`'s use; a benchmark run plants none).
"""

from __future__ import annotations

import statistics
import time
from typing import NamedTuple, Optional

import torch


class Outcome(NamedTuple):
    end_to_end: dict          # metric → value (host clock)
    attempted: int            # calls made in the window
    failed: int               # of those, not completed
    checks: dict              # compared number → its value
    memory_peak_bytes: int
    trace: Optional[dict]     # what the per-layer readers read (--trace 1)
    setup: list = []          # (step of the set-up, seconds since t0)


def counted(ref_grad: dict) -> set:
    """The leaves that count: those whose reference gradient at the first
    step is at least a thousandth of the median leaf's. A leaf under that
    is nought to rounding, and Adam would move it by round-off alone."""
    med = statistics.median(ref_grad.values())
    return {k for k, g in ref_grad.items() if g >= 1e-3 * med}


def gaps(prog: dict, ref: dict, leaves: set) -> float:
    """The worst counted leaf's gap between two norms: |‖p‖ − ‖r‖| over the
    larger of the reference's norm of that leaf and of the median leaf."""
    med = statistics.median(ref[k] for k in leaves)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves)


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(t.double())) for k, t in
            tensors.items()}


def sync() -> None:
    """Wait for the card, where one is in use (the tests run on the CPU)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Patches:
    """Attributes set for a block and put back after it (the faults that
    the tests and `gsbench.calibrate` plant in the timed path)."""

    def __init__(self):
        self._undo = []

    def setattr(self, obj, name: str, value) -> None:
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for obj, name, value in reversed(self._undo):
            setattr(obj, name, value)
        self._undo.clear()


class Window(NamedTuple):
    calls: int               # calls completed in the window
    seconds: float           # the window, ended by a synchronize
    call_s: list             # each call's seconds (when synchronised)
    trace: object            # trace.Trace of the traced block, or None
    traced: range            # the calls of the traced block
    traced_n: int            # calls under the profiler, every try counted
    traced_s: float          # seconds of the profiler's blocks and reading

    @property
    def untraced_call_s(self):
        """Seconds per call of the window's calls outside the profiler,
        free of its host overhead; None where there are none."""
        n = self.calls - self.traced_n
        return (self.seconds - self.traced_s) / n if n > 0 else None


def measure(call, seconds: float, trace: bool, traced_calls: int,
            sync_each: bool) -> Window:
    """Call `call(i)` for i = 0, 1, … until `seconds` have passed, then
    synchronise. With `sync_each`, each call is synchronised and timed
    from the host's request to its result on the card (a closed loop).
    With `trace`, a block of `traced_calls` calls from the first second on
    runs under the profiler (taken again, up to 3 times, if it recorded no
    device event), and the calls outside it are timed apart."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from .. import trace as tr_mod
    times, n, tr, traced, tries = [], 0, None, range(0), 0
    traced_s = 0.0
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        if (trace and tr is None and tries < 3
                and time.perf_counter() - start >= 1.0):
            tries += 1
            sync()   # the untraced calls' work is theirs
            t_traced = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with record_function(tr_mod.WINDOW):
                    for i in range(n, n + traced_calls):
                        t = time.perf_counter()
                        with record_function(tr_mod.OWN_PREFIX + "call"):
                            call(i)
                            if sync_each:
                                sync()
                        if sync_each:
                            times.append(time.perf_counter() - t)
                    sync()
            tr = tr_mod.read(prof.events(), tr_mod.OWN_PREFIX + "call")
            traced = range(n, n + traced_calls)
            n += traced_calls
            traced_s += time.perf_counter() - t_traced
            continue
        t = time.perf_counter()
        call(n)
        if sync_each:
            sync()
            times.append(time.perf_counter() - t)
        n += 1
    sync()
    return Window(n, time.perf_counter() - start, times, tr, traced,
                  traced_calls * tries, traced_s)
