"""The port's finer spans as `gsbench/spans.py` reads them: on the hand-made
trace of `test_bench_trace.py` with spans added, that they change nothing
`trace.read` gives its readers and that `spans.read` gives each span's
times, occurrences, launches and idle time; on the card (`-m cuda`), that
a traced step and frame name every wait for the card with a `sync/` span
and leave next to no idle time outside every span."""

from __future__ import annotations

import importlib

import pytest
import torch

from gsbench import run, spans, trace
from gsbench import cell as cell_mod
from gsbench.reference.render import Work
from gsbench.tests.test_bench_trace import EVENTS, _ev
from gsbench.tests.tiny import WORKLOADS, tiny

# as the port records them: host ranges, with no device-side copy
SPANS = [
    _ev("host/step", 5, 440), _ev("host/step", 505, 945),
    _ev("host/prepare", 505, 518),            # launches the forward (id 2)
    _ev("grad/projection", 610, 890),         # inside step/backward
    _ev("sync/binning_count", 895, 941),      # around the synchronise
]


def test_spans_change_no_reading():
    """Every field of `trace.read` but `idle_gaps` is the same with the
    spans; `idle_gaps` names a span where it named the stage around it,
    with the same seconds; every reader reads the same."""
    old = trace.read(EVENTS, "gsbench/call")
    new = trace.read(EVENTS + SPANS, "gsbench/call")
    assert new._replace(idle_gaps={}) == old._replace(idle_gaps={})
    assert sum(new.idle_gaps.values()) == pytest.approx(
        sum(old.idle_gaps.values()))
    assert new.idle_gaps == pytest.approx({"render/projection": 30e-6,
                                           "aten::mul": 440e-6,
                                           "grad/projection": 300e-6})
    cell = tiny("lgdwt_m360_garden.refine")
    ctx = {"kind": "train", "work": [(Work(1000, 50), 400, 12),
                                     (Work(1100, 50), 420, 12)],
           "P": 3000, "n_values": 3000 * 59, "width": 64, "height": 48,
           "dwt": True, "C": 3, "call_s": 500e-6}
    assert run.per_layer(cell, {**ctx, "trace": new}) == run.per_layer(
        cell, {**ctx, "trace": old})


def test_read_spans_of_the_hand_made_trace():
    sp = spans.read(EVENTS + SPANS)
    assert sp.calls == 2
    assert sp.spans["host/step"] == pytest.approx([875e-6, 50e-6, 2, 2])
    assert sp.spans["host/prepare"] == pytest.approx([13e-6, 180e-6, 1, 1])
    assert sp.spans["grad/projection"] == pytest.approx([280e-6, 0, 1, 0])
    assert sp.spans["sync/binning_count"] == pytest.approx([46e-6, 0, 1, 0])
    # the idle gaps by the innermost program span, stage or span
    assert sp.idle == pytest.approx({"render/projection": 30e-6,
                                     "host/step": 440e-6,
                                     "grad/projection": 300e-6})
    # a gap outside every call is the caller's, and not counted
    short = [_ev("gsbench/call", 500, 800) if (e.name, e.time_range.start)
             == ("gsbench/call", 500) else e for e in EVENTS + SPANS]
    assert spans.read(short).idle == pytest.approx(
        {"render/projection": 30e-6, "host/step": 440e-6})
    got = spans.per_call(sp)
    assert got["syncs"] == 0.5 and got["launches"] == 1.0
    # no window, or no device event: nothing to read
    assert spans.read([e for e in EVENTS if e.name != trace.WINDOW]) is None
    assert spans.read([e for e in EVENTS
                       if e.device_type.name == "CPU"]) is None


def test_idle_outside_every_span_and_unnamed_syncs():
    bare = [e for e in EVENTS if not e.name.startswith("render/")]
    assert spans.read(bare).idle == pytest.approx(
        {spans.OUTSIDE: 470e-6, "step/backward": 300e-6})
    # the synchronise inside host/step is named only with its span
    assert spans.unnamed_syncs(EVENTS + SPANS) == {}
    assert spans.unnamed_syncs(EVENTS + SPANS[:-1]) == {
        "cudaStreamSynchronize in step/backward": 1}
    assert spans.stage_launches(EVENTS + SPANS) == {"render/projection": 1,
                                                    "step/backward": 0}
    assert spans.is_launch("cudaLaunchKernel")
    assert spans.is_launch("cudaGraphLaunch")
    assert not spans.is_launch("cudaMemcpyAsync")
    assert spans.is_sync("cudaMemcpy") and spans.is_sync("cudaMemcpy2D")
    assert not spans.is_sync("cudaMemcpyAsync")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_traced_call_names_every_sync(workload):
    """A traced block of the cell at a tenth of its Gaussians on the card:
    every wait for the card inside `Trainer.step` or `renderer.render` lies
    in a `sync/` span; each `sync/binning_count` span ends after every
    kernel launched before it has ended (spans and kernels on one clock);
    no program span has a device-side copy. In a training cell at most 5%
    of the calls' idle time lies outside every span; a viewer call ends
    in the benchmark's own synchronize, whose wake-up and bookkeeping
    hold idle time that no span of the port can (9% of it at the cell's
    size), so there the rest of the checks stand alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from torch.autograd import DeviceType

    from gsbench import program
    program.build_kernels()
    c = cell_mod.load(workload)
    c = c._replace(cfg={**c.cfg, "n_gaussians": c.cfg["n_gaussians"] // 10})
    entry = importlib.import_module(f"gsbench.entries.{c.traffic['entry']}")
    events, _ = spans.capture(entry, c, 2 ** 33 + 5, 2.5,
                              torch.device("cuda", 0))
    sp = spans.read(events)
    assert sp is not None and sp.calls > 0
    assert spans.unnamed_syncs(events) == {}
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    assert not any(e.name.startswith(trace.PROGRAM_PREFIXES
                                     + spans.SPAN_PREFIXES) for e in dev)
    # the benchmark's own ranges have device-side copies: not kernels
    dev = [e for e in dev if not trace._is_range(e.name)]
    launched = {e.id: e.time_range.start for e in cpu
                if spans.is_launch(e.name)}
    counts = [e for e in cpu if e.name == "sync/binning_count"]
    assert counts
    for s in counts:
        t = s.time_range.start
        before = [k.time_range.end for k in dev
                  if launched.get(k.id, t) < t]
        assert before and max(before) <= s.time_range.end
    if c.traffic["entry"] == "train":
        assert sp.idle.get(spans.OUTSIDE, 0.0) <= 0.05 * sum(
            sp.idle.values())
