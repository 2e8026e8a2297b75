"""The traced run's reading (`gsbench/trace.py`) and the per-layer readers
on a hand-made trace: busy time, stages by correlation id, idle gaps by
what the host was doing, and readers that find nothing return None."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from gsbench import run, trace
from gsbench.reference.render import Work
from gsbench.tests.tiny import tiny


def _ev(name, start, end, cuda=False, id=0):
    return SimpleNamespace(
        name=name, id=id, time_range=SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if cuda else DeviceType.CPU)


EVENTS = [
    _ev("gsbench/window", 0, 1000), _ev("gsbench/call", 0, 450),
    _ev("gsbench/call", 500, 950), _ev("render/projection", 10, 100),
    _ev("cudaLaunchKernel", 20, 25, id=1), _ev("aten::mul", 200, 300),
    _ev("cudaLaunchKernel", 510, 515, id=2),
    _ev("step/backward", 600, 940),
    _ev("cudaStreamSynchronize", 900, 940),   # the host waits for the card
    _ev("void k_proj<float>(float*)", 30, 80, cuda=True, id=1),
    _ev("void (anonymous namespace)::raster_fwd_kernel<3, true>(int)", 520,
        700, cuda=True, id=2),
    _ev("render/projection", 30, 80, cuda=True, id=9),   # a range's echo
]


def test_read_hand_made_trace():
    tr = trace.read(EVENTS, "gsbench/call")
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx(230e-6)
    assert tr.calls == 2 and tr.call_host_s == pytest.approx([450e-6,
                                                              450e-6])
    assert tr.call_wait_s == pytest.approx([0.0, 40e-6])
    assert tr.stages["render/projection"] == pytest.approx([90e-6, 50e-6])
    assert tr.stages["other"][1] == pytest.approx(180e-6)
    assert tr.stages["step/backward"][1] == 0
    assert tr.idle_gaps == pytest.approx({"render/projection": 30e-6,
                                          "aten::mul": 440e-6,
                                          "step/backward": 300e-6})
    top = trace.top(tr.kernels)
    assert top[0] == ["(anonymous namespace)::raster_fwd_kernel<3, true>",
                      pytest.approx(180e-6)]


def test_read_without_device_events_is_none():
    assert trace.read([e for e in EVENTS if e.device_type ==
                       DeviceType.CPU], "gsbench/call") is None


def test_readers_on_the_hand_made_trace():
    cell = tiny("lgdwt_m360_garden.refine")
    tr = trace.read(EVENTS, "gsbench/call")
    ctx = {"kind": "train", "trace": tr, "work": [(Work(1000, 50), 400, 12),
                                                  (Work(1100, 50), 420, 12)],
           "P": 3000, "n_values": 3000 * 59, "width": 64, "height": 48,
           "dwt": True, "C": 3, "call_s": 500e-6}
    got = run.per_layer(cell, ctx)
    assert got["projection_ms.train"]["value"] == pytest.approx(0.025)
    # dispatch: the calls' host time less the wait in the synchronise
    assert got["host_ms_per_it.train"]["value"] == pytest.approx(0.43)
    # busy 115 us a call against 500 us a call outside the profiler
    assert got["device_idle.train"]["value"] == pytest.approx(77.0)
    assert 0 < got["raster_fwd_roofline.train"]["value"] < 100
    assert 0 < got["train_mfu"]["value"]
    # without untraced calls to time, idle and MFU find nothing to read
    bare = run.per_layer(cell, {**ctx, "call_s": None})
    assert "device_idle.train" not in bare and "train_mfu" not in bare
    # no K3 in this trace: its roofline finds nothing and is left out
    assert "raster_bwd_roofline.train" not in got
    # a viewer context reads nothing of the training metrics
    assert run.per_layer(cell, {**ctx, "kind": "view"}) == {}
