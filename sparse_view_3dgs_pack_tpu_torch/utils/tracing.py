"""Named spans of the port's work, for `torch.profiler`.

Every range the port opens goes through this module. `span(name)` is a
range on the host; `grad_span(name)` brackets one layer's share of the
backward, which the autograd engine runs on its own thread where no host
range of the caller reaches. Names, by prefix:

  render/ step/ dp/ nir/ dng/   the stages of a render and of a step;
                                 DNGaussian's passes dng/hard, dng/soft,
                                 dng/photo hold step/field (each forward
                                 evaluation of the neural field),
                                 step/depth_losses, step/losses,
                                 step/backward, step/adam and step/stats
  grad/                          a layer's part of the backward: grad/losses,
                                 grad/raster, grad/projection, grad/field
  sync/                          a point inside a step or a frame where the
                                 host waits for the card: sync/binning_count,
                                 sync/binning_tiles, sync/stats_scale,
                                 sync/ssim_window, sync/camera,
                                 sync/background; sync/grid_levels and
                                 sync/adam_bias only in the plain hash
                                 grid and the plain Adam (off the card's
                                 path)
  host/                          host code: host/step around all of
                                 a trainer's step (`Trainer`,
                                 `FSGSTrainer`, `NIRTrainer`,
                                 `DNGTrainer`), and host/frame around all of
                                 `renderer.render`, so that no moment of
                                 them lies outside a span; inside the first
                                 and the last host/prepare, host/params,
                                 host/finish

Spans exist only while a profiler records. With none, `span` returns a
shared null context and `grad_span` a pass-through: no RecordFunction is
created, no autograd node is added, and outputs and gradients are bitwise
those of the code without spans; the cost is one flag test.

A span is a RecordFunction of function scope (what the profiler records
for an operator), not `record_function`'s user scope: the profiler gives a
user-scope range a device-side copy spanning the kernels launched inside
it, which a reader of device events would have to tell apart from work.
These leave none, so every device event in a trace is a kernel or a copy,
and each span lines up, on the profiler's clock, with the kernels its host
calls launched.
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _profiler

# the stages' ranges, and the finer spans inside them
STAGE_PREFIXES = ("render/", "step/", "dp/", "nir/", "dng/")
SPAN_PREFIXES = ("grad/", "sync/", "host/")
PREFIXES = STAGE_PREFIXES + SPAN_PREFIXES

_NULL = contextlib.nullcontext()


def recording() -> bool:
    """Whether a profiler records now."""
    return _profiler._is_profiler_enabled


def _range(name: str):
    return torch._C._profiler._RecordFunctionFast(name)


def span(name: str, on: bool = True):
    """A range named `name` while a profiler records and `on` holds (a
    site that waits for the card only in some calls passes whether this
    one does); a null context otherwise."""
    return _range(name) if on and recording() else _NULL


class _Open(torch.autograd.Function):
    """Identity on a layer's outputs; its backward, which runs once every
    output's gradient is complete, opens the layer's range."""

    @staticmethod
    def forward(ctx, holder, *xs):
        ctx.holder = holder
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        ctx.holder.open()
        return (None, *gs)


class _Close(torch.autograd.Function):
    """Identity on a layer's inputs; its backward, which runs once the
    layer has given every input its gradient, closes the range."""

    @staticmethod
    def forward(ctx, holder, *xs):
        ctx.holder = holder
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        ctx.holder.close()
        return (None, *gs)


class _GradSpan:
    """One layer's range in the backward. `inputs(*ts)` goes on the
    tensors the layer reads and `outputs(*ts)` on those it returns, in the
    forward; each returns the tensors (or None) as one tuple, wrapped
    where they require a gradient. A range opened and never closed (a
    backward that stops short of the inputs) ends when its record is
    freed."""

    def __init__(self, name: str):
        self.name, self.rf = name, None

    def open(self) -> None:
        self.rf = _range(self.name)
        self.rf.__enter__()

    def close(self) -> None:
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None

    def _wrap(self, fn, ts):
        idx = [i for i, t in enumerate(ts)
               if t is not None and t.requires_grad]
        if not idx:
            return tuple(ts)
        out = list(ts)
        for i, t in zip(idx, fn.apply(self, *(ts[i] for i in idx))):
            out[i] = t
        return tuple(out)

    def inputs(self, *ts):
        return self._wrap(_Close, ts)

    def outputs(self, *ts):
        return self._wrap(_Open, ts)


class _NoGradSpan:
    @staticmethod
    def inputs(*ts):
        return ts

    outputs = inputs


_NO_GRAD_SPAN = _NoGradSpan()


def grad_span(name: str):
    """The range of one layer's backward, named `name`, while a profiler
    records and autograd is on; a pass-through otherwise."""
    if recording() and torch.is_grad_enabled():
        return _GradSpan(name)
    return _NO_GRAD_SPAN
