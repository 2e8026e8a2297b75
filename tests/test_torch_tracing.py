"""The port's spans (`utils/tracing.py`) on a tiny LGDWT-GS scene on the CPU:
which spans a training step and an inference frame record and how they
nest, and that without a profiler the spans add no autograd node, create
no RecordFunction and change no number."""

from __future__ import annotations

import contextlib
from argparse import Namespace
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sparse_view_3dgs_pack_tpu_torch import renderer, testing
from sparse_view_3dgs_pack_tpu_torch.config import METHOD_OPTS
from sparse_view_3dgs_pack_tpu_torch.models import gaussians as gm
from sparse_view_3dgs_pack_tpu_torch.train import step
from sparse_view_3dgs_pack_tpu_torch.train.loop import Trainer
from sparse_view_3dgs_pack_tpu_torch.utils import tracing

SIZE = 32


def _trainer(seed: int = 3, n: int = 120) -> Trainer:
    """An lgdwt `Trainer` of `n` Gaussians (SH 1, varied shapes and
    opacities) and 3 orbit views of random targets, on the CPU."""
    rng = np.random.default_rng(seed)
    model = gm.create_from_pcd(rng.uniform(-0.8, 0.8, (n, 3)),
                               rng.random((n, 3)), n_images=3, sh_degree=1,
                               device="cpu")
    with torch.no_grad():
        model.features_rest.copy_(torch.as_tensor(
            rng.normal(size=(n, 3, 3)) * 0.2))
        model.opacity.copy_(torch.as_tensor(rng.uniform(-2.0, 1.0, (n, 1))))
        model.scaling.copy_(torch.as_tensor(
            np.log(rng.uniform(0.03, 0.12, (n, 3)))))
    cams = testing.make_orbit_cameras(3, radius=3.0, width=SIZE)
    for c in cams:
        c.image = rng.random((SIZE, SIZE, 3)).astype(np.float32)
        c.alpha_mask = np.ones((SIZE, SIZE), np.float32)
    scene = SimpleNamespace(gaussians=model, cameras_extent=1.0,
                            getTrainCameras=lambda: cams)
    opt = Namespace(**{**METHOD_OPTS["lgdwt"], "patch_size": 16,
                       "densify_until_iter": 0})
    pipe = Namespace(debug=False, debug_from=-1, antialiasing=False)
    args = Namespace(sh_degree=1, white_background=False,
                     train_test_exp=False, source_path="", model_path="")
    tr = Trainer(scene, opt, pipe, args)
    tr.active_sh_degree = 1
    return tr


def _spans(prof) -> list:
    """(name, start, end) of every span of the port in the profile, in
    order of start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.name.startswith(tracing.PREFIXES)),
                  key=lambda s: s[1])


def _inside(spans, inner: str, outer: str) -> bool:
    """Every `inner` span lies within some `outer` span."""
    outs = [(s, e) for n, s, e in spans if n == outer]
    return all(any(s0 <= s and e <= e0 for s0, e0 in outs)
               for n, s, e in spans if n == inner)


def _names(spans) -> list:
    return [n for n, _, _ in spans]


def test_training_step_records_its_spans_nested():
    """One `Trainer.step` under a profiler: the backward's three layer
    spans in the order the backward reaches them, inside `step/backward`;
    each host sync inside the stage that makes it; the host spans around
    the rest."""
    tr = _trainer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.step()
    spans = _spans(prof)
    names = _names(spans)
    for n in ("host/step", "host/prepare", "host/params", "host/finish",
              "grad/losses", "grad/raster",
              "grad/projection", "sync/binning_count", "sync/binning_tiles",
              "sync/ssim_window", "sync/stats_scale"):
        assert names.count(n) == 1, (n, names)
    assert names.count("sync/adam_bias") == 2          # Adam, exposure Adam
    assert "sync/camera" not in names                  # the bank's tensors
    assert "sync/background" not in names              # a fixed background
    grads = [n for n in names if n.startswith("grad/")]
    assert grads == ["grad/losses", "grad/raster", "grad/projection"]
    for inner, outer in (
            ("grad/losses", "step/backward"), ("grad/raster", "step/backward"),
            ("grad/projection", "step/backward"),
            ("sync/binning_count", "render/binning"),
            ("sync/binning_tiles", "render/binning"),
            ("sync/ssim_window", "step/losses"),
            ("sync/adam_bias", "step/adam"), ("sync/stats_scale", "step/stats"),
            ("host/prepare", "host/step"), ("host/params", "host/step"),
            ("step/backward", "host/step"), ("host/finish", "host/step")):
        assert _inside(spans, inner, outer), (inner, outer)
    # each layer's backward does its work inside its span
    events = prof.events()
    for name, s, e in spans:
        if name.startswith("grad/"):
            assert any(ev.name.startswith("aten::") and s <= ev.time_range.start
                       and ev.time_range.end <= e for ev in events), name


def test_random_background_is_a_sync():
    tr = _trainer()
    tr.opt.random_background = True
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.step()
    assert _names(_spans(prof)).count("sync/background") == 1


def test_inference_frame_records_its_spans():
    """A frame from a camera of host arrays copies it to the device
    (`sync/camera`) and counts its pairs (`sync/binning_count`), all
    inside `host/frame`; an inference frame spans no backward."""
    tr = _trainer()
    cam = tr.scene.getTrainCameras()[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        renderer.render(tr.model, cam, np.zeros(3, np.float32))
    spans = _spans(prof)
    names = _names(spans)
    assert names[0] == "host/frame"
    for n in ("sync/camera", "sync/background", "sync/binning_count",
              "sync/binning_tiles", "render/projection", "render/binning",
              "render/rasterize"):
        assert names.count(n) == 1, (n, names)
        assert _inside(spans, n, "host/frame"), n
    assert _inside(spans, "sync/camera", "render/projection")
    assert not any(n.startswith("grad/") for n in names)


def _graph_nodes(loss: torch.Tensor) -> list:
    seen, todo = set(), [loss.grad_fn]
    while todo:
        f = todo.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        todo.extend(g for g, _ in f.next_functions)
    return [type(f).__name__ for f in seen]


def _view_loss(tr: Trainer) -> torch.Tensor:
    b = tr.bank
    p = tr.model.params()
    loss, _, _, _ = step.view_losses(
        p, tr.model.exposure[0], b.camera(0), b.gt[0], b.alpha_mask[0],
        b.invdepth[0], b.depth_mask[0], b.has_depth[0], tr.background, 0.0,
        tr.dwt_running_mean, tr.cfg, tr.cfg.sh_degree)
    return loss


def test_without_a_profiler_no_node_and_no_record(monkeypatch):
    """With no profiler the loss's autograd graph holds no span node (with
    one it holds the two of each of grad/losses and grad/projection, and
    nothing else more), and a step and a frame create no
    RecordFunction."""
    tr = _trainer()
    plain = _graph_nodes(_view_loss(tr))
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _graph_nodes(_view_loss(tr))
    spans = sorted(n for n in traced if n in ("_OpenBackward",
                                              "_CloseBackward"))
    assert spans == ["_CloseBackward"] * 2 + ["_OpenBackward"] * 2
    assert not any(n in ("_OpenBackward", "_CloseBackward") for n in plain)
    assert len(traced) == len(plain) + 4

    made = []
    real = torch._C._profiler._RecordFunctionFast

    def counted(*a, **k):
        made.append(a)
        return real(*a, **k)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counted)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counted)
    tr.step()
    renderer.render(tr.model, tr.scene.getTrainCameras()[1], tr.background)
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):
        tr.step()
    assert made    # the count above would have seen them


@pytest.mark.parametrize("sparse_adam", [False, True])
def test_spans_change_no_number(sparse_adam):
    """The loss, every gradient, the view-space gradient and every
    parameter and moment after a step are bitwise equal with the profiler
    on and off."""
    outs = []
    for traced in (False, True):
        tr = _trainer()
        cfg = tr.cfg._replace(sparse_adam=sparse_adam)
        with profile(activities=[ProfilerActivity.CPU]) if traced \
                else contextlib.nullcontext():
            sg = step.loss_and_grads(tr.model, tr.bank, 1, 0.0, 1,
                                     tr.background, tr.dwt_running_mean,
                                     cfg)
            step.train_step(tr.model, tr.adam, tr.exp_adam,
                            tr.dwt_running_mean, tr.bank, 2,
                            {k: 1e-3 for k in tr.model.params()}, 1e-3, 0.0,
                            1, tr.background, cfg)
        outs.append((sg, tr.model.params(), tr.adam))
    (g0, p0, a0), (g1, p1, a1) = outs
    assert torch.equal(g0.loss, g1.loss)
    assert torch.equal(g0.viewspace_grad, g1.viewspace_grad)
    assert torch.equal(g0.exposure_grad, g1.exposure_grad)
    for k in g0.grads:
        assert float(g0.grads[k].abs().max()) > 0, k
        assert torch.equal(g0.grads[k], g1.grads[k]), k
        assert torch.equal(p0[k], p1[k]), k
        assert torch.equal(a0.m[k], a1.m[k]) and torch.equal(a0.v[k],
                                                             a1.v[k]), k
