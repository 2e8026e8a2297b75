"""`train/nir_loop.py::NIRTrainer`: its `step()` is one iteration of the
mult-dwtgs loop that `train_nir` ran inline before the trainer existed,
and the train CLI's loop runs through it.

The loop it replaced is kept below as `_inline_loop`, a frozen copy of that
loop's body (its own `StepConfig` from the options, the SH schedule, the
seeded view draw, `nir_step`, the 3DGS densify and opacity-reset
schedule). Both run on the CPU from the same 32-px LLFF-style scene with
its NIR band, through densify events (one with the screen-size limit) and
an opacity reset; every parameter (the NIR albedo and gain too), moment,
Adam step, densification statistic and the DWT running mean must agree
bit for bit."""

from __future__ import annotations

import random
from argparse import ArgumentParser, Namespace

import numpy as np
import pytest
import torch

from sparse_view_3dgs_pack_tpu_torch import testing
from sparse_view_3dgs_pack_tpu_torch.config import (OptimizationParams,
                                                    PipelineParams)
from sparse_view_3dgs_pack_tpu_torch.models import gaussians as gm
from sparse_view_3dgs_pack_tpu_torch.scene import Scene
from sparse_view_3dgs_pack_tpu_torch.train import nir_loop
from sparse_view_3dgs_pack_tpu_torch.train.densify import (densify_and_prune,
                                                           reset_opacity)
from sparse_view_3dgs_pack_tpu_torch.train.optim import (init_adam,
                                                         make_lr_schedules)
from sparse_view_3dgs_pack_tpu_torch.train.step import CameraBank, StepConfig
import torch_port  # noqa: F401  (one intra-op thread)

ITERS = 12
SEED = 5
FLAGS = ["--iterations", str(ITERS), "--patch_size", "16",
         "--densify_from_iter", "2", "--densification_interval", "3",
         "--densify_until_iter", "11", "--opacity_reset_interval", "6",
         "--densify_grad_threshold", "0.00001"]


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return testing.write_llff_colmap_scene(
        str(tmp_path_factory.mktemp("nir_trainer") / "scene"), size=32,
        n_gauss=200, n_dense=150, n_sparse=40, nir=True)


def _inputs(scene_dir, out):
    parser = ArgumentParser()
    op, pp = OptimizationParams(parser, "mult-dwtgs"), PipelineParams(parser)
    args = parser.parse_args(FLAGS)
    dataset = Namespace(source_path=scene_dir, model_path=str(out),
                        sh_degree=1, images="images", depths="", eval=True,
                        train_test_exp=False, n_views=3,
                        point_cloud_type="dense", resolution=-1,
                        white_background=False, data_device="cpu")
    pipe = pp.extract(args)
    pipe.debug_from = -1
    return dataset, op.extract(args), pipe


def _scene(dataset):
    """The Scene with the NIR band; the camera shuffle seeded."""
    random.seed(0)
    return Scene(dataset, sh_degree=dataset.sh_degree, device="cpu",
                 use_nir=True)


def _inline_loop(scene, dataset, opt, iterations, seed, nir_weight):
    """The loop body `train_nir` ran before `NIRTrainer`, frozen, without
    its loss line and saves. Returns its state."""
    device = torch.device("cpu")
    cams = scene.getTrainCameras()
    W, H = cams[0].width, cams[0].height
    bank = CameraBank.from_cameras(cams, 3, device)
    model = scene.gaussians
    adam = init_adam(model.params())
    lr_scheds = make_lr_schedules(opt, scene.cameras_extent)
    bg = torch.tensor([0.0, 0.0, 0.0], device=device)
    base = StepConfig(
        width=W, height=H, sh_degree=dataset.sh_degree,
        lambda_dssim=opt.lambda_dssim,
        dwt_enable=getattr(opt, "dwt_enable", True),
        dwt_weights=(opt.dwt_ll1_weight, opt.dwt_lh1_weight,
                     opt.dwt_hl1_weight, opt.dwt_hh1_weight,
                     opt.dwt_ll2_weight, opt.dwt_lh2_weight,
                     opt.dwt_hl2_weight, opt.dwt_hh2_weight),
        patch_dwt_enable=getattr(opt, "patch_dwt_enable", True),
        patch_dwt_weight=opt.patch_dwt_weight, patch_size=opt.patch_size,
        patch_percentile=opt.patch_percentile,
        patch_dwt_lh1_weight=opt.patch_dwt_lh1_weight,
        patch_dwt_hl1_weight=opt.patch_dwt_hl1_weight)
    cfg = nir_loop.NIRConfig(base=base, nir_weight=nir_weight)
    rng = random.Random(seed)
    running = torch.ones((), device=device)
    active_sh = 0
    viewpoint_stack = []
    events = dict(densify=0, limited=0, resets=0)
    for it in range(1, iterations + 1):
        if it % 1000 == 0 and active_sh < dataset.sh_degree:
            active_sh += 1
        if not viewpoint_stack:
            viewpoint_stack = list(range(len(cams)))
        cam_idx = viewpoint_stack.pop(rng.randint(0,
                                                  len(viewpoint_stack) - 1))
        lrs = {k: f(it) for k, f in lr_scheds.items()}
        _, running = nir_loop.nir_step(model, adam, running, bank, cam_idx,
                                       lrs, active_sh, bg, cfg)
        if it < opt.densify_until_iter:
            if (it > opt.densify_from_iter
                    and it % opt.densification_interval == 0):
                limited = it > opt.opacity_reset_interval
                densify_and_prune(
                    model, adam, opt.densify_grad_threshold, 0.005,
                    scene.cameras_extent,
                    max_screen_size=20 if limited else 0,
                    percent_dense=opt.percent_dense,
                    generator=torch.Generator(device=device).manual_seed(it))
                events["densify"] += 1
                events["limited"] += int(limited)
            if it % opt.opacity_reset_interval == 0:
                reset_opacity(model, adam)
                events["resets"] += 1
    return model, adam, running, viewpoint_stack, events


def _assert_same_state(a, b):
    (ma, aa, ra), (mb, ab, rb) = a, b
    assert torch.equal(ra, rb)
    for name in (*ma.params(), "xyz_gradient_accum", "denom", "max_radii2d"):
        assert torch.equal(getattr(ma, name), getattr(mb, name)), name
    assert aa.step == ab.step
    for k in aa.m:
        assert torch.equal(aa.m[k], ab.m[k]) and torch.equal(aa.v[k],
                                                             ab.v[k]), k


def test_trainer_steps_match_the_loop_it_replaced(scene_dir, tmp_path):
    """`NIRTrainer.step` × 12 against the frozen loop: the same state bit
    for bit, through three densify events (the last with the screen-size
    limit) and an opacity reset."""
    dataset, opt, pipe = _inputs(scene_dir, tmp_path)
    model, adam, running, stack, events = _inline_loop(
        _scene(dataset), dataset, opt, ITERS, SEED, 0.5)
    assert events == dict(densify=3, limited=1, resets=1)
    assert model.num_points != 150 and "nir_albedo" in model.params()

    tr = nir_loop.NIRTrainer(_scene(dataset), opt, pipe, dataset, seed=SEED,
                             nir_weight=0.5)
    for i in range(ITERS):
        before = list(tr.viewpoint_stack) or list(range(3))
        metrics = tr.step()
        assert tr.iteration == i + 1
        assert before.count(tr.cam_idx) == 1
        assert tr.cam_idx not in tr.viewpoint_stack
        assert np.isfinite(float(metrics["loss"]))
        assert np.isfinite(float(metrics["nir"]))
    assert tr.viewpoint_stack == stack
    _assert_same_state((model, adam, running),
                       (tr.model, tr.adam, tr.dwt_running_mean))


def test_train_nir_steps_a_trainer(scene_dir, tmp_path, monkeypatch):
    """The CLI's loop (`train_nir`) calls `NIRTrainer.step` once an
    iteration, and what it saves (and the scene it returns) is the state
    of a trainer stepped as often by hand."""
    steps = []
    real = nir_loop.NIRTrainer.step

    def step(self):
        steps.append(self.iteration + 1)
        return real(self)
    monkeypatch.setattr(nir_loop.NIRTrainer, "step", step)
    (tmp_path / "out").mkdir()
    dataset, opt, pipe = _inputs(scene_dir, tmp_path / "out")
    run = Namespace(save_iterations=[ITERS], seed=SEED, nir_weight=0.5)
    random.seed(0)
    scene = nir_loop.train_nir(dataset, opt, pipe, run, torch.device("cpu"))
    assert steps == list(range(1, ITERS + 1))
    monkeypatch.setattr(nir_loop.NIRTrainer, "step", real)

    tr = nir_loop.NIRTrainer(_scene(dataset), opt, pipe, dataset, seed=SEED,
                             nir_weight=0.5)
    for _ in range(ITERS):
        tr.step()
    for k, p in tr.model.params().items():
        assert torch.equal(getattr(scene.gaussians, k), p), k
    saved = gm.load_ply(str(tmp_path / "out" / "point_cloud" /
                            f"iteration_{ITERS}" / "point_cloud.ply"),
                        sh_degree=1, device="cpu")
    for k in tr.model.row_names():
        assert torch.equal(getattr(saved, k), getattr(tr.model, k).detach()), k
