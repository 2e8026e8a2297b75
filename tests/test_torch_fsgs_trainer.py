"""`train/fsgs_loop.py::FSGSTrainer`: its `step()` is one iteration of the
FSGS loop that `train_fsgs` ran inline before the trainer existed, and the
train CLI's loop runs through it.

The loop it replaced is kept below as `_inline_loop`, a frozen copy of that
loop's body (the SH and depth-weight schedules, the view draw, `fsgs_step`
with the confidence, the warped pseudo step, the densify event with the
distance split and proximity, the opacity reset, the counts). Both run on
the CPU from the same 32-px LLFF-style scene with stray points in its
dense init, through densify events that split by distance and append by
proximity, warped pseudo steps and opacity resets; every parameter,
moment, Adam step, densification statistic, the confidence and the counts
must agree bit for bit."""

from __future__ import annotations

import random
from argparse import ArgumentParser, Namespace

import numpy as np
import pytest
import torch

from sparse_view_3dgs_pack_tpu_torch import testing
from sparse_view_3dgs_pack_tpu_torch.config import (OptimizationParams,
                                                    PipelineParams)
from sparse_view_3dgs_pack_tpu_torch.depth.estimator import \
    get_depth_estimator
from sparse_view_3dgs_pack_tpu_torch.models import gaussians as gm
from sparse_view_3dgs_pack_tpu_torch.scene import Scene
from sparse_view_3dgs_pack_tpu_torch.train import fsgs_loop
from sparse_view_3dgs_pack_tpu_torch.train.densify import (densify_and_prune,
                                                           proximity_densify,
                                                           reset_opacity)
from sparse_view_3dgs_pack_tpu_torch.train.optim import (init_adam,
                                                         make_lr_schedules)
from sparse_view_3dgs_pack_tpu_torch.train.step import CameraBank
import torch_port  # noqa: F401  (one intra-op thread)

ITERS = 12
FLAGS = ["--iterations", str(ITERS), "--densify_from_iter", "2",
         "--densification_interval", "5", "--densify_until_iter", "12",
         "--proximity_until_iter", "12", "--start_sample_pseudo", "3",
         "--end_sample_pseudo", "11", "--sample_pseudo_interval", "2",
         "--opacity_reset_interval", "5", "--densify_grad_threshold",
         "0.00001", "--percent_dense", "0.1"]


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return testing.write_llff_colmap_scene(
        str(tmp_path_factory.mktemp("fsgs_trainer") / "scene"), size=32,
        n_gauss=400, n_dense=300, n_sparse=60, n_outliers=6)


def _inputs(scene_dir, out):
    parser = ArgumentParser()
    op, pp = OptimizationParams(parser, "fsgs"), PipelineParams(parser)
    args = parser.parse_args(FLAGS)
    dataset = Namespace(source_path=scene_dir, model_path=str(out),
                        sh_degree=1, images="images", depths="", eval=True,
                        train_test_exp=False, n_views=3,
                        point_cloud_type="dense", resolution=-1,
                        white_background=False, data_device="cpu")
    pipe = pp.extract(args)
    pipe.debug_from = -1
    pipe.use_confidence = True
    return dataset, op.extract(args), pipe


def _scene(scene_dir, dataset):
    """The Scene with its priors on the cameras, as `train_fsgs` read them
    before `FSGSTrainer`; the host RNG seeded (the camera shuffle, the
    view and pseudo-pose draws)."""
    random.seed(0)
    scene = Scene(dataset, sh_degree=dataset.sh_degree, device="cpu")
    estimator = get_depth_estimator("precomputed", scene_dir)
    for c in scene.getTrainCameras():
        d = estimator.depth_for_camera(c)
        if d is not None:
            c.invdepthmap = np.asarray(d, np.float32)
            c.depth_mask = np.ones_like(c.invdepthmap)
            c.depth_reliable = True
    return scene, estimator


def _inline_loop(scene, dataset, opt, pipe, estimator, iterations):
    """The loop body `train_fsgs` ran before `FSGSTrainer`, frozen, without
    its loss line, evaluations and saves. Returns its state."""
    device = torch.device("cpu")
    cams = scene.getTrainCameras()
    W, H = cams[0].width, cams[0].height
    extent = scene.cameras_extent
    bank = CameraBank.from_cameras(cams, 3, device)
    model = scene.gaussians
    adam = init_adam(model.params())
    lr_scheds = make_lr_schedules(opt, extent)
    bg = torch.tensor([0.0, 0.0, 0.0], device=device)
    cfg = fsgs_loop.FSGSConfig(width=W, height=H,
                               sh_degree=dataset.sh_degree,
                               lambda_dssim=opt.lambda_dssim,
                               use_confidence=bool(getattr(
                                   pipe, "use_confidence", False)))
    confidence = torch.ones(model.num_points, device=device)
    pseudo_cams = fsgs_loop._pseudo_cameras(cams, dataset.source_path)
    centers = np.stack([c.camera_center for c in cams])
    dist_thres = getattr(opt, "dist_thres", 10.0)
    prox_until = getattr(opt, "proximity_until_iter", 2000)
    counts = dict(pseudo_steps=0, warped_steps=0, warped_applied=0,
                  proximity_appended=0, distance_splits=0,
                  peak_gaussians=model.num_points)
    depth_weight = float(opt.depth_weight)
    active_sh = 0
    viewpoint_stack, pseudo_stack = [], []
    resets = 0
    for it in range(1, iterations + 1):
        if it % 500 == 0 and active_sh < dataset.sh_degree:
            active_sh += 1
        if it > opt.end_sample_pseudo:
            depth_weight = 0.001
        if not viewpoint_stack:
            viewpoint_stack = list(range(len(cams)))
        cam_idx = viewpoint_stack.pop(
            random.randint(0, len(viewpoint_stack) - 1))
        lrs = {k: f(it) for k, f in lr_scheds.items()}
        if confidence.shape[0] != model.num_points:
            confidence = torch.ones(model.num_points, device=device)
        fsgs_loop.fsgs_step(model, adam, bank, cam_idx, lrs, depth_weight,
                            active_sh, bg, cfg, confidence)
        if (estimator.available and it % opt.sample_pseudo_interval == 0
                and opt.start_sample_pseudo < it < opt.end_sample_pseudo):
            if not pseudo_stack:
                pseudo_stack = list(pseudo_cams)
            pcam = pseudo_stack.pop(random.randint(0, len(pseudo_stack) - 1))
            w = (min((it - opt.start_sample_pseudo) / 500.0, 1.0)
                 * opt.depth_pseudo_weight)
            assert not estimator.can_estimate
            j = int(np.argmin(np.linalg.norm(
                centers - pcam.camera_center, axis=1)))
            if cams[j].depth_reliable:
                _, _, applied = fsgs_loop.fsgs_warped_pseudo_step(
                    model, adam, bank.camera(j), bank.invdepth[j],
                    pcam.params(), lrs, w, active_sh, bg, cfg)
                counts["warped_steps"] += 1
                counts["warped_applied"] += int(applied)
        if it < opt.densify_until_iter:
            if (it > opt.densify_from_iter
                    and it % opt.densification_interval == 0):
                _, _, extra_split = fsgs_loop.fsgs_densify_masks(
                    model, extent, dist_thres)
                counts["distance_splits"] += int(extra_split.sum())
                densify_and_prune(
                    model, adam, opt.densify_grad_threshold, 0.005, extent,
                    max_screen_size=0, percent_dense=opt.percent_dense,
                    generator=torch.Generator(device=device).manual_seed(it),
                    extra_split_mask=extra_split)
                counts["peak_gaussians"] = max(counts["peak_gaussians"],
                                               model.num_points)
                if it < prox_until:
                    prox_mask, nn_idx, _ = fsgs_loop.fsgs_densify_masks(
                        model, extent, dist_thres)
                    counts["proximity_appended"] += proximity_densify(
                        model, adam, nn_idx, prox_mask)
                counts["peak_gaussians"] = max(counts["peak_gaussians"],
                                               model.num_points)
            if (it > opt.start_sample_pseudo
                    and (it - opt.start_sample_pseudo - 1)
                    % opt.opacity_reset_interval == 0):
                reset_opacity(model, adam)
                resets += 1
    return (model, adam, confidence, counts, viewpoint_stack,
            len(pseudo_stack), resets)


def _assert_same_state(a, b):
    (ma, aa, conf_a, ca), (mb, ab, conf_b, cb) = a, b
    assert ca == cb
    assert torch.equal(conf_a, conf_b)
    for name in ("xyz", "features_dc", "features_rest", "scaling",
                 "rotation", "opacity", "xyz_gradient_accum", "denom",
                 "max_radii2d"):
        assert torch.equal(getattr(ma, name), getattr(mb, name)), name
    assert aa.step == ab.step
    for k in aa.m:
        assert torch.equal(aa.m[k], ab.m[k]) and torch.equal(aa.v[k],
                                                             ab.v[k]), k


def test_trainer_steps_match_the_loop_it_replaced(scene_dir, tmp_path):
    """`FSGSTrainer.step` × 12 against the frozen loop: the same state bit
    for bit, through warped pseudo steps, two densify events with
    distance splits and proximity appends, and two opacity resets."""
    dataset, opt, pipe = _inputs(scene_dir, tmp_path)
    scene, estimator = _scene(scene_dir, dataset)
    model, adam, conf, counts, stack, n_pseudo, resets = _inline_loop(
        scene, dataset, opt, pipe, estimator, ITERS)
    assert counts["warped_steps"] == 4 and counts["warped_applied"] > 0
    assert counts["proximity_appended"] > 0
    assert counts["distance_splits"] > 0
    assert resets == 2

    scene, estimator = _scene(scene_dir, dataset)
    tr = fsgs_loop.FSGSTrainer(scene, opt, pipe, dataset, estimator)
    for i in range(ITERS):
        before = list(tr.viewpoint_stack) or list(range(3))
        metrics = tr.step()
        assert tr.iteration == i + 1
        assert before.count(tr.cam_idx) == 1
        assert tr.cam_idx not in tr.viewpoint_stack
        assert np.isfinite(float(metrics["loss"]))
    assert tr.viewpoint_stack == stack
    assert len(tr.pseudo_stack) == n_pseudo
    assert tr.depth_weight == 0.001
    _assert_same_state((model, adam, conf, counts),
                       (tr.model, tr.adam, tr.confidence, tr.counts))


def test_train_fsgs_steps_a_trainer(scene_dir, tmp_path, monkeypatch):
    """The CLI's loop (`train_fsgs`) calls `FSGSTrainer.step` once an
    iteration, and what it saves is the state of a trainer stepped as
    often by hand."""
    steps = []
    real = fsgs_loop.FSGSTrainer.step

    def step(self):
        steps.append(self.iteration + 1)
        return real(self)
    monkeypatch.setattr(fsgs_loop.FSGSTrainer, "step", step)
    (tmp_path / "out").mkdir()
    dataset, opt, pipe = _inputs(scene_dir, tmp_path / "out")
    run = Namespace(save_iterations=[5], test_iterations=[5],
                    depth_estimator="precomputed")
    random.seed(0)
    counts = fsgs_loop.train_fsgs(dataset, opt, pipe, run,
                                  torch.device("cpu"))
    assert steps == list(range(1, ITERS + 1))
    monkeypatch.setattr(fsgs_loop.FSGSTrainer, "step", real)

    scene, estimator = _scene(scene_dir, dataset)
    tr = fsgs_loop.FSGSTrainer(scene, opt, pipe, dataset, estimator)
    for _ in range(ITERS):
        tr.step()
    assert tr.counts == counts
    for it in (5, ITERS):
        assert (tmp_path / "out" / "point_cloud" / f"iteration_{it}"
                / "point_cloud.ply").exists()
    saved = gm.load_ply(str(tmp_path / "out" / "point_cloud" /
                            f"iteration_{ITERS}" / "point_cloud.ply"),
                        sh_degree=1, device="cpu")
    for k, p in tr.model.params().items():
        assert torch.equal(getattr(saved, k), p.detach()), k
