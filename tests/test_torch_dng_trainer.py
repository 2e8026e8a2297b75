"""`train/dng_loop.py::DNGTrainer`: its `step()` is one iteration of the
DNGaussian loop that `train_dngaussian` ran inline before the trainer
existed, and the train CLI's loop runs through it.

The loop it replaced is kept below as `_inline_loop`, a frozen copy of that
loop's body (the SH schedule, the view and patch draws, `dng_step`, the
densify event, the near-range prune). Both run on the CPU from the same
32-px LLFF-style scene, with a small field, the soft pass and the
smoothness term switched on inside the run, densify events and a
near-range prune that removes points; every parameter, moment, Adam step,
densification statistic and count must agree bit for bit."""

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
from sparse_view_3dgs_pack_tpu_torch.models import neural_field as nf
from sparse_view_3dgs_pack_tpu_torch.ops import hashgrid
from sparse_view_3dgs_pack_tpu_torch.scene import Scene
from sparse_view_3dgs_pack_tpu_torch.train import dng_loop
from sparse_view_3dgs_pack_tpu_torch.train.densify import (densify_and_prune,
                                                           prune_only)
from sparse_view_3dgs_pack_tpu_torch.train.optim import (init_adam,
                                                         make_lr_schedules)
from sparse_view_3dgs_pack_tpu_torch.train.step import CameraBank
from sparse_view_3dgs_pack_tpu_torch.utils.pose_utils import \
    generate_spiral_path
import torch_port  # noqa: F401  (one intra-op thread)

GRID = dict(num_levels=4, level_dim=2, base_resolution=4,
            log2_hashmap_size=10, desired_resolution=32)
TCFG = nf.NeuralFieldConfig(grid=hashgrid.HashGridConfig(**GRID), bound=1.5)
ITERS = 12
SEED = 3
FLAGS = ["--iterations", str(ITERS), "--soft_depth_start", "3",
         "--densify_from_iter", "2", "--densify_until_iter", "10",
         "--densification_interval", "3", "--densify_grad_threshold",
         "0.00001"]


@pytest.fixture
def small_field(monkeypatch):
    """The small field, the near-range prune from iteration 1 and the
    smoothness term from iteration 5."""
    monkeypatch.setattr(dng_loop, "NeuralFieldConfig",
                        lambda bound: TCFG._replace(bound=bound))
    monkeypatch.setattr(dng_loop, "NEAR_PRUNE_FROM_ITER", 0)
    monkeypatch.setattr(dng_loop, "SMOOTH_FROM_ITER", 4)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return testing.write_llff_colmap_scene(
        str(tmp_path_factory.mktemp("dng_trainer") / "scene"), size=32,
        n_gauss=200, n_dense=150, n_sparse=40)


def _inputs(scene_dir, out):
    parser = ArgumentParser()
    op, pp = OptimizationParams(parser, "dngaussian"), PipelineParams(parser)
    args = parser.parse_args(FLAGS)
    dataset = Namespace(source_path=scene_dir, model_path=str(out),
                        sh_degree=1, images="images", depths="", eval=True,
                        train_test_exp=False, n_views=3,
                        point_cloud_type="dense", resolution=-1,
                        white_background=False, data_device="cpu")
    pipe = pp.extract(args)
    pipe.debug_from = -1
    return dataset, op.extract(args), pipe


def _scene(scene_dir, dataset):
    """The Scene with its priors on the cameras (as `train_dngaussian`
    reads them); the camera shuffle seeded."""
    random.seed(0)
    scene = Scene(dataset, sh_degree=dataset.sh_degree, device="cpu")
    estimator = get_depth_estimator("precomputed", scene_dir)
    for c in scene.getTrainCameras():
        d = estimator.depth_for_camera(c)
        c.invdepthmap = (255.0 - np.asarray(d)).astype(np.float32)
        c.depth_mask = np.ones_like(c.invdepthmap)
        c.depth_reliable = True
    return scene


def _near_range(scene) -> float:
    """A range that holds some of the init points: the 10th percentile of
    their distance to the spiral's nearest camera."""
    centers = np.stack([c.camera_center for c in generate_spiral_path(
        scene.getTrainCameras(), dng_loop.SPIRAL_FRAMES)])
    xyz = scene.gaussians.xyz.detach().numpy()
    d = np.linalg.norm(xyz[:, None] - centers[None], axis=-1).min(1)
    return float(np.percentile(d, 10))


def _inline_loop(scene, dataset, opt, iterations, near_range, seed):
    """The loop body `train_dngaussian` ran before `DNGTrainer`, frozen,
    without its prints, evaluations and saves. Returns its state."""
    device = torch.device("cpu")
    cams = scene.getTrainCameras()
    W, H = cams[0].width, cams[0].height
    bank = CameraBank.from_cameras(cams, 3, device)
    model = scene.gaussians
    adam = init_adam(model.params())
    field = nf.NeuralField(
        dng_loop.NeuralFieldConfig(bound=max(scene.cameras_extent, 1.0)),
        torch.Generator(device=device).manual_seed(0))
    field_adam = init_adam(field.params())
    field_lrs = dng_loop.neural_lrs(field)
    lr_scheds = make_lr_schedules(opt, scene.cameras_extent)
    bg = torch.tensor([0.0, 0.0, 0.0], device=device)
    spiral = torch.tensor(np.stack([c.camera_center for c in
                                    generate_spiral_path(
                                        cams, dng_loop.SPIRAL_FRAMES)]),
                          device=device)
    use_neural = bool(getattr(opt, "use_neural", 1))
    rng = random.Random(seed)
    counts = dict(soft_passes=0, near_prunes=0, near_pruned=0,
                  peak_gaussians=model.num_points)
    active_sh = 0
    viewpoint_stack = []
    for it in range(1, iterations + 1):
        if it % 1000 == 0 and active_sh < dataset.sh_degree:
            active_sh += 1
        if not viewpoint_stack:
            viewpoint_stack = list(range(len(cams)))
        cam_idx = viewpoint_stack.pop(rng.randint(0,
                                                  len(viewpoint_stack) - 1))
        patch_idx = rng.randint(0, 11)
        cfg = dng_loop.DNGConfig(
            width=W, height=H, sh_degree=dataset.sh_degree,
            lambda_dssim=opt.lambda_dssim,
            error_tolerance=opt.error_tolerance, shape_pena=opt.shape_pena,
            scale_pena=opt.scale_pena, opa_pena=opt.opa_pena,
            use_neural=use_neural, use_mask=False,
            use_smooth=(it > dng_loop.SMOOTH_FROM_ITER),
            use_soft=(it > opt.soft_depth_start))
        lrs = {k: f(it) for k, f in lr_scheds.items()}
        dng_loop.dng_step(model, field, adam, field_adam, bank, cam_idx,
                          patch_idx, lrs, field_lrs, active_sh, bg, cfg)
        counts["soft_passes"] += int(cfg.use_soft)
        if (opt.densify_from_iter < it < opt.densify_until_iter
                and it % opt.densification_interval == 0):
            densify_and_prune(
                model, adam, opt.densify_grad_threshold,
                dng_loop.MIN_OPACITY, scene.cameras_extent,
                max_screen_size=0, percent_dense=opt.percent_dense,
                generator=torch.Generator(device=device).manual_seed(it))
            counts["peak_gaussians"] = max(counts["peak_gaussians"],
                                           model.num_points)
        if (near_range > 0 and it > dng_loop.NEAR_PRUNE_FROM_ITER
                and (it - 1) % dng_loop.NEAR_PRUNE_EVERY == 0):
            counts["near_pruned"] += prune_only(
                model, adam, dng_loop.near_range_mask(model.xyz.detach(),
                                                      spiral, near_range))
            counts["near_prunes"] += 1
    return model, field, adam, field_adam, counts, viewpoint_stack


def _assert_same_state(a, b):
    (ma, fa, aa, faa, ca), (mb, fb, ab, fab, cb) = a, b
    assert ca == cb
    for name in ("xyz", "features_dc", "features_rest", "scaling",
                 "rotation", "opacity", "xyz_gradient_accum", "denom",
                 "max_radii2d"):
        assert torch.equal(getattr(ma, name), getattr(mb, name)), name
    for (k, p), q in zip(fa.params().items(), fb.params().values()):
        assert torch.equal(p, q), k
    for s, t in ((aa, ab), (faa, fab)):
        assert s.step == t.step
        for k in s.m:
            assert torch.equal(s.m[k], t.m[k]) and torch.equal(s.v[k],
                                                               t.v[k]), k


def test_trainer_steps_match_the_loop_it_replaced(scene_dir, tmp_path,
                                                  small_field):
    """`DNGTrainer.step` × 12 against the frozen loop: the same state bit
    for bit, through soft passes, the smoothness switch, densify events
    and a near-range prune that removes points."""
    dataset, opt, pipe = _inputs(scene_dir, tmp_path)
    scene = _scene(scene_dir, dataset)
    near = _near_range(scene)
    model, field, adam, fadam, counts, stack = _inline_loop(
        scene, dataset, opt, ITERS, near, SEED)
    assert counts["soft_passes"] == ITERS - 3 and counts["near_prunes"] == 1
    assert counts["near_pruned"] > 0
    assert counts["peak_gaussians"] > 150

    tr = dng_loop.DNGTrainer(_scene(scene_dir, dataset), opt, pipe, dataset,
                             seed=SEED, near_range=near)
    for i in range(ITERS):
        before = list(tr.viewpoint_stack) or list(range(3))
        metrics = tr.step()
        assert tr.iteration == i + 1
        assert before.count(tr.cam_idx) == 1
        assert tr.cam_idx not in tr.viewpoint_stack
        assert 0 <= tr.patch_idx <= 11
        assert np.isfinite(float(metrics["loss"]))
    assert tr.viewpoint_stack == stack
    assert tr.cfg.use_soft and tr.cfg.use_smooth
    _assert_same_state((model, field, adam, fadam, counts),
                       (tr.model, tr.field, tr.adam, tr.field_adam,
                        tr.counts))


def test_train_dngaussian_steps_a_trainer(scene_dir, tmp_path, small_field,
                                          monkeypatch):
    """The CLI's loop (`train_dngaussian`) calls `DNGTrainer.step` once an
    iteration, and what it saves is the state of a trainer stepped as
    often by hand."""
    steps = []
    real = dng_loop.DNGTrainer.step

    def step(self):
        steps.append(self.iteration + 1)
        return real(self)
    monkeypatch.setattr(dng_loop.DNGTrainer, "step", step)
    (tmp_path / "out").mkdir()
    dataset, opt, pipe = _inputs(scene_dir, tmp_path / "out")
    run = Namespace(save_iterations=[ITERS], test_iterations=[5],
                    depth_estimator="precomputed", seed=SEED)
    random.seed(0)
    counts = dng_loop.train_dngaussian(dataset, opt, pipe, run,
                                       torch.device("cpu"))
    assert steps == list(range(1, ITERS + 1))
    monkeypatch.setattr(dng_loop.DNGTrainer, "step", real)

    tr = dng_loop.DNGTrainer(_scene(scene_dir, dataset), opt, pipe, dataset,
                             seed=SEED)
    for _ in range(ITERS):
        tr.step()
    assert tr.counts == counts
    it_dir = tmp_path / "out" / "point_cloud" / f"iteration_{ITERS}"
    saved = gm.load_ply(str(it_dir / "point_cloud.ply"), sh_degree=1,
                        device="cpu")
    for k, p in tr.model.params().items():
        assert torch.equal(getattr(saved, k), p.detach()), k
    field = nf.load_neural_npz(str(it_dir / "neural_renderer.npz"), "cpu")
    for (k, p), q in zip(field.params().items(), tr.field.params().values()):
        assert torch.equal(p, q.detach()), k
