"""FSGS training (reference `FSGS/train.py:38-176`).

Counterpart of `sparse_view_3dgs_pack_tpu/train/fsgs_loop.py:46-424`,
without the capacity, pair-bucket and speculative-compile machinery of XLA's
static shapes. What differs from the 3DGS loop: masked L1 + SSIM; a
Pearson-correlation depth prior against a mono-depth map per view (its
gradient reaches the backward kernel through the expected-depth cotangent);
pseudo-view depth distillation every `sample_pseudo_interval` iterations
(the pseudo target is a mono-depth network's estimate of the render when
the estimator can score novel images, else the nearest training view's
prior warped into the pseudo view, `depth/warp.py`); at each densify event
clone/split with FSGS's distance split, the prune, then proximity-guided
densification on the pruned state until `proximity_until_iter`, from one
exact 3-NN search (`ops/knn.py::knn3`) per state; the SH degree up every
500 iterations; the opacity reset offset from `start_sample_pseudo`; the
depth weight 0.001 after `end_sample_pseudo`. No exposure Adam, as in JAX.

`FSGSTrainer` holds the model, Adam, the camera bank, the confidence, the
pseudo poses and the counts; its `step()` is one iteration (the schedules,
the view draw, `fsgs_step`, the pseudo step, the densify event and the
opacity reset, the debug check), and `train_fsgs` is the CLI's loop
around it (`loop.drive`). The view and pseudo-pose draws come from the
`random` module.
"""

from __future__ import annotations

import random
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..depth.estimator import attach_priors, get_depth_estimator
from ..depth.warp import metric_depth_from_prior, warp_depth
from ..losses.depth import (fsgs_depth_loss, pseudo_depth_loss,
                            warped_pseudo_depth_loss)
from ..losses.photometric import l1_loss_mask
from ..losses.ssim import ssim
from ..models.gaussians import GaussianModel
from ..ops.knn import knn3
from ..renderer import render_core
from ..scene import Scene
from ..utils.pose_utils import (generate_random_poses_360,
                                generate_random_poses_llff)
from ..utils.tracing import span
from .densify import (add_densification_stats, densify_and_prune,
                      proximity_densify, reset_opacity)
from .loop import StepTrainer, drive, evaluate_cameras
from .optim import AdamState, adam_update, cleared, grads_or_zeros
from .step import CameraBank

# warped pseudo steps with less covered area than this are skipped
MIN_COVERAGE = 0.05


class FSGSConfig(NamedTuple):
    width: int
    height: int
    sh_degree: int
    lambda_dssim: float = 0.2
    use_confidence: bool = False


def _render(params: dict, cam, bg, cfg: FSGSConfig, active_degree: int,
            confidence=None):
    """The training render (16×16 tiles, differentiable rasterizer), the
    SH evaluated to the active degree."""
    return render_core(params, None, cam, cfg.width, cfg.height, bg,
                       sh_degree_active=min(active_degree, cfg.sh_degree),
                       inference=False, confidence=confidence)


def fsgs_step(model: GaussianModel, adam: AdamState, bank: CameraBank,
              cam_idx: int, lrs: dict, depth_weight: float,
              active_degree: int, bg, cfg: FSGSConfig,
              confidence: Optional[torch.Tensor] = None) -> dict:
    """One FSGS step (JAX `fsgs_step`): masked L1 + SSIM, plus
    `depth_weight` × the Pearson depth prior where the view has one;
    backward, Adam, densification statistics. `confidence` (N,) scales the
    gradients when `cfg.use_confidence`. Updates `model` and `adam` in
    place; returns the metrics."""
    params = cleared(model.params())
    res = _render(params, bank.camera(cam_idx), bg, cfg, active_degree,
                  confidence if cfg.use_confidence else None)
    image = res.render * bank.alpha_mask[cam_idx]
    gt = bank.gt[cam_idx]
    ll1 = l1_loss_mask(image, gt)
    loss = ((1.0 - cfg.lambda_dssim) * ll1
            + cfg.lambda_dssim * (1.0 - ssim(image, gt)))
    dterm = fsgs_depth_loss(res.expected_depth, bank.invdepth[cam_idx])
    loss = loss + depth_weight * bank.has_depth[cam_idx] * dterm
    loss.backward()
    adam_update(model.params(), grads_or_zeros(params), adam, lrs)
    vs = res.viewspace_points
    add_densification_stats(
        model, vs.grad if vs.grad is not None else torch.zeros_like(vs),
        res.radii, cfg.width, cfg.height)
    return {"loss": loss.detach(), "l1": ll1.detach(),
            "depth": dterm.detach(), "n_pairs": res.n_pairs}


@torch.no_grad()
def fsgs_render_pseudo(model: GaussianModel, cam, active_degree: int, bg,
                       cfg: FSGSConfig):
    """(image (H, W, 3), expected depth (H, W)) of a pseudo view."""
    res = _render(model.params(), cam, bg, cfg, active_degree)
    return res.render, res.expected_depth


def _masked_update(model, adam, params, ok, lrs, weight):
    """Adam on the gradients when `ok`, else on zeros at lr 0 (the moments
    still decay and the step still counts, as in the JAX step)."""
    grads = grads_or_zeros(params)
    if not ok:
        grads = {k: torch.zeros_like(v) for k, v in grads.items()}
    adam_update(model.params(), grads, adam,
                {k: v * weight * float(ok) for k, v in lrs.items()})


def fsgs_warped_pseudo_step(model: GaussianModel, adam: AdamState, src_cam,
                            src_prior: torch.Tensor, dst_cam, lrs: dict,
                            weight: float, active_degree: int, bg,
                            cfg: FSGSConfig):
    """Offline pseudo-view distillation: the source view's prior aligned to
    metric depth against its own render, warped into the pseudo camera, a
    masked Pearson loss there (the substitute for MiDaS-on-render,
    `FSGS/train.py:116-131`). Skipped (Adam at lr 0) on a non-finite loss
    or a coverage of at most MIN_COVERAGE. Returns (loss, coverage,
    applied)."""
    params = cleared(model.params())
    with torch.no_grad():   # a fixed distillation target
        src = _render(params, src_cam, bg, cfg, active_degree)
        z_src, src_valid = metric_depth_from_prior(src_prior, src.depth,
                                                   src.alpha)
        warped, valid = warp_depth(z_src, src_valid, src_cam, dst_cam,
                                   cfg.width, cfg.height)
        coverage = float(valid.to(torch.float32).mean())
    res = _render(params, dst_cam, bg, cfg, active_degree)
    loss = warped_pseudo_depth_loss(res.expected_depth, warped, valid)
    loss.backward()
    value = float(loss.detach())
    ok = np.isfinite(value) and coverage > MIN_COVERAGE
    _masked_update(model, adam, params, ok, lrs, weight)
    return value, coverage, ok


def fsgs_pseudo_step(model: GaussianModel, adam: AdamState, cam,
                     midas_pseudo: torch.Tensor, lrs: dict, weight: float,
                     active_degree: int, bg, cfg: FSGSConfig):
    """Distillation against a mono-depth estimate of the pseudo view's
    render (`FSGS/train.py:116-131`); skipped on a non-finite loss.
    Returns (loss, applied)."""
    params = cleared(model.params())
    res = _render(params, cam, bg, cfg, active_degree)
    loss = pseudo_depth_loss(res.expected_depth, midas_pseudo)
    loss.backward()
    value = float(loss.detach())
    ok = bool(np.isfinite(value))
    _masked_update(model, adam, params, ok, lrs, weight)
    return value, ok


@torch.no_grad()
def fsgs_densify_masks(model: GaussianModel, scene_extent: float,
                       dist_thres: float):
    """One 3-NN search serving both FSGS densification extras: the
    proximity mask (mean 3-NN d² > 5·extent ∧ max scale > extent,
    `FSGS/scene/gaussian_model.py:405-408`) with the neighbour indices,
    and the distance split mask (d² > dist_thres·extent ∧ max scale >
    extent, `gaussian_model.py:434-437`). → (prox_mask, nn_idx,
    split_mask)."""
    dist, idx = knn3(model.xyz.detach())
    big = model.get_scaling().max(dim=-1).values > scene_extent
    return (big & (dist > 5.0 * scene_extent), idx,
            big & (dist > dist_thres * scene_extent))


def _pseudo_cameras(cams, source_path: str):
    """Pseudo poses (reference `scene/__init__.py:83-95`)."""
    if "360" in source_path:
        return generate_random_poses_360(cams, n_poses=1000)
    return generate_random_poses_llff(cams, n_poses=1000)


class FSGSTrainer(StepTrainer):
    """FSGS's training state, stepped one iteration at a time (as
    `train/loop.py::Trainer` is for the main path). `scene` has
    `gaussians`, `getTrainCameras()` and `cameras_extent`; a camera whose
    `invdepthmap` is set (with `depth_reliable`) carries its mono-depth
    prior; `dataset_args` gives `sh_degree`, `white_background` and
    `source_path` (a "360" in it picks the 360 pseudo poses); `estimator`
    (`depth/estimator.py`) decides the pseudo step: none when it is not
    `available`, the reference's when it `can_estimate`, else the warp."""

    def __init__(self, scene, opt, pipe, dataset_args, estimator):
        super().__init__(scene, opt, pipe, dataset_args, random,
                         dataset_args.white_background)
        self.estimator = estimator
        self.cams = scene.getTrainCameras()
        self.cfg = FSGSConfig(
            width=self.width, height=self.height, sh_degree=self.sh_degree,
            lambda_dssim=opt.lambda_dssim,
            use_confidence=bool(getattr(pipe, "use_confidence", False)))
        # per-Gaussian confidence: ones, carried across densification like
        # the reference (`gaussian_model.py:158,351,402` keeps it all-ones)
        self.confidence = torch.ones(self.model.num_points,
                                     device=self.device)
        self.pseudo_cams = _pseudo_cameras(self.cams,
                                           dataset_args.source_path)
        self.pseudo_stack = []
        self.centers = np.stack([c.camera_center for c in self.cams])
        self.dist_thres = getattr(opt, "dist_thres", 10.0)
        self.prox_until = getattr(opt, "proximity_until_iter", 2000)
        self.depth_weight = float(opt.depth_weight)
        self.counts = dict(pseudo_steps=0, warped_steps=0, warped_applied=0,
                           proximity_appended=0, distance_splits=0,
                           peak_gaussians=self.model.num_points)

    def step(self) -> dict:
        """One iteration, under the "host/step" span: the SH and depth
        weight schedules, the view draw, `fsgs_step`, the pseudo step, the
        densify event and the opacity reset, the debug check. Returns
        `fsgs_step`'s metrics."""
        with span("host/step"):
            self.iteration += 1
            it, o, model = self.iteration, self.opt, self.model
            self.grow_sh(500)
            if it > o.end_sample_pseudo:
                self.depth_weight = 0.001
            self.cam_idx = self.pick_camera()
            lrs = self.lrs()
            if self.confidence.shape[0] != model.num_points:
                self.confidence = torch.ones(model.num_points,
                                             device=self.device)
            metrics = fsgs_step(model, self.adam, self.bank, self.cam_idx,
                                lrs, self.depth_weight,
                                self.active_sh_degree, self.background,
                                self.cfg, self.confidence)
            if (self.estimator.available
                    and it % o.sample_pseudo_interval == 0
                    and o.start_sample_pseudo < it < o.end_sample_pseudo):
                self._pseudo_step(lrs)
            if it < o.densify_until_iter:
                if (it > o.densify_from_iter
                        and it % o.densification_interval == 0):
                    self._densify()
                if (it > o.start_sample_pseudo
                        and (it - o.start_sample_pseudo - 1)
                        % o.opacity_reset_interval == 0):
                    reset_opacity(model, self.adam)
            self.check(metrics)
            return metrics

    def _pseudo_step(self, lrs: dict) -> None:
        """Pseudo-view depth distillation on a pseudo pose drawn without
        replacement, its weight ramped in over 500 iterations."""
        it, o, model = self.iteration, self.opt, self.model
        if not self.pseudo_stack:
            self.pseudo_stack = list(self.pseudo_cams)
        pcam = self.pseudo_stack.pop(
            self.rng.randint(0, len(self.pseudo_stack) - 1))
        w = (min((it - o.start_sample_pseudo) / 500.0, 1.0)
             * o.depth_pseudo_weight)
        args = (lrs, w, self.active_sh_degree, self.background, self.cfg)
        if self.estimator.can_estimate:
            img, _ = fsgs_render_pseudo(model, pcam.params(),
                                        self.active_sh_degree,
                                        self.background, self.cfg)
            midas = self.estimator.estimate(img)
            if midas is not None:
                fsgs_pseudo_step(model, self.adam, pcam.params(),
                                 torch.as_tensor(midas, device=self.device),
                                 *args)
                self.counts["pseudo_steps"] += 1
            return
        # the nearest training view's prior, warped
        j = int(np.argmin(np.linalg.norm(
            self.centers - pcam.camera_center, axis=1)))
        if self.cams[j].depth_reliable:
            _, _, applied = fsgs_warped_pseudo_step(
                model, self.adam, self.bank.camera(j), self.bank.invdepth[j],
                pcam.params(), *args)
            self.counts["warped_steps"] += 1
            self.counts["warped_applied"] += int(applied)

    def _densify(self) -> None:
        """The densify event (reference `FSGS/scene/gaussian_model.py:
        475-482`): clone → split (+ the distance mask) → prune, then
        proximity on the pruned state (a new search: the prune moved the
        rows) until `proximity_until_iter`; one `[densify N]` line."""
        it, o, model = self.iteration, self.opt, self.model
        extent, counts = self.scene.cameras_extent, self.counts
        _, _, extra_split = fsgs_densify_masks(model, extent,
                                               self.dist_thres)
        n_dist = int(extra_split.sum())
        counts["distance_splits"] += n_dist
        scale = model.get_scaling().detach().max(dim=-1).values
        sizes = (f"big={int((scale > extent).sum())} max_scale="
                 f"{float(scale.max()):.3f}")
        res = densify_and_prune(
            model, self.adam, o.densify_grad_threshold, 0.005, extent,
            max_screen_size=0, percent_dense=o.percent_dense,
            generator=torch.Generator(device=self.device).manual_seed(it),
            extra_split_mask=extra_split)
        counts["peak_gaussians"] = max(counts["peak_gaussians"],
                                       model.num_points)
        appended = 0
        if it < self.prox_until:
            prox_mask, nn_idx, _ = fsgs_densify_masks(model, extent,
                                                      self.dist_thres)
            appended = proximity_densify(model, self.adam, nn_idx, prox_mask)
            counts["proximity_appended"] += appended
        counts["peak_gaussians"] = max(counts["peak_gaussians"],
                                       model.num_points)
        # splits count the distance-selected ones, prunes the split
        # originals; `big`: Gaussians larger than the scene extent before
        # the event (those the distance split and proximity may take)
        print(f"[densify {it}] cloned={res.cloned} split={res.split}"
              f" distance_split={n_dist} proximity={appended} "
              f"pruned={res.pruned} gaussians={model.num_points} "
              f"{sizes}", flush=True)


def train_fsgs(dataset, opt, pipe, args, device) -> dict:
    """The FSGS training loop on `device`: an `FSGSTrainer` driven by
    `loop.drive` for `opt.iterations` steps, evaluating the test views and
    five training views. Returns its counts: pseudo and warped pseudo
    steps (and how many a coverage above MIN_COVERAGE let through),
    proximity appends, distance splits, the peak Gaussian count."""
    scene = Scene(dataset, sh_degree=dataset.sh_degree, device=device)
    estimator = get_depth_estimator(
        getattr(args, "depth_estimator", "auto"), dataset.source_path)
    attach_priors(scene.getTrainCameras(), estimator)
    trainer = FSGSTrainer(scene, opt, pipe, dataset, estimator)
    def evaluate():   # the test views, then five training views
        return [(name, evaluate_cameras(trainer.model, views,
                                        trainer.background,
                                        trainer.active_sh_degree))
                for name, views in (("test", scene.getTestCameras()),
                                    ("train", trainer.cams[:5]))]
    # the loss line with the view's depth-prior term
    drive(trainer, opt.iterations, args.save_iterations,
          getattr(args, "test_iterations", None) or (), evaluate,
          "FSGS training", ("depth",))
    counts = trainer.counts
    print("FSGS counts: " + " ".join(f"{k}={v}" for k, v in counts.items()),
          flush=True)
    return counts
