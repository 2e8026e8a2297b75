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
"""

from __future__ import annotations

import random
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..depth.estimator import get_depth_estimator
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
from . import debug
from .densify import (add_densification_stats, densify_and_prune,
                      proximity_densify, reset_opacity)
from .loop import evaluate_cameras, format_eval
from .optim import (AdamState, adam_update, grads_or_zeros, init_adam,
                    make_lr_schedules)
from .step import CameraBank, sh_band_mask

# warped pseudo steps with less covered area than this are skipped
MIN_COVERAGE = 0.05


class FSGSConfig(NamedTuple):
    width: int
    height: int
    sh_degree: int
    lambda_dssim: float = 0.2
    use_confidence: bool = False


def _banded(model: GaussianModel, active_degree: int, cfg: FSGSConfig):
    """The model's parameters with the SH bands above `active_degree`
    masked out."""
    params = model.params()
    p = dict(params)
    band = sh_band_mask(active_degree, cfg.sh_degree, model.xyz.device)
    p["features_rest"] = params["features_rest"] * band[1:][None]
    return params, p


def _render(p: dict, cam, bg, cfg: FSGSConfig, confidence=None):
    """The training render (16×16 tiles, differentiable rasterizer)."""
    return render_core(p, torch.eye(3, 4, device=p["xyz"].device), cam,
                       cfg.width, cfg.height, bg,
                       sh_degree_active=cfg.sh_degree, inference=False,
                       confidence=confidence)


def fsgs_step(model: GaussianModel, adam: AdamState, bank: CameraBank,
              cam_idx: int, lrs: dict, depth_weight: float,
              active_degree: int, bg, cfg: FSGSConfig,
              confidence: Optional[torch.Tensor] = None) -> dict:
    """One FSGS step (JAX `fsgs_step`): masked L1 + SSIM, plus
    `depth_weight` × the Pearson depth prior where the view has one;
    backward, Adam, densification statistics. `confidence` (N,) scales the
    gradients when `cfg.use_confidence`. Updates `model` and `adam` in
    place; returns the metrics."""
    params, p = _banded(model, active_degree, cfg)
    for t in params.values():
        t.grad = None
    res = _render(p, bank.camera(cam_idx), bg, cfg,
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
    res = _render(_banded(model, active_degree, cfg)[1], cam, bg, cfg)
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
    params, p = _banded(model, active_degree, cfg)
    with torch.no_grad():   # a fixed distillation target
        src = _render(p, src_cam, bg, cfg)
        z_src, src_valid = metric_depth_from_prior(src_prior, src.depth,
                                                   src.alpha)
        warped, valid = warp_depth(z_src, src_valid, src_cam, dst_cam,
                                   cfg.width, cfg.height)
        coverage = float(valid.to(torch.float32).mean())
    for t in params.values():
        t.grad = None
    res = _render(p, dst_cam, bg, cfg)
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
    params, p = _banded(model, active_degree, cfg)
    for t in params.values():
        t.grad = None
    res = _render(p, cam, bg, cfg)
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


def train_fsgs(dataset, opt, pipe, args, device) -> dict:
    """The FSGS training loop on `device`. Returns its counts: pseudo and
    warped pseudo steps (and how many a coverage above MIN_COVERAGE let
    through), proximity appends, distance splits, the peak Gaussian
    count."""
    scene = Scene(dataset, sh_degree=dataset.sh_degree, device=device)
    cams = scene.getTrainCameras()
    W, H = cams[0].width, cams[0].height
    extent = scene.cameras_extent

    estimator = get_depth_estimator(
        getattr(args, "depth_estimator", "auto"), dataset.source_path)
    # mono depth priors ride in the bank's inverse-depth slot
    for c in cams:
        d = estimator.depth_for_camera(c)
        if d is not None:
            c.invdepthmap = np.asarray(d, np.float32)
            c.depth_mask = np.ones_like(c.invdepthmap)
            c.depth_reliable = True
    bank = CameraBank.from_cameras(cams, 3, device)

    model = scene.gaussians
    adam = init_adam(model.params())
    lr_scheds = make_lr_schedules(opt, extent)
    bg = torch.tensor([1.0, 1.0, 1.0] if dataset.white_background
                      else [0.0, 0.0, 0.0], device=device)
    cfg = FSGSConfig(width=W, height=H, sh_degree=dataset.sh_degree,
                     lambda_dssim=opt.lambda_dssim,
                     use_confidence=bool(getattr(pipe, "use_confidence",
                                                 False)))
    # per-Gaussian confidence: ones, carried across densification like the
    # reference (`gaussian_model.py:158,351,402` keeps it all-ones)
    confidence = torch.ones(model.num_points, device=device)
    pseudo_cams = _pseudo_cameras(cams, dataset.source_path)
    centers = np.stack([c.camera_center for c in cams])
    dist_thres = getattr(opt, "dist_thres", 10.0)
    prox_until = getattr(opt, "proximity_until_iter", 2000)

    counts = dict(pseudo_steps=0, warped_steps=0, warped_applied=0,
                  proximity_appended=0, distance_splits=0,
                  peak_gaussians=model.num_points)
    depth_weight = float(opt.depth_weight)
    active_sh = 0
    viewpoint_stack, pseudo_stack = [], []
    save_iters = set(args.save_iterations)
    test_iters = set(getattr(args, "test_iterations", None) or [])
    t0 = time.time()
    for it in range(1, opt.iterations + 1):
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
        metrics = fsgs_step(model, adam, bank, cam_idx, lrs, depth_weight,
                            active_sh, bg, cfg, confidence)

        # pseudo-view depth distillation
        if (estimator.available and it % opt.sample_pseudo_interval == 0
                and opt.start_sample_pseudo < it < opt.end_sample_pseudo):
            if not pseudo_stack:
                pseudo_stack = list(pseudo_cams)
            pcam = pseudo_stack.pop(random.randint(0, len(pseudo_stack) - 1))
            w = (min((it - opt.start_sample_pseudo) / 500.0, 1.0)
                 * opt.depth_pseudo_weight)
            if estimator.can_estimate:
                img, _ = fsgs_render_pseudo(model, pcam.params(), active_sh,
                                            bg, cfg)
                midas = estimator.estimate(img)
                if midas is not None:
                    fsgs_pseudo_step(model, adam, pcam.params(),
                                     torch.as_tensor(midas, device=device),
                                     lrs, w, active_sh, bg, cfg)
                    counts["pseudo_steps"] += 1
            else:
                # the nearest training view's prior, warped
                j = int(np.argmin(np.linalg.norm(
                    centers - pcam.camera_center, axis=1)))
                if cams[j].depth_reliable:
                    _, _, applied = fsgs_warped_pseudo_step(
                        model, adam, bank.camera(j), bank.invdepth[j],
                        pcam.params(), lrs, w, active_sh, bg, cfg)
                    counts["warped_steps"] += 1
                    counts["warped_applied"] += int(applied)

        # densification (reference `FSGS/scene/gaussian_model.py:475-482`):
        # clone → split (+ the distance mask) → prune, then proximity on the
        # pruned state (a new search: the prune moved the rows)
        if it < opt.densify_until_iter:
            if (it > opt.densify_from_iter
                    and it % opt.densification_interval == 0):
                _, _, extra_split = fsgs_densify_masks(model, extent,
                                                       dist_thres)
                n_dist = int(extra_split.sum())
                counts["distance_splits"] += n_dist
                scale = model.get_scaling().detach().max(dim=-1).values
                sizes = f"big={int((scale > extent).sum())} max_scale=" \
                      f"{float(scale.max()):.3f}"
                res = densify_and_prune(
                    model, adam, opt.densify_grad_threshold, 0.005, extent,
                    max_screen_size=0, percent_dense=opt.percent_dense,
                    generator=torch.Generator(device=device).manual_seed(it),
                    extra_split_mask=extra_split)
                counts["peak_gaussians"] = max(counts["peak_gaussians"],
                                               model.num_points)
                appended = 0
                if it < prox_until:
                    prox_mask, nn_idx, _ = fsgs_densify_masks(
                        model, extent, dist_thres)
                    appended = proximity_densify(model, adam, nn_idx,
                                                 prox_mask)
                    counts["proximity_appended"] += appended
                counts["peak_gaussians"] = max(counts["peak_gaussians"],
                                               model.num_points)
                # splits count the distance-selected ones, prunes the
                # split originals; `big`: Gaussians larger than the scene
                # extent before the event (those the distance split and
                # proximity may take)
                print(f"[densify {it}] cloned={res.cloned} split={res.split}"
                      f" distance_split={n_dist} proximity={appended} "
                      f"pruned={res.pruned} gaussians={model.num_points} "
                      f"{sizes}", flush=True)
            if (it > opt.start_sample_pseudo
                    and (it - opt.start_sample_pseudo - 1)
                    % opt.opacity_reset_interval == 0):
                reset_opacity(model, adam)

        debug.check_step(pipe, it, metrics, model, dataset.model_path,
                         {"cam_idx": cam_idx, "active_sh_degree": active_sh})
        if it % 100 == 0:
            # the JAX loop's line, then this view's depth-prior term
            print(f"[{it}/{opt.iterations}] loss="
                  f"{float(metrics['loss']):.5f} depth="
                  f"{float(metrics['depth']):.5f}", flush=True)
        if it in test_iters or it == opt.iterations:
            for name, views in (("test", scene.getTestCameras()),
                                ("train", cams[:5])):
                stats = evaluate_cameras(model, views, bg, active_sh)
                if stats:
                    print(f"\n[ITER {it}] Evaluating {name}: "
                          f"{format_eval(stats)} ({model.num_points} "
                          f"Gaussians)", flush=True)
        if it in save_iters or it == opt.iterations:
            scene.gaussians = model
            scene.save(it)

    elapsed = time.time() - t0
    print(f"FSGS training took {elapsed:.1f}s for {opt.iterations} "
          f"iterations ({opt.iterations / max(elapsed, 1e-9):.2f} it/s)")
    print("FSGS counts: " + " ".join(f"{k}={v}" for k, v in counts.items()),
          flush=True)
    scene.gaussians = model
    return counts
