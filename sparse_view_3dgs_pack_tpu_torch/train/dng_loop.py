"""DNGaussian training (reference `DNGaussian/train_llff.py:39-213`).

Counterpart of `sparse_view_3dgs_pack_tpu/train/dng_loop.py`, without the
capacity, pair-bucket and speculative-compile machinery of XLA's static
shapes. Each iteration runs three passes over one view, each its own
forward, backward and Adam step:
  1. hard depth: opacity fixed at 0.95, unit colours, scaling and rotation
     detached, so only the positions learn; patch-normalised margin MSE,
     local (×0.1) and global (×1), plus edge-aware smoothness (×0.1) after
     iteration 3000, against the mono-depth map (255 − the prior);
  2. soft depth (after `soft_depth_start`): the same losses with xyz,
     scaling and rotation detached, so the opacity and the neural field
     learn;
  3. photometric: L1 + λ·(1 − SSIM) + shape, scale and opacity penalties,
     the colours and opacities from the neural field (`use_neural` 1) or
     from the model's SH and opacity (`use_neural` 0).
Every 25 iterations after 2000, Gaussians within `near_range` of a camera
on the 120-frame spiral are pruned (`train_llff.py:206-213`).

Adam counts calls, as in JAX (`optim.py:60-85`): the Gaussians' AdamState
steps once per pass, each group with a zero gradient where the pass
detaches it (its moments still move it); the field's own AdamState steps
in the soft and photometric passes. One patch size per iteration, drawn
from 5–16, serves the four patch-norm losses (PARITY.md "Known
deviations"); it and the camera order come from a `random.Random(seed)`.
The passes run under the spans (`utils/tracing.py`)
"dng/hard", "dng/soft" and "dng/photo".
"""

from __future__ import annotations

import os
import random
import time
from typing import NamedTuple

import numpy as np
import torch

from ..depth.estimator import get_depth_estimator
from ..losses.dng import (loss_depth_smoothness, patch_norm_mse_loss,
                          patch_norm_mse_loss_global)
from ..losses.photometric import l1_loss
from ..losses.ssim import ssim
from ..models.gaussians import GaussianModel
from ..models.neural_field import (NeuralField, NeuralFieldConfig,
                                   gaussian_outputs, save_neural_npz)
from ..renderer import render, render_core, render_neural
from ..scene import Scene
from ..utils.image import psnr
from ..utils.pose_utils import generate_spiral_path
from ..utils.tracing import span
from . import debug
from .densify import add_densification_stats, densify_and_prune, prune_only
from .loop import format_eval
from .optim import (AdamState, adam_update, grads_or_zeros, init_adam,
                    make_lr_schedules)
from .step import CameraBank, sh_band_mask

# The JAX loop reads `opt.neural_grid` / `opt.neural_net`, which config.py
# never defines, so these constants are its LRs; `neural_*_lr_init/final`
# go unused (ROADMAP Queue 3, documented JAX behaviour).
NEURAL_GRID_LR, NEURAL_NET_LR = 5e-3, 5e-4
# the prune's opacity threshold (JAX `getattr(opt, "prune_threshold", 0.01)`)
MIN_OPACITY = 0.01
HARD_OPACITY = 0.95
# the patch size of an iteration: MIN_PATCH + an index drawn from 0..11
MIN_PATCH = 5
SMOOTH_FROM_ITER, SMOOTH_WEIGHT = 3000, 0.1
NEAR_PRUNE_FROM_ITER, NEAR_PRUNE_EVERY = 2000, 25
SPIRAL_FRAMES = 120


class DNGConfig(NamedTuple):
    width: int
    height: int
    sh_degree: int
    lambda_dssim: float = 0.2
    error_tolerance: float = 0.2
    shape_pena: float = 0.001
    scale_pena: float = 0.001
    opa_pena: float = 0.01
    use_neural: bool = True
    use_smooth: bool = False
    use_soft: bool = False
    use_mask: bool = False   # DTU: mask the photometric loss


def neural_lrs(field: NeuralField, grid_lr: float = NEURAL_GRID_LR,
               net_lr: float = NEURAL_NET_LR) -> dict:
    """name → lr: the table at the grid LR, the MLPs at the net LR,
    coord_center 0 (reference `GridRenderer.get_params`,
    `neural_renderer.py:126-134`; JAX `neural_lr_tree`)."""
    return {name: (grid_lr if name == "encoder" else
                   0.0 if name == "coord_center" else net_lr)
            for name in field.params()}


def _depth_losses(depth, depth_mono, image_like, patch_idx: int,
                  cfg: DNGConfig) -> torch.Tensor:
    """Local (×0.1) and global patch-norm losses at the patch size
    MIN_PATCH + patch_idx, plus the smoothness term when on."""
    ps = MIN_PATCH + patch_idx
    loss = (0.1 * patch_norm_mse_loss(depth, depth_mono, ps,
                                      cfg.error_tolerance)
            + patch_norm_mse_loss_global(depth, depth_mono, ps,
                                         cfg.error_tolerance))
    if cfg.use_smooth:
        loss = loss + SMOOTH_WEIGHT * loss_depth_smoothness(depth,
                                                            image_like)
    return loss


def _render(p: dict, cam, bg, cfg: DNGConfig, color=None, opacity=None):
    """The training render (16×16 tiles, differentiable rasterizer)."""
    return render_core(p, torch.eye(3, 4, device=p["xyz"].device), cam,
                       cfg.width, cfg.height, bg,
                       sh_degree_active=cfg.sh_degree, inference=False,
                       override_color=color, opacity_override=opacity)


class _View(NamedTuple):
    cam: object
    gt: torch.Tensor
    depth_mono: torch.Tensor
    has_depth: torch.Tensor
    alpha_mask: torch.Tensor


def _banded(model: GaussianModel, band: torch.Tensor, frozen=()) -> tuple:
    """(the parameters, a copy with the SH bands above the active degree
    masked out and the `frozen` groups detached), gradients cleared."""
    params = model.params()
    for t in params.values():
        t.grad = None
    p = dict(params)
    p["features_rest"] = params["features_rest"] * band[1:][None]
    for k in frozen:
        p[k] = p[k].detach()
    return params, p


def hard_pass(model, adam, view: _View, patch_idx, lrs, band, bg,
              cfg: DNGConfig) -> torch.Tensor:
    """Pass 1: the depth losses of a render at opacity 0.95 with unit
    colours; only xyz gets a gradient. One Adam step of every group."""
    with span("dng/hard"):
        params, p = _banded(model, band, ("scaling", "rotation"))
        n = model.num_points
        res = _render(p, view.cam, bg, cfg,
                      torch.ones((n, 3), device=bg.device),
                      torch.full((n,), HARD_OPACITY, device=bg.device))
        loss = view.has_depth * _depth_losses(
            res.expected_depth, view.depth_mono, view.gt, patch_idx, cfg)
        loss.backward()
        adam_update(model.params(), grads_or_zeros(params), adam, lrs)
    return loss.detach()


def soft_pass(model, field, adam, field_adam, view: _View, patch_idx, lrs,
              field_lrs, band, bg, cfg: DNGConfig) -> torch.Tensor:
    """Pass 2: the depth losses with the geometry detached; the opacity
    (through the field when `use_neural`) gets the gradient. One Adam step
    of every group and of the field."""
    with span("dng/soft"):
        params, p = _banded(model, band, ("xyz", "scaling", "rotation"))
        fparams = field.params()
        for t in fparams.values():
            t.grad = None
        color = opacity = None
        if cfg.use_neural:
            color, opacity = gaussian_outputs(field, p["xyz"], p["opacity"],
                                              view.cam.cam_center)
        res = _render(p, view.cam, bg, cfg, color, opacity)
        loss = view.has_depth * _depth_losses(
            res.expected_depth, view.depth_mono, view.gt, patch_idx, cfg)
        loss.backward()
        adam_update(model.params(), grads_or_zeros(params), adam, lrs)
        adam_update(fparams, grads_or_zeros(fparams), field_adam, field_lrs)
    return loss.detach()


def photo_pass(model, field, adam, field_adam, view: _View, lrs, field_lrs,
               band, bg, cfg: DNGConfig) -> dict:
    """Pass 3: L1 + SSIM (masked for DTU) + the shape, scale and opacity
    penalties; the field is evaluated twice, for the render and for the
    opacity penalty, both with gradient (JAX `dng_loop.py:209-241`). One
    Adam step of every group and of the field, then the densification
    statistics."""
    with span("dng/photo"):
        params, p = _banded(model, band)
        fparams = field.params()
        for t in fparams.values():
            t.grad = None
        color = opacity = None
        if cfg.use_neural:
            color, opacity = gaussian_outputs(field, p["xyz"], p["opacity"],
                                              view.cam.cam_center)
        res = _render(p, view.cam, bg, cfg, color, opacity)
        image, gt = res.render, view.gt
        if cfg.use_mask:
            image, gt = image * view.alpha_mask, gt * view.alpha_mask
        ll1 = l1_loss(image, gt)
        loss = ll1 + cfg.lambda_dssim * (1.0 - ssim(image, gt))

        n = float(model.num_points)
        scaling = torch.exp(params["scaling"])
        smax = scaling.max(dim=-1).values
        smin = scaling.min(dim=-1).values
        shape_pena = torch.sum(smax / torch.clamp(smin, min=1e-12)) / n
        scale_pena = torch.sum(smax ** 2) / n
        if cfg.use_neural:
            _, opac = gaussian_outputs(field, params["xyz"],
                                       params["opacity"],
                                       view.cam.cam_center)
        else:
            opac = torch.sigmoid(params["opacity"][:, 0])
        hi = (opac > 0.2).to(torch.float32)
        lo = (opac < 0.2).to(torch.float32)
        opa_pena = (1.0 - torch.sum(opac ** 2 * hi)
                    / torch.clamp(hi.sum(), min=1.0)
                    + torch.sum((1 - opac) ** 2 * lo)
                    / torch.clamp(lo.sum(), min=1.0))
        loss = loss + (cfg.shape_pena * shape_pena
                       + cfg.scale_pena * scale_pena
                       + cfg.opa_pena * opa_pena)
        loss.backward()
        adam_update(model.params(), grads_or_zeros(params), adam, lrs)
        adam_update(fparams, grads_or_zeros(fparams), field_adam, field_lrs)
        vs = res.viewspace_points
        add_densification_stats(
            model, vs.grad if vs.grad is not None else torch.zeros_like(vs),
            res.radii, cfg.width, cfg.height)
    return {"loss": loss.detach(), "l1": ll1.detach(),
            "n_pairs": res.n_pairs}


def bank_view(bank: CameraBank, cam_idx: int) -> _View:
    """One training view of the bank; its inverse-depth slot holds the
    mono-depth map 255 − prior."""
    return _View(bank.camera(cam_idx), bank.gt[cam_idx],
                 bank.invdepth[cam_idx], bank.has_depth[cam_idx],
                 bank.alpha_mask[cam_idx])


def dng_step(model: GaussianModel, field: NeuralField, adam: AdamState,
             field_adam: AdamState, bank: CameraBank, cam_idx: int,
             patch_idx: int, lrs: dict, field_lrs: dict, active_degree: int,
             bg: torch.Tensor, cfg: DNGConfig) -> dict:
    """One DNGaussian iteration on view `cam_idx` (JAX `dng_step`): the
    hard pass, the soft pass when `cfg.use_soft`, the photometric pass.
    Updates the model, the field and both Adam states in place; returns
    the photometric pass's metrics."""
    view = bank_view(bank, cam_idx)
    band = sh_band_mask(active_degree, cfg.sh_degree, bg.device)
    hard_pass(model, adam, view, patch_idx, lrs, band, bg, cfg)
    if cfg.use_soft:
        soft_pass(model, field, adam, field_adam, view, patch_idx, lrs,
                  field_lrs, band, bg, cfg)
    return photo_pass(model, field, adam, field_adam, view, lrs, field_lrs,
                      band, bg, cfg)


@torch.no_grad()
def dng_eval_view(model: GaussianModel, field: NeuralField, cam, bg,
                  cfg: DNGConfig):
    """The inference render of one view the way the model trains: through
    the field when `use_neural`, else from the SH at the full degree (JAX
    `_dng_eval_view`)."""
    if cfg.use_neural:
        return render_neural(model, cam, bg, field,
                             sh_degree_active=cfg.sh_degree)
    return render(model, cam, bg, sh_degree_active=cfg.sh_degree)


@torch.no_grad()
def _dng_evaluate(model: GaussianModel, field: NeuralField, cameras, bg,
                  cfg: DNGConfig) -> dict:
    """Mean PSNR / L1 / SSIM over a camera list (reference
    training_report)."""
    if not cameras:
        return {}
    psnrs, l1s, ssims = [], [], []
    for cam in cameras:
        image = dng_eval_view(model, field, cam, bg, cfg).render
        gt = torch.as_tensor(cam.image[..., :3], dtype=torch.float32,
                             device=image.device)
        psnrs.append(psnr(image, gt))
        l1s.append((image - gt).abs().mean())
        ssims.append(ssim(image, gt))
    return {"psnr": float(torch.stack(psnrs).mean()),
            "l1": float(torch.stack(l1s).mean()),
            "ssim": float(torch.stack(ssims).mean()),
            "n_views": len(cameras)}


@torch.no_grad()
def near_range_mask(xyz: torch.Tensor, centers: torch.Tensor,
                    near_range: float) -> torch.Tensor:
    """(N,) bool: within `near_range` of any of the (M, 3) `centers`."""
    d = torch.linalg.vector_norm(xyz[:, None, :] - centers[None, :, :],
                                 dim=-1)
    return (d < near_range).any(dim=1)


def train_dngaussian(dataset, opt, pipe, args, device,
                     near_range: float = 0.0,
                     dataset_type: str = "llff") -> dict:
    """The DNGaussian training loop on `device`. dataset_type: `llff`,
    `dtu` (black background, masked photometric loss, reference
    `train_dtu.py`) or `blender` (white background). Returns its counts:
    soft passes, near-range prunes and the points they removed, the peak
    Gaussian count."""
    scene = Scene(dataset, sh_degree=dataset.sh_degree, device=device)
    cams = scene.getTrainCameras()
    W, H = cams[0].width, cams[0].height

    estimator = get_depth_estimator(getattr(args, "depth_estimator", "auto"),
                                    dataset.source_path)
    for c in cams:
        d = estimator.depth_for_camera(c)
        if d is not None:
            c.invdepthmap = (255.0 - np.asarray(d)).astype(np.float32)
            c.depth_mask = np.ones_like(c.invdepthmap)
            c.depth_reliable = True
    bank = CameraBank.from_cameras(cams, 3, device)

    model = scene.gaussians
    adam = init_adam(model.params())
    field = NeuralField(
        NeuralFieldConfig(bound=max(scene.cameras_extent, 1.0)),
        torch.Generator(device=device).manual_seed(0))
    field_adam = init_adam(field.params())
    field_lrs = neural_lrs(field)
    lr_scheds = make_lr_schedules(opt, scene.cameras_extent)

    white = dataset.white_background or dataset_type == "blender"
    bg = torch.tensor([1.0, 1.0, 1.0] if white else [0.0, 0.0, 0.0],
                      device=device)
    spiral = torch.tensor(np.stack([c.camera_center for c in
                                    generate_spiral_path(cams,
                                                         SPIRAL_FRAMES)]),
                          device=device)
    use_neural = bool(getattr(opt, "use_neural", 1))
    rng = random.Random(getattr(args, "seed", 0))

    counts = dict(soft_passes=0, near_prunes=0, near_pruned=0,
                  peak_gaussians=model.num_points)
    active_sh = 0
    viewpoint_stack = []
    save_iters = set(args.save_iterations)
    test_iters = set(getattr(args, "test_iterations", None) or [])
    t0 = time.time()
    for it in range(1, opt.iterations + 1):
        if it % 1000 == 0 and active_sh < dataset.sh_degree:
            active_sh += 1
        if not viewpoint_stack:
            viewpoint_stack = list(range(len(cams)))
        cam_idx = viewpoint_stack.pop(rng.randint(0,
                                                  len(viewpoint_stack) - 1))
        patch_idx = rng.randint(0, 11)
        cfg = DNGConfig(
            width=W, height=H, sh_degree=dataset.sh_degree,
            lambda_dssim=opt.lambda_dssim,
            error_tolerance=opt.error_tolerance, shape_pena=opt.shape_pena,
            scale_pena=opt.scale_pena, opa_pena=opt.opa_pena,
            use_neural=use_neural,
            use_mask=(dataset_type == "dtu"),
            use_smooth=(it > SMOOTH_FROM_ITER),
            use_soft=(it > opt.soft_depth_start))
        lrs = {k: f(it) for k, f in lr_scheds.items()}
        metrics = dng_step(model, field, adam, field_adam, bank, cam_idx,
                           patch_idx, lrs, field_lrs, active_sh, bg, cfg)
        counts["soft_passes"] += int(cfg.use_soft)

        if (opt.densify_from_iter < it < opt.densify_until_iter
                and it % opt.densification_interval == 0):
            densify_and_prune(
                model, adam, opt.densify_grad_threshold, MIN_OPACITY,
                scene.cameras_extent, max_screen_size=0,
                percent_dense=opt.percent_dense,
                generator=torch.Generator(device=device).manual_seed(it))
            counts["peak_gaussians"] = max(counts["peak_gaussians"],
                                           model.num_points)

        if (near_range > 0 and it > NEAR_PRUNE_FROM_ITER
                and (it - 1) % NEAR_PRUNE_EVERY == 0):
            counts["near_pruned"] += prune_only(
                model, adam, near_range_mask(model.xyz.detach(), spiral,
                                             near_range))
            counts["near_prunes"] += 1

        debug.check_step(pipe, it, metrics, model, dataset.model_path,
                         {"cam_idx": cam_idx, "active_sh_degree": active_sh})
        if it % 100 == 0:
            print(f"[{it}/{opt.iterations}] loss="
                  f"{float(metrics['loss']):.5f}", flush=True)
        if it in test_iters or it == opt.iterations:
            stats = _dng_evaluate(model, field, scene.getTestCameras(), bg,
                                  cfg)
            if stats:
                print(f"\n[ITER {it}] Evaluating test: {format_eval(stats)} "
                      f"({model.num_points} Gaussians)", flush=True)
        if it in save_iters or it == opt.iterations:
            scene.gaussians = model
            scene.save(it)
            if use_neural:
                # colour and opacity live in the field: the PLY alone does
                # not reproduce a render (reference `train_llff.py:232-235`)
                save_neural_npz(os.path.join(
                    dataset.model_path, "point_cloud", f"iteration_{it}",
                    "neural_renderer.npz"), field)

    elapsed = time.time() - t0
    print(f"DNGaussian training took {elapsed:.1f}s for {opt.iterations} "
          f"iterations ({opt.iterations / max(elapsed, 1e-9):.2f} it/s)")
    print("DNG counts: " + " ".join(f"{k}={v}" for k, v in counts.items()),
          flush=True)
    scene.gaussians = model
    return counts
