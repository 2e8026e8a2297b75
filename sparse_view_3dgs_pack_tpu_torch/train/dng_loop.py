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

`DNGTrainer` holds the model, the field, both Adam states, the schedules,
the camera bank, the spiral and that `Random`; its `step()` is one
iteration (the SH schedule, the view and patch draws, `dng_step`, the
densify event, the near-range prune, the debug check), and
`train_dngaussian` is the CLI's loop around it (`loop.drive`). The passes
run under the spans (`utils/tracing.py`) "dng/hard", "dng/soft" and
"dng/photo"; inside them "step/depth_losses" (the hard and soft passes'
depth losses), "step/losses" (the photometric loss and the three
penalties), "step/backward", "step/adam" (the Gaussians' and the field's
Adam) and "step/stats"; the field's evaluations under "step/field" and
"grad/field" (`models/neural_field.py`); all of `DNGTrainer.step` under
"host/step".
"""

from __future__ import annotations

import os
import random
from typing import NamedTuple

import numpy as np
import torch

from ..depth.estimator import attach_priors, get_depth_estimator
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
from .densify import add_densification_stats, densify_and_prune, prune_only
from .loop import StepTrainer, drive
from .optim import (AdamState, adam_update, cleared, grads_or_zeros,
                    init_adam)
from .step import CameraBank

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


def _render(p: dict, cam, bg, cfg: DNGConfig, active_degree: int,
            color=None, opacity=None):
    """The training render (16×16 tiles, differentiable rasterizer), the
    SH evaluated to the active degree."""
    return render_core(p, None, cam, cfg.width, cfg.height, bg,
                       sh_degree_active=min(active_degree, cfg.sh_degree),
                       inference=False, override_color=color,
                       opacity_override=opacity)


class _View(NamedTuple):
    cam: object
    gt: torch.Tensor
    depth_mono: torch.Tensor
    has_depth: torch.Tensor
    alpha_mask: torch.Tensor


def _frozen(model: GaussianModel, frozen=()) -> tuple:
    """(the parameters, a copy with the `frozen` groups detached),
    gradients cleared."""
    params = cleared(model.params())
    p = dict(params)
    for k in frozen:
        p[k] = p[k].detach()
    return params, p


def hard_pass(model, adam, view: _View, patch_idx, lrs, active_degree, bg,
              cfg: DNGConfig) -> torch.Tensor:
    """Pass 1: the depth losses of a render at opacity 0.95 with unit
    colours; only xyz gets a gradient. One Adam step of every group."""
    with span("dng/hard"):
        params, p = _frozen(model, ("scaling", "rotation"))
        n = model.num_points
        res = _render(p, view.cam, bg, cfg, active_degree,
                      torch.ones((n, 3), device=bg.device),
                      torch.full((n,), HARD_OPACITY, device=bg.device))
        with span("step/depth_losses"):
            loss = view.has_depth * _depth_losses(
                res.expected_depth, view.depth_mono, view.gt, patch_idx, cfg)
        with span("step/backward"):
            loss.backward()
        with span("step/adam"):
            adam_update(model.params(), grads_or_zeros(params), adam, lrs)
    return loss.detach()


def soft_pass(model, field, adam, field_adam, view: _View, patch_idx, lrs,
              field_lrs, active_degree, bg, cfg: DNGConfig) -> torch.Tensor:
    """Pass 2: the depth losses with the geometry detached; the opacity
    (through the field when `use_neural`) gets the gradient. One Adam step
    of every group and of the field."""
    with span("dng/soft"):
        params, p = _frozen(model, ("xyz", "scaling", "rotation"))
        fparams = cleared(field.params())
        color = opacity = None
        if cfg.use_neural:
            color, opacity = gaussian_outputs(field, p["xyz"], p["opacity"],
                                              view.cam.cam_center)
        res = _render(p, view.cam, bg, cfg, active_degree, color,
                      opacity)
        with span("step/depth_losses"):
            loss = view.has_depth * _depth_losses(
                res.expected_depth, view.depth_mono, view.gt, patch_idx, cfg)
        with span("step/backward"):
            loss.backward()
        with span("step/adam"):
            adam_update(model.params(), grads_or_zeros(params), adam, lrs)
            adam_update(fparams, grads_or_zeros(fparams), field_adam,
                        field_lrs)
    return loss.detach()


def _photo_loss(image, view: _View, params: dict, field: NeuralField,
                cfg: DNGConfig) -> tuple:
    """(the photometric pass's loss, its L1): L1 + SSIM (masked for DTU)
    and the shape, scale and opacity penalties, the last from a second
    evaluation of the field at the unmasked parameters."""
    gt = view.gt
    if cfg.use_mask:
        image, gt = image * view.alpha_mask, gt * view.alpha_mask
    ll1 = l1_loss(image, gt)
    loss = ll1 + cfg.lambda_dssim * (1.0 - ssim(image, gt))

    n = float(params["xyz"].shape[0])
    scaling = torch.exp(params["scaling"])
    smax = scaling.max(dim=-1).values
    smin = scaling.min(dim=-1).values
    shape_pena = torch.sum(smax / torch.clamp(smin, min=1e-12)) / n
    scale_pena = torch.sum(smax ** 2) / n
    if cfg.use_neural:
        _, opac = gaussian_outputs(field, params["xyz"], params["opacity"],
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
    return loss, ll1


def photo_pass(model, field, adam, field_adam, view: _View, lrs, field_lrs,
               active_degree, bg, cfg: DNGConfig) -> dict:
    """Pass 3: L1 + SSIM (masked for DTU) + the shape, scale and opacity
    penalties; the field is evaluated twice, for the render and for the
    opacity penalty, both with gradient (JAX `dng_loop.py:209-241`). One
    Adam step of every group and of the field, then the densification
    statistics."""
    with span("dng/photo"):
        params, p = _frozen(model)
        fparams = cleared(field.params())
        color = opacity = None
        if cfg.use_neural:
            color, opacity = gaussian_outputs(field, p["xyz"], p["opacity"],
                                              view.cam.cam_center)
        res = _render(p, view.cam, bg, cfg, active_degree, color,
                      opacity)
        with span("step/losses"):
            loss, ll1 = _photo_loss(res.render, view, params, field, cfg)
        with span("step/backward"):
            loss.backward()
        with span("step/adam"):
            adam_update(model.params(), grads_or_zeros(params), adam, lrs)
            adam_update(fparams, grads_or_zeros(fparams), field_adam,
                        field_lrs)
        with span("step/stats"):
            vs = res.viewspace_points
            add_densification_stats(
                model, vs.grad if vs.grad is not None
                else torch.zeros_like(vs), res.radii, cfg.width, cfg.height)
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
    the photometric pass's metrics, with the hard pass's loss
    (`hard_loss`) and the soft pass's where it ran (`soft_loss`)."""
    view = bank_view(bank, cam_idx)
    hard = hard_pass(model, adam, view, patch_idx, lrs, active_degree, bg,
                     cfg)
    soft = None
    if cfg.use_soft:
        soft = soft_pass(model, field, adam, field_adam, view, patch_idx,
                         lrs, field_lrs, active_degree, bg, cfg)
    metrics = photo_pass(model, field, adam, field_adam, view, lrs,
                         field_lrs, active_degree, bg, cfg)
    metrics["hard_loss"] = hard
    if soft is not None:
        metrics["soft_loss"] = soft
    return metrics


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


class DNGTrainer(StepTrainer):
    """DNGaussian's training state on the model's device, stepped one
    iteration at a time (as `train/loop.py::Trainer` is for the main
    path). `scene` has `gaussians`, `getTrainCameras()` and
    `cameras_extent`; a camera whose `invdepthmap` is set (with
    `depth_reliable`) carries 255 − its depth prior; `dataset_args` gives
    `sh_degree` and `white_background`. `seed` seeds the camera order and
    the patch draws; `near_range` > 0 arms the spiral's near-range prune;
    `dataset_type` `blender` trains on white."""

    def __init__(self, scene, opt, pipe, dataset_args, seed: int = 0,
                 near_range: float = 0.0, dataset_type: str = "llff"):
        super().__init__(scene, opt, pipe, dataset_args, random.Random(seed),
                         dataset_args.white_background
                         or dataset_type == "blender")
        self.near_range, self.dataset_type = near_range, dataset_type
        self.field = NeuralField(
            NeuralFieldConfig(bound=max(scene.cameras_extent, 1.0)),
            torch.Generator(device=self.device).manual_seed(0))
        self.field_adam = init_adam(self.field.params())
        self.field_lrs = neural_lrs(self.field)
        self.spiral = torch.tensor(
            np.stack([c.camera_center for c in generate_spiral_path(
                scene.getTrainCameras(), SPIRAL_FRAMES)]),
            device=self.device)
        self.use_neural = bool(getattr(opt, "use_neural", 1))
        self.counts = dict(soft_passes=0, near_prunes=0, near_pruned=0,
                           peak_gaussians=self.model.num_points)
        # the last step's patch index and configuration
        self.patch_idx = None
        self.cfg = None

    def config(self, it: int) -> DNGConfig:
        o = self.opt
        return DNGConfig(
            width=self.width, height=self.height, sh_degree=self.sh_degree,
            lambda_dssim=o.lambda_dssim, error_tolerance=o.error_tolerance,
            shape_pena=o.shape_pena, scale_pena=o.scale_pena,
            opa_pena=o.opa_pena, use_neural=self.use_neural,
            use_mask=(self.dataset_type == "dtu"),
            use_smooth=(it > SMOOTH_FROM_ITER),
            use_soft=(it > o.soft_depth_start))

    def step(self) -> dict:
        """One iteration, under the "host/step" span: the SH schedule, the
        view and patch draws, `dng_step`, the densify event, the
        near-range prune and the debug check. Returns the photometric
        pass's metrics."""
        with span("host/step"):
            self.iteration += 1
            it, o, model = self.iteration, self.opt, self.model
            self.grow_sh(1000)
            self.cam_idx = self.pick_camera()
            self.patch_idx = self.rng.randint(0, 11)
            self.cfg = cfg = self.config(it)
            metrics = dng_step(model, self.field, self.adam, self.field_adam,
                               self.bank, self.cam_idx, self.patch_idx,
                               self.lrs(), self.field_lrs,
                               self.active_sh_degree, self.background, cfg)
            self.counts["soft_passes"] += int(cfg.use_soft)

            if (o.densify_from_iter < it < o.densify_until_iter
                    and it % o.densification_interval == 0):
                densify_and_prune(
                    model, self.adam, o.densify_grad_threshold, MIN_OPACITY,
                    self.scene.cameras_extent, max_screen_size=0,
                    percent_dense=o.percent_dense,
                    generator=torch.Generator(
                        device=self.device).manual_seed(it))
                self.counts["peak_gaussians"] = max(
                    self.counts["peak_gaussians"], model.num_points)

            if (self.near_range > 0 and it > NEAR_PRUNE_FROM_ITER
                    and (it - 1) % NEAR_PRUNE_EVERY == 0):
                self.counts["near_pruned"] += prune_only(
                    model, self.adam, near_range_mask(
                        model.xyz.detach(), self.spiral, self.near_range))
                self.counts["near_prunes"] += 1
            self.check(metrics)
            return metrics

    def save_scene(self, iteration: int) -> None:
        """The PLY and, with the field, `neural_renderer.npz` beside it:
        colour and opacity live in the field, so the PLY alone does not
        reproduce a render (reference `train_llff.py:232-235`)."""
        super().save_scene(iteration)
        if self.use_neural:
            save_neural_npz(os.path.join(
                self.dataset_args.model_path, "point_cloud",
                f"iteration_{iteration}", "neural_renderer.npz"), self.field)


def train_dngaussian(dataset, opt, pipe, args, device,
                     near_range: float = 0.0,
                     dataset_type: str = "llff") -> dict:
    """The DNGaussian training loop on `device`: a `DNGTrainer` driven by
    `loop.drive` for `opt.iterations` steps, evaluating the test views
    through the field. dataset_type: `llff`, `dtu` (black background,
    masked photometric loss, reference `train_dtu.py`) or `blender`
    (white background). Returns its counts: soft passes, near-range
    prunes and the points they removed, the peak Gaussian count."""
    scene = Scene(dataset, sh_degree=dataset.sh_degree, device=device)
    estimator = get_depth_estimator(getattr(args, "depth_estimator", "auto"),
                                    dataset.source_path)
    attach_priors(scene.getTrainCameras(), estimator, lambda d: 255.0 - d)
    trainer = DNGTrainer(scene, opt, pipe, dataset,
                         seed=getattr(args, "seed", 0),
                         near_range=near_range, dataset_type=dataset_type)

    def evaluate():
        return [("test", _dng_evaluate(trainer.model, trainer.field,
                                       scene.getTestCameras(),
                                       trainer.background, trainer.cfg))]
    drive(trainer, opt.iterations, args.save_iterations,
          getattr(args, "test_iterations", None) or (), evaluate,
          "DNGaussian training", ())
    counts = trainer.counts
    print("DNG counts: " + " ".join(f"{k}={v}" for k, v in counts.items()),
          flush=True)
    return counts
