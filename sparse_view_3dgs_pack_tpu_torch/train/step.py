"""One training step of the 3DGS / LGDWT-GS family.

Counterpart of `sparse_view_3dgs_pack_tpu/train/step.py`. One step is one
forward (render → L1 + SSIM + Haar-DWT subbands + ELF-patch DWT + depth-L1),
one `backward()`, the per-group Adam and exposure Adam updates, and the
densification statistics (reference hot loop `LGDWT-GS/train.py:81-292`).
The JAX step is one jitted XLA program; here PyTorch runs eagerly and the
rasterizer's forward and backward are the hand-written kernels on a card.
The stages run under the spans of `utils/tracing.py` ("render/…" in
`renderer.render_core`, "step/losses", "step/backward" here, "step/adam"
and "step/stats" in `parallel/dp.py`), which a profile of the step reads
(`chip_smoke.py`); inside the backward, the losses' gradient runs under
"grad/losses", the rasterizer's under "grad/raster" and the projection's
under "grad/projection".
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..data.cameras import CameraParams
from ..device import resolve_device
from ..losses.depth import depth_l1_loss
from ..losses.dwt import (compute_elf_map, compute_patch_dwt_loss,
                          dwt_subband_loss)
from ..losses.photometric import l1_loss
from ..losses.ssim import ssim
from ..models.gaussians import GaussianModel
from ..renderer import render_core
from ..utils.tracing import grad_span, span
from .optim import AdamState, ExposureAdamState


class CameraBank(NamedTuple):
    """Every training view's camera and targets, on the device."""
    viewmat: torch.Tensor      # (N, 4, 4)
    full_proj: torch.Tensor    # (N, 4, 4)
    cam_center: torch.Tensor   # (N, 3)
    tan_fovx: list             # N floats
    tan_fovy: list
    gt: torch.Tensor           # (N, H, W, C)
    alpha_mask: torch.Tensor   # (N, H, W, 1)
    invdepth: torch.Tensor     # (N, H, W)
    depth_mask: torch.Tensor   # (N, H, W)
    has_depth: torch.Tensor    # (N,) float32
    nir: torch.Tensor          # (N, H, W), or (N, 1, 1) zeros if no view has one

    @classmethod
    def from_cameras(cls, cams, channels: int = 3, device="cuda"):
        device = resolve_device(device)
        H, W = cams[0].height, cams[0].width
        n = len(cams)
        gt = np.zeros((n, H, W, channels), np.float32)
        am = np.ones((n, H, W, 1), np.float32)
        inv = np.zeros((n, H, W), np.float32)
        dm = np.zeros((n, H, W), np.float32)
        hd = np.zeros((n,), np.float32)
        any_nir = any(c.nir is not None for c in cams)
        nir = np.zeros((n, H, W) if any_nir else (n, 1, 1), np.float32)
        vm = np.zeros((n, 4, 4), np.float32)
        fp = np.zeros((n, 4, 4), np.float32)
        cc = np.zeros((n, 3), np.float32)
        tx, ty = [], []
        for i, c in enumerate(cams):
            p = c.params()
            vm[i], fp[i], cc[i] = p.viewmat, p.full_proj, p.cam_center
            tx.append(float(p.tan_fovx))
            ty.append(float(p.tan_fovy))
            if c.image is not None:
                gt[i] = c.image[..., :channels]
            if c.alpha_mask is not None:
                am[i, ..., 0] = c.alpha_mask
            if c.invdepthmap is not None and c.depth_reliable:
                inv[i] = c.invdepthmap
                dm[i] = c.depth_mask if c.depth_mask is not None else 1.0
                hd[i] = 1.0
            if c.nir is not None:
                nir[i] = c.nir
        t = lambda a: torch.as_tensor(a, device=device)
        return cls(t(vm), t(fp), t(cc), tx, ty, t(gt), t(am), t(inv), t(dm),
                   t(hd), t(nir))

    def camera(self, idx: int) -> CameraParams:
        return CameraParams(viewmat=self.viewmat[idx],
                            full_proj=self.full_proj[idx],
                            cam_center=self.cam_center[idx],
                            tan_fovx=self.tan_fovx[idx],
                            tan_fovy=self.tan_fovy[idx])


class StepConfig(NamedTuple):
    width: int
    height: int
    channels: int = 3
    sh_degree: int = 3
    lambda_dssim: float = 0.2
    antialiasing: bool = False
    train_test_exp: bool = False
    sparse_adam: bool = False
    # LGDWT: global DWT subband loss
    dwt_enable: bool = False
    dwt_weights: tuple = (1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0)  # LL1..HH2
    # LGDWT: ELF patch DWT loss
    patch_dwt_enable: bool = False
    patch_dwt_weight: float = 0.1
    patch_size: int = 128
    patch_percentile: float = 0.2
    patch_dwt_lh1_weight: float = 1.0
    patch_dwt_hl1_weight: float = 1.0


_DWT_KEYS = ("ll1", "lh1", "hl1", "hh1", "ll2", "lh2", "hl2", "hh2")


def step_config(opt, pipe, dataset_args, width: int,
                height: int) -> StepConfig:
    """The step's configuration from the CLI's option groups (an option a
    group lacks takes the value of a run with the DWT losses off)."""
    return StepConfig(
        width=width, height=height, sh_degree=dataset_args.sh_degree,
        lambda_dssim=opt.lambda_dssim,
        antialiasing=getattr(pipe, "antialiasing", False),
        train_test_exp=getattr(dataset_args, "train_test_exp", False),
        sparse_adam=(opt.optimizer_type == "sparse_adam"),
        dwt_enable=getattr(opt, "dwt_enable", False),
        dwt_weights=tuple(getattr(opt, f"dwt_{k}_weight", 0.0)
                          for k in _DWT_KEYS),
        patch_dwt_enable=getattr(opt, "patch_dwt_enable", False),
        patch_dwt_weight=getattr(opt, "patch_dwt_weight", 0.1),
        patch_size=getattr(opt, "patch_size", 128),
        patch_percentile=getattr(opt, "patch_percentile", 0.2),
        patch_dwt_lh1_weight=getattr(opt, "patch_dwt_lh1_weight", 1.0),
        patch_dwt_hl1_weight=getattr(opt, "patch_dwt_hl1_weight", 1.0))


def sh_band_mask(active_degree: int, max_degree: int, device):
    """(K, 1) float mask of the SH coefficients of bands ≤ active_degree:
    the JAX step's way to the active degree, the reference the tests hold
    the port's active-degree renders to."""
    idx = torch.arange((max_degree + 1) ** 2, device=device)
    band = torch.floor(torch.sqrt(idx.to(torch.float32))).to(torch.int64)
    return (band <= active_degree).to(torch.float32)[:, None]


def photometric_losses(image, gt, dwt_running_mean: torch.Tensor,
                       cfg: StepConfig):
    """L1 + SSIM + the DWT subbands + the ELF-patch DWT of one masked
    render (`step.py:155-190`; the RGB pass of mult-dwtgs's step too).
    Returns (loss, metrics, new_running); the DWT scale is the running
    mean of base/dwt with its stop-gradients (`step.py:170-175`)."""
    ll1 = l1_loss(image, gt)
    ssim_value = ssim(image, gt)
    base = (1.0 - cfg.lambda_dssim) * ll1 + cfg.lambda_dssim * (
        1.0 - ssim_value)
    metrics = {"l1": ll1.detach(), "ssim": ssim_value.detach()}

    loss = base
    new_running = dwt_running_mean
    if cfg.dwt_enable:
        weights = {k + "_weight": w
                   for k, w in zip(_DWT_KEYS, cfg.dwt_weights)}
        dwt_loss, _ = dwt_subband_loss(image, gt, weights)
        ratio = base.detach() / (dwt_loss.detach() + 1e-8)
        new_running = 0.95 * dwt_running_mean + 0.05 * ratio
        dwt_scale = torch.clamp(new_running, 0.1, 10.0)
        loss = loss + dwt_scale.detach() * dwt_loss
        metrics["dwt"] = dwt_loss.detach()
        metrics["dwt_scale"] = dwt_scale.detach()

    if cfg.patch_dwt_enable:
        elf = compute_elf_map(gt)
        patch_loss = compute_patch_dwt_loss(
            image, gt, elf, patch_size=cfg.patch_size,
            percentile=cfg.patch_percentile,
            lh1_weight=cfg.patch_dwt_lh1_weight,
            hl1_weight=cfg.patch_dwt_hl1_weight)
        loss = loss + cfg.patch_dwt_weight * patch_loss
        metrics["patch_dwt"] = patch_loss.detach()
    return loss, metrics, new_running


def view_losses(p: dict, exposure_mat, cam, gt, alpha_mask, mono_invdepth,
                depth_mask, has_depth, bg_color, depth_weight: float,
                dwt_running_mean: torch.Tensor, cfg: StepConfig,
                active_degree: int):
    """The full per-view training loss (`step.py:140-194`): the
    photometric losses plus depth-L1. The SH colour is evaluated to
    `active_degree`, which is what the JAX step's band mask gives: the
    masked coefficients add exactly 0 to the colour and take exactly 0
    gradient. Returns (loss, metrics, new_running, render result). The
    backward from the loss to the render's image and depth runs under
    "grad/losses"."""
    res = render_core(
        p, exposure_mat, cam, cfg.width, cfg.height, bg_color,
        sh_degree_active=min(active_degree, cfg.sh_degree),
        antialiasing=cfg.antialiasing,
        use_trained_exp=cfg.train_test_exp, inference=False)
    with span("step/losses"):
        g = grad_span("grad/losses")
        image, invdepth = g.inputs(res.render, res.depth)
        loss, metrics, new_running = photometric_losses(
            image * alpha_mask, gt, dwt_running_mean, cfg)
        metrics["n_pairs"] = res.n_pairs
        depth_term = depth_l1_loss(invdepth, mono_invdepth, depth_mask)
        (loss,) = g.outputs(loss + depth_weight * has_depth * depth_term)
        metrics["depth_l1"] = (depth_term * has_depth).detach()
        metrics["loss"] = loss.detach()
    return loss, metrics, new_running.detach(), res


class StepGrads(NamedTuple):
    loss: torch.Tensor
    metrics: dict
    grads: dict                  # name → gradient of each parameter
    exposure_grad: torch.Tensor  # (n_images, 3, 4)
    viewspace_grad: torch.Tensor  # (N, 2) d loss / d means2d (pixels)
    radii: torch.Tensor          # (N,) int32
    new_running: torch.Tensor    # () the DWT running mean


def loss_and_grads(model: GaussianModel, bank: CameraBank, cam_idx: int,
                   depth_weight: float, active_degree: int, bg_color,
                   dwt_running_mean: torch.Tensor, cfg: StepConfig,
                   loss_scale: float = 1.0) -> StepGrads:
    """Forward and `backward()` of one view: the loss and every gradient
    before the optimizer (what `jax.grad` of `step.py:213-229` gives).
    The gradients are those of `loss_scale` times the loss (the data-
    parallel step's 1/B, `parallel/dp.py`); the loss and metrics are the
    view's own."""
    with span("host/params"):
        exposure = model.exposure.detach().requires_grad_(True)
        params = model.params()
        exposure_mat = exposure[min(cam_idx, exposure.shape[0] - 1)]
        cam = bank.camera(cam_idx)
    loss, metrics, new_running, res = view_losses(
        params, exposure_mat, cam, bank.gt[cam_idx],
        bank.alpha_mask[cam_idx], bank.invdepth[cam_idx],
        bank.depth_mask[cam_idx], bank.has_depth[cam_idx], bg_color,
        depth_weight, dwt_running_mean, cfg, active_degree)
    for t in params.values():
        t.grad = None
    with span("step/backward"):
        (loss if loss_scale == 1.0 else loss * loss_scale).backward()
    grads = {k: (t.grad if t.grad is not None else torch.zeros_like(t))
             for k, t in params.items()}
    vs = res.viewspace_points
    return StepGrads(
        loss=loss.detach(), metrics=metrics, grads=grads,
        exposure_grad=(exposure.grad if exposure.grad is not None
                       else torch.zeros_like(exposure)),
        viewspace_grad=(vs.grad if vs.grad is not None
                        else torch.zeros_like(vs)),
        radii=res.radii, new_running=new_running)


def train_step(model: GaussianModel, adam: AdamState,
               exp_adam: ExposureAdamState, dwt_running_mean: torch.Tensor,
               bank: CameraBank, cam_idx: int, lrs: dict,
               exposure_lr: float, depth_weight: float, active_degree: int,
               bg_color, cfg: StepConfig):
    """One step: forward, backward, Adam + exposure Adam, densification
    statistics. Updates `model`, `adam`, `exp_adam` in place; returns
    (metrics, new DWT running mean). The data-parallel step of one view
    with no group (`parallel/dp.py::dp_train_step`)."""
    from ..parallel.dp import dp_train_step     # dp builds on this module
    return dp_train_step(model, adam, exp_adam, dwt_running_mean, bank,
                         [cam_idx], 1, lrs, exposure_lr, depth_weight,
                         active_degree, bg_color, cfg)
