"""mult-dwtgs: multispectral RGB+NIR training (reference
`LGDWT-GS/mult-dwtgs/train_nir.py:32-151`).

Counterpart of `sparse_view_3dgs_pack_tpu/train/nir_loop.py`, without the
capacity, pair-bucket and speculative-compile machinery of XLA's static
shapes. One step renders the view twice from the same Gaussians:
  1. RGB: the LGDWT losses (L1 + SSIM + the DWT subbands with the running
     ratio carry + the ELF-patch DWT) of the masked render;
  2. NIR: a one-channel render (C = 1) whose colour is each Gaussian's
     sigmoid(nir_albedo)·nir_gain on a black background, masked like the
     RGB image, under `nir_weight`·(L1 + 0.2·(1 − SSIM)) against the
     view's NIR image. The reference tiles the albedo to three channels
     for its three-channel rasterizer and keeps channel 0
     (`mult-dwtgs/gaussian_renderer/__init__.py:185-258`); the port's
     kernels render one channel.
then one backward and one Adam step over every group. The densification
statistics come from the RGB render's screen-space gradient only (JAX
passes the offset to the RGB pass alone, `nir_loop.py:93-97`). The passes
run under the spans (`utils/tracing.py`) "nir/rgb", "nir/nir",
"nir/backward", "nir/adam" and "nir/stats".
"""

from __future__ import annotations

import random
import time
from typing import NamedTuple

import torch

from ..losses.nir import combined_nir_loss
from ..models.gaussians import GaussianModel
from ..renderer import render_core
from ..scene import Scene
from ..utils.tracing import span
from . import debug
from .densify import add_densification_stats, densify_and_prune, reset_opacity
from .optim import (AdamState, adam_update, grads_or_zeros, init_adam,
                    make_lr_schedules)
from .step import CameraBank, StepConfig, photometric_losses, sh_band_mask

# the JAX loop's prune threshold and screen-size limit after the first
# opacity reset (`nir_loop.py:178-186`)
MIN_OPACITY = 0.005
MAX_SCREEN_SIZE = 20


class NIRConfig(NamedTuple):
    base: StepConfig
    nir_weight: float = 0.5


def nir_colors(params: dict) -> torch.Tensor:
    """(N, 1) the NIR pass's payload: sigmoid(nir_albedo)·nir_gain."""
    return torch.sigmoid(params["nir_albedo"]) * params["nir_gain"][0]


def nir_step(model: GaussianModel, adam: AdamState,
             dwt_running_mean: torch.Tensor, bank: CameraBank, cam_idx: int,
             lrs: dict, active_degree: int, bg: torch.Tensor,
             cfg: NIRConfig):
    """One mult-dwtgs step on view `cam_idx` (JAX `nir_step`). Updates the
    model and `adam` in place; returns (metrics, new DWT running mean)."""
    b = cfg.base
    device = bg.device
    params = model.params()
    for t in params.values():
        t.grad = None
    p = dict(params)
    band = sh_band_mask(active_degree, b.sh_degree, device)
    p["features_rest"] = params["features_rest"] * band[1:][None]
    cam = bank.camera(cam_idx)
    alpha_mask = bank.alpha_mask[cam_idx]
    eye = torch.eye(3, 4, device=device)
    with span("nir/rgb"):
        res = render_core(p, eye, cam, b.width, b.height, bg,
                          sh_degree_active=b.sh_degree, inference=False)
        loss, metrics, new_running = photometric_losses(
            res.render * alpha_mask, bank.gt[cam_idx], dwt_running_mean, b)
    with span("nir/nir"):
        nres = render_core(p, eye, cam, b.width, b.height,
                           torch.zeros(1, device=device),
                           sh_degree_active=b.sh_degree,
                           override_color=nir_colors(params),
                           inference=False)
        nir_pred = nres.render[..., 0] * alpha_mask[..., 0]
        nloss = combined_nir_loss(nir_pred, bank.nir[cam_idx])
        loss = loss + cfg.nir_weight * nloss
    with span("nir/backward"):
        loss.backward()
    with span("nir/adam"):
        adam_update(model.params(), grads_or_zeros(params), adam, lrs)
    with span("nir/stats"):
        vs = res.viewspace_points
        add_densification_stats(
            model, vs.grad if vs.grad is not None else torch.zeros_like(vs),
            res.radii, b.width, b.height)
    metrics.update(loss=loss.detach(), nir=nloss.detach(),
                   n_pairs=res.n_pairs)
    return metrics, new_running.detach()


@torch.no_grad()
def render_nir(model: GaussianModel, camera) -> torch.Tensor:
    """(H, W) inference render of `model`'s NIR band from `camera` (the
    reference's `render_nir`, channel 0 of its tiled render)."""
    device = model.xyz.device
    return render_core(model.params(), torch.eye(3, 4, device=device),
                       camera.params(), camera.width, camera.height,
                       torch.zeros(1, device=device),
                       model.max_sh_degree,
                       override_color=nir_colors(model.params()),
                       inference=True).render[..., 0]


def train_nir(dataset, opt, pipe, args, device) -> Scene:
    """The mult-dwtgs training loop on `device` (JAX `train_nir`): the
    3DGS densify / opacity-reset schedule, the debug snapshot, the PLY at
    the save iterations; no evaluation and no checkpoint, as in JAX.
    Returns the scene, its model the trained one (the PLY holds no
    `nir_gain`)."""
    scene = Scene(dataset, sh_degree=dataset.sh_degree, device=device,
                  use_nir=True)
    cams = scene.getTrainCameras()
    W, H = cams[0].width, cams[0].height
    n_nir = sum(c.nir is not None for c in cams)
    print(f"NIR images: {n_nir} of {len(cams)} training views from "
          f"<scene>/nir/", flush=True)
    bank = CameraBank.from_cameras(cams, 3, device)

    model = scene.gaussians
    adam = init_adam(model.params())
    lr_scheds = make_lr_schedules(opt, scene.cameras_extent)
    bg = torch.tensor([1.0, 1.0, 1.0] if dataset.white_background
                      else [0.0, 0.0, 0.0], device=device)
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
    cfg = NIRConfig(base=base, nir_weight=getattr(args, "nir_weight", 0.5))
    rng = random.Random(getattr(args, "seed", 0))

    running = torch.ones((), device=device)
    active_sh = 0
    viewpoint_stack = []
    save_iters = set(args.save_iterations)
    t0 = time.time()
    for it in range(1, opt.iterations + 1):
        if it % 1000 == 0 and active_sh < dataset.sh_degree:
            active_sh += 1
        if not viewpoint_stack:
            viewpoint_stack = list(range(len(cams)))
        cam_idx = viewpoint_stack.pop(rng.randint(0,
                                                  len(viewpoint_stack) - 1))
        lrs = {k: f(it) for k, f in lr_scheds.items()}
        metrics, running = nir_step(model, adam, running, bank, cam_idx,
                                    lrs, active_sh, bg, cfg)

        if it < opt.densify_until_iter:
            if (it > opt.densify_from_iter
                    and it % opt.densification_interval == 0):
                densify_and_prune(
                    model, adam, opt.densify_grad_threshold, MIN_OPACITY,
                    scene.cameras_extent,
                    max_screen_size=(MAX_SCREEN_SIZE
                                     if it > opt.opacity_reset_interval
                                     else 0),
                    percent_dense=opt.percent_dense,
                    generator=torch.Generator(device=device).manual_seed(it))
            if it % opt.opacity_reset_interval == 0:
                reset_opacity(model, adam)

        debug.check_step(pipe, it, metrics, model, dataset.model_path,
                         {"cam_idx": cam_idx, "active_sh_degree": active_sh})
        if it % 100 == 0:
            print(f"[{it}/{opt.iterations}] loss="
                  f"{float(metrics['loss']):.5f} "
                  f"nir={float(metrics['nir']):.5f}", flush=True)
        if it in save_iters or it == opt.iterations:
            scene.gaussians = model
            scene.save(it)

    elapsed = time.time() - t0
    print(f"mult-dwtgs training took {elapsed:.1f}s for {opt.iterations} "
          f"iterations ({opt.iterations / max(elapsed, 1e-9):.2f} it/s)",
          flush=True)
    scene.gaussians = model
    return scene
