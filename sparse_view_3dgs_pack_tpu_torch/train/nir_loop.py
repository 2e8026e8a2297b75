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

`NIRTrainer` holds the model, Adam, the camera bank (with the NIR images),
the DWT running mean and a seeded `random.Random` for the view draws; its
`step()` is one iteration (the SH schedule, the view draw, `nir_step`, the
3DGS densify and opacity-reset schedule, the debug check) under
"host/step", and `train_nir` is the CLI's loop around it (`loop.drive`).
"""

from __future__ import annotations

import random
from typing import NamedTuple

import torch

from ..losses.nir import combined_nir_loss
from ..models.gaussians import GaussianModel
from ..renderer import render_core
from ..scene import Scene
from ..utils.tracing import span
from .densify import add_densification_stats
from .loop import StepTrainer, drive
from .optim import AdamState, adam_update, cleared, grads_or_zeros
from .step import CameraBank, StepConfig, photometric_losses, step_config


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
    """One mult-dwtgs step on view `cam_idx` (JAX `nir_step`), the SH
    evaluated to `active_degree`. Updates the model and `adam` in place;
    returns (metrics, new DWT running mean)."""
    b = cfg.base
    device = bg.device
    params = cleared(model.params())
    cam = bank.camera(cam_idx)
    alpha_mask = bank.alpha_mask[cam_idx]
    degree = min(active_degree, b.sh_degree)
    with span("nir/rgb"):
        res = render_core(params, None, cam, b.width, b.height, bg,
                          sh_degree_active=degree, inference=False)
        loss, metrics, new_running = photometric_losses(
            res.render * alpha_mask, bank.gt[cam_idx], dwt_running_mean, b)
    with span("nir/nir"):
        nres = render_core(params, None, cam, b.width, b.height,
                           torch.zeros(1, device=device),
                           sh_degree_active=degree,
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
    return render_core(model.params(), None, camera.params(), camera.width,
                       camera.height, torch.zeros(1, device=model.xyz.device),
                       model.max_sh_degree,
                       override_color=nir_colors(model.params()),
                       inference=True).render[..., 0]


class NIRTrainer(StepTrainer):
    """mult-dwtgs's training state, stepped one iteration at a time (as
    `train/loop.py::Trainer` is for the main path). `scene` has
    `gaussians` (with the NIR albedo and gain), `getTrainCameras()` (a
    camera's `nir` its NIR image, or None) and `cameras_extent`;
    `dataset_args` gives `sh_degree` and `white_background`. `seed` seeds
    the view draws; `nir_weight` weighs the NIR loss."""

    def __init__(self, scene, opt, pipe, dataset_args, seed: int = 0,
                 nir_weight: float = 0.5):
        super().__init__(scene, opt, pipe, dataset_args,
                         random.Random(seed), dataset_args.white_background)
        self.cfg = NIRConfig(base=step_config(opt, pipe, dataset_args,
                                              self.width, self.height),
                             nir_weight=nir_weight)
        self.dwt_running_mean = torch.ones((), device=self.device)

    def step(self) -> dict:
        """One iteration, under the "host/step" span: the SH schedule, the
        view draw, `nir_step`, the densify and opacity-reset schedule (JAX
        `nir_loop.py:197-215`: no reset at `densify_from_iter` on a white
        background), the debug check. Returns `nir_step`'s metrics."""
        with span("host/step"):
            self.iteration += 1
            self.grow_sh(1000)
            self.cam_idx = self.pick_camera()
            metrics, self.dwt_running_mean = nir_step(
                self.model, self.adam, self.dwt_running_mean, self.bank,
                self.cam_idx, self.lrs(), self.active_sh_degree,
                self.background, self.cfg)
            self.densify_3dgs(reset_on_white=False)
            self.check(metrics)
            return metrics


def train_nir(dataset, opt, pipe, args, device) -> Scene:
    """The mult-dwtgs training loop on `device` (JAX `train_nir`): an
    `NIRTrainer` driven by `loop.drive` for `opt.iterations` steps, the
    NIR loss on its loss line; no evaluation and no checkpoint, as in
    JAX. Returns the scene, its model the trained one
    (the PLY holds no `nir_gain`)."""
    scene = Scene(dataset, sh_degree=dataset.sh_degree, device=device,
                  use_nir=True)
    cams = scene.getTrainCameras()
    n_nir = sum(c.nir is not None for c in cams)
    print(f"NIR images: {n_nir} of {len(cams)} training views from "
          f"<scene>/nir/", flush=True)
    trainer = NIRTrainer(scene, opt, pipe, dataset,
                         seed=getattr(args, "seed", 0),
                         nir_weight=getattr(args, "nir_weight", 0.5))

    drive(trainer, opt.iterations, args.save_iterations, (), None,
          "mult-dwtgs training", ("nir",))
    return scene
