"""Host training loop for the 3DGS / LGDWT-GS family.

Counterpart of `sparse_view_3dgs_pack_tpu/train/loop.py:116-574` without
what exists for XLA's static shapes: no speculative compiler, no capacity
or pair buckets, no lagged pair-count readback. The loop serves the SIBR
remote viewer when one listens (`serve_viewer`), samples cameras without
replacement, evaluates the LR schedules, runs
`parallel/dp.py::dp_train_step` (one view, or one a rank over a data-
parallel group; on one view it is `train/step.py::train_step`), checks
the step when debugging is armed (`train/debug.py`), and fires the host
events: densify / clone / split / prune, opacity reset, SH-degree growth,
eval, save, checkpoint (`train/checkpoint.py`). In a data-parallel run
every rank draws the same cameras, background and densify draws (the
host RNGs seeded alike, the densify generator by the iteration), so the
replicas stay bitwise equal; rank 0 alone evaluates, logs and writes.
"""

from __future__ import annotations

import os
import random
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..losses.ssim import ssim as ssim_fn
from ..metrics.lpips import lpips as lpips_fn
from ..metrics.lpips import lpips_is_proxy
from ..parallel.dp import broadcast_state, dp_train_step
from ..renderer import render
from ..utils.general import get_expon_lr_func
from ..utils.image import psnr as psnr_fn
from ..utils.tracing import span
from ..viewer import network_gui
from . import checkpoint as ckpt
from . import debug
from .densify import densify_and_prune, reset_opacity
from .optim import (init_adam, init_exposure_adam, make_exposure_schedule,
                    make_lr_schedules)
from .step import CameraBank, StepConfig


def evaluate_cameras(model, cameras, bg, active_sh,
                     antialiasing=False) -> dict:
    """Mean PSNR / L1 / SSIM of inference renders over a camera list, and
    the VGG LPIPS when converted weights are installed: a proxy LPIPS never
    enters the in-training report (`loop.py:61-95`)."""
    if not cameras:
        return {}
    real_lpips = not lpips_is_proxy("vgg")
    psnrs, l1s, ssims, lpipss = [], [], [], []
    for cam in cameras:
        res = render(model, cam, bg, sh_degree_active=active_sh,
                     antialiasing=antialiasing)
        gt = torch.as_tensor(cam.image[..., :3], dtype=torch.float32,
                             device=res.render.device)
        psnrs.append(psnr_fn(res.render, gt))
        l1s.append((res.render - gt).abs().mean())
        ssims.append(ssim_fn(res.render, gt))
        if real_lpips:
            lpipss.append(lpips_fn(res.render, gt))
    stats = {"psnr": float(torch.stack(psnrs).mean()),
             "l1": float(torch.stack(l1s).mean()),
             "ssim": float(torch.stack(ssims).mean()),
             "n_views": len(cameras)}
    if real_lpips:
        stats["lpips"] = float(torch.stack(lpipss).mean())
    return stats


def format_eval(stats: dict) -> str:
    """One line: `PSNR 21.13 SSIM 0.7421 [LPIPS 0.3120]`."""
    line = (f"PSNR {stats.get('psnr', 0):.2f}"
            f" SSIM {stats.get('ssim', 0):.4f}")
    if "lpips" in stats:
        line += f" LPIPS {stats['lpips']:.4f}"
    return line


class Trainer:
    """Owns the model, optimizer states and schedules on one device.

    With a `group` (`parallel/dp.py::DPGroup`) each step trains on one view
    per rank; rank 0's initial state is broadcast to the others."""

    def __init__(self, scene, opt, pipe, dataset_args, group=None):
        self.dp_n = group.world_size if group is not None else 1
        self.group = group
        self.rank = group.rank if group is not None else 0
        self.scene = scene
        self.opt = opt
        self.pipe = pipe
        self.dataset_args = dataset_args

        self.model = scene.gaussians
        self.device = self.model.xyz.device
        cams = scene.getTrainCameras()
        self.width = cams[0].width
        self.height = cams[0].height
        self.channels = 3
        self.bank = CameraBank.from_cameras(cams, self.channels, self.device)

        self.adam = init_adam(self.model.params())
        self.exp_adam = init_exposure_adam(self.model.exposure)
        self.dwt_running_mean = torch.ones((), device=self.device)
        self.iteration = 0
        self.start_iteration = 0      # where this run began (a checkpoint's)
        self.active_sh_degree = 0
        self.lr_scheds = make_lr_schedules(opt, scene.cameras_extent)
        self.exposure_sched = make_exposure_schedule(opt)
        self.depth_weight_sched = get_expon_lr_func(
            opt.depth_l1_weight_init, opt.depth_l1_weight_final,
            max_steps=opt.iterations)
        self.background = torch.tensor(
            [1.0, 1.0, 1.0] if dataset_args.white_background
            else [0.0, 0.0, 0.0], device=self.device)[:self.channels]
        self.cfg = self._config()
        self.viewpoint_stack = []
        self._broadcast()

    def _broadcast(self):
        broadcast_state(self.group, self.model, self.adam, self.exp_adam,
                        self.dwt_running_mean)

    def _config(self) -> StepConfig:
        o = self.opt
        return StepConfig(
            width=self.width, height=self.height, channels=self.channels,
            sh_degree=self.dataset_args.sh_degree,
            lambda_dssim=o.lambda_dssim,
            antialiasing=getattr(self.pipe, "antialiasing", False),
            train_test_exp=getattr(self.dataset_args, "train_test_exp", False),
            sparse_adam=(o.optimizer_type == "sparse_adam"),
            dwt_enable=getattr(o, "dwt_enable", False),
            dwt_weights=tuple(getattr(o, f"dwt_{k}_weight", 0.0) for k in (
                "ll1", "lh1", "hl1", "hh1", "ll2", "lh2", "hl2", "hh2")),
            patch_dwt_enable=getattr(o, "patch_dwt_enable", False),
            patch_dwt_weight=getattr(o, "patch_dwt_weight", 0.1),
            patch_size=getattr(o, "patch_size", 128),
            patch_percentile=getattr(o, "patch_percentile", 0.2),
            patch_dwt_lh1_weight=getattr(o, "patch_dwt_lh1_weight", 1.0),
            patch_dwt_hl1_weight=getattr(o, "patch_dwt_hl1_weight", 1.0))

    def serve_viewer(self):
        """Poll the SIBR remote-viewer socket once (reference polls every
        iteration, `LGDWT-GS/train.py:82-95`; JAX `loop.py:359-376`): each
        requested frame is an inference render of the current model. A
        message with train=False and keep_alive holds training here,
        serving frames, until the viewer resumes it. No-op when no
        listener."""
        if network_gui.listener is None:
            return

        def render_fn(cam, scaling_modifier):
            return render(self.model, cam, self.background,
                          sh_degree_active=self.active_sh_degree,
                          scaling_modifier=float(scaling_modifier)).render

        network_gui.serve_once(render_fn, self.dataset_args.source_path)

    def pick_camera(self) -> int:
        if not self.viewpoint_stack:
            self.viewpoint_stack = list(range(len(self.scene.getTrainCameras())))
        return self.viewpoint_stack.pop(
            random.randint(0, len(self.viewpoint_stack) - 1))

    def step(self) -> dict:
        """One training step, under the "host/step" span: "host/prepare"
        (the viewer, the schedules, the background, the view), the step
        of `parallel/dp.py`, then "host/finish" (the debug check and the
        densification events)."""
        with span("host/step"):
            with span("host/prepare"):
                self.iteration += 1
                it = self.iteration
                o = self.opt
                self.serve_viewer()
                if (it % 1000 == 0
                        and self.active_sh_degree < self.dataset_args.sh_degree):
                    self.active_sh_degree += 1
                lrs = {k: f(it) for k, f in self.lr_scheds.items()}
                random_bg = getattr(o, "random_background", False)
                with span("sync/background", on=random_bg):
                    bg = (torch.as_tensor(np.random.random(self.channels),
                                          dtype=torch.float32,
                                          device=self.device)
                          if random_bg else self.background)
                # every rank draws all dp_n views and takes its own
                cams = [self.pick_camera() for _ in range(self.dp_n)]
                exposure_lr = self.exposure_sched(it)
                depth_weight = self.depth_weight_sched(it)
            metrics, self.dwt_running_mean = dp_train_step(
                self.model, self.adam, self.exp_adam, self.dwt_running_mean,
                self.bank, cams[self.rank:self.rank + 1], self.dp_n,
                lrs, exposure_lr, depth_weight, self.active_sh_degree, bg,
                self.cfg, group=self.group)
            with span("host/finish"):
                self._finish(it, cams, metrics)
            return metrics

    def _finish(self, it: int, cams: list, metrics: dict) -> None:
        o = self.opt
        # snapshot on a non-finite loss (the reference's CHECK_CUDA dump);
        # every replica raises, rank 0 writes
        debug.check_step(self.pipe, it, metrics, self.model,
                         getattr(self.dataset_args, "model_path", "."),
                         {"cam_idx": cams[0] if self.dp_n == 1 else cams,
                          "active_sh_degree": self.active_sh_degree},
                         write=self.rank == 0)

        # densification events (reference train.py:265-276)
        if it < o.densify_until_iter:
            if it > o.densify_from_iter and it % o.densification_interval == 0:
                size_thr = 20 if it > o.opacity_reset_interval else 0
                gen = torch.Generator(device=self.device).manual_seed(it)
                densify_and_prune(
                    self.model, self.adam, o.densify_grad_threshold, 0.005,
                    self.scene.cameras_extent, max_screen_size=size_thr,
                    percent_dense=o.percent_dense, generator=gen)
            if (it % o.opacity_reset_interval == 0
                    or (self.dataset_args.white_background
                        and it == o.densify_from_iter)):
                reset_opacity(self.model, self.adam)

    def evaluate(self, cameras) -> dict:
        return evaluate_cameras(self.model, cameras, self.background,
                                self.active_sh_degree,
                                getattr(self.pipe, "antialiasing", False))

    def save_scene(self, iteration: int):
        self.scene.gaussians = self.model
        self.scene.save(iteration)

    def save_checkpoint(self, path: str):
        ckpt.save_checkpoint(path, self.model, self.adam, self.exp_adam,
                             self.dwt_running_mean, self.iteration)

    def restore_checkpoint(self, path: str):
        """Model, optimizer states, DWT running mean and iteration from a
        checkpoint of either package; the active SH degree follows the
        iteration (`loop.py:504-510`)."""
        c = ckpt.load_checkpoint(path, self.device)
        self.model = self.scene.gaussians = c.model
        self.adam, self.exp_adam = c.adam, c.exp_adam
        self.dwt_running_mean, self.iteration = c.dwt_running_mean, c.iteration
        self.start_iteration = c.iteration
        self.active_sh_degree = min(self.iteration // 1000,
                                    self.dataset_args.sh_degree)
        self._broadcast()


def simple_train(scene, opt, pipe, dataset_args, testing_iterations=(),
                 saving_iterations=(), checkpoint_iterations=(),
                 start_checkpoint: Optional[str] = None,
                 progress: Optional[Callable] = None, tb: bool = True,
                 group=None):
    """The training loop of `loop.py:513-574`: resumes from
    `start_checkpoint` when given, evaluates at `testing_iterations`,
    saves the PLY at `saving_iterations` and a checkpoint
    (`<model_path>/chkpnt<N>.npz`) at `checkpoint_iterations`. With a
    `group` (`Trainer`: one view a rank), only rank 0 evaluates, reports
    and writes."""
    from .logging import TrainReporter

    trainer = Trainer(scene, opt, pipe, dataset_args, group=group)
    main = trainer.rank == 0
    if start_checkpoint:
        trainer.restore_checkpoint(start_checkpoint)
        if main:
            print(f"Resumed from {start_checkpoint} "
                  f"(iteration {trainer.iteration})")
    reporter = TrainReporter(scene.model_path, enabled=tb and main)
    t0 = time.time()
    last = t0
    for it in range(trainer.iteration + 1, opt.iterations + 1):
        metrics = trainer.step()
        if not main:
            continue
        if progress and it % 10 == 0:
            progress(it, metrics)
        if it % 10 == 0:
            now = time.time()
            reporter.scalars(it, metrics)
            reporter.iter_time(it, (now - last) / 10)
            last = now
        if it in testing_iterations:
            cams = scene.getTestCameras() or scene.getTrainCameras()[:4]
            stats = trainer.evaluate(cams)
            print(f"\n[ITER {it}] Evaluating: {format_eval(stats)} "
                  f"({trainer.model.num_points} Gaussians)")
            if reporter.writer is not None:
                if getattr(opt, "dwt_enable", False):
                    res = render(trainer.model, cams[0], trainer.background,
                                 sh_degree_active=trainer.active_sh_degree)
                    reporter.wef_heatmaps(it, res.render, torch.as_tensor(
                        cams[0].image[..., :3], device=trainer.device))
                reporter.writer.add_scalar("test/psnr", stats["psnr"], it)
                reporter.writer.add_scalar("test/ssim", stats["ssim"], it)
                reporter.histogram(it, "scene/opacity_histogram",
                                   trainer.model.get_opacity().detach()
                                   .cpu().numpy())
                reporter.writer.add_scalar("scene/total_points",
                                           trainer.model.num_points, it)
        if it in saving_iterations:
            print(f"\n[ITER {it}] Saving Gaussians")
            trainer.save_scene(it)
        if it in checkpoint_iterations:
            print(f"\n[ITER {it}] Saving Checkpoint")
            trainer.save_checkpoint(
                os.path.join(scene.model_path, f"chkpnt{it}.npz"))
    reporter.close()
    return trainer, time.time() - t0
