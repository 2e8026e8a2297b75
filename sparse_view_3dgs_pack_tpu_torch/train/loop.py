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
`StepTrainer` holds what the trainers of every method share (FSGS's,
DNGaussian's and mult-dwtgs' too), and `drive` is those three CLI loops.
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
from .step import CameraBank, step_config

# the 3DGS prune threshold and the screen-size limit after the first
# opacity reset (reference `train.py:265-276`)
MIN_OPACITY = 0.005
MAX_SCREEN_SIZE = 20


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


class StepTrainer:
    """What every method's trainer holds on the model's device, and the
    decisions their steps share. `scene` has `gaussians`,
    `getTrainCameras()` and `cameras_extent`; `dataset_args` gives
    `sh_degree` (and `model_path` for the debug snapshot); `rng` draws the
    views (the `random` module, or a seeded `random.Random`); `white`
    trains on a white background."""

    def __init__(self, scene, opt, pipe, dataset_args, rng, white: bool):
        self.scene, self.opt, self.pipe = scene, opt, pipe
        self.dataset_args = dataset_args
        self.rng = rng
        self.model = scene.gaussians
        self.device = self.model.xyz.device
        cams = scene.getTrainCameras()
        self.width, self.height = cams[0].width, cams[0].height
        self.n_views = len(cams)
        self.sh_degree = dataset_args.sh_degree
        self.bank = CameraBank.from_cameras(cams, 3, self.device)
        self.adam = init_adam(self.model.params())
        self.lr_scheds = make_lr_schedules(opt, scene.cameras_extent)
        self.background = torch.tensor(
            [1.0, 1.0, 1.0] if white else [0.0, 0.0, 0.0],
            device=self.device)
        self.iteration = 0
        self.active_sh_degree = 0
        self.viewpoint_stack = []
        self.cam_idx = None           # the last step's view

    def grow_sh(self, every: int) -> None:
        """One SH band more every `every` iterations, up to the model's."""
        if (self.iteration % every == 0
                and self.active_sh_degree < self.sh_degree):
            self.active_sh_degree += 1

    def lrs(self) -> dict:
        return {k: f(self.iteration) for k, f in self.lr_scheds.items()}

    def pick_camera(self) -> int:
        """A training view, drawn without replacement until all are
        taken."""
        if not self.viewpoint_stack:
            self.viewpoint_stack = list(range(self.n_views))
        return self.viewpoint_stack.pop(
            self.rng.randint(0, len(self.viewpoint_stack) - 1))

    def check(self, metrics: dict, write: bool = True) -> None:
        """The debug snapshot on a non-finite loss (`train/debug.py`)."""
        debug.check_step(self.pipe, self.iteration, metrics, self.model,
                         getattr(self.dataset_args, "model_path", "."),
                         {"cam_idx": self.cam_idx,
                          "active_sh_degree": self.active_sh_degree},
                         write=write)

    def densify_3dgs(self, reset_on_white: bool) -> None:
        """The 3DGS densify and opacity-reset schedule (reference
        `train.py:265-276`); with `reset_on_white`, a reset at
        `densify_from_iter` too."""
        it, o = self.iteration, self.opt
        if it >= o.densify_until_iter:
            return
        if it > o.densify_from_iter and it % o.densification_interval == 0:
            densify_and_prune(
                self.model, self.adam, o.densify_grad_threshold,
                MIN_OPACITY, self.scene.cameras_extent,
                max_screen_size=(MAX_SCREEN_SIZE
                                 if it > o.opacity_reset_interval else 0),
                percent_dense=o.percent_dense,
                generator=torch.Generator(device=self.device).manual_seed(it))
        if (it % o.opacity_reset_interval == 0
                or (reset_on_white and it == o.densify_from_iter)):
            reset_opacity(self.model, self.adam)

    def save_scene(self, iteration: int) -> None:
        self.scene.gaussians = self.model
        self.scene.save(iteration)


class Trainer(StepTrainer):
    """The 3DGS / LGDWT-GS trainer: `StepTrainer` with the exposure Adam,
    the DWT running mean and the step of `parallel/dp.py`.

    With a `group` (`parallel/dp.py::DPGroup`) each step trains on one view
    per rank; rank 0's initial state is broadcast to the others."""

    def __init__(self, scene, opt, pipe, dataset_args, group=None):
        super().__init__(scene, opt, pipe, dataset_args, random,
                         dataset_args.white_background)
        self.dp_n = group.world_size if group is not None else 1
        self.group = group
        self.rank = group.rank if group is not None else 0
        self.exp_adam = init_exposure_adam(self.model.exposure)
        self.dwt_running_mean = torch.ones((), device=self.device)
        self.start_iteration = 0      # where this run began (a checkpoint's)
        self.exposure_sched = make_exposure_schedule(opt)
        self.depth_weight_sched = get_expon_lr_func(
            opt.depth_l1_weight_init, opt.depth_l1_weight_final,
            max_steps=opt.iterations)
        self.cfg = step_config(opt, pipe, dataset_args, self.width,
                               self.height)
        self._broadcast()

    def _broadcast(self):
        broadcast_state(self.group, self.model, self.adam, self.exp_adam,
                        self.dwt_running_mean)

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

    def step(self) -> dict:
        """One training step, under the "host/step" span: "host/prepare"
        (the viewer, the schedules, the background, the view), the step
        of `parallel/dp.py`, then "host/finish" (the debug check and the
        densification events)."""
        with span("host/step"):
            with span("host/prepare"):
                self.iteration += 1
                it = self.iteration
                self.serve_viewer()
                self.grow_sh(1000)
                lrs = self.lrs()
                random_bg = getattr(self.opt, "random_background", False)
                with span("sync/background", on=random_bg):
                    bg = (torch.as_tensor(np.random.random(3),
                                          dtype=torch.float32,
                                          device=self.device)
                          if random_bg else self.background)
                # every rank draws all dp_n views and takes its own
                cams = [self.pick_camera() for _ in range(self.dp_n)]
                self.cam_idx = cams[0] if self.dp_n == 1 else cams
                exposure_lr = self.exposure_sched(it)
                depth_weight = self.depth_weight_sched(it)
            metrics, self.dwt_running_mean = dp_train_step(
                self.model, self.adam, self.exp_adam, self.dwt_running_mean,
                self.bank, cams[self.rank:self.rank + 1], self.dp_n,
                lrs, exposure_lr, depth_weight, self.active_sh_degree, bg,
                self.cfg, group=self.group)
            with span("host/finish"):
                # snapshot on a non-finite loss (the reference's CHECK_CUDA
                # dump); every replica raises, rank 0 writes
                self.check(metrics, write=self.rank == 0)
                self.densify_3dgs(
                    reset_on_white=self.dataset_args.white_background)
            return metrics

    def evaluate(self, cameras) -> dict:
        return evaluate_cameras(self.model, cameras, self.background,
                                self.active_sh_degree,
                                getattr(self.pipe, "antialiasing", False))

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
        self.active_sh_degree = min(self.iteration // 1000, self.sh_degree)
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


def timing_line(label: str, seconds: float, iterations: int) -> None:
    """`<label> took <s>s for <n> iterations (<it/s> it/s)`, the line
    `full_schedule.read_train_log` and the CLI tests read."""
    print(f"{label} took {seconds:.1f}s for {iterations} iterations "
          f"({iterations / max(seconds, 1e-9):.2f} it/s)", flush=True)


def drive(trainer: StepTrainer, iterations: int, save_iterations,
          test_iterations, evaluate: Optional[Callable], label: str,
          terms: tuple) -> None:
    """A method's CLI loop: `trainer.step()` `iterations` times; after a
    step, every 100 iterations the line `[it/N] loss=… <term>=…` (the
    metrics named in `terms` after the loss), at `test_iterations` and the
    last one line per (name, stats) that `evaluate()` returns, at
    `save_iterations` and the last the trainer's `save_scene`; then the
    timing line under `label`."""
    save, test = set(save_iterations), set(test_iterations)
    t0 = time.time()
    for it in range(1, iterations + 1):
        metrics = trainer.step()
        if it % 100 == 0:
            print(f"[{it}/{iterations}] " + " ".join(
                f"{k}={float(metrics[k]):.5f}" for k in ("loss", *terms)),
                flush=True)
        if evaluate is not None and (it in test or it == iterations):
            for name, stats in evaluate():
                if stats:
                    print(f"\n[ITER {it}] Evaluating {name}: "
                          f"{format_eval(stats)} "
                          f"({trainer.model.num_points} Gaussians)",
                          flush=True)
        if it in save or it == iterations:
            trainer.save_scene(it)
    timing_line(label, time.time() - t0, iterations)
