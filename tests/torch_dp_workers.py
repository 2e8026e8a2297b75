"""Rank functions for the port's data-parallel tests
(`tests/test_torch_parallel.py`, `tests/test_torch_train_cli.py`).

`parallel/dp.py::launch` runs each in spawned processes, which import this
module by name: it imports torch and the port only (no jax), and writes
what a rank ends with to `<out_dir>/rank<r>.npz` for the test to read.
"""

import os
from argparse import ArgumentParser, Namespace

import numpy as np
import torch

from sparse_view_3dgs_pack_tpu_torch import testing
from sparse_view_3dgs_pack_tpu_torch.models import gaussians as gm
from sparse_view_3dgs_pack_tpu_torch.parallel import dp
from sparse_view_3dgs_pack_tpu_torch.train import optim, step


def state_arrays(model, adam, exp_adam, running) -> dict:
    """name → numpy array of every tensor of a replica's state."""
    names = list(model.params())
    keys = (names + ["exposure"] + list(gm.STAT_NAMES)
            + [f"m.{k}" for k in names] + [f"v.{k}" for k in names]
            + ["exp_m", "exp_v", "running"])
    return {k: t.detach().cpu().numpy() for k, t in zip(
        keys, dp.state_tensors(model, adam, exp_adam, running))}


def dp_step(fixture: dict, cam_idxs, group=None):
    """One `dp_train_step` from the fixture's state (numpy rows, cameras,
    step config, step inputs) on this rank's `cam_idxs`; returns the state
    arrays and the metrics."""
    model = gm.from_jax_params(fixture["params"], fixture["n"],
                               exposure=fixture["exposure"], device="cpu")
    adam = optim.init_adam(model.params())
    eadam = optim.init_exposure_adam(model.exposure)
    bank = step.CameraBank.from_cameras(fixture["cams"], device="cpu")
    metrics, running = dp.dp_train_step(
        model, adam, eadam, torch.tensor(fixture["running"]), bank,
        cam_idxs, fixture["n_views"], fixture["lrs"], fixture["exposure_lr"],
        fixture["depth_weight"], fixture["active"], torch.zeros(3),
        step.StepConfig(**fixture["cfg"]), group=group)
    out = state_arrays(model, adam, eadam, running)
    out.update({f"metric.{k}": np.asarray(float(v))
                for k, v in metrics.items()})
    return out


def dp_step_rank(group, fixture: dict, out_dir: str) -> None:
    """This rank's share of the fixture's views, one step."""
    k = fixture["n_views"] // group.world_size
    views = list(range(group.rank * k, (group.rank + 1) * k))
    np.savez(os.path.join(out_dir, f"rank{group.rank}.npz"),
             **dp_step(fixture, views, group))


def fake_scene(n_points=160, n_views=8, size=32, seed=3):
    """An in-memory stand-in for `Scene` (`Trainer` reads its model,
    training cameras and extent) over random targets: the port's copy of
    JAX `testing.make_fake_scene`, the same numpy draws."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n_points, 3)).astype(np.float32)
    cols = rng.random((n_points, 3)).astype(np.float32)
    cams = testing.make_orbit_cameras(n_views, radius=3.5, width=size,
                                      height_px=size)
    for c in cams:
        c.image = rng.random((size, size, 3)).astype(np.float32)
        c.alpha_mask = np.ones((size, size), np.float32)
    scene = Namespace(
        gaussians=gm.create_from_pcd(pts, cols, n_images=n_views,
                                     sh_degree=1, device="cpu"),
        cameras_extent=3.5, model_path="")
    scene.getTrainCameras = lambda scale=1.0: cams
    scene.getTestCameras = lambda scale=1.0: []
    return scene


def make_trainer(iterations: int, group=None):
    """A 3dgs `Trainer` on `fake_scene` with JAX's dry-run schedule of
    `test_parallel.py::test_trainer_dp_cli_path_reaches_single_device_psnr`
    (densify from 10 every 20 until 50)."""
    from sparse_view_3dgs_pack_tpu_torch.config import (OptimizationParams,
                                                        PipelineParams)
    from sparse_view_3dgs_pack_tpu_torch.train.loop import Trainer
    parser = ArgumentParser()
    op, pp = OptimizationParams(parser, method="3dgs"), PipelineParams(parser)
    args = parser.parse_args([
        "--iterations", str(iterations), "--densification_interval", "20",
        "--densify_from_iter", "10", "--densify_until_iter", "50",
        "--densify_grad_threshold", "1e-4"])
    scene = fake_scene()
    dataset = Namespace(sh_degree=1, white_background=False,
                        train_test_exp=False, source_path="", model_path="")
    return Trainer(scene, op.extract(args), pp.extract(args), dataset,
                   group)


def train_psnr(iterations: int, group=None):
    """(PSNR on 4 training views before, after, the trainer) of
    `iterations` steps, the host RNGs seeded as the CLI seeds them."""
    import random
    random.seed(0)
    np.random.seed(0)
    tr = make_trainer(iterations, group)
    cams = tr.scene.getTrainCameras()[:4]
    p0 = tr.evaluate(cams)["psnr"]
    for _ in range(iterations):
        tr.step()
    return p0, tr.evaluate(cams)["psnr"], tr


def trainer_rank(group, iterations: int, out_dir: str) -> None:
    """A data-parallel `Trainer` run; each rank saves its final state and
    the PSNR before and after."""
    p0, p1, tr = train_psnr(iterations, group=group)
    np.savez(os.path.join(out_dir, f"rank{group.rank}.npz"),
             psnr=np.array([p0, p1]), iteration=np.array(tr.iteration),
             **state_arrays(tr.model, tr.adam, tr.exp_adam,
                            tr.dwt_running_mean))
