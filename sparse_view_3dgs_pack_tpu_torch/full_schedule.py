#!/usr/bin/env python3
"""The main path at its reference schedule: lgdwt for 30k iterations on a
synthetic 800×800 scene, through the train, render and metrics CLIs.

    python -m sparse_view_3dgs_pack_tpu_torch.full_schedule [workdir]
        [--iterations 30000] [--size 800] [--device cuda]
        [--test_iterations 1000 7000 15000 30000] [--in_process]
        [train flags ...]

The port's counterpart of `scripts/tpu_full_schedule.py`. It writes that
script's scene (`:25-83`) with the port's own modules: a 60k-Gaussian cloud
(`testing.make_gaussian_cloud(11, 60_000, extent=1.2, scale_range=(0.002,
0.02))`) rendered at SH 0 by the inference renderer from 24 orbit cameras
at radius 3.5, clipped to [0, 1] and written as PNGs (`utils/image_io.py`);
`transforms_train.json` and `transforms_test.json`, both holding the same
24 frames; `points3d.ply`, 5,000 of the cloud's centres with N(0, 0.02)
noise and random colours (`default_rng(0)`). Then it runs `train --method
lgdwt --eval --disable_viewer` with the JAX script's iterations, test
and save iterations, `render --skip_train` and `metrics`, each as a
subprocess (`--in_process`: in this process, so that a caller can count
the kernels' launches), and writes `<workdir>/summary.json`: the test PSNR
of the start model and at each test iteration with the Gaussian count,
it/s, each stage's wall time and exit code, and `results.json`, beside the
JAX record of `PARITY.md:182-199`. The training runs without the JAX
script's `--quiet`, which would silence the eval lines read here.

The "test" views are the training views, so the run checks fitting at
scale, not generalisation. `--n_gauss` and `--n_init` shrink the cloud and
the start points for a run on the CPU (`--device cpu`, a small `--size`);
other flags go to the train CLI (at 64 px, say, `--patch_size 16`).
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import re
import subprocess
import sys
import time
import traceback
from argparse import ArgumentParser, Namespace

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "sparse_view_3dgs_pack_tpu_torch"
N_VIEWS = 24
TEST_ITERATIONS = (1000, 7000, 15000, 30000)
# PARITY.md:182-199: one 30k run of the JAX package on a TPU (iteration →
# test PSNR, Gaussians), and its results.json
JAX_CURVE = {1000: (18.96, 6460), 7000: (27.51, 179_609),
             15000: (29.89, 201_689), 30000: (34.49, 201_689)}
JAX_RESULTS = {"PSNR": 34.45, "SSIM": 0.964}

EVAL_LINE = re.compile(r"\[ITER (\d+)\] Evaluating: PSNR ([0-9.]+) SSIM "
                       r"([0-9.]+).*\((\d+) Gaussians\)")
ITS_LINE = re.compile(r"Training took [0-9.]+s for \d+ iterations "
                      r"\(([0-9.]+) it/s\)")


def log(*a):
    print(f"[{time.strftime('%H:%M:%S')}]", *a, flush=True)


def cameras(size: int) -> list:
    """The scene's 24 orbit cameras at `size`×`size`."""
    from . import testing
    return testing.make_orbit_cameras(N_VIEWS, radius=3.5, width=size,
                                      height_px=size)


def scene_inputs(size: int, n_gauss: int = 60_000, n_init: int = 5_000):
    """The scene's cloud, cameras and start points (the JAX script's
    draws): (cloud dict, cameras, init xyz, init colours)."""
    from . import testing
    cloud = testing.make_gaussian_cloud(11, n_gauss, extent=1.2,
                                        scale_range=(0.002, 0.02))
    cams = cameras(size)
    rng = np.random.default_rng(0)
    sel = rng.choice(n_gauss, n_init, replace=False)
    xyz = cloud["xyz"][sel] + rng.normal(0, 0.02, (n_init, 3))
    return cloud, cams, xyz, rng.random((n_init, 3))


def render_views(cloud, cams, device) -> list:
    """Each camera's SH-0 inference render of the cloud on a black
    background, clipped to [0, 1]: float32 (H, W, 3) arrays."""
    import torch

    from .models.gaussians import GaussianModel
    from .renderer import render
    f = cloud["features"]
    model = GaussianModel(cloud["xyz"], f[:, :1], f[:, 1:], cloud["scales"],
                          cloud["quats"], cloud["opacity"]).to(device)
    return [torch.clamp(render(model, cam, [0.0, 0.0, 0.0],
                               sh_degree_active=0).render, 0.0, 1.0)
            .cpu().numpy() for cam in cams]


def build_scene(root: str, size: int, device, n_gauss: int = 60_000,
                n_init: int = 5_000) -> None:
    """Write the Blender-layout scene under `root`."""
    from .data.ply import store_point_cloud
    from .utils import image_io
    cloud, cams, xyz, rgb = scene_inputs(size, n_gauss, n_init)
    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    frames = []
    for i, (cam, img) in enumerate(zip(cams, render_views(cloud, cams,
                                                          device))):
        image_io.write_png(os.path.join(root, "train", f"r_{i}.png"),
                           (img * 255).astype(np.uint8))
        w2c = np.eye(4)
        w2c[:3, :3] = cam.R.T
        w2c[:3, 3] = cam.T
        c2w = np.linalg.inv(w2c)
        c2w[:3, 1:3] *= -1
        frames.append({"file_path": f"./train/r_{i}",
                       "transform_matrix": c2w.tolist()})
    meta = {"camera_angle_x": cams[0].fovx, "frames": frames}
    for split in ("train", "test"):
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump(meta, f)
    store_point_cloud(os.path.join(root, "points3d.ply"), xyz, rgb)


def start_psnr(scene: str, device) -> float:
    """Test PSNR of the model the trainer starts from (iteration 0, SH 0)."""
    from .data import readers
    from .data.camera_utils import camera_list_from_cam_infos
    from .data.ply import fetch_point_cloud
    from .models import gaussians as gm
    from .train.loop import evaluate_cameras
    info = readers.read_nerf_synthetic_scene(scene, False, "", True)
    cams = camera_list_from_cam_infos(info.test_cameras, 1.0,
                                      Namespace(resolution=-1), True, True)
    pcd = fetch_point_cloud(os.path.join(scene, "points3d.ply"))
    start = gm.create_from_pcd(pcd.points, pcd.colors, n_images=N_VIEWS,
                               sh_degree=3, device=device)
    return float(evaluate_cameras(start, cams, [0.0, 0.0, 0.0], 0)["psnr"])


def stages(scene: str, model: str, iterations: int, test_iterations,
           device: str, train_flags=()) -> list:
    """(name, module, argv) of the train, render and metrics stages."""
    return [
        ("train", f"{PKG}.train",
         ["--method", "lgdwt", "-s", scene, "-m", model, "--iterations",
          str(iterations), "--test_iterations",
          *map(str, test_iterations), "--save_iterations", str(iterations),
          "--eval", "--disable_viewer", "--device", device,
          *train_flags]),
        ("render", f"{PKG}.render",
         ["-m", model, "--skip_train", "--device", device]),
        ("metrics", f"{PKG}.metrics", ["-m", model, "--device", device]),
    ]


def run_stage(module: str, argv: list, log_path: str,
              in_process: bool) -> int:
    """One CLI with its output in `log_path`; its exit code."""
    with open(log_path, "w") as f:
        if not in_process:
            return subprocess.call([sys.executable, "-m", module, *argv],
                                   cwd=REPO, stdout=f,
                                   stderr=subprocess.STDOUT)
        main = importlib.import_module(
            module + (".__main__" if module.endswith((".train", ".metrics"))
                      else "")).main
        with contextlib.redirect_stdout(f):
            try:
                rc = main(argv)
            except Exception:
                traceback.print_exc(file=f)
                return 1
        return rc if isinstance(rc, int) else 0


def read_train_log(text: str) -> dict:
    """The eval lines (iteration → PSNR, SSIM, Gaussians) and it/s."""
    curve = {int(m[1]): (float(m[2]), float(m[3]), int(m[4]))
             for m in EVAL_LINE.finditer(text)}
    its = ITS_LINE.search(text)
    return {"curve": curve, "its_per_s": float(its[1]) if its else None}


def main(argv=None) -> int:
    ap = ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workdir", nargs="?", default="full_schedule_run")
    ap.add_argument("--iterations", type=int, default=30_000)
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--test_iterations", type=int, nargs="+", default=None,
                    help="default: those of 1000 7000 15000 30000 below "
                         "--iterations, and --iterations")
    ap.add_argument("--n_gauss", type=int, default=60_000,
                    help="ground-truth cloud size")
    ap.add_argument("--n_init", type=int, default=5_000,
                    help="start points in points3d.ply")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--in_process", action="store_true",
                    help="run the three CLIs in this process")
    args, train_flags = ap.parse_known_args(argv)
    from .device import resolve_device
    device = resolve_device(args.device)
    tests = args.test_iterations or sorted(
        {t for t in TEST_ITERATIONS if t < args.iterations}
        | {args.iterations})
    scene = os.path.abspath(os.path.join(args.workdir, "scene"))
    model = os.path.abspath(os.path.join(args.workdir, "model"))
    os.makedirs(args.workdir, exist_ok=True)

    summary = {"config": {"size": args.size, "iterations": args.iterations,
                          "test_iterations": tests, "views": N_VIEWS,
                          "n_gauss": args.n_gauss, "n_init": args.n_init,
                          "device": str(device),
                          "train_flags": train_flags}, "stages": {}}
    t0 = time.time()
    build_scene(scene, args.size, device, args.n_gauss, args.n_init)
    summary["stages"]["scene"] = {"rc": 0, "seconds": time.time() - t0}
    summary["test_psnr_iteration_0"] = start_psnr(scene, device)
    log(f"scene at {scene} in {time.time() - t0:.1f} s; test PSNR at "
        f"iteration 0: {summary['test_psnr_iteration_0']:.3f} dB")
    for name, module, cmd in stages(scene, model, args.iterations, tests,
                                    args.device, train_flags):
        t0 = time.time()
        rc = run_stage(module, cmd, os.path.join(args.workdir,
                                                 f"{name}.log"),
                       args.in_process)
        summary["stages"][name] = {"rc": rc, "seconds": time.time() - t0}
        log(f"{name}: rc={rc} in {time.time() - t0:.1f} s")
        if rc != 0:
            break

    with open(os.path.join(args.workdir, "train.log")) as f:
        train = read_train_log(f.read())
    summary["its_per_s"] = train["its_per_s"]
    summary["curve"] = [
        {"iteration": it, "psnr": p, "ssim": s, "gaussians": n,
         "jax_psnr": JAX_CURVE.get(it, (None, None))[0],
         "jax_gaussians": JAX_CURVE.get(it, (None, None))[1]}
        for it, (p, s, n) in sorted(train["curve"].items())]
    path = os.path.join(model, "results.json")
    if os.path.exists(path):
        with open(path) as f:
            summary["results"] = json.load(f).get(f"ours_{args.iterations}")
    summary["jax"] = {"source": "PARITY.md:182-199", "results": JAX_RESULTS,
                      "curve": {str(k): v for k, v in JAX_CURVE.items()}}
    summary["ok"] = (all(s["rc"] == 0 for s in summary["stages"].values())
                     and len(summary["stages"]) == 4)
    with open(os.path.join(args.workdir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    for row in summary["curve"]:
        log(json.dumps(row))
    log(f"results {summary.get('results')} (JAX {JAX_RESULTS}); "
        f"{summary['its_per_s']} it/s")
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
