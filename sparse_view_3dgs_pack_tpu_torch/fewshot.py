#!/usr/bin/env python3
"""Few-shot quality run of the port: FSGS, DNGaussian and 3DGS at 3 views
on a forward-facing COLMAP scene with an MVS-style dense init.

    python -m sparse_view_3dgs_pack_tpu_torch.fewshot [workdir] [--size 400]
        [--iters_fsgs 10000] [--iters_dng 6000]
        [--arms fsgs_dense,3dgs] [--seeds 0] [--device cuda]

The port's counterpart of `scripts/fsgs_fewshot_bench.py`. It builds the
fixture with `testing.write_llff_colmap_scene` (24 cameras, llffhold 8, so
21 training candidates of which the reader keeps 3; 20k ground-truth
Gaussians rendered by the port's renderer; `3_views/dense/fused.ply`;
disparity `depth_maps/`), then runs each arm's train → render → metrics
through the port's CLIs as subprocesses, once per training seed (the train
CLI's `--seed`), and writes `summary.json` (each run's `results.json`)
into the working directory. Arms:
  fsgs_dense    the reference recipe: dense init and depth priors
  fsgs_sparse   ablation: the sparse SfM init, depth priors
  fsgs_nodepth  ablation: dense init, no depth prior (and so no pseudo
                views)
  fsgs_noprox   ablation: dense init and depth priors, proximity
                densification off
  dngaussian    DNGaussian with the neural field, depth priors, its 6k
                schedule (the JAX script's `dngaussian` arm)
  dngaussian_sh the same through the SH colours (`--use_neural 0`), the
                variant of PARITY.md's JAX record
  3dgs          the few-shot baseline, sparse init
The `fsgs_*` and `3dgs` arms pass exactly the JAX script's extra arguments
(`scripts/fsgs_fewshot_bench.py:198-211`).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from argparse import ArgumentParser

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARMS = {
    # name: (method, schedule, extra train args)
    "fsgs_dense": ("fsgs", "fsgs", ["--point_cloud_type", "dense",
                                    "--depth_estimator", "precomputed"]),
    "fsgs_sparse": ("fsgs", "fsgs", ["--point_cloud_type", "sparse",
                                     "--depth_estimator", "precomputed"]),
    "fsgs_nodepth": ("fsgs", "fsgs", ["--point_cloud_type", "dense",
                                      "--depth_estimator", "none"]),
    "fsgs_noprox": ("fsgs", "fsgs", ["--point_cloud_type", "dense",
                                     "--depth_estimator", "precomputed",
                                     "--proximity_until_iter", "0"]),
    "dngaussian": ("dngaussian", "dng", ["--depth_estimator",
                                         "precomputed"]),
    "dngaussian_sh": ("dngaussian", "dng", ["--depth_estimator",
                                            "precomputed", "--use_neural",
                                            "0"]),
    "3dgs": ("3dgs", "fsgs", ["--point_cloud_type", "sparse"]),
}


def log(*a):
    print(f"[{time.strftime('%H:%M:%S')}]", *a, flush=True)


def arm_commands(name: str, scene: str, model: str, iters: int, size: int,
                 device: str, seed: int = 0) -> list:
    """The train, render and metrics command lines of one arm."""
    method, _, args = ARMS[name]
    # view-space gradients scale as 1/size: 0.0002 is the reference's at
    # ~800 px
    grad = 0.0002 * 800.0 / size
    tests = list(range(1000, iters + 1, max(iters // 10, 1000)))
    if not tests or tests[-1] != iters:
        tests.append(iters)
    mod = "sparse_view_3dgs_pack_tpu_torch"
    return [
        [sys.executable, "-m", f"{mod}.train", "-s", scene, "-m", model,
         "--method", method, "--eval", "--n_views", "3", "--iterations",
         str(iters), "--test_iterations", *map(str, tests),
         "--save_iterations", str(iters), "--densify_grad_threshold",
         str(grad), "--disable_viewer", "--device", device, "--seed",
         str(seed), *args],
        [sys.executable, "-m", f"{mod}.render", "-m", model, "--skip_train",
         "--device", device],
        [sys.executable, "-m", f"{mod}.metrics", "-m", model, "--device",
         device],
    ]


def run_arm(name: str, scene: str, out_root: str, iters: int, size: int,
            device: str, seed: int = 0) -> dict:
    run = name if seed == 0 else f"{name}_seed{seed}"
    model = os.path.join(out_root, run)
    os.makedirs(model, exist_ok=True)
    t0 = time.time()
    with open(os.path.join(model, "train.log"), "w") as f:
        for cmd in arm_commands(name, scene, model, iters, size, device,
                                seed):
            log(f"[{run}] {' '.join(cmd[2:4])} ...")
            rc = subprocess.call(cmd, cwd=REPO, stdout=f, stderr=f)
            if rc != 0:
                log(f"[{run}] FAILED rc={rc} (see {f.name})")
                return {"arm": name, "seed": seed, "rc": rc,
                        "duration_sec": time.time() - t0}
    with open(os.path.join(model, "results.json")) as f:
        res = json.load(f)
    return {"arm": name, "seed": seed, "rc": 0,
            "duration_sec": time.time() - t0, "results": res}


def main(argv=None) -> int:
    ap = ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workdir", nargs="?", default="fewshot_runs")
    ap.add_argument("--size", type=int, default=400)
    ap.add_argument("--iters_fsgs", type=int, default=10_000)
    ap.add_argument("--iters_dng", type=int, default=6_000)
    ap.add_argument("--arms", default="fsgs_dense,3dgs")
    ap.add_argument("--seeds", default="0",
                    help="training seeds, each arm runs once per seed")
    ap.add_argument("--n_gauss", type=int, default=20_000,
                    help="ground-truth cloud size")
    ap.add_argument("--n_dense", type=int, default=30_000,
                    help="MVS-style dense init size")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from .device import resolve_device
    from .testing import write_llff_colmap_scene
    arms = args.arms.split(",")
    unknown = [a for a in arms if a not in ARMS]
    if unknown:
        raise SystemExit(f"unknown arms {unknown}; choose from {list(ARMS)}")

    scene = os.path.join(args.workdir, "scene")
    out_root = os.path.join(args.workdir, "runs")
    os.makedirs(out_root, exist_ok=True)
    t0 = time.time()
    write_llff_colmap_scene(scene, size=args.size, n_gauss=args.n_gauss,
                            n_dense=args.n_dense,
                            device=resolve_device(args.device))
    log(f"scene at {scene} in {time.time() - t0:.1f} s: dense init "
        f"{args.n_dense} points")
    rows = []
    for name in arms:
        iters = args.iters_fsgs if ARMS[name][1] == "fsgs" else args.iters_dng
        for seed in (int(v) for v in args.seeds.split(",")):
            rows.append(run_arm(name, os.path.abspath(scene),
                                os.path.abspath(out_root), iters, args.size,
                                args.device, seed))
            with open(os.path.join(args.workdir, "summary.json"), "w") as f:
                json.dump(rows, f, indent=1)
            log(f"[{name}] {json.dumps(rows[-1])}")
    return 0 if all(r["rc"] == 0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
