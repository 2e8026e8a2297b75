#!/usr/bin/env python3
"""Training CLI of the port:

    python -m sparse_view_3dgs_pack_tpu_torch.train -s <scene> -m <out> \
        --method lgdwt [--device cuda]

Flag-compatible with the root `train.py` (reference `LGDWT-GS/train.py:
356-384`) and writes the same model directory: `cfg_args`, `input.ply`,
`cameras.json`, `point_cloud/iteration_N/point_cloud.ply`,
`exposure.json`. `--device cuda` (the default; never falls back) trains
through the CUDA rasterizer kernels, `--device cpu` through their plain
PyTorch versions. `--checkpoint_iterations N ...` writes
`<model_path>/chkpnt<N>.npz` (the JAX package's layout; either package
resumes from the other's), `--start_checkpoint <file>` resumes from one,
and `--debug_from N` (or `--debug`) arms the debug snapshot: from
iteration N each step's loss is read on the host and a non-finite one
writes `<model_path>/snapshot_fw.npz` and stops the run. `--method fsgs`
trains FSGS (`train/fsgs_loop.py`) with its flags: `--depth_estimator`
(`precomputed` reads `<source>/depth_maps/`), `--proximity_until_iter`,
`--dist_thres`, `--use_confidence`, and the readers' `--n_views` and
`--point_cloud_type` (`dense` starts from `<n>_views/dense/fused.ply`).
`--method dngaussian` trains DNGaussian (`train/dng_loop.py`) with
`--near_range` (the spiral near-range prune), `--dataset_type
llff|dtu|blender`, `--use_neural 0|1` and `--soft_depth_start`, and writes
`neural_renderer.npz` beside each PLY when `--use_neural 1`.
`--method mult-dwtgs` (also `python -m
sparse_view_3dgs_pack_tpu_torch.train_nir`) trains RGB+NIR
(`train/nir_loop.py`): the NIR images come from `<source>/nir/<image
name>` (what `preprocessing/greenhouse.py` writes), each Gaussian gets an
NIR albedo and the model one gain, `--nir_weight` weighs the NIR loss,
and the PLY carries `nir_albedo`. `--seed` seeds the host RNGs and the
camera order (default 0, the JAX CLI's fixed seed). The 3dgs / lgdwt
loop serves the SIBR remote viewer on `--ip` / `--port` (127.0.0.1:6009;
`viewer/network_gui.py`) unless `--disable_viewer` is given; the other
methods train without it, as in the JAX CLI. The checkpoint flags apply to
the 3dgs / lgdwt loop only, as in the JAX CLI.

`--data_parallel N` (or `auto`: every CUDA card; 1 on the CPU) trains
3dgs / lgdwt on N views a step (`parallel/dp.py`): the CLI spawns N
ranks itself, rank r on `cuda:<r>` over NCCL (on `--device cpu`, N
processes over gloo), joined through a file rendezvous in the model
directory; N is clamped to the cards there are. Rank 0 alone serves the
viewer, evaluates, prints and writes. The other methods ignore the flag,
as in the JAX CLI. `--profile DIR` writes a `torch.profiler` Chrome trace
of the run (rank 0's under data parallelism) to
`DIR/train.pt.trace.json`, with the port's spans (`utils/tracing.py`):
the stages `render/…`, `step/…`, `dp/…`; each layer's backward
`grad/losses`, `grad/raster`, `grad/projection`; each wait for the card
`sync/<site>`; the host code between them `host/…`.
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

import torch

from ..config import (ModelParams, OptimizationParams, PipelineParams,
                      write_cfg_args)
from ..device import resolve_device
from ..utils.general import safe_state


def main(argv=None):
    parser = ArgumentParser(description="Training script parameters")
    parser.add_argument("--method", type=str, default=os.environ.get(
        "GS_METHOD", "lgdwt"),
        choices=["3dgs", "lgdwt", "fsgs", "dngaussian", "mult-dwtgs"])
    known, _ = parser.parse_known_args(argv)

    lp = ModelParams(parser)
    op = OptimizationParams(parser, method=known.method)
    pp = PipelineParams(parser)
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--debug_from", type=int, default=-1)
    parser.add_argument("--detect_anomaly", action="store_true", default=False)
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[7_000, 30_000])
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[7_000, 30_000])
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int,
                        default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--disable_viewer", action="store_true", default=False)
    parser.add_argument("--dataset_type", type=str, default="llff",
                        choices=["llff", "dtu", "blender"])
    parser.add_argument("--near_range", type=float, default=0.0)
    parser.add_argument("--depth_estimator", type=str, default="auto",
                        choices=["auto", "precomputed", "midas", "none"])
    parser.add_argument("--use_confidence", action="store_true",
                        default=False,
                        help="FSGS: scale each Gaussian's gradients by its "
                             "confidence (all ones, as in the reference)")
    parser.add_argument("--profile", type=str, default="",
                        help="write a torch.profiler Chrome trace of the "
                             "run to this directory; its spans: the stages "
                             "render/, step/, dp/, each layer's backward "
                             "grad/losses|raster|projection, each wait for "
                             "the card sync/<site>, the host code between "
                             "them host/")
    parser.add_argument("--data_parallel", type=str, default="1",
                        help="views-per-step data parallelism, one rank a "
                             "device: an int, or 'auto' for every CUDA "
                             "card (3dgs/lgdwt methods); ranks wait at most "
                             "30 minutes in a collective, so a viewer "
                             "pausing rank 0 longer ends the run")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the CUDA kernels) or cpu (their plain "
                             "PyTorch versions); never falls back")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the host RNGs and the camera order")
    args = parser.parse_args(argv)
    args.save_iterations.append(args.iterations)
    device = resolve_device(args.device)

    print("Optimizing " + args.model_path)
    torch.autograd.set_detect_anomaly(args.detect_anomaly)
    safe_state(args.quiet, args.seed)
    os.makedirs(args.model_path, exist_ok=True)
    write_cfg_args(args.model_path, args)

    from ..parallel.dp import (clamp_data_parallel, launch,
                               resolve_data_parallel)
    from .recipes import run_profiled, train_method, train_rank
    groups = (lp.extract(args), op.extract(args), pp.extract(args))
    n = 1
    if known.method in ("3dgs", "lgdwt"):
        n = clamp_data_parallel(
            resolve_data_parallel(args.data_parallel, device), device)
    if n > 1:
        print(f"[dp] data-parallel over {n} devices ({device.type})")
        devices = ([f"cuda:{r}" for r in range(n)] if device.type == "cuda"
                   else ["cpu"] * n)
        launch(train_rank, devices,
               os.path.join(args.model_path, f".dp_rendezvous_{os.getpid()}"),
               args=(known.method, *groups, args))
        result = None
    else:
        result = run_profiled(args.profile, device, train_method,
                              known.method, *groups, args, device)
    print("\nTraining complete.")
    return result


if __name__ == "__main__":
    main()
