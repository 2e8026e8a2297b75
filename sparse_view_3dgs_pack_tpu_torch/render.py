#!/usr/bin/env python3
"""Rendering CLI of the port:

    python -m sparse_view_3dgs_pack_tpu_torch.render -m <model_dir> [--device cuda]

Flag- and output-compatible with the root `render.py` (reference
`LGDWT-GS/render.py:62-77`): loads the trained PLY at --iteration (or the
latest) and writes `<split>/ours_<iter>/{renders,gt}/NNNNN.png`. On
`--device cuda` (the default) frames go through the CUDA rasterizer kernel;
`--device cpu` runs its plain PyTorch version.
"""

from __future__ import annotations

import contextlib
import os
import sys
from argparse import ArgumentParser

import numpy as np
import torch

from .config import ModelParams, PipelineParams, get_combined_args
from .device import resolve_device
from .renderer import render
from .scene import Scene
from .utils import image_io


def to_u8(img: torch.Tensor) -> np.ndarray:
    """[0, 1] float → uint8 by truncation, as the JAX CLI."""
    return (torch.clamp(img, 0.0, 1.0) * 255).to(torch.uint8).cpu().numpy()


def render_set(model_path, name, iteration, views, model, bg, antialiasing,
               active_sh):
    render_path = os.path.join(model_path, name, f"ours_{iteration}",
                               "renders")
    gts_path = os.path.join(model_path, name, f"ours_{iteration}", "gt")
    os.makedirs(render_path, exist_ok=True)
    os.makedirs(gts_path, exist_ok=True)
    for idx, view in enumerate(views):
        res = render(model, view, bg, sh_degree_active=active_sh,
                     antialiasing=antialiasing)
        image_io.write_png(os.path.join(render_path, f"{idx:05d}.png"),
                           to_u8(res.render))
        if view.image is not None:
            gt = (np.clip(view.image, 0, 1) * 255).astype(np.uint8)
            image_io.write_png(os.path.join(gts_path, f"{idx:05d}.png"), gt)


def main(argv=None):
    parser = ArgumentParser(description="Testing script parameters")
    model = ModelParams(parser, sentinel=True)
    pipeline = PipelineParams(parser)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--video", action="store_true")
    parser.add_argument("--depth_video", action="store_true")
    parser.add_argument("--fps", default=30, type=int)
    parser.add_argument("--tile_parallel", default=0, type=int)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the CUDA kernel) or cpu (its plain "
                             "PyTorch version); never falls back")
    args = get_combined_args(parser, argv)
    if args.video or args.depth_video:
        raise NotImplementedError("--video/--depth_video are not ported to "
                                  "the PyTorch package yet (ROADMAP Queue 1)")
    if args.tile_parallel:
        raise NotImplementedError("--tile_parallel is not ported to the "
                                  "PyTorch package yet (ROADMAP Queue 1, "
                                  "multi-GPU)")
    device = resolve_device(args.device)
    with open(os.devnull, "w") as null, \
            contextlib.redirect_stdout(null if args.quiet else sys.stdout):
        _render_model(model.extract(args), pipeline.extract(args),
                      args.iteration, args.skip_train, args.skip_test, device)


def _render_model(dataset, pipe, iteration, skip_train, skip_test, device):
    print("Rendering " + dataset.model_path)
    scene = Scene(dataset, load_iteration=iteration, shuffle=False,
                  sh_degree=dataset.sh_degree, device=device)
    neural = os.path.join(dataset.model_path, "point_cloud",
                          f"iteration_{scene.loaded_iter}",
                          "neural_renderer.npz")
    if os.path.exists(neural):
        raise NotImplementedError(
            "DNGaussian neural-field rendering (render_neural) is not ported "
            "to the PyTorch package yet (ROADMAP Queue 1, DNGaussian)")
    state = scene.gaussians
    bg = [1, 1, 1] if dataset.white_background else [0, 0, 0]
    sh = state.max_sh_degree
    for split, views, skip in (("train", scene.getTrainCameras(), skip_train),
                               ("test", scene.getTestCameras(), skip_test)):
        if not skip and views:
            render_set(dataset.model_path, split, scene.loaded_iter, views,
                       state, bg, pipe.antialiasing, sh)


if __name__ == "__main__":
    main()
