#!/usr/bin/env python3
"""Rendering CLI of the port:

    python -m sparse_view_3dgs_pack_tpu_torch.render -m <model_dir> \
        [--video] [--depth_video] [--device cuda]

Flag- and output-compatible with the root `render.py` (reference
`LGDWT-GS/render.py:62-77`): loads the trained PLY at --iteration (or the
latest) and writes `<split>/ours_<iter>/{renders,gt}/NNNNN.png`. A
DNGaussian model (`neural_renderer.npz` beside its PLY) renders through
its neural field (`renderer.render_neural`). `--video` also writes the
120-frame spiral about the training cameras to `video/ours_<iter>.mp4`,
`--depth_video` its depth colormap to `video/depth_ours_<iter>.mp4` (cv2
`mp4v`, FSGS `render.py:55-81`, DNGaussian `spiral.py`). On `--device
cuda` (the default) frames go through the CUDA rasterizer kernel;
`--device cpu` runs its plain PyTorch version. `--tile_parallel N` (-1:
every card) renders each frame in N horizontal bands of tile rows, band b
on `cuda:<b>` (`parallel/tiles.py`), clamped to the cards there are; on
`--device cpu` the N bands run one after the other on the CPU. With fewer
than 2 devices, or a neural field, it renders on one device and says so,
as the JAX CLI does (`render.py:206-226`).
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
from argparse import ArgumentParser

import numpy as np
import torch

from .config import ModelParams, PipelineParams, get_combined_args
from .device import resolve_device
from .models.neural_field import load_neural_npz
from .renderer import render, render_neural
from .scene import Scene
from .utils import image_io
from .utils.pose_utils import generate_spiral_path

VIDEO_FRAMES = 120


def to_u8(img: torch.Tensor) -> np.ndarray:
    """[0, 1] float → uint8 by truncation on the device (the root CLI's
    `_u8_fn`), then to the host."""
    return (torch.clamp(img, 0.0, 1.0) * 255).to(torch.uint8).cpu().numpy()


def render_set(model_path, name, iteration, views, model, bg, antialiasing,
               active_sh, render_fn=render):
    render_path = os.path.join(model_path, name, f"ours_{iteration}",
                               "renders")
    gts_path = os.path.join(model_path, name, f"ours_{iteration}", "gt")
    os.makedirs(render_path, exist_ok=True)
    os.makedirs(gts_path, exist_ok=True)
    for idx, view in enumerate(views):
        res = render_fn(model, view, bg, sh_degree_active=active_sh,
                        antialiasing=antialiasing)
        image_io.write_png(os.path.join(render_path, f"{idx:05d}.png"),
                           to_u8(res.render))
        if view.image is not None:
            gt = (np.clip(view.image, 0, 1) * 255).astype(np.uint8)
            image_io.write_png(os.path.join(gts_path, f"{idx:05d}.png"), gt)


def _depth_colormap(depth, alpha) -> np.ndarray:
    """Percentile-normalised −log(depth) on a turbo-like ramp, weighted by
    alpha: DNGaussian's spiral depth visualisation (`DNGaussian/spiral.py:
    28-95`; root `render.py:64-85`)."""
    d = np.asarray(depth, np.float32)
    w = np.clip(np.asarray(alpha, np.float32), 0, 1)
    v = -np.log(np.maximum(d, 1e-6))
    flat = v.reshape(-1)
    wf = w.reshape(-1)
    order = np.argsort(flat)
    acc = np.cumsum(wf[order])
    if acc[-1] <= 0:
        return np.zeros(d.shape + (3,), np.uint8)
    lo, hi = np.interp([0.005 * acc[-1], 0.995 * acc[-1]], acc, flat[order])
    x = np.clip((v - min(lo, hi)) / max(abs(hi - lo), 1e-9), 0, 1)
    r = np.clip(1.6 * x - 0.3, 0, 1)
    g = np.clip(1.7 - np.abs(2.4 * x - 1.2), 0, 1)
    b = np.clip(1.2 - 1.6 * x, 0, 1)
    rgb = np.stack([r, g, b], -1) * w[..., None]
    return (rgb * 255).astype(np.uint8)


def render_video(model_path, iteration, views, model, bg, antialiasing,
                 active_sh, fps=30, depth_video=False, render_fn=render):
    """The spiral video about `views` (root `render.py:88-133`), and with
    `depth_video` its depth colormap; cv2 is imported here only."""
    import cv2

    os.makedirs(os.path.join(model_path, "video"), exist_ok=True)
    h, w = views[0].height, views[0].width
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    writer = cv2.VideoWriter(os.path.join(model_path, "video",
                                          f"ours_{iteration}.mp4"),
                             fourcc, fps, (w, h))
    dwriter = cv2.VideoWriter(
        os.path.join(model_path, "video", f"depth_ours_{iteration}.mp4"),
        fourcc, fps, (w, h)) if depth_video else None
    for cam in generate_spiral_path(views, n_frames=VIDEO_FRAMES):
        res = render_fn(model, cam, bg, sh_degree_active=active_sh,
                        antialiasing=antialiasing)
        writer.write(cv2.cvtColor(to_u8(res.render), cv2.COLOR_RGB2BGR))
        if dwriter is not None:
            dm = _depth_colormap(res.expected_depth.cpu().numpy(),
                                 res.alpha.cpu().numpy())
            dwriter.write(cv2.cvtColor(dm, cv2.COLOR_RGB2BGR))
    writer.release()
    if dwriter is not None:
        dwriter.release()


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
    parser.add_argument("--tile_parallel", default=0, type=int,
                        help="render each frame in N bands of tile rows, "
                             "one a device (-1 = all cards); the Gaussians "
                             "are projected once and copied to each")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the CUDA kernel) or cpu (its plain "
                             "PyTorch version); never falls back")
    args = get_combined_args(parser, argv)
    device = resolve_device(args.device)
    with open(os.devnull, "w") as null, \
            contextlib.redirect_stdout(null if args.quiet else sys.stdout):
        _render_model(model.extract(args), pipeline.extract(args), args,
                      device)


def load_model(dataset, iteration, device):
    """(scene, render function) of a trained model as the CLI renders it:
    through `render_neural` and the field of `neural_renderer.npz` when
    the iteration has one, else through `render`."""
    scene = Scene(dataset, load_iteration=iteration, shuffle=False,
                  sh_degree=dataset.sh_degree, device=device)
    neural = os.path.join(dataset.model_path, "point_cloud",
                          f"iteration_{scene.loaded_iter}",
                          "neural_renderer.npz")
    if not os.path.exists(neural):
        return scene, render
    print(f"Rendering with neural field: {neural}")
    return scene, functools.partial(render_neural,
                                    field=load_neural_npz(neural, device))


def _tile_parallel(n_req: int, render_fn, scene, device):
    """`--tile_parallel`: the band-parallel drop-in over n devices, or
    `render_fn` with the JAX CLI's message where it cannot be used."""
    from .parallel.tiles import make_tile_parallel_render_fn
    n_avail = (torch.cuda.device_count() if device.type == "cuda"
               else max(n_req, 1))
    n_dev = n_avail if n_req < 0 else min(n_req, n_avail)
    if render_fn is not render:
        print("tile_parallel: neural-field rendering active, falling back "
              "to single-device")
        return render_fn
    if n_dev < 2:
        print(f"tile_parallel: only {n_dev} device(s) available, rendering "
              "single-device")
        return render_fn
    cams = scene.getTrainCameras() or scene.getTestCameras()
    devices = ([f"cuda:{i}" for i in range(n_dev)] if device.type == "cuda"
               else ["cpu"] * n_dev)
    print(f"tile_parallel: band-sharded rendering over {n_dev} devices")
    return make_tile_parallel_render_fn(devices, cams[0].width,
                                        cams[0].height)


def _render_model(dataset, pipe, args, device):
    print("Rendering " + dataset.model_path)
    scene, render_fn = load_model(dataset, args.iteration, device)
    if args.tile_parallel:
        render_fn = _tile_parallel(args.tile_parallel, render_fn, scene,
                                   device)
    model = scene.gaussians
    bg = [1, 1, 1] if dataset.white_background else [0, 0, 0]
    sh = model.max_sh_degree
    for split, views, skip in (("train", scene.getTrainCameras(),
                                args.skip_train),
                               ("test", scene.getTestCameras(),
                                args.skip_test)):
        if not skip and views:
            render_set(dataset.model_path, split, scene.loaded_iter, views,
                       model, bg, pipe.antialiasing, sh, render_fn)
    if args.video or args.depth_video:
        render_video(dataset.model_path, scene.loaded_iter,
                     scene.getTrainCameras(), model, bg, pipe.antialiasing,
                     sh, fps=args.fps, depth_video=args.depth_video,
                     render_fn=render_fn)


if __name__ == "__main__":
    main()
