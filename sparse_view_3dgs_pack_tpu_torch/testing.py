"""Synthetic fixtures for the port's tests and `chip_smoke.py`.

The cloud and camera generators are the JAX package's own (numpy only, no
jax); this module adds the rasterizer test scenes of `tests/test_pallas.py`
and a Blender-layout scene writer that needs no PIL.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

from sparse_view_3dgs_pack_tpu.testing import (look_at_rt,
                                               make_gaussian_cloud,
                                               make_orbit_cameras)

from .utils import image_io

RASTER_W, RASTER_H = 64, 48
RASTER_SCENES = ("basic", "multichunk", "sticky")


def raster_scene(name: str):
    """(cloud, camera) of one rasterizer test scene at 64×48 — the scenes of
    `tests/test_pallas.py`:
      basic       250 Gaussians (`_proj()`);
      multichunk  600, half piled into one spot, low opacity: one deep tile
                  spanning several pair batches (`_proj(concentrate=True)`);
      sticky      320 in one spot, high-alpha ones in front of low-alpha
                  ones: the T < 1e-4 stop is crossed mid-list
                  (`test_pallas_sticky_early_stop`)."""
    if name == "basic":
        cloud = make_gaussian_cloud(0, 250, extent=1.0,
                                    scale_range=(0.02, 0.1))
    elif name == "multichunk":
        n = 600
        cloud = make_gaussian_cloud(2, n, extent=1.0, scale_range=(0.02, 0.1))
        cloud["xyz"][: n // 2] = cloud["xyz"][: n // 2] * 0.03
        cloud["opacity"][:] = -4.5
    elif name == "sticky":
        n = 320
        cloud = make_gaussian_cloud(9, n, extent=0.4,
                                    scale_range=(0.05, 0.15))
        cloud["xyz"][:] = cloud["xyz"] * 0.05
        cloud["opacity"][: n // 2] = 4.0
        cloud["opacity"][n // 2:] = -4.8
    else:
        raise ValueError(f"unknown raster scene {name!r}")
    cam = make_orbit_cameras(1, radius=4.0, width=RASTER_W,
                             height_px=RASTER_H)[0]
    return cloud, cam


def make_sh3_cloud(seed: int, n: int, extent: float = 2.5,
                   scale_range=(0.004, 0.02)):
    """`make_gaussian_cloud` at SH degree 3 with the 15 higher coefficients
    drawn from a seeded normal × 0.1 (the generator leaves them zero)."""
    cloud = make_gaussian_cloud(seed, n, extent=extent,
                                scale_range=scale_range, sh_degree=3)
    rng = np.random.default_rng(seed + 1)
    rest = cloud["features"][:, 1:, :]
    cloud["features"][:, 1:, :] = (rng.standard_normal(rest.shape)
                                   * 0.1).astype(np.float32)
    return cloud


def write_blender_scene(root: str, n_train: int = 4, n_test: int = 2,
                        width: int = 800):
    """NeRF-synthetic layout (transforms_{train,test}.json + black RGB PNGs
    written with `image_io`) for orbit cameras at radius 6 around the origin
    (the orbit of `chip_smoke.py`'s 1080p frames). The images are
    placeholders for the caller to overwrite."""
    radius, height, fovx = 6.0, 1.5, math.radians(50)
    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    os.makedirs(os.path.join(root, "test"), exist_ok=True)
    blank = np.zeros((width, width, 3), np.uint8)
    for split, n in (("train", n_train), ("test", n_test)):
        frames = []
        for i in range(n):
            a = 2 * math.pi * i / n + (0.3 if split == "test" else 0.0)
            eye = np.array([radius * math.cos(a), radius * math.sin(a),
                            height])
            R_c2w, T = look_at_rt(eye, (0, 0, 0))
            w2c = np.eye(4)
            w2c[:3, :3] = R_c2w.T
            w2c[:3, 3] = T
            c2w = np.linalg.inv(w2c)
            c2w[:3, 1:3] *= -1   # the reader flips y/z back
            image_io.write_png(os.path.join(root, split, f"r_{i}.png"), blank)
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": fovx, "frames": frames}, f)
    return root
