"""Synthetic fixtures for the port's tests and `chip_smoke.py`.

`look_at_rt`, `make_orbit_cameras` and `make_gaussian_cloud` are copies of
the generators in `sparse_view_3dgs_pack_tpu/testing.py` and give the same
numbers from the same seed; this module adds the rasterizer test scenes of
`tests/test_pallas.py` and a Blender-layout scene writer that needs no PIL.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

from .utils import image_io


def look_at_rt(eye, target, up=(0.0, 0.0, 1.0)):
    """Returns (R, T) in the dataset-reader convention: R = cam→world rotation
    (transposed world→cam), T = world→cam translation. Camera looks down +z."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    up = np.asarray(up, np.float64)
    right = np.cross(fwd, up)
    if np.linalg.norm(right) < 1e-6:
        right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    Rw2c = np.stack([right, down, fwd], axis=0)  # world→cam
    T = -Rw2c @ eye
    return Rw2c.T, T  # stored convention transposes back


def make_orbit_cameras(n, radius=4.0, height=1.2, fovx=math.radians(60),
                       width=128, height_px=None, target=(0, 0, 0),
                       phase=0.0):
    from .data.cameras import Camera
    H = height_px or width
    fovy = 2 * math.atan(math.tan(fovx / 2) * H / width)
    cams = []
    for i in range(n):
        a = 2 * math.pi * i / max(n, 1) + phase
        eye = (radius * math.cos(a), radius * math.sin(a), height)
        R, T = look_at_rt(eye, target)
        cams.append(Camera(uid=i, colmap_id=i + 1, R=R, T=T, fovx=fovx,
                           fovy=fovy, image_name=f"r_{i:03d}.png",
                           width=width, height=H))
    return cams


def make_gaussian_cloud(key_or_seed, n, extent=1.0, scale_range=(0.02, 0.12),
                        channels=3, sh_degree=0):
    """Random raw Gaussian parameter dict (pre-activation), numpy."""
    rng = np.random.default_rng(key_or_seed)
    xyz = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    n_sh = (sh_degree + 1) ** 2
    features = np.zeros((n, n_sh, channels), np.float32)
    features[:, 0, :] = rng.uniform(-1.5, 1.5, (n, channels))
    scales = np.log(rng.uniform(*scale_range, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opacity = rng.uniform(-1.0, 3.0, (n, 1)).astype(np.float32)  # pre-sigmoid
    return dict(xyz=xyz, features=features, scales=scales, quats=quats,
                opacity=opacity)

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


def cull_stress_frame(seed: int = 4, device="cpu"):
    """Projected inputs of a RASTER_W×RASTER_H frame that stresses the tile
    kernels' warp cull: thin Gaussians at ±45° (a few at other angles),
    centres between tiles and off the image, opacities at, just above and
    just below 1/255 and at 0.99 or more, and one Gaussian larger than a
    tile. (means2d, depths, conics, colors, opacities, radii) as tensors on
    `device`: float32, and per-axis 3σ radii (P, 2) int32 for the binning."""
    import torch
    W, H = RASTER_W, RASTER_H
    rng = np.random.default_rng(seed)
    n = 240
    major = rng.uniform(3.0, 14.0, n)
    minor = rng.uniform(0.3, 1.2, n)
    theta = rng.choice([np.pi / 4, -np.pi / 4], n)
    theta[:40] = rng.uniform(0.0, np.pi, 40)
    co, si = np.cos(theta), np.sin(theta)
    cxx = co * co * major ** 2 + si * si * minor ** 2
    cyy = si * si * major ** 2 + co * co * minor ** 2
    cxy = co * si * (major ** 2 - minor ** 2)
    cxx[0] = cyy[0] = 30.0 ** 2       # larger than a tile
    cxy[0] = 0.0
    det = cxx * cyy - cxy ** 2
    conics = np.stack([cyy / det, -cxy / det, cxx / det], 1)
    means = np.stack([rng.uniform(-20.0, W + 20.0, n),
                      rng.uniform(-20.0, H + 20.0, n)], 1)
    means[0] = (W / 2, H / 2)
    means[1:30] = np.round(means[1:30] / 16.0) * 16.0 - 0.5  # tile corners
    eps = np.float32(1.0) / np.float32(255.0)
    op = rng.uniform(0.05, 0.9, n)
    op[30:60] = eps * (1.0 + rng.uniform(-2e-3, 2e-3, 30))
    op[60:64] = eps
    op[64:84] = rng.uniform(0.99, 1.0, 20)
    radii = np.ceil(3.0 * np.sqrt(np.stack([cxx, cyy], 1)))
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return (f32(means), f32(rng.uniform(1.0, 8.0, n)), f32(conics),
            f32(rng.uniform(0.0, 1.0, (n, 3))), f32(op),
            torch.as_tensor(radii.astype(np.int32), device=device))


def log_t_f64(means2d, conics, opacities, ids, starts, counts, n_contrib,
              width: int, height: int, tile_x: int, tile_y: int,
              f32_terms: bool):
    """Each pixel's log T_final as a float64 sum, in order, of log1p(-α)
    over the pairs of its tile before its n_contrib (an (H, W) int tensor),
    skipped pairs adding 0. With `f32_terms` α and the skip test are the
    plain version's float32 expression (`ops.blending.alpha_from_power`) and
    only log1p and the sum are float64: what a float32 sum of those terms
    should give, whatever its order. Without it, α and the skip test are
    float64 too, from the same float32 inputs. A loop over tiles: for the
    small test frames. Returns a float64 (H, W) tensor."""
    import torch
    from .ops.blending import ALPHA_EPS, ALPHA_MAX, alpha_from_power
    dev = means2d.device
    dt = torch.float32 if f32_terms else torch.float64
    gx = (width + tile_x - 1) // tile_x
    out = torch.zeros((height, width), dtype=torch.float64, device=dev)
    for t in range(counts.shape[0]):
        s, c = int(starts[t]), int(counts[t])
        x0, y0 = (t % gx) * tile_x, (t // gx) * tile_y
        x1, y1 = min(x0 + tile_x, width), min(y0 + tile_y, height)
        if c == 0 or x0 >= x1 or y0 >= y1:
            continue
        g = ids[s:s + c].to(torch.int64)
        y, x = torch.meshgrid(torch.arange(y0, y1, device=dev),
                              torch.arange(x0, x1, device=dev),
                              indexing="ij")
        dx = x.to(dt)[..., None] - means2d[g, 0].to(dt)
        dy = y.to(dt)[..., None] - means2d[g, 1].to(dt)
        a, b, cc = conics[g].to(dt).unbind(1)
        power = -0.5 * (a * dx * dx + cc * dy * dy) - b * dx * dy
        op = opacities[g].to(dt)
        if f32_terms:
            alpha = alpha_from_power(power, op).double()
        else:
            alpha = torch.clamp(op * torch.exp(torch.clamp(power, max=0.0)),
                                max=ALPHA_MAX)
            alpha = torch.where((power > 0.0) | (alpha < ALPHA_EPS),
                                torch.zeros_like(alpha), alpha)
        before = (torch.arange(c, device=dev)
                  < n_contrib[y0:y1, x0:x1, None].to(dev))
        out[y0:y1, x0:x1] = torch.where(before, torch.log1p(-alpha),
                                        torch.zeros_like(alpha)).sum(-1)
    return out


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
                        width: int = 800, cloud=None, device="cpu",
                        init_points: int = 0):
    """NeRF-synthetic layout (transforms_{train,test}.json + RGB PNGs written
    with `image_io`) for orbit cameras at radius 6 around the origin (the
    orbit of `chip_smoke.py`'s 1080p frames).

    Without `cloud` the images are black placeholders for the caller to
    overwrite. With a `make_gaussian_cloud` dict they are renders of it
    (the port's renderer on `device`, black background), and
    `init_points` > 0 also writes `points3d.ply`: that many of the cloud's
    centres, moved by N(0, 0.05) noise, with random colours — the training
    start the readers pick up."""
    radius, height, fovx = 6.0, 1.5, math.radians(50)
    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    os.makedirs(os.path.join(root, "test"), exist_ok=True)
    blank = np.zeros((width, width, 3), np.uint8)
    model = None
    if cloud is not None:
        from .models.gaussians import GaussianModel
        f = cloud["features"]
        model = GaussianModel(cloud["xyz"], f[:, :1], f[:, 1:],
                              cloud["scales"], cloud["quats"],
                              cloud["opacity"]).to(device)
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
            image = blank if model is None else _render_u8(
                model, R_c2w, T, fovx, width)
            image_io.write_png(os.path.join(root, split, f"r_{i}.png"), image)
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": fovx, "frames": frames}, f)
    if cloud is not None and init_points > 0:
        from .data.ply import store_point_cloud
        rng = np.random.default_rng(0)
        sel = rng.choice(len(cloud["xyz"]), init_points, replace=False)
        store_point_cloud(os.path.join(root, "points3d.ply"),
                          cloud["xyz"][sel]
                          + rng.normal(0, 0.05, (init_points, 3)),
                          rng.random((init_points, 3)))
    return root


def _render_u8(model, R, T, fovx, width):
    from .data.cameras import Camera
    from .render import to_u8
    from .renderer import render
    cam = Camera(uid=0, colmap_id=0, R=R, T=T, fovx=fovx, fovy=fovx,
                 image_name="", width=width, height=width)
    return to_u8(render(model, cam, [0.0, 0.0, 0.0]).render)
