"""Synthetic fixtures for the port's tests and `chip_smoke.py`.

`look_at_rt`, `make_orbit_cameras`, `make_gaussian_cloud` and
`write_colmap_scene` are copies of the generators in
`sparse_view_3dgs_pack_tpu/testing.py` and give the same numbers from the
same seed; this module adds the rasterizer test scenes of
`tests/test_pallas.py`, a Blender-layout scene writer that needs no PIL,
and the forward-facing COLMAP scene of `scripts/fsgs_fewshot_bench.py`
(`write_llff_colmap_scene`, with an optional NIR band), rendered by the
port's own renderer, and the SIBR remote viewer's camera message for a
camera (`viewer_message`).
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

def write_colmap_scene(root, n_train=6, n_points=500, width=64, height=48,
                       image_dir="images", seed=0):
    """Write a minimal-but-real COLMAP scene tree with random-noise PNGs
    (JAX `testing.write_colmap_scene`: the same cameras, points and pixels
    from the same seed)."""
    from .data import colmap
    from .utils.graphics import fov2focal

    rng = np.random.default_rng(seed)
    sparse = os.path.join(root, "sparse/0")
    os.makedirs(sparse, exist_ok=True)
    imdir = os.path.join(root, image_dir)
    os.makedirs(imdir, exist_ok=True)

    fovx = math.radians(55)
    fx = fov2focal(fovx, width)
    cams = {1: colmap.Camera(1, "PINHOLE", width, height,
                             np.array([fx, fx, width / 2, height / 2]))}
    colmap.write_cameras_binary(cams, os.path.join(sparse, "cameras.bin"))

    images = {}
    for i in range(n_train):
        a = 2 * math.pi * i / n_train
        eye = np.array([3 * math.cos(a), 3 * math.sin(a), 1.0])
        R_c2w, T = look_at_rt(eye, (0, 0, 0))
        qvec = colmap.rotmat2qvec(R_c2w.T)
        name = f"img_{i:03d}.png"
        images[i + 1] = colmap.Image(i + 1, qvec, T, 1, name,
                                     np.zeros((0, 2)),
                                     np.zeros((0,), np.int64))
        arr = (rng.random((height, width, 3)) * 255).astype(np.uint8)
        image_io.write_png(os.path.join(imdir, name), arr)
    colmap.write_images_binary(images, os.path.join(sparse, "images.bin"))

    xyz = rng.uniform(-1, 1, (n_points, 3))
    rgb = (rng.random((n_points, 3)) * 255).astype(np.uint8)
    pts = {i: colmap.Point3D(i, xyz[i], rgb[i], 0.5,
                             np.array([1], np.int32), np.array([0], np.int32))
           for i in range(n_points)}
    colmap.write_points3D_binary(pts, os.path.join(sparse, "points3D.bin"))
    return root


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
              f32_terms: bool, sequential: bool = False):
    """Each pixel's log T_final as a float64 sum, in order, of log1p(-α)
    over the pairs of its tile before its n_contrib (an (H, W) int tensor),
    skipped pairs adding 0. With `f32_terms` α and the skip test are the
    plain version's float32 expression (`ops.blending.alpha_from_power`) and
    only log1p and the sum are float64: what a float32 sum of those terms
    should give, whatever its order. Without it, α and the skip test are
    float64 too, from the same float32 inputs. With `sequential` (and
    `f32_terms`) log1p is float32 too and the terms are summed in float32,
    one pair after the other, as the kernel's running sum adds them. A
    loop over tiles: for the small test frames. Returns a float64 (H, W)
    tensor."""
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
            alpha = alpha_from_power(power, op)
            if not sequential:
                alpha = alpha.double()
        else:
            alpha = torch.clamp(op * torch.exp(torch.clamp(power, max=0.0)),
                                max=ALPHA_MAX)
            alpha = torch.where((power > 0.0) | (alpha < ALPHA_EPS),
                                torch.zeros_like(alpha), alpha)
        before = (torch.arange(c, device=dev)
                  < n_contrib[y0:y1, x0:x1, None].to(dev))
        terms = torch.where(before, torch.log1p(-alpha),
                            torch.zeros_like(alpha))
        if sequential:
            acc = torch.zeros(terms.shape[:2], dtype=dt, device=dev)
            for k in range(c):
                acc = acc + terms[..., k]
            out[y0:y1, x0:x1] = acc.double()
        else:
            out[y0:y1, x0:x1] = terms.sum(-1)
    return out


def knn_stress_cloud(seed: int, n: int) -> np.ndarray:
    """(n, 3) float32 points that stress an exact 3-NN search: a dense
    cluster in [-1, 1]³, 1% far outliers (10 to 10⁴ units out, most more
    than 5 cloud extents from any other point), and exact duplicates (a
    tenth of the points repeat others, some three or more times, so that
    whole neighbour lists tie at distance 0 and go by index)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.0, 1.0, (n, 3))
    n_out = max(n // 100, 4)
    v = rng.normal(size=(n_out, 3))
    v *= 10.0 ** rng.uniform(1.0, 4.0, (n_out, 1)) / np.linalg.norm(
        v, axis=1, keepdims=True)
    pts[:n_out] = v
    n_dup = n // 10
    dst = rng.choice(np.arange(n_out, n), n_dup, replace=False)
    src = rng.choice(np.arange(n_out, n), n_dup // 4, replace=False)
    pts[dst] = pts[src[rng.integers(0, len(src), n_dup)]]
    return pts.astype(np.float32)


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


def viewer_message(cam, train: bool = True, keep_alive: bool = True,
                   scaling_modifier: float = 1.0) -> bytes:
    """The length-prefixed JSON message a SIBR remote viewer sends to ask
    for a frame from `cam` (a `data.cameras.Camera`, any size): its
    float32 matrices transposed into the viewer's row-vector convention,
    with the y/z columns negated that `viewer/network_gui.py::receive`
    negates back, so the MiniCam received holds `cam`'s matrices
    exactly."""
    view = np.asarray(cam.world_view_transform, np.float32).T.copy()
    view[:, 1:3] *= -1
    proj = np.asarray(cam.full_proj_transform, np.float32).T.copy()
    proj[:, 1] *= -1
    msg = json.dumps({
        "resolution_x": cam.width, "resolution_y": cam.height,
        "train": train, "fov_y": cam.fovy, "fov_x": cam.fovx,
        "z_near": cam.znear, "z_far": cam.zfar, "shs_python": False,
        "rot_scale_python": False, "keep_alive": keep_alive,
        "scaling_modifier": scaling_modifier,
        "view_matrix": view.reshape(-1).tolist(),
        "view_projection_matrix": proj.reshape(-1).tolist()}).encode()
    return len(msg).to_bytes(4, "little") + msg


def _render_u8(model, R, T, fovx, width):
    from .data.cameras import Camera
    from .render import to_u8
    from .renderer import render
    cam = Camera(uid=0, colmap_id=0, R=R, T=T, fovx=fovx, fovy=fovx,
                 image_name="", width=width, height=width)
    return to_u8(render(model, cam, [0.0, 0.0, 0.0]).render)


def write_llff_colmap_scene(root: str, seed: int = 3, size: int = 400,
                            n_cams: int = 24, n_gauss: int = 20_000,
                            n_dense: int = 30_000, n_sparse: int = 300,
                            n_outliers: int = 0, nir: bool = False,
                            device="cpu"):
    """The few-shot fixture of `scripts/fsgs_fewshot_bench.py:46`
    (`build_llff_colmap_scene`), with the port's generators and renderer
    (on `device`, black background): a layered cloud of `n_gauss` Gaussians
    (three depth slabs around z = 0, 1.2 and 2.6) seen by `n_cams`
    forward-facing cameras on a jittered 6-wide grid at z ≈ -4 looking at
    (0, 0, 0.8); COLMAP `sparse/0` binaries (one PINHOLE camera), `images/`,
    `n_sparse` noisy SfM-like points, `3_views/dense/fused.ply` (`n_dense`
    noisy surface samples with their true colours, the MVS-style init FSGS
    reads) and `depth_maps/img_NNN.npy`: DPT-style relative disparity,
    0–255, higher = closer, 0 where the render's alpha is at most 0.3 (the
    convention of `fsgs_depth_loss` and of MiDaS). `n_outliers` > 0 adds
    that many stray points to `fused.ply`, as MVS leaves them: uniform in
    direction at 8 to 15 units from the cloud's centre, with random
    colours (none in the JAX script's fixture; FSGS's proximity
    densification and distance split exist for such points). `nir` adds
    the band mult-dwtgs trains on: each ground-truth Gaussian gets an NIR
    albedo drawn uniform in [0.05, 0.95] from `seed` + 2, rendered with
    one channel on a black background into `nir/img_NNN.png` (8-bit
    grayscale), the layout `preprocessing/greenhouse.py` writes; the other
    files are the same with or without it."""
    from .data import colmap
    from .data.cameras import Camera
    from .data.ply import store_point_cloud
    from .models.gaussians import GaussianModel
    from .render import to_u8
    from .renderer import render
    from .utils.graphics import fov2focal

    rng = np.random.default_rng(seed)
    W = H = size
    cloud = make_gaussian_cloud(seed, n_gauss, extent=1.0,
                                scale_range=(0.01, 0.05))
    xyz = cloud["xyz"]
    slab = rng.integers(0, 3, len(xyz))
    xyz[:, 2] = xyz[:, 2] * np.array([0.5, 0.4, 0.8])[slab] \
        + np.array([0.0, 1.2, 2.6])[slab]
    cloud["xyz"] = xyz.astype(np.float32)

    fovx = math.radians(55)
    fovy = 2 * math.atan(math.tan(fovx / 2) * H / W)
    cams = []
    for i in range(n_cams):
        gx = (i % 6 - 2.5) * 0.45 + rng.normal(0, 0.05)
        gy = (i // 6 - 1.5) * 0.45 + rng.normal(0, 0.05)
        eye = np.array([gx, gy, -4.0 + rng.normal(0, 0.08)])
        R, T = look_at_rt(eye, (0, 0, 0.8), up=(0.0, -1.0, 0.0))
        cams.append(Camera(uid=i, colmap_id=i + 1, R=R, T=T, fovx=fovx,
                           fovy=fovy, image_name=f"img_{i:03d}.png",
                           width=W, height=H))

    f = cloud["features"]
    model = GaussianModel(cloud["xyz"], f[:, :1], f[:, 1:], cloud["scales"],
                          cloud["quats"], cloud["opacity"]).to(device)
    sparse0 = os.path.join(root, "sparse/0")
    imdir = os.path.join(root, "images")
    ddir = os.path.join(root, "depth_maps")
    nir_dir = os.path.join(root, "nir")
    for d in (sparse0, imdir, ddir) + ((nir_dir,) if nir else ()):
        os.makedirs(d, exist_ok=True)
    if nir:
        import torch
        albedo = torch.as_tensor(np.random.default_rng(seed + 2).uniform(
            0.05, 0.95, (n_gauss, 1)).astype(np.float32), device=device)
    colmap.write_cameras_binary(
        {1: colmap.Camera(1, "PINHOLE", W, H,
                          np.array([fov2focal(fovx, W), fov2focal(fovy, H),
                                    W / 2, H / 2]))},
        os.path.join(sparse0, "cameras.bin"))
    images = {}
    for i, cam in enumerate(cams):
        res = render(model, cam, [0.0, 0.0, 0.0])
        image_io.write_png(os.path.join(imdir, cam.image_name),
                           to_u8(res.render))
        if nir:
            image_io.write_png(os.path.join(nir_dir, cam.image_name),
                               to_u8(render(model, cam, [0.0],
                                            override_color=albedo).render))
        depth = res.expected_depth.cpu().numpy()
        cov = res.alpha.cpu().numpy() > 0.3
        disp = np.where(cov, 1.0 / np.maximum(depth, 1e-3), 0.0)
        dmax = disp.max() if cov.any() else 1.0
        dmin = disp[cov].min() if cov.any() else 0.0
        disp255 = np.where(cov, 255.0 * (disp - dmin)
                           / max(dmax - dmin, 1e-6), 0.0)
        np.save(os.path.join(ddir, f"img_{i:03d}.npy"),
                disp255.astype(np.float32))
        images[i + 1] = colmap.Image(i + 1, colmap.rotmat2qvec(cam.R.T),
                                     cam.T, 1, cam.image_name,
                                     np.zeros((0, 2)),
                                     np.zeros((0,), np.int64))
    colmap.write_images_binary(images, os.path.join(sparse0, "images.bin"))

    true_cols = 1.0 / (1.0 + np.exp(-cloud["features"][:, 0, :]))
    sel = rng.choice(n_gauss, n_sparse, replace=False)
    pts = {int(i): colmap.Point3D(
               int(i), cloud["xyz"][s] + rng.normal(0, 0.02, 3),
               (true_cols[s] * 255).astype(np.uint8), 0.5,
               np.array([1], np.int32), np.array([0], np.int32))
           for i, s in enumerate(sel)}
    colmap.write_points3D_binary(pts, os.path.join(sparse0, "points3D.bin"))
    dsel = rng.choice(n_gauss, n_dense, replace=True)
    dense = cloud["xyz"][dsel] + rng.normal(0, 0.01, (n_dense, 3))
    cols = true_cols[dsel]
    if n_outliers:
        out = np.random.default_rng(seed + 1)
        v = out.normal(size=(n_outliers, 3))
        v *= out.uniform(8.0, 15.0, (n_outliers, 1)) / np.linalg.norm(
            v, axis=1, keepdims=True)
        dense = np.concatenate([dense, v + np.array([0.0, 0.0, 1.2])])
        cols = np.concatenate([cols, out.random((n_outliers, 3))])
    os.makedirs(os.path.join(root, "3_views/dense"), exist_ok=True)
    store_point_cloud(os.path.join(root, "3_views/dense/fused.ply"), dense,
                      cols)
    return root


PROJECTION_MODES = ("plain", "antialias", "precomp", "override",
                    "confidence")


def projection_case(seed: int, n: int, width: int = 64, height: int = 48,
                    channels: int = 3, sh_degree: int = 3,
                    mode: str = "plain", device="cpu"):
    """(ProjectionInputs, cotangents) of one view of `n` raw Gaussians with
    every case the projection's gradient masks tell apart: a tenth behind
    the near plane, a tenth beside the view beyond the Jacobian's
    1.3·tan_fov clamp, a tenth just off the image with small scales
    (rect-culled), a tenth whose SH colour is clamped at 0, quaternions
    of any length. `mode`: "plain"; "antialias" (with scale_modifier
    0.7); "precomp" (colours given); "override" (activated opacities
    given); "confidence" (FSGS's gradient scale). The cotangents are
    seeded normals of the five differentiable outputs."""
    from .ops.projection import ProjectionCamera, ProjectionInputs
    import torch
    rng = np.random.default_rng(seed)
    cam = make_orbit_cameras(1, radius=4.0, width=width,
                             height_px=height)[0]
    p = cam.params()
    tan_x, tan_y = float(p.tan_fovx), float(p.tan_fovy)
    xyz = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    k = n // 10
    # camera-frame points mapped to the world by the inverse view matrix
    to_world = np.linalg.inv(p.viewmat.astype(np.float64))

    def world(xc, yc, zc):
        pts = np.stack([xc, yc, zc, np.ones_like(zc)], 1) @ to_world.T
        return pts[:, :3].astype(np.float32)

    zc = rng.uniform(1.0, 5.0, k)
    side = rng.choice([-1.0, 1.0], k)
    xyz[:k] = cam.camera_center * 1.6 + 0.2 * xyz[:k]           # behind
    xyz[k:2 * k] = world(side * zc * tan_x * rng.uniform(1.4, 3.0, k),
                         rng.uniform(-0.5, 0.5, k) * zc * tan_y, zc)
    xyz[2 * k:3 * k] = world(rng.uniform(-0.5, 0.5, k) * zc * tan_x,
                             side * zc * tan_y * rng.uniform(1.06, 1.2, k),
                             zc)
    scales = np.log(rng.uniform(0.01, 0.15, (n, 3)))
    scales[2 * k:3 * k] = np.log(rng.uniform(0.001, 0.003, (k, 3)))
    quats = rng.normal(size=(n, 4)) * rng.uniform(0.3, 2.0, (n, 1))
    opacity = rng.uniform(-3.0, 4.0, (n, 1))
    n_sh = (sh_degree + 1) ** 2
    features = rng.normal(0.0, 0.3, (n, 16, channels))
    features[:, 0] = rng.uniform(-1.5, 1.5, (n, channels))
    features[3 * k:4 * k, 0] = -3.0                      # colour clamped at 0
    features[:, n_sh:] = 0.0
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    inp = ProjectionInputs(
        xyz=t(xyz), scaling=t(scales), opacity=t(opacity),
        rotation=t(quats), features_dc=t(features[:, :1]),
        features_rest=t(features[:, 1:]),
        cam=ProjectionCamera(t(p.viewmat), t(p.full_proj),
                             t(p.cam_center), tan_x, tan_y, width, height),
        sh_degree=sh_degree)
    if mode == "antialias":
        inp = inp._replace(antialiasing=True, scale_modifier=0.7)
    elif mode == "precomp":
        inp = inp._replace(colors_precomp=t(rng.uniform(-0.2, 1.2,
                                                       (n, channels))))
    elif mode == "override":
        inp = inp._replace(opacity_override=t(rng.uniform(0.0, 1.0, n)))
    elif mode == "confidence":
        inp = inp._replace(confidence=t(rng.uniform(0.1, 1.0, n)))
    elif mode != "plain":
        raise ValueError(f"unknown projection mode {mode!r}")
    cot = (t(rng.normal(size=(n, 2))), t(rng.normal(size=n)),
           t(rng.normal(size=(n, 3))), t(rng.normal(size=(n, channels))),
           t(rng.normal(size=n)))
    return inp, cot
