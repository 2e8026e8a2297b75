"""LLFF `poses_bounds.npy` generation from a COLMAP model (reference
`dataset_preprocessing/poses/pose_utils.py:258` — the standard LLFF
imgs2poses recipe).

Each row is a flattened 3×5 matrix ([R | t | hwf] in LLFF's [down, right,
backwards] axis convention) plus near/far depth bounds from the visible 3D
points' camera-space depths.

The port's copy of `sparse_view_3dgs_pack_tpu/preprocessing/llff_poses.py`
(host only).
"""

from __future__ import annotations

import os

import numpy as np

from ..data import colmap as colmap_io


def load_colmap_model(basedir: str):
    sparse0 = os.path.join(basedir, "sparse", "0")
    cams = colmap_io.read_cameras_binary(os.path.join(sparse0, "cameras.bin"))
    images = colmap_io.read_images_binary(os.path.join(sparse0, "images.bin"))
    pts = colmap_io.read_points3D_binary_full(
        os.path.join(sparse0, "points3D.bin"))
    return cams, images, pts


def gen_poses(basedir: str, factors=None) -> bool:
    sparse0 = os.path.join(basedir, "sparse", "0")
    needed = [os.path.join(sparse0, f"{n}.bin")
              for n in ("cameras", "images", "points3D")]
    if not all(os.path.exists(p) for p in needed):
        print("Need to run COLMAP first")
        return False

    cams, images, pts = load_colmap_model(basedir)
    cam = next(iter(cams.values()))
    h, w, f = cam.height, cam.width, float(cam.params[0])
    hwf = np.array([h, w, f]).reshape(3, 1)

    # order images by name (LLFF perm)
    keys = sorted(images, key=lambda k: images[k].name)

    w2c_mats = []
    for k in keys:
        im = images[k]
        R = colmap_io.qvec2rotmat(im.qvec)
        m = np.eye(4)
        m[:3, :3] = R
        m[:3, 3] = im.tvec
        w2c_mats.append(m)
    w2c = np.stack(w2c_mats)
    c2w = np.linalg.inv(w2c)[:, :3, :4]                  # (N, 3, 4)
    poses = np.concatenate(
        [c2w, np.tile(hwf[None], (len(keys), 1, 1))], axis=2)  # (N, 3, 5)
    # COLMAP [right, down, fwd] → LLFF [down, right, backwards]
    poses = np.concatenate([poses[:, :, 1:2], poses[:, :, 0:1],
                            -poses[:, :, 2:3], poses[:, :, 3:4],
                            poses[:, :, 4:5]], axis=2)

    # depth bounds from visible points
    id2row = {k: i for i, k in enumerate(keys)}
    zs = [[] for _ in keys]
    for p in pts.values():
        for iid in p.image_ids:
            row = id2row.get(int(iid))
            if row is None:
                continue
            z = (w2c[row, 2, :3] @ p.xyz) + w2c[row, 2, 3]
            zs[row].append(z)
    bounds = []
    for z in zs:
        z = np.array(z) if z else np.array([0.1, 10.0])
        bounds.append([np.percentile(z, 0.1), np.percentile(z, 99.9)])
    bounds = np.array(bounds)

    out = np.concatenate([poses.reshape(len(keys), -1), bounds], axis=1)
    np.save(os.path.join(basedir, "poses_bounds.npy"), out)
    print(f"wrote poses_bounds.npy ({out.shape})")

    if factors:
        from .full_colmap import make_image_pyramid
        make_image_pyramid(basedir)
    return True
