"""Fit per-image scale/offset aligning mono inverse depth to COLMAP sparse
depth → `sparse/0/depth_params.json` (reference
`utils/make_depth_scale.py:8-50`).

For each image: project its visible 3D points, read the mono inverse-depth
map at those pixels, and least-squares fit  mono·scale + offset ≈ 1/z_colmap.
The training loader consumes depth_params.json via `data/camera_utils.py`
(reliability gating against the median scale, reference `cameras.py:61-84`).

The port's copy of `sparse_view_3dgs_pack_tpu/preprocessing/make_depth_scale.py`
(host only):
`python -m sparse_view_3dgs_pack_tpu_torch.preprocessing.make_depth_scale`.
"""

from __future__ import annotations

import json
import os
from argparse import ArgumentParser

import numpy as np

from ..data import colmap as colmap_io


def fit_image(im, cam, pts3d, invdepth_map):
    R = colmap_io.qvec2rotmat(im.qvec)
    h, w = invdepth_map.shape[:2]
    if cam.model.startswith("SIMPLE") or cam.model in ("RADIAL", "FOV"):
        fx = fy = cam.params[0]
        cx, cy = cam.params[1], cam.params[2]
    else:
        fx, fy = cam.params[0], cam.params[1]
        cx, cy = cam.params[2], cam.params[3]
    sx, sy = w / cam.width, h / cam.height

    monos, invs = [], []
    for pid, xy in zip(im.point3D_ids, im.xys):
        if pid < 0 or pid not in pts3d:
            continue
        p = pts3d[pid].xyz
        pc = R @ p + im.tvec
        if pc[2] <= 0.01:
            continue
        u = int(round((fx * pc[0] / pc[2] + cx) * sx))
        v = int(round((fy * pc[1] / pc[2] + cy) * sy))
        if 0 <= u < w and 0 <= v < h:
            monos.append(invdepth_map[v, u])
            invs.append(1.0 / pc[2])
    if len(monos) < 10:
        return {"scale": 0.0, "offset": 0.0}
    A = np.stack([np.asarray(monos), np.ones(len(monos))], axis=1)
    sol, *_ = np.linalg.lstsq(A, np.asarray(invs), rcond=None)
    return {"scale": float(sol[0]), "offset": float(sol[1])}


def make_depth_scale(source_path: str, depths_dir: str) -> str:
    import cv2

    sparse0 = os.path.join(source_path, "sparse", "0")
    cams = colmap_io.read_cameras_binary(os.path.join(sparse0, "cameras.bin"))
    images = colmap_io.read_images_binary(
        os.path.join(sparse0, "images.bin"), want_points2d=True)
    pts3d = colmap_io.read_points3D_binary_full(
        os.path.join(sparse0, "points3D.bin"))

    params = {}
    for im in images.values():
        stem = os.path.splitext(im.name)[0]
        dpath = os.path.join(source_path, depths_dir, stem + ".png")
        if not os.path.exists(dpath):
            continue
        raw = cv2.imread(dpath, -1)
        if raw is None:
            continue
        inv = raw.astype(np.float32) / float(2 ** 16)
        params[stem] = fit_image(im, cams[im.camera_id], pts3d, inv)

    out = os.path.join(sparse0, "depth_params.json")
    with open(out, "w") as f:
        json.dump(params, f, indent=2)
    print(f"wrote {out} ({len(params)} images)")
    return out


def main(argv=None):
    ap = ArgumentParser()
    ap.add_argument("--base_dir", "-s", required=True)
    ap.add_argument("--depths_dir", "-d", default="depths")
    a = ap.parse_args(argv)
    make_depth_scale(a.base_dir, a.depths_dir)


if __name__ == "__main__":
    main()
