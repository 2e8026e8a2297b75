"""Scene readers: COLMAP and Blender (NeRF-synthetic).

The port's own copy of `sparse_view_3dgs_pack_tpu/data/readers.py`, kept
line for line with it except for two changes: `sh2rgb` comes from the
port's `utils/sh.py` (the JAX module imports jax through its own), and image
sizes come from `utils/image_io.py`, not PIL. COLMAP, PLY and camera math
are the port's own copies (`data/colmap.py`, `data/ply.py`,
`utils/graphics.py`).

Behavioural port of the reference `scene/dataset_readers.py`
(`LGDWT-GS/scene/dataset_readers.py:188-330`): llffhold eval split on sorted
image names, n_views linspace subselection, dense/triangulated/sparse point
cloud choice, NeRF++ scene normalisation, depth_params.json ingestion.
"""

from __future__ import annotations

import json
import math
import os
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

from ..utils import image_io
from ..utils.graphics import (BasicPointCloud, focal2fov, fov2focal,
                              get_world2view)
from ..utils.sh import sh2rgb
from . import colmap, ply


class CameraInfo(NamedTuple):
    uid: int
    R: np.ndarray
    T: np.ndarray
    fovy: float
    fovx: float
    depth_params: Optional[dict]
    image_path: str
    image_name: str
    depth_path: str
    width: int
    height: int
    is_test: bool


class SceneInfo(NamedTuple):
    point_cloud: Optional[BasicPointCloud]
    train_cameras: list
    test_cameras: list
    nerf_normalization: dict
    ply_path: str
    is_nerf_synthetic: bool


def get_nerfpp_norm(cam_infos) -> dict:
    """Camera-centroid translate + 1.1× max-radius (reference `getNerfppNorm`)."""
    centers = []
    for cam in cam_infos:
        w2c = get_world2view(cam.R, cam.T)
        centers.append(np.linalg.inv(w2c)[:3, 3])
    centers = np.stack(centers, axis=0)
    avg = centers.mean(axis=0)
    diagonal = np.linalg.norm(centers - avg, axis=1).max()
    return {"translate": -avg, "radius": float(diagonal * 1.1)}


def _focal_pair(intr: colmap.Camera):
    """fx, fy per COLMAP camera model (only pinhole-family focal terms are
    honoured, as in the reference; distortion must be removed by undistort)."""
    two_focal = {"PINHOLE", "OPENCV", "OPENCV_FISHEYE", "FULL_OPENCV",
                 "THIN_PRISM_FISHEYE"}
    fx = float(intr.params[0])
    fy = float(intr.params[1]) if intr.model in two_focal else fx
    return fx, fy


def read_colmap_cameras(cam_extrinsics, cam_intrinsics, depths_params,
                        images_folder, depths_folder, test_cam_names):
    infos = []
    for key in cam_extrinsics:
        extr = cam_extrinsics[key]
        intr = cam_intrinsics[extr.camera_id]
        fx, fy = _focal_pair(intr)
        fovx = focal2fov(fx, intr.width)
        fovy = focal2fov(fy, intr.height)
        R = colmap.qvec2rotmat(extr.qvec).T
        T = np.array(extr.tvec)

        stem = extr.name[: -(len(extr.name.split(".")[-1]) + 1)]
        dp = None
        if depths_params is not None:
            dp = depths_params.get(stem)
        depth_path = (os.path.join(depths_folder, f"{stem}.png")
                      if depths_folder else "")
        infos.append(CameraInfo(
            uid=intr.id, R=R, T=T, fovy=fovy, fovx=fovx, depth_params=dp,
            image_path=os.path.join(images_folder, extr.name),
            image_name=extr.name, depth_path=depth_path,
            width=intr.width, height=intr.height,
            is_test=extr.name in test_cam_names))
    return infos


def read_colmap_scene(path, images="images", depths="", eval=False,
                      train_test_exp=False, llffhold=8, n_views=0,
                      point_cloud_type="dense") -> SceneInfo:
    sparse0 = os.path.join(path, "sparse/0")
    try:
        cam_extr = colmap.read_images_binary(os.path.join(sparse0, "images.bin"))
        cam_intr = colmap.read_cameras_binary(os.path.join(sparse0, "cameras.bin"))
    except FileNotFoundError:
        cam_extr = colmap.read_images_text(os.path.join(sparse0, "images.txt"))
        cam_intr = colmap.read_cameras_text(os.path.join(sparse0, "cameras.txt"))

    depths_params = None
    if depths:
        dp_file = os.path.join(sparse0, "depth_params.json")
        with open(dp_file) as f:
            depths_params = json.load(f)
        scales = np.array([depths_params[k]["scale"] for k in depths_params])
        med_scale = np.median(scales[scales > 0]) if (scales > 0).any() else 0
        for k in depths_params:
            depths_params[k]["med_scale"] = med_scale

    if eval:
        if "360" in path:
            llffhold = 8
        if llffhold:
            names = sorted(cam_extr[k].name for k in cam_extr)
            test_names = {n for i, n in enumerate(names) if i % llffhold == 0}
        else:
            with open(os.path.join(sparse0, "test.txt")) as f:
                test_names = {l.strip() for l in f if l.strip()}
    else:
        test_names = set()

    reading_dir = images if images else "images"
    cam_infos = read_colmap_cameras(
        cam_extr, cam_intr, depths_params,
        images_folder=os.path.join(path, reading_dir),
        depths_folder=os.path.join(path, depths) if depths else "",
        test_cam_names=test_names)
    cam_infos = sorted(cam_infos, key=lambda c: c.image_name)

    train_cams = [c for c in cam_infos if train_test_exp or not c.is_test]
    test_cams = [c for c in cam_infos if c.is_test]

    if n_views > 0 and len(train_cams) > n_views:
        idx = np.linspace(0, len(train_cams) - 1, n_views, dtype=int)
        train_cams = [train_cams[i] for i in idx]

    normalization = get_nerfpp_norm(train_cams)

    # point-cloud selection (reference `dataset_readers.py:261-313`)
    if n_views > 0 and point_cloud_type == "dense":
        ply_path = os.path.join(path, f"{n_views}_views/dense/fused.ply")
    elif n_views > 0 and point_cloud_type == "triangulated":
        tri = os.path.join(path, f"{n_views}_views/triangulated")
        ply_path = os.path.join(tri, "points3D.ply")
        if not os.path.exists(ply_path):
            try:
                xyz, rgb, _ = colmap.read_points3D_binary(
                    os.path.join(tri, "points3D.bin"))
            except FileNotFoundError:
                xyz, rgb, _ = colmap.read_points3D_text(
                    os.path.join(tri, "points3D.txt"))
            ply.store_point_cloud(ply_path, xyz, rgb)
    else:
        ply_path = os.path.join(sparse0, "points3D.ply")

    if "sparse" in ply_path and not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = colmap.read_points3D_binary(
                os.path.join(sparse0, "points3D.bin"))
        except FileNotFoundError:
            xyz, rgb, _ = colmap.read_points3D_text(
                os.path.join(sparse0, "points3D.txt"))
        ply.store_point_cloud(ply_path, xyz, rgb)

    try:
        pcd = ply.fetch_point_cloud(ply_path)
    except Exception:
        pcd = None

    return SceneInfo(point_cloud=pcd, train_cameras=train_cams,
                     test_cameras=test_cams,
                     nerf_normalization=normalization, ply_path=ply_path,
                     is_nerf_synthetic=False)


def read_blender_cameras(path, transformsfile, depths_folder, white_background,
                         is_test, extension=".png"):
    """NeRF-synthetic transforms_{train,test}.json reader (reference
    `readCamerasFromTransforms`)."""
    infos = []
    with open(os.path.join(path, transformsfile)) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    for idx, frame in enumerate(contents["frames"]):
        file_path = frame["file_path"]
        cam_name = os.path.join(path, file_path + extension)
        if not os.path.exists(cam_name) and os.path.exists(
                os.path.join(path, file_path)):
            cam_name = os.path.join(path, file_path)

        # NeRF 'transform_matrix' is camera→world with OpenGL axes; flip y/z
        # to COLMAP convention, then invert for world→camera.
        c2w = np.array(frame["transform_matrix"])
        c2w[:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w)
        R = np.transpose(w2c[:3, :3])
        T = w2c[:3, 3]

        width, height = image_io.image_size(cam_name)
        image_name = Path(cam_name).stem
        fovy = focal2fov(fov2focal(fovx, width), height)
        depth_path = (os.path.join(depths_folder, f"{image_name}.png")
                      if depths_folder else "")
        infos.append(CameraInfo(
            uid=idx, R=R, T=T, fovy=fovy, fovx=fovx, depth_params=None,
            image_path=cam_name, image_name=image_name, depth_path=depth_path,
            width=width, height=height, is_test=is_test))
    return infos


def read_nerf_synthetic_scene(path, white_background=False, depths="",
                              eval=False, n_views=0,
                              extension=".png") -> SceneInfo:
    depths_folder = os.path.join(path, depths) if depths else ""
    train_cams = read_blender_cameras(path, "transforms_train.json",
                                      depths_folder, white_background, False,
                                      extension)
    test_cams = read_blender_cameras(path, "transforms_test.json",
                                     depths_folder, white_background, True,
                                     extension)
    if not eval:
        train_cams.extend(test_cams)
        test_cams = []
    if n_views > 0 and len(train_cams) > n_views:
        idx = np.linspace(0, len(train_cams) - 1, n_views, dtype=int)
        train_cams = [train_cams[i] for i in idx]

    normalization = get_nerfpp_norm(train_cams)

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        # random init inside [-1.3, 1.3]^3, as the reference does
        num_pts = 100_000
        rng = np.random.default_rng(0)
        xyz = rng.random((num_pts, 3)) * 2.6 - 1.3
        shs = rng.random((num_pts, 3)) / 255.0
        ply.store_point_cloud(ply_path, xyz, sh2rgb(shs) * 255)
    try:
        pcd = ply.fetch_point_cloud(ply_path)
    except Exception:
        pcd = None

    return SceneInfo(point_cloud=pcd, train_cameras=train_cams,
                     test_cameras=test_cams,
                     nerf_normalization=normalization, ply_path=ply_path,
                     is_nerf_synthetic=True)


sceneLoadTypeCallbacks = {
    "Colmap": read_colmap_scene,
    "Blender": read_nerf_synthetic_scene,
}
