"""Scene: cameras plus the Gaussian model, and the model directory's files.

Counterpart of `sparse_view_3dgs_pack_tpu/scene.py` (reference
`scene/__init__.py:21-152`): detects COLMAP vs Blender layouts, loads the
cameras, and either loads a trained model (`point_cloud/iteration_N/
point_cloud.ply` plus `exposure.json`) or, for training, initialises one
from the scene's point cloud and writes `input.ply` and `cameras.json`.
`save` writes the PLY and `exposure.json` in the JAX package's layout.
`use_nir` (mult-dwtgs) loads each camera's NIR image from `<scene>/nir/`
and gives a new model the NIR parameters.
"""

from __future__ import annotations

import json
import os
import random
import shutil
from typing import Optional

import numpy as np
import torch

from .data import readers
from .data.camera_utils import camera_list_from_cam_infos, camera_to_json
from .device import resolve_device
from .models import gaussians as gm
from .utils.general import searchForMaxIteration


class Scene:
    def __init__(self, args, load_iteration: Optional[int] = None,
                 shuffle: bool = True, resolution_scales=(1.0,),
                 sh_degree: int = 3, device: str | torch.device = "cuda",
                 use_nir: bool = False):
        device = resolve_device(device)
        self.model_path = args.model_path
        self.loaded_iter = None
        if load_iteration is not None:
            if load_iteration == -1:
                self.loaded_iter = searchForMaxIteration(
                    os.path.join(self.model_path, "point_cloud"))
                if self.loaded_iter is None:
                    raise FileNotFoundError(f"no point_cloud/iteration_* "
                                            f"under {self.model_path}")
            else:
                self.loaded_iter = load_iteration
            print(f"Loading trained model at iteration {self.loaded_iter}")

        if os.path.exists(os.path.join(args.source_path, "sparse")):
            scene_info = readers.read_colmap_scene(
                args.source_path, args.images, getattr(args, "depths", ""),
                args.eval, getattr(args, "train_test_exp", False),
                n_views=getattr(args, "n_views", 0),
                point_cloud_type=getattr(args, "point_cloud_type", "dense"))
        elif os.path.exists(os.path.join(args.source_path,
                                         "transforms_train.json")):
            print("Found transforms_train.json, assuming Blender data set!")
            scene_info = readers.read_nerf_synthetic_scene(
                args.source_path, args.white_background,
                getattr(args, "depths", ""), args.eval,
                n_views=getattr(args, "n_views", 0))
        else:
            raise ValueError(f"Could not recognize scene type: "
                             f"{args.source_path}")
        self.scene_info = scene_info

        if not self.loaded_iter:
            if scene_info.ply_path and os.path.exists(scene_info.ply_path):
                shutil.copyfile(scene_info.ply_path,
                                os.path.join(self.model_path, "input.ply"))
            cam_json = [camera_to_json(i, c) for i, c in enumerate(
                scene_info.train_cameras + scene_info.test_cameras)]
            with open(os.path.join(self.model_path, "cameras.json"), "w") as f:
                json.dump(cam_json, f)

        if shuffle:
            random.shuffle(scene_info.train_cameras)
            random.shuffle(scene_info.test_cameras)

        self.cameras_extent = scene_info.nerf_normalization["radius"]
        self.train_cameras = {}
        self.test_cameras = {}
        for scale in resolution_scales:
            self.train_cameras[scale] = camera_list_from_cam_infos(
                scene_info.train_cameras, scale, args,
                scene_info.is_nerf_synthetic, False, use_nir)
            self.test_cameras[scale] = camera_list_from_cam_infos(
                scene_info.test_cameras, scale, args,
                scene_info.is_nerf_synthetic, True, use_nir)

        train = self.train_cameras[resolution_scales[0]]
        n_images = max(len(train), 1)
        if self.loaded_iter:
            exposure = None
            exp_path = os.path.join(self.model_path, "exposure.json")
            if os.path.exists(exp_path):
                with open(exp_path) as f:
                    exp = json.load(f)
                mats = [exp.get(c.image_name, np.eye(3, 4).tolist())
                        for c in train]
                if mats:
                    exposure = np.array(mats, np.float32)
            self.gaussians = gm.load_ply(
                os.path.join(self.model_path, "point_cloud",
                             f"iteration_{self.loaded_iter}",
                             "point_cloud.ply"),
                sh_degree=sh_degree, n_images=n_images, device=device,
                exposure=exposure)
        else:
            pcd = scene_info.point_cloud
            if pcd is None:
                raise ValueError("no point cloud available for init")
            self.gaussians = gm.create_from_pcd(
                pcd.points.astype(np.float32), pcd.colors.astype(np.float32),
                n_images=n_images, sh_degree=sh_degree, use_nir=use_nir,
                device=device)

    def save(self, iteration: int) -> None:
        pc_path = os.path.join(self.model_path, "point_cloud",
                               f"iteration_{iteration}")
        gm.save_ply(self.gaussians, os.path.join(pc_path, "point_cloud.ply"))
        gm.save_exposure_json(self.gaussians,
                              [c.image_name for c in self.getTrainCameras()],
                              os.path.join(self.model_path, "exposure.json"))

    def getTrainCameras(self, scale=1.0):
        return self.train_cameras[scale]

    def getTestCameras(self, scale=1.0):
        return self.test_cameras[scale]
