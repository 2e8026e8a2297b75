"""Scene: cameras plus a trained model from a model directory.

Counterpart of `sparse_view_3dgs_pack_tpu/scene.py` for its load path:
`point_cloud/iteration_N/point_cloud.ply` plus `exposure.json`. Starting
from the scene's point cloud belongs to training, which is not ported yet.
"""

from __future__ import annotations

import json
import os
import random

import numpy as np
import torch

from .data import readers
from .data.camera_utils import camera_list_from_cam_infos
from .models import gaussians as gm
from .utils.general import searchForMaxIteration


class Scene:
    def __init__(self, args, load_iteration: int, shuffle: bool = True,
                 resolution_scales=(1.0,), sh_degree: int = 3,
                 device: str | torch.device = "cpu"):
        if load_iteration is None:
            raise NotImplementedError(
                "initialising a model from the scene's point cloud is "
                "training, which is not ported yet: give load_iteration")
        self.model_path = args.model_path
        if load_iteration == -1:
            self.loaded_iter = searchForMaxIteration(
                os.path.join(self.model_path, "point_cloud"))
        else:
            self.loaded_iter = load_iteration
        if self.loaded_iter is None:
            raise FileNotFoundError(f"no point_cloud/iteration_* under "
                                    f"{self.model_path}")
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

        if shuffle:
            random.shuffle(scene_info.train_cameras)
            random.shuffle(scene_info.test_cameras)

        self.cameras_extent = scene_info.nerf_normalization["radius"]
        self.train_cameras = {}
        self.test_cameras = {}
        for scale in resolution_scales:
            self.train_cameras[scale] = camera_list_from_cam_infos(
                scene_info.train_cameras, scale, args,
                scene_info.is_nerf_synthetic, False)
            self.test_cameras[scale] = camera_list_from_cam_infos(
                scene_info.test_cameras, scale, args,
                scene_info.is_nerf_synthetic, True)

        train = self.train_cameras[resolution_scales[0]]
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
                         f"iteration_{self.loaded_iter}", "point_cloud.ply"),
            sh_degree=sh_degree, n_images=max(len(train), 1), device=device,
            exposure=exposure)

    def getTrainCameras(self, scale=1.0):
        return self.train_cameras[scale]

    def getTestCameras(self, scale=1.0):
        return self.test_cameras[scale]
