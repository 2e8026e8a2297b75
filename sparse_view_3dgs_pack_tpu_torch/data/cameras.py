"""Host-side camera objects + device-side camera pytree.

Role of the reference `scene/cameras.py` (`LGDWT-GS/scene/cameras.py:19-102`):
per-view GT image, alpha mask, mono inverse-depth map, view/projection
transforms. Host state is numpy; `params()` yields the `CameraParams` the
renderer moves to the device.

The port's copy of `sparse_view_3dgs_pack_tpu/data/cameras.py`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np

from ..utils.graphics import get_projection_matrix, get_world2view


class CameraParams(NamedTuple):
    """Device-side view parameters (all float32, math convention: p_cam =
    viewmat @ p_world; clip = full_proj @ p_world)."""
    viewmat: np.ndarray      # (4, 4)
    full_proj: np.ndarray    # (4, 4)
    cam_center: np.ndarray   # (3,)
    tan_fovx: np.ndarray     # ()
    tan_fovy: np.ndarray     # ()


@dataclass
class Camera:
    uid: int
    colmap_id: int
    R: np.ndarray                      # (3,3) cam→world rotation
    T: np.ndarray                      # (3,) world→cam translation
    fovx: float
    fovy: float
    image_name: str
    width: int
    height: int
    image: Optional[np.ndarray] = None        # (H, W, 3) float32 in [0,1]
    alpha_mask: Optional[np.ndarray] = None   # (H, W) float32
    invdepthmap: Optional[np.ndarray] = None  # (H, W) float32
    depth_mask: Optional[np.ndarray] = None   # (H, W) float32
    depth_reliable: bool = False
    nir: Optional[np.ndarray] = None          # (H, W) float32 (mult-dwtgs)
    znear: float = 0.01
    zfar: float = 100.0
    trans: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    scale: float = 1.0
    is_test: bool = False

    def __post_init__(self):
        self.world_view_transform = get_world2view(
            self.R, self.T, self.trans, self.scale)              # (4,4) W2V
        self.projection_matrix = get_projection_matrix(
            self.znear, self.zfar, self.fovx, self.fovy)
        self.full_proj_transform = (
            self.projection_matrix @ self.world_view_transform).astype(np.float32)
        self.camera_center = np.linalg.inv(
            self.world_view_transform)[:3, 3].astype(np.float32)

    @property
    def image_width(self):
        return self.width

    @property
    def image_height(self):
        return self.height

    def params(self) -> CameraParams:
        return CameraParams(
            viewmat=self.world_view_transform.astype(np.float32),
            full_proj=self.full_proj_transform.astype(np.float32),
            cam_center=self.camera_center.astype(np.float32),
            tan_fovx=np.float32(np.tan(self.fovx * 0.5)),
            tan_fovy=np.float32(np.tan(self.fovy * 0.5)),
        )


class MiniCam:
    """Viewer-supplied camera (reference `scene/cameras.py:88-102`): built
    directly from transforms received over the network_gui socket."""

    def __init__(self, width, height, fovy, fovx, znear, zfar,
                 world_view_transform, full_proj_transform):
        self.width = self.image_width = width
        self.height = self.image_height = height
        self.fovy = fovy
        self.fovx = fovx
        self.znear = znear
        self.zfar = zfar
        # accepts either convention; stored math-convention (left-multiply)
        self.world_view_transform = np.asarray(world_view_transform, np.float32)
        self.full_proj_transform = np.asarray(full_proj_transform, np.float32)
        self.camera_center = np.linalg.inv(
            self.world_view_transform)[:3, 3].astype(np.float32)

    def params(self) -> CameraParams:
        return CameraParams(
            viewmat=self.world_view_transform,
            full_proj=self.full_proj_transform,
            cam_center=self.camera_center,
            tan_fovx=np.float32(np.tan(self.fovx * 0.5)),
            tan_fovy=np.float32(np.tan(self.fovy * 0.5)),
        )
