"""Camera / projection math (host-side numpy, mirrored in jnp where needed).

Numerically matches the conventions of the reference stack's
``utils/graphics_utils.py`` (see reference `LGDWT-GS/utils/graphics_utils.py:38-76`)
so COLMAP poses produce identical view/projection transforms, but matrices here
are stored in standard math convention (column-vector, left-multiply); the
reference stores transposes for torch row-vector batching.

The port's copy of `sparse_view_3dgs_pack_tpu/utils/graphics.py`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np


class BasicPointCloud(NamedTuple):
    points: np.ndarray   # (N, 3) float
    colors: np.ndarray   # (N, C) float in [0, 1]
    normals: np.ndarray  # (N, 3) float


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def get_world2view(R: np.ndarray, t: np.ndarray,
                   translate: np.ndarray | None = None,
                   scale: float = 1.0) -> np.ndarray:
    """World→camera 4x4.

    ``R`` is the camera-to-world rotation (COLMAP qvec transposed, the storage
    convention of the reference's dataset readers), ``t`` the world→camera
    translation.  ``translate``/``scale`` re-centre and re-scale the camera
    position (used for scene normalisation / NeRF++-style radius).
    """
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0

    if translate is not None or scale != 1.0:
        if translate is None:
            translate = np.zeros(3)
        C2W = np.linalg.inv(Rt)
        cam_center = C2W[:3, 3]
        cam_center = (cam_center + translate) * scale
        C2W[:3, 3] = cam_center
        Rt = np.linalg.inv(C2W)
    return Rt.astype(np.float32)


def get_projection_matrix(znear: float, zfar: float,
                          fovx: float, fovy: float) -> np.ndarray:
    """OpenGL-style perspective projection used by the 3DGS rasterizer.

    Maps camera space to clip space; NDC z in [0, 1] (z_sign = +1 since the
    camera looks down +z in the COLMAP/3DGS convention).
    """
    tan_half_fovy = math.tan(fovy / 2.0)
    tan_half_fovx = math.tan(fovx / 2.0)

    top = tan_half_fovy * znear
    bottom = -top
    right = tan_half_fovx * znear
    left = -right

    P = np.zeros((4, 4), dtype=np.float32)
    z_sign = 1.0
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = z_sign
    P[2, 2] = z_sign * zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def getWorld2View2(R, t, translate=np.array([0.0, 0.0, 0.0]), scale=1.0):
    """Reference-compatible alias (`graphics_utils.py:38`)."""
    return get_world2view(R, t, translate, scale)


def getProjectionMatrix(znear, zfar, fovX, fovY):
    """Reference-compatible alias (`graphics_utils.py:51`)."""
    return get_projection_matrix(znear, zfar, fovX, fovY)
