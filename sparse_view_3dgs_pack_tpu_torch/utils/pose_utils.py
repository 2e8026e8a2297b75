"""Camera-path synthesis: spiral/ellipse render paths and FSGS pseudo-views.

Covers the roles of the reference `FSGS/utils/pose_utils.py`
(`generate_spiral_path:46`, `generate_ellipse_path:140`,
`generate_random_poses_llff:207`, `generate_random_poses_360:257`): video
fly-throughs for `render.py --video` and random nearby training poses for
FSGS's pseudo-view depth distillation. Implemented from the standard LLFF/
mip-NeRF pose math on this framework's Camera objects.

The port's copy of `sparse_view_3dgs_pack_tpu/utils/pose_utils.py`, numpy
only; `stepfun` is the port's numpy copy of `sample_np`.
"""

from __future__ import annotations

import math

import numpy as np

from ..data.cameras import Camera
from . import stepfun


def _c2w(cam: Camera) -> np.ndarray:
    w2c = np.eye(4)
    w2c[:3, :3] = cam.R.T
    w2c[:3, 3] = cam.T
    return np.linalg.inv(w2c)


def _camera_from_c2w(c2w: np.ndarray, template: Camera, uid: int) -> Camera:
    w2c = np.linalg.inv(c2w)
    return Camera(uid=uid, colmap_id=uid, R=w2c[:3, :3].T, T=w2c[:3, 3],
                  fovx=template.fovx, fovy=template.fovy,
                  image_name=f"path_{uid:05d}",
                  width=template.width, height=template.height)


def _normalize(v):
    return v / max(np.linalg.norm(v), 1e-12)


def _look_at_pose(position, lookdir, up):
    """c2w with columns (right, down, forward) — COLMAP/3DGS convention."""
    forward = _normalize(lookdir)
    right = _normalize(np.cross(forward, up))
    down = np.cross(forward, right)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = down
    c2w[:3, 2] = forward
    c2w[:3, 3] = position
    return c2w


def average_pose(cams) -> np.ndarray:
    c2ws = np.stack([_c2w(c) for c in cams])
    center = c2ws[:, :3, 3].mean(0)
    forward = _normalize(c2ws[:, :3, 2].mean(0))
    up = -_normalize(c2ws[:, :3, 1].mean(0))
    return _look_at_pose(center, forward, up)


def generate_spiral_path(cams, n_frames: int = 120, n_rots: int = 2,
                         zrate: float = 0.5):
    """LLFF-style spiral about the average pose."""
    c2ws = np.stack([_c2w(c) for c in cams])
    avg = average_pose(cams)
    up = -_normalize(c2ws[:, :3, 1].mean(0))

    positions = c2ws[:, :3, 3]
    rads = np.percentile(np.abs(positions - avg[:3, 3]), 90, axis=0)
    rads = np.where(rads < 1e-6, 0.1, rads)
    focus = avg[:3, 3] + avg[:3, 2] * np.linalg.norm(
        positions - avg[:3, 3], axis=1).mean() * 1.5

    out = []
    for i, theta in enumerate(np.linspace(0, 2 * np.pi * n_rots, n_frames,
                                          endpoint=False)):
        offset = np.array([np.cos(theta), -np.sin(theta),
                           -np.sin(theta * zrate)]) * rads
        position = avg[:3, 3] + avg[:3, :3] @ offset
        c2w = _look_at_pose(position, focus - position, up)
        out.append(_camera_from_c2w(c2w, cams[0], i))
    return out


def generate_ellipse_path(cams, n_frames: int = 120, z_variation: float = 0.0,
                          const_speed: bool = True):
    """360°-style ellipse path at the mean camera height, looking at the
    scene centroid. `const_speed` resamples the angles so arc velocity is
    near constant — the reference default
    (`FSGS/utils/pose_utils.py:180-184`, the repo's one `sample_np` use)."""
    c2ws = np.stack([_c2w(c) for c in cams])
    positions = c2ws[:, :3, 3]
    center = positions.mean(0)
    up = -_normalize(c2ws[:, :3, 1].mean(0))
    offsets = positions - center
    # principal in-plane radii
    rad_a = np.percentile(np.linalg.norm(offsets[:, :2], axis=1), 90)
    z_mean = positions[:, 2].mean()
    z_amp = z_variation * (np.percentile(positions[:, 2], 90)
                           - np.percentile(positions[:, 2], 10))

    def get_positions(theta):
        return center + np.stack([rad_a * np.cos(theta),
                                  rad_a * np.sin(theta),
                                  (z_mean - center[2]
                                   + z_amp * np.sin(2 * theta))], axis=-1)

    theta = np.linspace(0, 2 * np.pi, n_frames + 1, endpoint=True)
    if const_speed:
        lengths = np.linalg.norm(np.diff(get_positions(theta), axis=0),
                                 axis=-1)
        theta = stepfun.sample_np(None, theta, np.log(lengths), n_frames + 1)
    out = []
    for i, position in enumerate(get_positions(theta)[:-1]):
        c2w = _look_at_pose(position, center - position, up)
        out.append(_camera_from_c2w(c2w, cams[0], i))
    return out


def generate_random_poses_llff(cams, n_poses: int = 10000,
                               strength: float = 0.1, seed: int = 0):
    """FSGS pseudo-views for forward-facing scenes
    (`FSGS/utils/pose_utils.py:207`): random convex combinations of nearby
    training poses plus jitter, looking at the shared focus point."""
    rng = np.random.default_rng(seed)
    c2ws = np.stack([_c2w(c) for c in cams])
    positions = c2ws[:, :3, 3]
    up = -_normalize(c2ws[:, :3, 1].mean(0))
    avg = average_pose(cams)
    focus = avg[:3, 3] + avg[:3, 2] * np.linalg.norm(
        positions - avg[:3, 3], axis=1).mean() * 2.0
    scale = (positions.max(0) - positions.min(0)) + 1e-3

    out = []
    for i in range(n_poses):
        w = rng.dirichlet(np.ones(len(cams)))
        pos = w @ positions + rng.normal(0, strength, 3) * scale
        c2w = _look_at_pose(pos, focus - pos, up)
        out.append(_camera_from_c2w(c2w, cams[0], i))
    return out


def generate_random_poses_360(cams, n_poses: int = 10000, seed: int = 0):
    """Pseudo-views for inward-facing captures
    (`FSGS/utils/pose_utils.py:257`): random azimuth on the fitted orbit."""
    rng = np.random.default_rng(seed)
    c2ws = np.stack([_c2w(c) for c in cams])
    positions = c2ws[:, :3, 3]
    center = positions.mean(0)
    up = -_normalize(c2ws[:, :3, 1].mean(0))
    radius = np.linalg.norm(positions - center, axis=1)

    out = []
    for i in range(n_poses):
        theta = rng.uniform(0, 2 * np.pi)
        r = rng.choice(radius) * rng.uniform(0.9, 1.1)
        z = rng.choice(positions[:, 2] - center[2]) * rng.uniform(0.8, 1.2)
        rho = math.sqrt(max(r * r - z * z, 0.01 * r * r))
        pos = center + np.array([rho * np.cos(theta), rho * np.sin(theta), z])
        c2w = _look_at_pose(pos, center - pos, up)
        out.append(_camera_from_c2w(c2w, cams[0], i))
    return out
