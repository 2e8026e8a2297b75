"""CameraInfo → Camera loading with the reference resolution policy.

Counterpart of `sparse_view_3dgs_pack_tpu/data/camera_utils.py:19-124`, with
the same logic and three changes: images are decoded by `utils/image_io.py`
(PNG natively; PIL only for other formats and for resizing), `cv2` is
imported only when a depth map exists, and the NIR image is loaded when the
caller passes `use_nir` (the JAX loader reads `args.use_nir` from the
ModelParams group, which has no such flag, so the JAX CLI never loads
one; the reference loads it, `mult-dwtgs/utils/camera_utils.py:65-92`).
Images stay host numpy arrays; the renderer moves what it needs to the
device.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils import image_io
from ..utils.graphics import fov2focal
from .cameras import Camera

_WARNED = False


def _load_image(path, resolution):
    arr = image_io.read_image(path)
    if resolution != (arr.shape[1], arr.shape[0]):
        arr = image_io.resize(arr, resolution)
    arr = np.asarray(arr, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


def _resolve_resolution(orig_w, orig_h, resolution_arg, resolution_scale):
    global _WARNED
    if resolution_arg in (1, 2, 4, 8):
        return (round(orig_w / (resolution_scale * resolution_arg)),
                round(orig_h / (resolution_scale * resolution_arg)))
    if resolution_arg == -1:
        if orig_w > 1600:
            if not _WARNED:
                print("[ INFO ] large input images (>1.6K width); rescaling "
                      "to 1.6K. Use --resolution 1 to disable.")
                _WARNED = True
            global_down = orig_w / 1600
        else:
            global_down = 1
    else:
        global_down = orig_w / resolution_arg
    scale = float(global_down) * float(resolution_scale)
    return int(orig_w / scale), int(orig_h / scale)


def load_cam(args, uid, info, resolution_scale, is_nerf_synthetic,
             is_test_dataset, use_nir: bool = False) -> Camera:
    """One camera; with `use_nir`, its `nir` (H, W) from
    `<scene>/nir/<image basename>` where that file exists."""
    arr = _load_image(info.image_path, (info.width, info.height))
    orig_h, orig_w = arr.shape[:2]
    resolution = _resolve_resolution(orig_w, orig_h,
                                     getattr(args, "resolution", -1),
                                     resolution_scale)
    if resolution != (orig_w, orig_h):
        arr = _load_image(info.image_path, resolution)
    W, H = resolution

    if arr.shape[-1] == 4:
        alpha = arr[..., 3]
        rgb = arr[..., :3]
        if is_nerf_synthetic:
            bg = 1.0 if getattr(args, "white_background", False) else 0.0
            rgb = rgb * alpha[..., None] + bg * (1 - alpha[..., None])
    else:
        alpha = np.ones((H, W), np.float32)
        rgb = arr[..., :3] if arr.shape[-1] >= 3 else np.repeat(arr, 3, -1)
    rgb = np.clip(rgb, 0.0, 1.0).astype(np.float32)

    train_test_exp = getattr(args, "train_test_exp", False)
    if train_test_exp and info.is_test:
        alpha = alpha.copy()
        if is_test_dataset:
            alpha[:, : W // 2] = 0
        else:
            alpha[:, W // 2:] = 0

    invdepth = None
    depth_mask = None
    depth_reliable = False
    if info.depth_path and os.path.exists(info.depth_path):
        import cv2  # only depth maps need it

        raw = cv2.imread(info.depth_path, -1)
        if raw is not None:
            raw = raw.astype(np.float32)
            raw /= 512.0 if is_nerf_synthetic else float(2 ** 16)
            invdepth = cv2.resize(raw, resolution)
            invdepth[invdepth < 0] = 0
            depth_mask = np.ones((H, W), np.float32)
            depth_reliable = True
            dp = info.depth_params
            if dp is not None:
                if (dp["scale"] < 0.2 * dp["med_scale"]
                        or dp["scale"] > 5 * dp["med_scale"]):
                    depth_reliable = False
                    depth_mask *= 0
                if dp["scale"] > 0:
                    invdepth = invdepth * dp["scale"] + dp["offset"]
            if invdepth.ndim == 3:
                invdepth = invdepth[..., 0]

    nir = None
    if use_nir:
        nir_path = os.path.join(os.path.dirname(os.path.dirname(
            info.image_path)), "nir", os.path.basename(info.image_path))
        if os.path.exists(nir_path):
            nir_arr = _load_image(nir_path, resolution)
            nir = nir_arr[..., 0].astype(np.float32)

    return Camera(uid=uid, colmap_id=info.uid, R=info.R, T=info.T,
                  fovx=info.fovx, fovy=info.fovy, image_name=info.image_name,
                  width=W, height=H, image=rgb, alpha_mask=alpha,
                  invdepthmap=invdepth, depth_mask=depth_mask,
                  depth_reliable=depth_reliable, nir=nir,
                  is_test=info.is_test)


def camera_list_from_cam_infos(cam_infos, resolution_scale, args,
                               is_nerf_synthetic, is_test_dataset,
                               use_nir: bool = False):
    return [load_cam(args, i, c, resolution_scale, is_nerf_synthetic,
                     is_test_dataset, use_nir) for i, c in enumerate(cam_infos)]


def camera_to_json(uid, camera):
    """`cameras.json` entry of one CameraInfo (reference
    `utils/camera_utils.py:camera_to_JSON`)."""
    rt = np.zeros((4, 4))
    rt[:3, :3] = camera.R.T
    rt[:3, 3] = camera.T
    rt[3, 3] = 1.0
    c2w = np.linalg.inv(rt)
    return {
        "id": uid,
        "img_name": camera.image_name,
        "width": camera.width,
        "height": camera.height,
        "position": c2w[:3, 3].tolist(),
        "rotation": [r.tolist() for r in c2w[:3, :3]],
        "fy": fov2focal(camera.fovy, camera.height),
        "fx": fov2focal(camera.fovx, camera.width),
    }
