"""COLMAP model IO: binary + text parsers and writers.

Covers the roles of the reference's `scene/colmap_loader.py` and
`utils/read_write_model.py` (reference `LGDWT-GS/scene/colmap_loader.py`),
implemented from the public COLMAP format spec. Readers return plain
NamedTuples keyed by id, matching COLMAP's own data model.

The port's copy of `sparse_view_3dgs_pack_tpu/data/colmap.py`, line for
line: two binary readers go through the optional `fastio` extension when
it is built (`data/native.py`), as the JAX module's do.
"""

from __future__ import annotations

import os
import struct
from typing import NamedTuple

import numpy as np

# model_id → (name, num_params); public COLMAP camera model table
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: (mid, n) for mid, (name, n) in CAMERA_MODELS.items()}


class Camera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class Image(NamedTuple):
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray


class Point3D(NamedTuple):
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def qvec2rotmat(qvec):
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def rotmat2qvec(R):
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]]]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec = -qvec
    return qvec


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


# ----------------------------------------------------------------- binary IO

def read_cameras_binary(path) -> dict[int, Camera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, np_ = CAMERA_MODELS[model_id]
            params = np.array(_read(f, "<" + "d" * np_))
            cams[cam_id] = Camera(cam_id, name, int(w), int(h), params)
    return cams


def read_images_binary(path, want_points2d: bool = False) -> dict[int, Image]:
    if not want_points2d:
        from . import native
        if native.AVAILABLE:
            return native.read_images_binary_fast(path)
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = _read(f, "<Q")
            data = np.frombuffer(f.read(24 * npts),
                                 dtype=[("xy", "<2f8"), ("pid", "<i8")])
            images[image_id] = Image(image_id, qvec, tvec, camera_id,
                                     name.decode("utf-8"),
                                     np.ascontiguousarray(data["xy"]),
                                     np.ascontiguousarray(data["pid"]))
    return images


def read_points3D_binary(path):
    """→ (xyz (N,3) f64, rgb (N,3) u8, errors (N,1) f64), reference signature."""
    from . import native
    if native.AVAILABLE:
        return native.read_points3d_binary_fast(path)
    xyzs, rgbs, errs = [], [], []
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<QdddBBBd")
            xyzs.append(vals[1:4])
            rgbs.append(vals[4:7])
            errs.append(vals[7])
            (tlen,) = _read(f, "<Q")
            f.seek(8 * tlen, os.SEEK_CUR)
    return (np.array(xyzs, dtype=np.float64).reshape(-1, 3),
            np.array(rgbs, dtype=np.uint8).reshape(-1, 3),
            np.array(errs, dtype=np.float64).reshape(-1, 1))


def read_points3D_binary_full(path) -> dict[int, Point3D]:
    pts = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<QdddBBBd")
            pid = vals[0]
            (tlen,) = _read(f, "<Q")
            track = np.frombuffer(f.read(8 * tlen), dtype="<i4").reshape(-1, 2)
            pts[pid] = Point3D(pid, np.array(vals[1:4]),
                               np.array(vals[4:7], dtype=np.uint8),
                               vals[7],
                               np.ascontiguousarray(track[:, 0]),
                               np.ascontiguousarray(track[:, 1]))
    return pts


# ------------------------------------------------------------------- text IO

def _text_lines(path):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_text(path) -> dict[int, Camera]:
    cams = {}
    for line in _text_lines(path):
        el = line.split()
        cam_id = int(el[0])
        cams[cam_id] = Camera(cam_id, el[1], int(el[2]), int(el[3]),
                              np.array(el[4:], dtype=np.float64))
    return cams


def read_images_text(path) -> dict[int, Image]:
    images = {}
    lines = list(_text_lines(path))
    for i in range(0, len(lines), 2):
        el = lines[i].split()
        image_id = int(el[0])
        qvec = np.array(el[1:5], dtype=np.float64)
        tvec = np.array(el[5:8], dtype=np.float64)
        camera_id = int(el[8])
        name = el[9]
        el2 = lines[i + 1].split() if i + 1 < len(lines) else []
        if el2:
            arr = np.array(el2, dtype=np.float64).reshape(-1, 3)
            xys, pids = arr[:, :2], arr[:, 2].astype(np.int64)
        else:
            xys = np.zeros((0, 2))
            pids = np.zeros((0,), dtype=np.int64)
        images[image_id] = Image(image_id, qvec, tvec, camera_id, name, xys, pids)
    return images


def read_points3D_text(path):
    xyzs, rgbs, errs = [], [], []
    for line in _text_lines(path):
        el = line.split()
        xyzs.append([float(v) for v in el[1:4]])
        rgbs.append([int(v) for v in el[4:7]])
        errs.append(float(el[7]))
    return (np.array(xyzs, dtype=np.float64).reshape(-1, 3),
            np.array(rgbs, dtype=np.uint8).reshape(-1, 3),
            np.array(errs, dtype=np.float64).reshape(-1, 1))


# ------------------------------------------------------------------- writers

def write_cameras_binary(cams: dict[int, Camera], path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            mid, np_ = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            f.write(struct.pack("<" + "d" * np_, *cam.params[:np_]))


def write_images_binary(images: dict[int, Image], path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec,
                                im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", len(im.point3D_ids)))
            for xy, pid in zip(im.xys, im.point3D_ids):
                f.write(struct.pack("<ddq", xy[0], xy[1], int(pid)))


def write_points3D_binary(pts: dict[int, Point3D], path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for p in pts.values():
            f.write(struct.pack("<QdddBBBd", p.id, *p.xyz,
                                *[int(v) for v in p.rgb], p.error))
            f.write(struct.pack("<Q", len(p.image_ids)))
            for iid, pix in zip(p.image_ids, p.point2D_idxs):
                f.write(struct.pack("<ii", int(iid), int(pix)))


def write_images_text(images: dict[int, Image], path):
    with open(path, "w") as f:
        f.write("# Image list\n")
        for im in images.values():
            f.write(f"{im.id} " + " ".join(f"{v:.12g}" for v in im.qvec) + " "
                    + " ".join(f"{v:.12g}" for v in im.tvec)
                    + f" {im.camera_id} {im.name}\n")
            f.write(" ".join(f"{xy[0]:.6g} {xy[1]:.6g} {int(pid)}"
                             for xy, pid in zip(im.xys, im.point3D_ids)) + "\n")


# reference-compatible aliases (`scene/colmap_loader.py`)
read_extrinsics_binary = read_images_binary
read_intrinsics_binary = read_cameras_binary
read_extrinsics_text = read_images_text
read_intrinsics_text = read_cameras_text
