"""Self-contained PLY reader/writer (no `plyfile` dependency).

Supports ascii and binary_little_endian, the only formats the 3DGS ecosystem
produces. The writer emits binary_little_endian, matching the byte layout the
reference's `plyfile`-based writer produces for Gaussian checkpoints
(reference `LGDWT-GS/scene/gaussian_model.py:225-256`) and SIBR expects.

The port's copy of `sparse_view_3dgs_pack_tpu/data/ply.py`, line for line
except one: the reader tries the optional `fastio` extension first where it
is built (`data/native.py`), as the JAX module does, and reads the file in
Python when `fastio` refuses its layout (ascii, a property that is neither
float32 nor uint8: an OSError); the JAX module catches any exception there.
"""

from __future__ import annotations

import numpy as np

_PLY_TO_NP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_NP_TO_PLY = {
    np.dtype("i1"): "char", np.dtype("u1"): "uchar",
    np.dtype("i2"): "short", np.dtype("u2"): "ushort",
    np.dtype("i4"): "int", np.dtype("u4"): "uint",
    np.dtype("f4"): "float", np.dtype("f8"): "double",
}


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Read the `vertex` element of a PLY file → {prop_name: 1-D array}.

    List properties and non-vertex elements are not supported (none appear in
    3DGS point clouds / checkpoints).
    """
    from . import native
    if native.AVAILABLE:
        try:
            return native.read_ply_fast(path)
        except OSError:
            pass  # ascii / unusual dtypes → python path
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop, dtype)])
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "comment" or tokens[0] == "obj_info":
                continue
            elif tokens[0] == "element":
                cur = (tokens[1], int(tokens[2]), [])
                elements.append(cur)
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    raise ValueError(f"{path}: list properties unsupported")
                cur[2].append((tokens[2], _PLY_TO_NP[tokens[1]]))
            elif tokens[0] == "end_header":
                break
        if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
            raise ValueError(f"{path}: unknown format {fmt}")

        out = {}
        for name, count, props in elements:
            if fmt == "ascii":
                rows = [f.readline().split() for _ in range(count)]
                arr = np.array(rows, dtype=np.float64)
                rec = {p: arr[:, i].astype(np.dtype(dt))
                       for i, (p, dt) in enumerate(props)}
            else:
                endian = "<" if fmt == "binary_little_endian" else ">"
                dtype = np.dtype([(p, endian + dt) for p, dt in props])
                raw = np.frombuffer(f.read(count * dtype.itemsize),
                                    dtype=dtype, count=count)
                rec = {p: np.ascontiguousarray(raw[p]) for p, _ in props}
            if name == "vertex":
                return rec
            out = rec  # fall back to last element if no vertex
        return out


def write_ply(path: str, props: dict[str, np.ndarray]) -> None:
    """Write arrays as the `vertex` element, binary_little_endian.

    Property order follows dict insertion order; all arrays must be 1-D with
    equal length.
    """
    names = list(props.keys())
    n = len(props[names[0]])
    cols = []
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    for name in names:
        a = np.ascontiguousarray(props[name])
        assert a.ndim == 1 and len(a) == n, (name, a.shape)
        header.append(f"property {_NP_TO_PLY[a.dtype.newbyteorder('=')]} {name}")
        cols.append(a)
    header.append("end_header")
    rec = np.empty(n, dtype=[(name, c.dtype) for name, c in zip(names, cols)])
    for name, c in zip(names, cols):
        rec[name] = c
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())


def fetch_point_cloud(path: str):
    """PLY → BasicPointCloud (reference `dataset_readers.py:fetchPly`)."""
    from ..utils.graphics import BasicPointCloud
    v = read_ply(path)
    pts = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    if "red" in v:
        colors = np.stack([v["red"], v["green"], v["blue"]], axis=1)
        if colors.dtype != np.float32:
            colors = colors.astype(np.float32) / 255.0
    else:
        colors = np.full_like(pts, 0.5)
    if "nx" in v:
        normals = np.stack([v["nx"], v["ny"], v["nz"]], axis=1).astype(np.float32)
    else:
        normals = np.zeros_like(pts)
    return BasicPointCloud(points=pts, colors=colors, normals=normals)


def store_point_cloud(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """BasicPointCloud → PLY with u8 colors (reference `storePly`)."""
    xyz = np.asarray(xyz, dtype=np.float32)
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8:
        rgb = np.clip(rgb * 255.0 if rgb.max() <= 1.0 + 1e-6 else rgb,
                      0, 255).astype(np.uint8)
    zeros = np.zeros(len(xyz), dtype=np.float32)
    write_ply(path, {
        "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
        "nx": zeros, "ny": zeros, "nz": zeros,
        "red": rgb[:, 0], "green": rgb[:, 1], "blue": rgb[:, 2],
    })
