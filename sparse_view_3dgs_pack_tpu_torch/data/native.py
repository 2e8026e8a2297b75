"""Optional native (C++) scene-IO accelerator bindings.

The port's copy of `sparse_view_3dgs_pack_tpu/data/native.py`. Build once
with `python native/setup.py build_ext --inplace`. When the `fastio`
extension is importable, `data/colmap.py` and `data/ply.py` route their
hot binary readers through it; otherwise pure-Python paths are used. This
is host IO, not a device path. Outputs are verified byte-identical by
`tests/test_torch_native.py`.
"""

from __future__ import annotations

import numpy as np

try:
    import fastio as _fastio
    AVAILABLE = True
except ImportError:
    _fastio = None
    AVAILABLE = False


def read_points3d_binary_fast(path):
    bx, br, be, n = _fastio.read_points3d_bin(path)
    xyz = np.frombuffer(bx, dtype="<f8").reshape(n, 3)
    rgb = np.frombuffer(br, dtype=np.uint8).reshape(n, 3)
    err = np.frombuffer(be, dtype="<f8").reshape(n, 1)
    return xyz.copy(), rgb.copy(), err.copy()


def read_images_binary_fast(path):
    from .colmap import Image
    out = {}
    for (iid, q, t, cam_id, name) in _fastio.read_images_bin(path):
        out[iid] = Image(iid, np.array(q), np.array(t), cam_id, name,
                         np.zeros((0, 2)), np.zeros((0,), np.int64))
    return out


def read_ply_fast(path):
    names, formats, n, raw = _fastio.read_ply_raw(path)
    dtype = np.dtype([(nm, "<f4" if f == "f" else "u1")
                      for nm, f in zip(names, formats)])
    rec = np.frombuffer(raw, dtype=dtype, count=n)
    return {nm: np.ascontiguousarray(rec[nm]) for nm in names}
