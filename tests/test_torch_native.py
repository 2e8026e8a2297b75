"""The port's `data/native.py` (the optional `fastio` readers) against
the port's pure-Python readers, byte for byte, mirroring
`tests/test_native.py`; every test skips where `fastio` is not built."""

import os
import struct

import numpy as np
import pytest

from sparse_view_3dgs_pack_tpu_torch import testing
from sparse_view_3dgs_pack_tpu_torch.data import colmap, native, ply


@pytest.fixture(autouse=True)
def _needs_fastio():
    if not native.AVAILABLE:
        pytest.skip("fastio extension not built")


def _py_points3d(path):
    """The pure-Python reader's loop."""
    xyzs, rgbs, errs = [], [], []
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            vals = struct.unpack("<QdddBBBd", f.read(8 + 24 + 3 + 8))
            xyzs.append(vals[1:4])
            rgbs.append(vals[4:7])
            errs.append(vals[7])
            (tlen,) = struct.unpack("<Q", f.read(8))
            f.seek(8 * tlen, os.SEEK_CUR)
    return (np.array(xyzs).reshape(-1, 3),
            np.array(rgbs, np.uint8).reshape(-1, 3),
            np.array(errs).reshape(-1, 1))


def test_points3d_parity(tmp_path):
    scene = testing.write_colmap_scene(str(tmp_path), n_train=4, n_points=77)
    path = os.path.join(scene, "sparse/0/points3D.bin")
    fast = colmap.read_points3D_binary(path)
    for got, want in zip(fast, _py_points3d(path)):
        np.testing.assert_array_equal(got, want)


def test_images_parity(tmp_path):
    scene = testing.write_colmap_scene(str(tmp_path), n_train=5)
    path = os.path.join(scene, "sparse/0/images.bin")
    fast = colmap.read_images_binary(path)
    slow = colmap.read_images_binary(path, want_points2d=True)
    assert set(fast) == set(slow)
    for k in fast:
        np.testing.assert_array_equal(fast[k].qvec, slow[k].qvec)
        np.testing.assert_array_equal(fast[k].tvec, slow[k].tvec)
        assert fast[k].name == slow[k].name
        assert fast[k].camera_id == slow[k].camera_id


def test_ply_parity_and_python_path_for_other_layouts(tmp_path):
    """float32 / uint8 columns through `fastio`; a float64 column, which
    `fastio` refuses, through the Python reader."""
    rng = np.random.default_rng(0)
    props = {"x": rng.normal(size=50).astype(np.float32),
             "f_dc_0": rng.normal(size=50).astype(np.float32),
             "red": (rng.random(50) * 255).astype(np.uint8)}
    path = str(tmp_path / "g.ply")
    ply.write_ply(path, props)
    fast = native.read_ply_fast(path)
    for k, v in props.items():
        np.testing.assert_array_equal(fast[k], v)
        np.testing.assert_array_equal(ply.read_ply(path)[k], v)
    wide = str(tmp_path / "d.ply")
    ply.write_ply(wide, {"x": rng.normal(size=5)})
    with pytest.raises(OSError):
        native.read_ply_fast(wide)
    assert ply.read_ply(wide)["x"].dtype == np.float64
