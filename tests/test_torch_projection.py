"""Port parity: `ops/projection.py` and `ops/binning.py` against JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_view_3dgs_pack_tpu.ops import binning as jax_binning
from sparse_view_3dgs_pack_tpu_torch import testing
from sparse_view_3dgs_pack_tpu_torch.ops import binning
from torch_port import project_both, to_torch

FLOAT_FIELDS = ("means2d", "depths", "conics", "colors", "opacities")
INT_FIELDS = ("radii", "rect_radii")


@pytest.mark.parametrize("sh_degree", [0, 3])
@pytest.mark.parametrize("antialiasing", [False, True])
def test_projection_matches_jax(sh_degree, antialiasing):
    cloud = testing.make_sh3_cloud(5, 400, extent=1.0,
                                   scale_range=(0.01, 0.1))
    if sh_degree == 0:
        cloud["features"] = cloud["features"][:, :1]
    cam = testing.make_orbit_cameras(1, radius=3.0, width=64,
                                     height_px=48)[0]
    # a tenth of the cloud behind the camera: near-culled rows
    eye = cam.camera_center
    cloud["xyz"][::10] = eye * 1.6 + 0.2 * cloud["xyz"][::10]
    jp, tp = project_both(cloud, cam, sh_degree, antialiasing)
    for name in FLOAT_FIELDS:
        # f32 rounding of the same arithmetic in another order
        np.testing.assert_allclose(getattr(tp, name).numpy(),
                                   np.asarray(getattr(jp, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    assert np.isinf(tp.depths.numpy()).sum() > 0, "scene must cull some"
    for name in INT_FIELDS:
        a = getattr(tp, name).numpy()
        b = np.asarray(getattr(jp, name))
        # a ceil() may flip where f32 order differs: ±1 on ≤0.5% of rows
        assert np.abs(a - b).max() <= 1, name
        assert (a != b).any(axis=-1 if a.ndim == 2 else None).mean() \
            <= 0.005, name


@pytest.mark.parametrize("tile_x,tile_y", [(16, 16), (32, 16)])
def test_binning_matches_jax(tile_x, tile_y):
    """Both sides binned from JAX's own means2d/depths/rect_radii: the
    sorted ids, tile starts and counts are identical, tie order included."""
    cloud, cam = testing.raster_scene("multichunk")
    jp, _ = project_both(cloud, cam)
    W, H = cam.width, cam.height
    ref = jax_binning.bin_gaussians(jp.means2d, jp.depths, jp.rect_radii, W,
                                    H, 1 << 14, tile_x, tile_y)
    tp = to_torch(jp)
    out = binning.bin_gaussians(tp.means2d, tp.depths, tp.rect_radii, W, H,
                                tile_x, tile_y)
    n = int(ref.total_pairs)
    assert out.total_pairs == n > 0
    np.testing.assert_array_equal(out.ids.numpy(), np.asarray(ref.ids)[:n])
    np.testing.assert_array_equal(out.tile_starts.numpy(),
                                  np.asarray(ref.tile_starts))
    np.testing.assert_array_equal(out.tile_counts.numpy(),
                                  np.asarray(ref.tile_counts))
    assert binning.count_pairs(tp.means2d, tp.depths, tp.rect_radii, W, H,
                               tile_x, tile_y) == n
    # equal depth keys exist, so the tie order was really exercised
    _, db = binning._key_bits(int(out.tile_counts.shape[0]))
    keys = binning.depth_key(tp.depths, db)[out.ids.long()]
    assert (keys[1:] == keys[:-1]).any()


def test_binning_empty_frame():
    means = torch.zeros((3, 2))
    out = binning.bin_gaussians(means, torch.ones(3),
                                torch.zeros((3, 2), dtype=torch.int32),
                                64, 48, 32, 16)
    assert out.total_pairs == 0 and out.ids.numel() == 0
    assert int(out.tile_counts.sum()) == 0
    assert out.tile_starts.shape == (2 * 3,)


def test_sh_eval_matches_jax():
    from sparse_view_3dgs_pack_tpu.utils.sh import eval_sh as jax_eval_sh
    from sparse_view_3dgs_pack_tpu_torch.utils.sh import eval_sh
    rng = np.random.default_rng(0)
    sh = rng.normal(size=(50, 16, 3)).astype(np.float32)
    d = rng.normal(size=(50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    for deg in range(4):
        np.testing.assert_allclose(
            eval_sh(deg, torch.as_tensor(sh), torch.as_tensor(d)).numpy(),
            np.asarray(jax_eval_sh(deg, jnp.asarray(sh), jnp.asarray(d))),
            rtol=1e-6, atol=1e-6)
