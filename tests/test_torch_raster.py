"""Port parity for the forward rasterizer (`ops/raster.py`): its plain
PyTorch version against the JAX dense oracle and the JAX Pallas kernels
(interpret mode), the wrapper's dispatch, and — on a card only — the CUDA
kernel against the plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sparse_view_3dgs_pack_tpu.ops import binning as jax_binning
from sparse_view_3dgs_pack_tpu.ops.pallas.raster import (
    pack_fields, rasterize_forward_pallas, unpack_tiles)
from sparse_view_3dgs_pack_tpu.ops.pallas.raster_vjp import \
    make_pallas_rasterizer
from sparse_view_3dgs_pack_tpu.ops.rasterize_ref import \
    rasterize_dense as jax_rasterize_dense
from sparse_view_3dgs_pack_tpu_torch import testing
from sparse_view_3dgs_pack_tpu_torch.ops import raster
from sparse_view_3dgs_pack_tpu_torch.ops.binning import bin_gaussians
from sparse_view_3dgs_pack_tpu_torch.ops.rasterize_ref import rasterize_dense
from torch_port import project_both, to_torch

W, H = testing.RASTER_W, testing.RASTER_H
BG = np.array([0.1, 0.2, 0.3], np.float32)


def _scene(name):
    cloud, cam = testing.raster_scene(name)
    jp, _ = project_both(cloud, cam)
    return jp, to_torch(jp)


def _plain(tp, tile_x, tile_y, n_contrib):
    ba = bin_gaussians(tp.means2d, tp.depths, tp.radii, W, H, tile_x, tile_y)
    return raster.rasterize_forward_torch(
        tp.means2d, tp.depths, tp.conics, tp.colors, tp.opacities, ba.ids,
        ba.tile_starts, ba.tile_counts, torch.as_tensor(BG), W, H, tile_x,
        tile_y, n_contrib), ba


@pytest.mark.parametrize("scene", testing.RASTER_SCENES)
@pytest.mark.parametrize("n_contrib", [False, True])
def test_plain_forward_matches_dense_oracle(scene, n_contrib):
    """The bar of `tests/test_pallas.py:92-99`: colour/invdepth/alpha 2e-6,
    depth 2e-5. 16×16 tiles, the oracle's cull. The deep tiles of the
    multichunk and sticky scenes span several PLAIN_CHUNK steps, so the
    carries of (log T, done) are exercised."""
    jp, tp = _scene(scene)
    ref = jax_rasterize_dense(jp, W, H, jnp.asarray(BG))
    out, ba = _plain(tp, 16, 16, n_contrib)
    if scene != "basic":
        assert int(ba.tile_counts.max()) > raster.PLAIN_CHUNK
    for name, tol in (("color", 2e-6), ("invdepth", 2e-6), ("alpha", 2e-6),
                      ("depth", 2e-5)):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=tol,
                                   err_msg=name)
    assert (out.n_contrib is not None) == n_contrib


def test_dense_oracle_matches_jax():
    jp, tp = _scene("basic")
    for match in (True, False):
        ref = jax_rasterize_dense(jp, W, H, jnp.asarray(BG),
                                  match_binning_order=match)
        out = rasterize_dense(tp, W, H, torch.as_tensor(BG),
                              match_binning_order=match)
        for name in ("color", "invdepth", "alpha", "depth"):
            np.testing.assert_allclose(getattr(out, name).numpy(),
                                       np.asarray(getattr(ref, name)),
                                       atol=2e-6, rtol=1e-6, err_msg=name)


@pytest.mark.timeout(600)
@pytest.mark.parametrize("scene", ["basic", "multichunk"])
def test_plain_forward_matches_pallas_inference(scene):
    """32×16 inference: the JAX kernel's own tolerance against the oracle
    (`tests/test_pallas.py:219-223`, bf16 single-pass blend and a
    non-sticky cutoff)."""
    jp, tp = _scene(scene)
    ba = jax_binning.bin_gaussians(jp.means2d, jp.depths, jp.radii, W, H,
                                   1 << 14, 32, 16)
    fn = make_pallas_rasterizer(W, H, 3, inference=True, tile_x=32,
                                tile_y=16)
    with pltpu.force_tpu_interpret_mode():
        ref = fn(jp.means2d, jp.depths, jp.conics, jp.colors, jp.opacities,
                 ba.ids, ba.tile_starts, ba.tile_counts, jnp.asarray(BG))
    out, _ = _plain(tp, 32, 16, False)
    for got, want, name in zip((out.color, out.invdepth, out.depth,
                                out.alpha), ref,
                               ("color", "invdepth", "depth", "alpha")):
        if name == "depth":
            continue   # raw depths through a bf16 blend: checked below
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3,
                                   err_msg=name)
    d_scale = float(np.abs(np.asarray(ref[2])).max())
    np.testing.assert_allclose(out.depth.numpy(), np.asarray(ref[2]),
                               atol=5e-3 * d_scale)


@pytest.mark.timeout(600)
@pytest.mark.parametrize("scene", ["basic", "sticky"])
def test_n_contrib_matches_pallas_training(scene):
    """The training instantiation's per-pixel n_contrib (every pair before
    the sticky stop, skipped ones included) against the JAX training kernel:
    equal on ≥ 99.9% of pixels (the kernel's transmittance cumsum is a
    split-bf16 matmul, so a crossing right at ln 1e-4 may flip)."""
    jp, tp = _scene(scene)
    ba = jax_binning.bin_gaussians(jp.means2d, jp.depths, jp.radii, W, H,
                                   1 << 14, 16, 16)
    pd = pack_fields(jp.means2d, jp.depths, jp.conics, jp.colors,
                     jp.opacities, ba.ids)
    with pltpu.force_tpu_interpret_mode():
        raw = rasterize_forward_pallas(
            pd, ba.tile_starts, ba.tile_counts, jnp.asarray(BG), W, H,
            ba.ids.shape[0], 5, mm_precision="split",
            compute_n_contrib=True)
    want = np.asarray(unpack_tiles(raw, W, H, 3)["n_contrib"])
    out, _ = _plain(tp, 16, 16, True)
    got = out.n_contrib.numpy()
    assert got.dtype == np.int32 and got.max() > 0
    assert (got == want).mean() >= 0.999


def test_wrapper_cpu_runs_plain_version():
    """A CPU tensor takes the plain version and leaves the launch count, in
    the inference and the differentiable closure alike."""
    _, tp = _scene("basic")
    ba = bin_gaussians(tp.means2d, tp.depths, tp.radii, W, H, 32, 16)
    before = raster.rasterize_forward.launches
    args = (tp.means2d, tp.depths, tp.conics, tp.colors, tp.opacities,
            ba.ids, ba.tile_starts, ba.tile_counts, torch.as_tensor(BG))
    out = raster.make_rasterizer(W, H, 3)(*args)
    assert raster.rasterize_forward.launches == before
    ref = raster.rasterize_forward_torch(*args, W, H, 32, 16)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="int32"):
        raster.rasterize_forward(*args[:5], ba.ids.long(), *args[6:], W, H,
                                 32, 16)
    with pytest.raises(ValueError, match="C \\+ 2"):
        raster.rasterize_forward(*args[:3], torch.zeros((tp.colors.shape[0],
                                                         7)),
                                 *args[4:8], torch.zeros(7), W, H, 32, 16)
    # the differentiable closure: same images, still no launch on the CPU
    train = raster.make_rasterizer(W, H, 3, inference=False)(*args)
    for a, b in zip(train, ref):
        assert torch.equal(a, b)
    assert raster.rasterize_forward.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("tile_x,tile_y", [(16, 16), (32, 16)])
@pytest.mark.parametrize("n_contrib", [False, True])
def test_cuda_kernel_matches_plain(tile_x, tile_y, n_contrib):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _, tp = _scene("sticky")
    tp = type(tp)(*[t.cuda() for t in tp])
    ba = bin_gaussians(tp.means2d, tp.depths, tp.radii, W, H, tile_x, tile_y)
    args = (tp.means2d, tp.depths, tp.conics, tp.colors, tp.opacities,
            ba.ids, ba.tile_starts, ba.tile_counts,
            torch.as_tensor(BG, device="cuda"), W, H, tile_x, tile_y,
            n_contrib)
    before = raster.rasterize_forward.launches
    out = raster.rasterize_forward(*args)
    ref = raster.rasterize_forward_torch(*args)
    torch.cuda.synchronize()
    assert raster.rasterize_forward.launches == before + 1
    for name in ("color", "invdepth", "alpha"):
        torch.testing.assert_close(getattr(out, name), getattr(ref, name),
                                   atol=1e-5, rtol=0)
    torch.testing.assert_close(out.depth, ref.depth, atol=1e-5 * float(
        ref.depth.abs().max()), rtol=0)
    if n_contrib:
        assert torch.equal(out.n_contrib, ref.n_contrib)
