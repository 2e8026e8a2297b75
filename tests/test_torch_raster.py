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
    train = raster.make_rasterizer(W, H, 3, inference=False)(
        *args, ba.gaussian_slots, ba.gaussian_offsets)
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


@pytest.mark.parametrize("tile_x,tile_y", [(16, 16), (32, 16), (16, 8)])
@pytest.mark.parametrize("n_contrib", [False, True])
def test_forward_warp_layout_covers_each_pixel_once(tile_x, tile_y,
                                                     n_contrib):
    """The forward kernel's warp layout (`raster.fwd_pixels` rows per
    thread: 2 training, 4 inference) gives every pixel of a tile to exactly
    one warp, and each warp's rectangle (`raster.warp_rects`, the
    rectangle its cull tests) holds exactly that warp's pixels."""
    pixels = raster.fwd_pixels(n_contrib)
    wp = raster.warp_pixels(tile_x, tile_y, pixels)
    assert wp.shape == (tile_x * tile_y // (32 * pixels), 32 * pixels)
    assert torch.equal(wp.flatten().sort().values,
                       torch.arange(tile_x * tile_y))
    for w, (x0, x1, y0, y1) in enumerate(
            raster.warp_rects(tile_x, tile_y, pixels).tolist()):
        x, y = torch.meshgrid(torch.arange(x0, x1 + 1),
                              torch.arange(y0, y1 + 1), indexing="xy")
        assert torch.equal((y * tile_x + x).flatten().sort().values,
                           wp[w].sort().values)


def _stress_args(tile_x, tile_y, n_contrib, device):
    m2, dep, con, col, op, radii = testing.cull_stress_frame(device=device)
    ba = bin_gaussians(m2, dep, radii, W, H, tile_x, tile_y)
    return (m2, dep, con, col, op, ba.ids, ba.tile_starts, ba.tile_counts,
            torch.as_tensor(BG, device=device), W, H, tile_x, tile_y,
            n_contrib)


@pytest.mark.parametrize("tile_x,tile_y", [(16, 16), (32, 16), (16, 8)])
def test_plain_log_t_is_its_terms_float64_sum(tile_x, tile_y):
    """On the cull-stress frame the plain version's log T_final is within
    2e-6 of the float64 sum of its own float32 terms: the order of its
    chunked sums costs less than that, so what separates it from the
    float64 sum of float64 terms is the rounding of each term."""
    args = _stress_args(tile_x, tile_y, True, "cpu")
    ref = raster.rasterize_forward_torch(*args)
    m2, _, con, _, op, ids, starts, counts = args[:8]
    exact = testing.log_t_f64(m2, con, op, ids, starts, counts,
                              ref.n_contrib, W, H, tile_x, tile_y, True)
    torch.testing.assert_close(ref.log_t.double(), exact, atol=2e-6,
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("tile_x,tile_y", [(16, 16), (32, 16), (16, 8)])
@pytest.mark.parametrize("n_contrib", [False, True])
def test_cuda_kernel_on_cull_stress_frame(tile_x, tile_y, n_contrib):
    """The kernel's per-warp cull on the frame built to stress it (thin
    diagonal Gaussians, centres on tile corners, opacities at 1/255), at
    both tile shapes of the port and at 16×8 (a block of one warp in the
    inference instantiation, two in the training one): every
    image within 1e-5 of the plain version and n_contrib equal, so no
    culled (warp, pair) held a pixel that blends or stops; log T_final
    within 1e-5 too (the kernel rounds the quadratic form of the thin
    Gaussians term by term, as the plain version does)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    args = _stress_args(tile_x, tile_y, n_contrib, "cuda")
    out = raster.rasterize_forward(*args)
    ref = raster.rasterize_forward_torch(*args)
    torch.cuda.synchronize()
    for name in ("color", "invdepth", "alpha"):
        torch.testing.assert_close(getattr(out, name), getattr(ref, name),
                                   atol=1e-5, rtol=0)
    torch.testing.assert_close(out.depth, ref.depth, atol=1e-5 * float(
        ref.depth.abs().max()), rtol=0)
    if n_contrib:
        assert torch.equal(out.n_contrib, ref.n_contrib)
        torch.testing.assert_close(out.log_t, ref.log_t, atol=1e-5, rtol=0)


def test_library_hash_covers_the_headers_a_source_includes(tmp_path,
                                                           monkeypatch):
    """A kernel library's name changes with an edit to a `csrc/` header its
    source includes (so a stale library is never loaded), and not with an
    edit to a header it does not include: both tile kernels include
    `raster_common.cuh`, the probes include no header."""
    from sparse_view_3dgs_pack_tpu_torch.ops import _build
    for p in _build.CSRC_DIR.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    for name in ("raster_fwd", "raster_bwd"):
        assert [p.name for p in _build._headers(name)] == \
            ["raster_common.cuh"]
    assert _build._headers("probes") == []
    names = ("raster_fwd", "raster_bwd", "probes")
    before = {n: _build.library_path(n) for n in names}
    with open(tmp_path / "raster_common.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build.library_path(n) for n in names}
    assert after["raster_bwd"] != before["raster_bwd"]
    assert after["raster_fwd"] != before["raster_fwd"]
    assert after["probes"] == before["probes"]
