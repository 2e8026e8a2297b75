"""Port parity for the differentiable rasterizer (`ops/raster.py`): the
plain backward through `RasterizeFunction` against `jax.grad` of the JAX
dense oracle and the JAX Pallas custom VJP (interpret mode), against
autograd through the plain forward, the wrapper's dispatch, and — on a
card only — the CUDA kernels against their plain versions."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sparse_view_3dgs_pack_tpu.ops import binning as jax_binning
from sparse_view_3dgs_pack_tpu.ops.pallas.raster_vjp import \
    make_pallas_rasterizer
from sparse_view_3dgs_pack_tpu.ops.projection import Projected as JaxProj
from sparse_view_3dgs_pack_tpu.ops.rasterize_ref import \
    rasterize_dense as jax_rasterize_dense
from sparse_view_3dgs_pack_tpu_torch import testing
from sparse_view_3dgs_pack_tpu_torch.ops import raster
from sparse_view_3dgs_pack_tpu_torch.ops.binning import (bin_gaussians,
                                                          tile_grid)
from sparse_view_3dgs_pack_tpu_torch.ops.blending import alpha_from_power
from torch_port import project_both, to_torch

W, H = testing.RASTER_W, testing.RASTER_H
BG = np.array([0.05, 0.1, 0.15], np.float32)
NAMES = ("means2d", "depths", "conics", "colors", "opacities", "bg")
# the bars of tests/test_pallas.py (:116, :163, :199): atol relative to the
# largest reference gradient, and rtol
BARS = {"basic": (3e-5, 2e-3), "multichunk": (1e-4, 5e-3),
        "sticky": (2e-3, 5e-2)}


def _scene(name):
    cloud, cam = testing.raster_scene(name)
    jp, _ = project_both(cloud, cam)
    return jp, to_torch(jp)


def _cotangents(seed=7):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((H, W, 3), (H, W), (H, W), (H, W))]


def _port_grads(tp, tile_x, tile_y, gw):
    """Gradients of Σ out·gw through `RasterizeFunction` (plain versions
    on the CPU), for the five per-Gaussian inputs and bg."""
    ba = bin_gaussians(tp.means2d, tp.depths, tp.radii, W, H, tile_x,
                       tile_y)
    ins = [t.clone().requires_grad_(True) for t in
           (tp.means2d, tp.depths, tp.conics, tp.colors, tp.opacities)]
    bg = torch.tensor(BG, requires_grad=True)
    fn = raster.make_rasterizer(W, H, 3, inference=False, tile_x=tile_x,
                                tile_y=tile_y)
    outs = fn(*ins, ba.ids, ba.tile_starts, ba.tile_counts, bg,
              ba.gaussian_slots, ba.gaussian_offsets)
    sum(torch.sum(o * torch.as_tensor(g)) for o, g in zip(outs, gw)
        ).backward()
    return [t.grad.numpy() for t in ins] + [bg.grad.numpy()], ba


@functools.lru_cache(maxsize=None)
def _oracle_grads(scene):
    """jax.grad of the dense oracle under the cotangents of `_cotangents()`
    (the same for both tile shapes of a scene: computed once)."""
    jp, _ = _scene(scene)
    gw = _cotangents()

    def loss(m2, dep, con, col, op, bg):
        r = jax_rasterize_dense(JaxProj(
            means2d=m2, depths=dep, radii=jp.radii, conics=con, colors=col,
            opacities=op, rect_radii=None), W, H, bg)
        return (jnp.sum(r.color * gw[0]) + jnp.sum(r.invdepth * gw[1])
                + jnp.sum(r.depth * gw[2]) + jnp.sum(r.alpha * gw[3]))

    return [np.asarray(g) for g in jax.grad(loss, argnums=range(6))(
        jp.means2d, jp.depths, jp.conics, jp.colors, jp.opacities,
        jnp.asarray(BG))]


def _assert_grads_close(got, want, live, atol_rel, rtol):
    for g, r, name in zip(got, want, NAMES):
        if name != "bg":          # culled Gaussians: no gradient either side
            g, r = g[live], r[live]
        scale = max(np.abs(r).max(), 1e-3)
        np.testing.assert_allclose(g, r, atol=atol_rel * scale, rtol=rtol,
                                   err_msg=name)
        assert np.abs(g).max() > 0, f"zero gradients for {name}"


@pytest.mark.parametrize("scene,tile", [
    ("basic", (16, 16)), ("multichunk", (16, 16)), ("sticky", (16, 16)),
    ("multichunk", (32, 16)), ("sticky", (32, 16))])
def test_backward_matches_dense_oracle(scene, tile):
    """Every gradient, d_depths and d_bg included, against jax.grad of the
    dense oracle at the JAX kernel's own bars. The oracle culls with
    16-wide tiles; on the basic scene 32×16 tiles cover a few tile-edge
    pixels it does not (PERF.md §6), so that case is held to the JAX
    Pallas VJP at 32×16 instead (next test)."""
    jp, tp = _scene(scene)
    gw = _cotangents()
    got, ba = _port_grads(tp, *tile, gw)
    if scene != "basic":
        assert int(ba.tile_counts.max()) > raster.PLAIN_CHUNK
    _assert_grads_close(got, _oracle_grads(scene),
                        np.asarray(jp.radii) > 0, *BARS[scene])


@pytest.mark.timeout(600)
def test_backward_matches_pallas_vjp_32x16():
    """The basic scene at 32×16 against the JAX Pallas custom VJP
    (`make_pallas_rasterizer`, interpret mode) on the same 32×16 binning,
    at the bar of `tests/test_pallas.py:138`."""
    jp, tp = _scene("basic")
    gw = _cotangents()
    ba = jax_binning.bin_gaussians(jp.means2d, jp.depths, jp.radii, W, H,
                                   1 << 13, 32, 16)
    fn = make_pallas_rasterizer(W, H, 3, tile_x=32, tile_y=16)

    def loss(m2, dep, con, col, op, bg):
        c, invd, d, a = fn(m2, dep, con, col, op, ba.ids, ba.tile_starts,
                           ba.tile_counts, bg)
        return (jnp.sum(c * gw[0]) + jnp.sum(invd * gw[1])
                + jnp.sum(d * gw[2]) + jnp.sum(a * gw[3]))

    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(g) for g in jax.grad(loss, argnums=range(6))(
            jp.means2d, jp.depths, jp.conics, jp.colors, jp.opacities,
            jnp.asarray(BG))]
    got, _ = _port_grads(tp, 32, 16, gw)
    _assert_grads_close(got, want, np.asarray(jp.radii) > 0,
                        *BARS["basic"])


@pytest.mark.parametrize("scene", testing.RASTER_SCENES)
@pytest.mark.parametrize("tile", [(16, 16), (32, 16)])
def test_backward_matches_autograd_of_plain_forward(scene, tile):
    """Internal check on the same binning: the analytic backward against
    torch autograd through `rasterize_forward_torch`, atol 1e-5 of the
    largest gradient (f32 sums in another order; the sticky scene's
    autograd goes through T ~ 1e-4 divisions)."""
    _, tp = _scene(scene)
    gw = _cotangents(3)
    got, ba = _port_grads(tp, *tile, gw)
    ins = [t.clone().requires_grad_(True) for t in
           (tp.means2d, tp.depths, tp.conics, tp.colors, tp.opacities)]
    bg = torch.tensor(BG, requires_grad=True)
    out = raster.rasterize_forward_torch(*ins, ba.ids, ba.tile_starts,
                                         ba.tile_counts, bg, W, H, *tile)
    sum(torch.sum(o * torch.as_tensor(g)) for o, g in zip(
        (out.color, out.invdepth, out.depth, out.alpha), gw)).backward()
    want = [t.grad.numpy() for t in ins] + [bg.grad.numpy()]
    live = tp.radii.numpy() > 0
    for g, r, name in zip(got, want, NAMES):
        if name != "bg":
            g, r = g[live], r[live]
        np.testing.assert_allclose(g, r, atol=1e-5 * np.abs(r).max(),
                                   rtol=1e-3, err_msg=name)


def test_gradient_semantics_depths_and_culled():
    """d_depths = -d_invd/depth² + d_depth on finite depths and 0 on the
    culled rows (depth inf, radius 0, as the projection marks them); no NaN
    anywhere; per-pair rows reduce to the per-Gaussian gradients."""
    _, tp = _scene("basic")
    culled = torch.zeros(tp.depths.shape[0], dtype=torch.bool)
    culled[:10] = True
    tp = tp._replace(
        depths=torch.where(culled, torch.tensor(float("inf")), tp.depths),
        radii=torch.where(culled, 0, tp.radii))
    gw = _cotangents(5)
    got, ba = _port_grads(tp, 16, 16, gw)
    for g in got:
        assert np.isfinite(g).all()
    assert np.all(got[1][culled.numpy()] == 0.0)
    fwd = raster.rasterize_forward(tp.means2d, tp.depths, tp.conics,
                                   tp.colors, tp.opacities, ba.ids,
                                   ba.tile_starts, ba.tile_counts,
                                   torch.as_tensor(BG), W, H, 16, 16, True)
    pairs = raster.rasterize_backward(
        tp.means2d, tp.depths, tp.conics, tp.colors, tp.opacities, ba.ids,
        ba.tile_starts, ba.tile_counts, torch.as_tensor(BG), fwd.log_t,
        fwd.n_contrib, *[torch.as_tensor(g) for g in gw], W, H, 16, 16)
    assert pairs.shape == (ba.total_pairs, 11)
    per = raster.pairs_to_gaussians(pairs, ba.ids, ba.gaussian_slots,
                                    ba.gaussian_offsets)
    np.testing.assert_allclose(per[:, 0:2].numpy(), got[0], atol=1e-6)
    np.testing.assert_allclose(per[:, 6:9].numpy(), got[3], atol=1e-6)
    t_final = torch.exp(fwd.log_t)
    np.testing.assert_allclose(1.0 - t_final.numpy(), fwd.alpha.numpy(),
                               atol=1e-6)


def test_backward_wrappers_cpu_and_validation():
    """CPU tensors take the plain versions and leave the launch counts;
    bad dtypes and shapes raise."""
    _, tp = _scene("basic")
    ba = bin_gaussians(tp.means2d, tp.depths, tp.radii, W, H, 16, 16)
    before = (raster.rasterize_backward.launches,
              raster.pairs_to_gaussians.launches)
    gw = _port_grads(tp, 16, 16, _cotangents())
    assert gw is not None
    assert (raster.rasterize_backward.launches,
            raster.pairs_to_gaussians.launches) == before
    img = torch.zeros((H, W))
    args = (tp.means2d, tp.depths, tp.conics, tp.colors, tp.opacities,
            ba.ids, ba.tile_starts, ba.tile_counts, torch.as_tensor(BG),
            img, torch.zeros((H, W), dtype=torch.int32),
            torch.zeros((H, W, 3)), img, img, img)
    with pytest.raises(ValueError, match="n_contrib"):
        raster.rasterize_backward(*args[:10], img, *args[11:], W, H, 16, 16)
    with pytest.raises(ValueError, match="g_color"):
        raster.rasterize_backward(*args[:11], torch.zeros((H, W, 4)),
                                  *args[12:], W, H, 16, 16)
    rows = torch.zeros((ba.total_pairs, 11))
    with pytest.raises(ValueError, match="ids"):
        raster.pairs_to_gaussians(rows, ba.ids.long(), ba.gaussian_slots,
                                  ba.gaussian_offsets)
    with pytest.raises(ValueError, match="gaussian_slots"):
        raster.pairs_to_gaussians(rows, ba.ids, ba.gaussian_slots[1:],
                                  ba.gaussian_offsets)
    with pytest.raises(ValueError, match="gaussian_offsets"):
        raster.pairs_to_gaussians(rows, ba.ids, ba.gaussian_slots,
                                  ba.gaussian_offsets.long())
    with pytest.raises(ValueError, match="gaussian_slots"):
        raster.make_rasterizer(W, H, 3, inference=False)(
            tp.means2d, tp.depths, tp.conics, tp.colors, tp.opacities,
            ba.ids, ba.tile_starts, ba.tile_counts, torch.as_tensor(BG))


def _culled_visible(means2d, conics, opacities, ba, tile_x, tile_y, pixels):
    """(warp, pair) counts over every tile of the frame: those the cull
    box drops, and those it drops although a pixel of the warp passes the
    α ≥ 1/255 test of `alpha_from_power` in f32."""
    boxes = raster.cull_box_torch(means2d, conics, opacities)
    rects = raster.warp_rects(tile_x, tile_y, pixels)
    gx, _ = tile_grid(W, H, tile_x, tile_y)
    lin = torch.arange(tile_x * tile_y)
    culled = dropped = 0
    for t in range(ba.tile_counts.shape[0]):
        s, c = int(ba.tile_starts[t]), int(ba.tile_counts[t])
        if c == 0:
            continue
        g = ba.ids[s:s + c].long()
        ox, oy = (t % gx) * tile_x, (t // gx) * tile_y
        px = (ox + lin % tile_x).float()[:, None]
        py = (oy + lin // tile_x).float()[:, None]
        dx, dy = px - means2d[g, 0], py - means2d[g, 1]
        a, b, cc = conics[g].unbind(1)
        power = -0.5 * (a * dx * dx + cc * dy * dy) - b * dx * dy
        seen = alpha_from_power(power, opacities[g]) > 0          # (pix, k)
        seen = seen[raster.warp_pixels(tile_x, tile_y, pixels)].any(1)
        out = raster.rect_outside(
            boxes[g][None], (rects + torch.tensor([ox, ox, oy, oy]))[:, None])
        culled += int(out.sum())
        dropped += int((out & seen).sum())
    return culled, dropped


@pytest.mark.parametrize("tile_x,tile_y", [(16, 16), (32, 16)])
@pytest.mark.parametrize("pixels", [raster.BWD_PIXELS,
                                    raster.fwd_pixels(False)])
def test_cull_stress_no_visible_pair_culled(tile_x, tile_y, pixels):
    """On the cull-stress frame the plain cull box drops many (warp, pair)
    and never one where a pixel of the warp passes the α test, for warps
    of 2 pixels per thread (the backward and the training forward) and of
    4 (the inference forward)."""
    m2, dep, con, _, op, radii = testing.cull_stress_frame()
    ba = bin_gaussians(m2, dep, radii, W, H, tile_x, tile_y)
    culled, dropped = _culled_visible(m2, con, op, ba, tile_x, tile_y,
                                      pixels)
    assert dropped == 0
    # several warps of a pair, typically; a fifth of the (warp, pair) where
    # a tile has only two warps (16×16 at 4 pixels per thread)
    warps = tile_x * tile_y // (32 * pixels)
    assert culled > (ba.total_pairs if warps >= 4
                     else ba.total_pairs * warps / 5)


@pytest.mark.parametrize("tile_x,tile_y", [(16, 16), (32, 16)])
def test_cull_stress_backward_matches_autograd(tile_x, tile_y):
    """The plain backward on the cull-stress frame against torch autograd
    through the plain forward, at the bar of
    `test_backward_matches_autograd_of_plain_forward`."""
    m2, dep, con, col, op, radii = testing.cull_stress_frame()
    ba = bin_gaussians(m2, dep, radii, W, H, tile_x, tile_y)
    gw = [torch.as_tensor(g) for g in _cotangents(11)]
    bg = torch.as_tensor(BG)
    grads = []
    for through_kernel_path in (True, False):
        ins = [t.clone().requires_grad_(True) for t in (m2, dep, con, col, op)]
        if through_kernel_path:
            outs = raster.make_rasterizer(W, H, 3, inference=False,
                                          tile_x=tile_x, tile_y=tile_y)(
                *ins, ba.ids, ba.tile_starts, ba.tile_counts, bg,
                ba.gaussian_slots, ba.gaussian_offsets)
        else:
            o = raster.rasterize_forward_torch(
                *ins, ba.ids, ba.tile_starts, ba.tile_counts, bg, W, H,
                tile_x, tile_y)
            outs = (o.color, o.invdepth, o.depth, o.alpha)
        sum(torch.sum(o * g) for o, g in zip(outs, gw)).backward()
        grads.append([t.grad.numpy() for t in ins])
    for g, r, name in zip(*grads, NAMES):
        np.testing.assert_allclose(g, r, atol=1e-5 * np.abs(r).max(),
                                   rtol=1e-3, err_msg=name)
        assert np.abs(g).max() > 0, name


def _cuda_case(scene, tile_x, tile_y):
    """Backward inputs on the card: a raster test scene by name, or the
    cull-stress frame ("cull_stress"); returns (arguments, binning)."""
    if scene == "cull_stress":
        m2, dep, con, col, op, radii = testing.cull_stress_frame(
            device="cuda")
    else:
        _, tp = _scene(scene)
        m2, dep, con, col, op, radii = (
            t.cuda() for t in (tp.means2d, tp.depths, tp.conics, tp.colors,
                               tp.opacities, tp.radii))
    ba = bin_gaussians(m2, dep, radii, W, H, tile_x, tile_y)
    bg = torch.as_tensor(BG, device="cuda")
    fwd = raster.rasterize_forward(m2, dep, con, col, op, ba.ids,
                                   ba.tile_starts, ba.tile_counts, bg, W, H,
                                   tile_x, tile_y, True)
    gw = [torch.as_tensor(g, device="cuda") for g in _cotangents()]
    return (m2, dep, con, col, op, ba.ids, ba.tile_starts, ba.tile_counts,
            bg, fwd.log_t, fwd.n_contrib, *gw, W, H, tile_x, tile_y), ba


@pytest.mark.cuda
@pytest.mark.parametrize("scene", testing.RASTER_SCENES + ("cull_stress",))
@pytest.mark.parametrize("tile_x,tile_y", [(16, 16), (32, 16)])
def test_cuda_backward_matches_plain(scene, tile_x, tile_y):
    """K3 and the segment sum against their plain versions: per-pair and
    per-Gaussian rows within 1e-5 of the largest (f32 sums over a tile's
    pixels in another order); two kernel runs bitwise equal. The
    cull-stress frame holds the warp cull to the same bar."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    args, ba = _cuda_case(scene, tile_x, tile_y)
    before = raster.rasterize_backward.launches
    out = raster.rasterize_backward(*args)
    again = raster.rasterize_backward(*args)
    ref = raster.rasterize_backward_torch(*args)
    torch.cuda.synchronize()
    assert raster.rasterize_backward.launches == before + 2
    assert torch.equal(out, again)
    scale = float(ref.abs().max())
    torch.testing.assert_close(out, ref, atol=1e-5 * scale, rtol=0)
    ids, P = args[5], args[0].shape[0]
    order = (ba.gaussian_slots, ba.gaussian_offsets)
    per = raster.pairs_to_gaussians(out, ids, *order)
    assert torch.equal(per, raster.pairs_to_gaussians(again, ids, *order))
    per_ref = raster.pairs_to_gaussians_torch(out.cpu(), ids.cpu(), P)
    torch.testing.assert_close(per.cpu(), per_ref,
                               atol=1e-6 * float(per_ref.abs().max()),
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ("multichunk", "cull_stress"))
def test_cuda_segment_sum_binning_order_is_bitwise_the_sort_order(scene):
    """The segment sum over the binning's per-Gaussian order equals, bit
    for bit, the same call over a stable sort of the ids on the same pair
    rows (the order the wrapper sorted for on every call before)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    args, ba = _cuda_case(scene, 16, 16)
    ids, P = args[5], args[0].shape[0]
    pairs = raster.rasterize_backward(*args)
    slots = torch.sort(ids, stable=True).indices.to(torch.int32)
    offsets = torch.zeros(P + 1, dtype=torch.int32, device="cuda")
    offsets[1:] = torch.cumsum(torch.bincount(ids, minlength=P), 0)
    got = raster.pairs_to_gaussians(pairs, ids, ba.gaussian_slots,
                                    ba.gaussian_offsets)
    want = raster.pairs_to_gaussians(pairs, ids, slots, offsets)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int((got != 0).any(1).sum()) > 0
