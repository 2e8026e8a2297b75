"""The benchmark's plain reference against the port at a tiny size on the
CPU, where the port runs its own plain versions: the projection, the
binning and the forward agree bit for bit, the training render's
gradients and a training step to f32 rounding."""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from gsbench import program, scene
from gsbench.reference import render as rr
from gsbench.reference import train as rt
from gsbench.tests.tiny import tiny

W, H = 64, 48


@pytest.fixture(scope="module")
def inputs():
    torch.set_num_threads(2)
    cfg = tiny("lgdwt_m360_garden.refine").cfg
    params = scene.make_cloud(cfg["scene"], 3000, 3, 11, "cpu")
    views = scene.ring_views(cfg["ring"], 4, W, H, cfg["focal_px"], 11, 0)
    return cfg, params, views


def _port_projection(params, view):
    from sparse_view_3dgs_pack_tpu_torch.renderer import project_params
    return project_params(params, view, W, H, 3)


def test_projection_and_binning_bitwise(inputs):
    from sparse_view_3dgs_pack_tpu_torch.ops.binning import bin_gaussians
    _, params, views = inputs
    for view in views:
        ref = rr.project(params, view, W, H, 3)
        port = _port_projection(params, view)
        for name in ref._fields:
            assert torch.equal(getattr(ref, name), getattr(port, name)), name
        bins = rr.bin_pairs(ref.means2d, ref.depths, ref.rect_radii, W, H,
                            16, 16)
        ba = bin_gaussians(port.means2d, port.depths, port.rect_radii, W, H,
                           16, 16)
        assert bins.n_pairs == ba.total_pairs > 0
        assert torch.equal(bins.ids, ba.ids.to(torch.int64))
        assert torch.equal(bins.starts, ba.tile_starts.to(torch.int64))
        assert torch.equal(bins.counts, ba.tile_counts.to(torch.int64))


@pytest.mark.parametrize("tile", [(16, 16), (32, 16)])
def test_forward_bitwise(inputs, tile):
    from sparse_view_3dgs_pack_tpu_torch.ops.binning import bin_gaussians
    from sparse_view_3dgs_pack_tpu_torch.ops.raster import \
        rasterize_forward_torch
    _, params, views = inputs
    with torch.no_grad():
        pr = rr.project(params, views[1], W, H, 3)
    bins = rr.bin_pairs(pr.means2d, pr.depths, pr.rect_radii, W, H, *tile)
    bg = torch.tensor([0.1, 0.2, 0.3])
    ref = rr.forward(pr, bins, bg, W, H, *tile)
    ba = bin_gaussians(pr.means2d, pr.depths, pr.rect_radii, W, H, *tile)
    port = rasterize_forward_torch(
        pr.means2d, pr.depths, pr.conics, pr.colors, pr.opacities, ba.ids,
        ba.tile_starts, ba.tile_counts, bg, W, H, *tile,
        compute_n_contrib=True)
    for name in ("color", "invdepth", "depth", "alpha", "n_contrib",
                 "log_t"):
        assert torch.equal(getattr(ref, name), getattr(port, name)), name
    assert 0 < ref.work.contrib <= int(port.n_contrib.sum())


def test_training_render_gradients(inputs):
    from sparse_view_3dgs_pack_tpu_torch.renderer import render_core
    _, params, views = inputs
    gt = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(3))
    bg = torch.zeros(3)
    ref_leaves = {k: p.clone().requires_grad_(True) for k, p in
                  params.items()}
    img, _, _ = rr.render_train(ref_leaves, views[2], W, H, bg, 3)
    (img - gt).abs().mean().backward()
    port_leaves = {k: p.clone().requires_grad_(True) for k, p in
                   params.items()}
    res = render_core(port_leaves, torch.eye(3, 4), views[2], W, H, bg, 3,
                      inference=False)
    (res.render - gt).abs().mean().backward()
    assert torch.equal(img, res.render)
    for k in params:
        assert torch.allclose(ref_leaves[k].grad, port_leaves[k].grad,
                              rtol=1e-5, atol=1e-9), k
        assert ref_leaves[k].grad.abs().sum() > 0, k


@pytest.mark.parametrize("workload", ["lgdwt_m360_garden.refine",
                                      "3dgs_m360_bicycle.refine"])
def test_steps_follow_the_port(workload):
    """Two reference steps against two `Trainer.step`s over the same views:
    the losses equal and every parameter within f32 rounding."""
    cfg = tiny(workload).cfg
    vs = scene.ring_views(cfg["ring"], 6, W, H, cfg["focal_px"], 5, 0)
    params = scene.make_cloud(cfg["scene"], 3000, 3, 5, "cpu")
    tr = program.trainer(cfg, {k: p.clone() for k, p in params.items()}, vs,
                         5, "cpu")
    taken, losses = [], []
    for _ in range(2):
        before = list(tr.viewpoint_stack)
        losses.append(float(tr.step()["loss"]))
        taken.append(program.taken_view(before, tr.viewpoint_stack, 6))
    m, v = scene.adam_moments(params, cfg["adam_v_scale"], 5)
    targets = scene.make_targets(cfg["targets"], 6, W, H, 5, "cpu",
                                 only=taken)
    out = rt.steps(params, m, v, cfg["iteration"], cfg["iteration"],
                   [vs[i] for i in taken], targets, copy.deepcopy(cfg),
                   program.extent(vs))
    assert out["loss"] == losses
    for k, p in tr.model.params().items():
        np.testing.assert_allclose(p.detach().numpy(), params[k].numpy(),
                                   rtol=1e-6, atol=1e-8, err_msg=k)
