"""The yardstick's frozen copy against `chip_smoke.py`'s arithmetic: the
same operations, bytes and least times for the same counts, and on one
small frame the same (pair, pixel) counts from the reference's replay as
from `chip_smoke._work` over the port's own `n_contrib`."""

from __future__ import annotations

import os
import sys

import pytest
import torch

import gsbench
from gsbench import scene
from gsbench.reference import render as rr
from gsbench.tests.tiny import tiny
from gsbench.work import raster, step

sys.path.insert(0, os.path.dirname(os.path.dirname(gsbench.__file__)))
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("C", [1, 3])
def test_operation_counts_are_chip_smokes(C):
    assert raster.SKIP_OPS == chip_smoke.SKIP_OPS
    assert raster.fwd_ops_per_contrib(C) == chip_smoke.fwd_ops_per_contrib(C)
    assert raster.bwd_ops_per_contrib(C) == chip_smoke.bwd_ops_per_contrib(C)
    for contrib, stops in ((0, 0), (1000, 7), (79_628_452, 1_089_480)):
        assert raster.blend_ops(C, contrib, stops) == chip_smoke.blend_ops(
            C, contrib, stops)


@pytest.mark.parametrize("n_bytes,n_ops", [(1e9, 1e9), (1e6, 1e12), (0, 5)])
def test_bound_is_chip_smokes(n_bytes, n_ops):
    mine, theirs = raster.bound(n_bytes, n_ops), chip_smoke.bound(n_bytes,
                                                                  n_ops)
    assert mine[1] == theirs[1]
    assert mine[0] * 1e3 == pytest.approx(theirs[0], rel=1e-12)


@pytest.mark.parametrize("training", [False, True])
def test_kernel_bounds_are_chip_smokes(training):
    P, C, n_pairs, tiles, W, H = 3_000_000, 3, 10_700_000, 4293, 1297, 840
    contrib, stops = 79_628_452, 1_089_480
    work = chip_smoke.Work(contrib + 11, 11, stops, 0, 0, 0, 0, 0, 0, 0, 0)
    mine = raster.fwd_bound(P, C, n_pairs, tiles, W, H, contrib, stops,
                            training)
    theirs = chip_smoke._fwd_bound(P, C, n_pairs, tiles, W, H, work,
                                   training)
    assert mine[0] * 1e3 == pytest.approx(theirs[0], rel=1e-12)
    mine = raster.bwd_bound(P, C, n_pairs, tiles, W, H, contrib)
    theirs = chip_smoke._bwd_bound(P, C, n_pairs, tiles, W, H, work)
    assert mine[0] * 1e3 == pytest.approx(theirs[0], rel=1e-12)
    mine = raster.segsum_bound(P, C + 8, n_pairs)
    theirs = chip_smoke._segsum_bound(P, C + 8, n_pairs)
    assert mine[0] * 1e3 == pytest.approx(theirs[0], rel=1e-12)


@pytest.mark.parametrize("tile", [(16, 16), (32, 16)])
def test_replay_counts_are_chip_smokes_work(tile):
    """On one small frame: contributing evaluations and stops from the
    reference's replay equal `chip_smoke._work`'s from the port's plain
    forward's n_contrib."""
    from sparse_view_3dgs_pack_tpu_torch.ops.binning import bin_gaussians
    from sparse_view_3dgs_pack_tpu_torch.ops.raster import (
        fwd_pixels, rasterize_forward_torch)
    from sparse_view_3dgs_pack_tpu_torch.renderer import project_params
    torch.set_num_threads(2)
    W, H = 72, 40
    cfg = tiny("lgdwt_m360_garden.refine").cfg
    params = scene.make_cloud(cfg["scene"], 4000, 3, 3, "cpu")
    view = scene.ring_views(cfg["ring"], 3, W, H, 50.0, 3, 0)[1]
    with torch.no_grad():
        proj = project_params(params, view, W, H, 3)
    ba = bin_gaussians(proj.means2d, proj.depths, proj.rect_radii, W, H,
                       *tile)
    out = rasterize_forward_torch(
        proj.means2d, proj.depths, proj.conics, proj.colors,
        proj.opacities, ba.ids, ba.tile_starts, ba.tile_counts,
        torch.zeros(3), W, H, *tile, compute_n_contrib=True)
    theirs = chip_smoke._work(proj, ba, out.n_contrib, W, H, *tile,
                              fwd_pixels(tile == (16, 16)))
    work, n_pairs, tiles = rr.count_work(params, view, W, H, 3, *tile)
    assert n_pairs == ba.total_pairs
    assert work.contrib == theirs.before_stop - theirs.skipped > 0
    assert work.stops == theirs.stops > 0


def test_step_count_is_positive_and_grows_with_work():
    a = step.train_step_ops(1000, 59_000, 64, 48, True, 100, 10, 50)
    b = step.train_step_ops(1000, 59_000, 64, 48, True, 200, 10, 50)
    assert 0 < a < b
    assert step.train_step_ops(1000, 59_000, 64, 48, False, 100, 10, 50) < a
    assert step.frame_ops(1000, 100, 10) < a
