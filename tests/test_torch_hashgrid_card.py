"""The hash-grid kernels (`ops/hashgrid.py`, `csrc/hashgrid.cu`) on a card
(`-m cuda`): against the plain version on the tests' 4-level configuration
and on the published one at 300k points, the wrapper's refusals, and the
launches of one DNGaussian iteration. Each skips without a card: the
kernels have no CPU mode.

No JAX here: the card tests compare with the plain PyTorch version."""

from __future__ import annotations

from argparse import Namespace
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sparse_view_3dgs_pack_tpu_torch import testing
from sparse_view_3dgs_pack_tpu_torch.config import METHOD_OPTS
from sparse_view_3dgs_pack_tpu_torch.models import gaussians as gm
from sparse_view_3dgs_pack_tpu_torch.ops import hashgrid as hg
from sparse_view_3dgs_pack_tpu_torch.train import dng_loop

torch.set_num_threads(1)

# 4 levels from 4 to 32 in a 2^10 table: two dense levels, two hashed
SMALL = hg.HashGridConfig(num_levels=4, level_dim=2, base_resolution=4,
                          log2_hashmap_size=10, desired_resolution=32)
CASES = {"small": (SMALL, 5000, 1.5), "published": (hg.HashGridConfig(),
                                                     300_000, 1.0)}
# The gradients, relative to each one's largest entry: the kernel sums a
# table row's terms (and a point's 16 levels) by atomics, in an order that
# changes from run to run, the plain version by a sort in another order.
GRAD_TOL = 1e-5


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _case(cfg: hg.HashGridConfig, n: int, bound: float, seed: int, dev):
    """(table, x, cotangent) on `dev`: points over and past the bound (the
    clamp) with some on the faces (frac 1), a table of N(0, 1) features."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.1 * bound, 1.1 * bound, (n, 3)).astype(np.float32)
    x[:8] = bound * np.array([[1, 1, 1], [-1, -1, -1], [1, -1, 0],
                              [0, 1, -1], [1, 0.3, 0.2], [-1, 0.5, 1],
                              [2, 2, 2], [0, 0, 0]], np.float32)
    table = rng.normal(size=(cfg.num_levels, 1 << cfg.log2_hashmap_size,
                             cfg.level_dim)).astype(np.float32)
    cot = rng.normal(size=(n, cfg.output_dim)).astype(np.float32)
    return tuple(torch.tensor(a, device=dev) for a in (table, x, cot))


def _close(got, want, tol):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= tol * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_hashgrid_kernels_match_plain(case):
    """The forward the plain version's bit for bit, twice; the table's
    gradient, with and without the points', within `GRAD_TOL` of its
    largest entry of autograd's of the plain version, and rows no point
    touches exactly zero on both sides; the points' gradient within
    `GRAD_TOL`; one launch a call."""
    dev = _card()
    cfg, n, bound = CASES[case]
    table, x, cot = _case(cfg, n, bound, 7, dev)
    f0, b0 = hg.hashgrid_forward.launches, hg.hashgrid_backward.launches
    out = hg.hashgrid_forward(table, x, cfg, bound)
    again = hg.hashgrid_forward(table, x, cfg, bound)
    with torch.no_grad():
        ref = hg.hashgrid_encode_torch(table, x, cfg, bound)
    assert torch.equal(out, ref) and torch.equal(again, ref)

    t, p = table.clone().requires_grad_(), x.clone().requires_grad_()
    (hg.hashgrid_encode_torch(t, p, cfg, bound) * cot).sum().backward()
    g_table, g_x = hg.hashgrid_backward(table, x, cot, cfg, bound, True)
    g_table2, none = hg.hashgrid_backward(table, x, cot, cfg, bound, False)
    torch.cuda.synchronize()
    assert none is None
    untouched = t.grad == 0
    assert 0 < int(untouched.sum()) < untouched.numel()
    for g in (g_table, g_table2):
        _close(g, t.grad, GRAD_TOL)
        assert torch.equal(g == 0, untouched)
    _close(g_x, p.grad, GRAD_TOL)
    assert torch.equal(g_x == 0, p.grad == 0)
    assert (hg.hashgrid_forward.launches - f0,
            hg.hashgrid_backward.launches - b0) == (2, 2)


@pytest.mark.cuda
def test_cuda_hashgrid_function_is_the_kernels():
    """`hashgrid_encode` on CUDA tensors goes through `HashGridFunction`:
    its values are the forward kernel's and its gradients the backward
    kernel's (within `GRAD_TOL`: the atomics), one launch each way; with
    the points' gradient not asked for, none is computed."""
    dev = _card()
    table, x, cot = _case(SMALL, 3000, 1.5, 8, dev)
    f0, b0 = hg.hashgrid_forward.launches, hg.hashgrid_backward.launches
    t, p = table.clone().requires_grad_(), x.clone().requires_grad_()
    out = hg.hashgrid_encode(t, p, SMALL, 1.5)
    (out * cot).sum().backward()
    want_t, want_x = hg.hashgrid_backward(table, x, cot, SMALL, 1.5)
    assert torch.equal(out.detach(), hg.hashgrid_forward(table, x, SMALL,
                                                         1.5))
    _close(t.grad, want_t, GRAD_TOL)
    _close(p.grad, want_x, GRAD_TOL)
    t.grad = None
    (hg.hashgrid_encode(t, x, SMALL, 1.5) * cot).sum().backward()
    _close(t.grad, want_t, GRAD_TOL)
    assert (hg.hashgrid_forward.launches - f0,
            hg.hashgrid_backward.launches - b0) == (3, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("change", ["dtype", "contiguous", "x_shape",
                                    "table_shape", "level_dim", "device"])
def test_cuda_hashgrid_encode_refuses_what_the_kernels_do_not_take(change):
    """On CUDA tensors the wrapper raises, and falls back to nothing, on
    float64, a non-contiguous table, x not (N, 3), a table shape the
    configuration does not give, a level_dim with no instantiation, or
    the points on another device."""
    dev = _card()
    table, x, _ = _case(SMALL, 100, 1.5, 9, dev)
    cfg = SMALL
    bad = {"dtype": lambda: (table.double(), x.double(), cfg),
           "contiguous": lambda: (table.transpose(0, 1).contiguous()
                                  .transpose(0, 1), x, cfg),
           "x_shape": lambda: (table, x[:, :2].contiguous(), cfg),
           "table_shape": lambda: (table, x, cfg._replace(
               log2_hashmap_size=11)),
           "level_dim": lambda: (table[..., :1].repeat(1, 1, 3), x,
                                 cfg._replace(level_dim=3)),
           "device": lambda: (table, x.cpu(), cfg)}[change]()
    launches = hg.hashgrid_forward.launches
    with pytest.raises(ValueError):
        hg.hashgrid_encode(bad[0], bad[1], bad[2], 1.5)
    assert hg.hashgrid_forward.launches == launches


def _dng_trainer(dev, seed: int = 3, n: int = 2000):
    """A `DNGTrainer` of `n` Gaussians and the published field on `dev`, 3
    orbit views of random targets and depth priors, all three passes on
    from its first iteration."""
    rng = np.random.default_rng(seed)
    model = gm.create_from_pcd(rng.uniform(-0.8, 0.8, (n, 3)),
                               rng.random((n, 3)), n_images=3, sh_degree=1,
                               device=dev)
    cams = testing.make_orbit_cameras(3, radius=3.0, width=48)
    for c in cams:
        c.image = rng.random((48, 48, 3)).astype(np.float32)
        c.invdepthmap = (255.0 * rng.random((48, 48))).astype(np.float32)
        c.depth_reliable = True
    scene = SimpleNamespace(gaussians=model, cameras_extent=1.0,
                            getTrainCameras=lambda: cams)
    opt = Namespace(**{**METHOD_OPTS["dngaussian"], "soft_depth_start": 0,
                       "densify_until_iter": 0})
    pipe = Namespace(debug=False, debug_from=-1, antialiasing=False)
    args = Namespace(sh_degree=1, white_background=False)
    return dng_loop.DNGTrainer(scene, opt, pipe, args, seed=seed)


@pytest.mark.cuda
def test_cuda_dng_step_launches_the_hashgrid_three_times_each_way():
    """One `DNGTrainer.step` with all three passes: the field's three
    evaluations (the soft pass's, the photometric render's and its opacity
    penalty's) are three forward launches, their backwards three backward
    launches, and no `sync/grid_levels` wait is left on the card's path."""
    dev = _card()
    tr = _dng_trainer(dev)
    tr.step()
    f0, b0 = hg.hashgrid_forward.launches, hg.hashgrid_backward.launches
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.step()
    torch.cuda.synchronize()
    assert tr.cfg.use_soft
    assert (hg.hashgrid_forward.launches - f0,
            hg.hashgrid_backward.launches - b0) == (3, 3)
    names = [e.name for e in prof.events()]
    assert names.count("step/field") == 3
    assert "sync/grid_levels" not in names
