"""Bisect the forward rasterizer on the card:

    python -m sparse_view_3dgs_pack_tpu_torch.probes.fwd_bisect \\
        [--width 64 --height 48 --points 300 --device cuda]

Counterpart of `scripts/tpu_dbg.py`, on its scene (a 300-Gaussian
`make_gaussian_cloud(0, ...)` seen by an orbit camera at radius 4, SH
degree 0, binned into 16x16 tiles). Kernels of increasing likeness to the
forward kernel, each against its plain PyTorch version:
  D1  per-tile (pixel, pair) alpha of the first 256 pairs, without and
      with the walk over every batch (the two must be equal bit for bit);
  D2  the one-batch blend (payload sums, log T, n_contrib);
  K1  the forward kernel itself (training instantiation, zero background)
      against the D2 expectation carried over two batches, on every tile
      of at most 512 pairs. K1 contracts multiply-adds and the plain
      expectation does not, so a pixel may differ by one pair that sits
      within rounding of a skip test (alpha >= 1/255, power <= 0) or of the
      ln 1e-4 stop; such pixels, judged by a float64 replay, count as
      flips against `flip_fraction` instead of as errors.
It prints the worst difference of each and, for a failure, the first bad
tile with its rows (pixels) and columns, then exits 1.
"""

from __future__ import annotations

import sys
from argparse import ArgumentParser
from typing import Callable

import numpy as np
import torch

from .. import testing
from ..device import resolve_device
from ..ops import probes, raster
from ..ops.binning import bin_gaussians
from ..ops.blending import ALPHA_EPS
from ..ops.projection import project_gaussians

ALPHA_TOL = 1e-6     # D1 against its plain version, absolute
BLEND_TOL = 1e-5     # D2 and K1: relative to the largest value compared
K1_LANES = 2 * probes.CHUNK
# K1: how close (relative) to a skip test a pair must be, in a float64
# replay, for a pixel that differs to count as a rounding flip; and how
# many differing pixels are replayed at most
SKIP_TEST_REL = 1e-5
MAX_REPLAYS = 256


def build_scene(width: int, height: int, n_points: int,
                device: torch.device, seed: int = 0):
    """(Projected, Binning) of the script's scene on `device`."""
    cloud = testing.make_gaussian_cloud(seed, n_points, extent=1.0,
                                        scale_range=(0.02, 0.1))
    cam = testing.make_orbit_cameras(1, radius=4.0, width=width,
                                     height_px=height)[0]
    p = cam.params()
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    proj = project_gaussians(
        means3d=t(cloud["xyz"]), scales=torch.exp(t(cloud["scales"])),
        quats=t(cloud["quats"]),
        opacities=torch.sigmoid(t(cloud["opacity"][:, 0])),
        viewmat=t(p.viewmat), full_proj=t(p.full_proj),
        cam_center=t(p.cam_center), tan_fovx=float(p.tan_fovx),
        tan_fovy=float(p.tan_fovy), width=width, height=height,
        sh=t(cloud["features"]), sh_degree=0)
    ba = bin_gaussians(proj.means2d, proj.depths, proj.radii, width, height,
                       probes.TILE, probes.TILE)
    return proj, ba


def pair_args(proj, ba) -> tuple:
    """(means2d, depths, conics, colors, opacities, ids, starts, counts),
    contiguous: the rasterizer's pair list."""
    return (proj.means2d.contiguous(), proj.depths.contiguous(),
            proj.conics.contiguous(), proj.colors.contiguous(),
            proj.opacities.contiguous(), ba.ids, ba.tile_starts,
            ba.tile_counts)


def _report_tile(log, label, diff, bad, tiles, counts):
    """The script's report of the first tile with a bad entry: `diff` and
    `bad` are (n, 256, columns) over the tiles `tiles`."""
    i = int(torch.nonzero(bad.flatten(1).any(1))[0])
    t = int(tiles[i])
    where = torch.nonzero(bad[i])
    rows = sorted(set(where[:, 0].tolist()))[:12]
    cols = sorted(set(where[:, 1].tolist()))[:12]
    log(f"  {label}: first bad tile {t} (pairs {int(counts[t])}): "
        f"maxdiff {float(diff[i].max()):.4g}, {where.shape[0]} bad entries, "
        f"rows (pixels) {rows} columns {cols}")


def _relative(got, want, agree, tiles, counts, log, label, tol):
    """Largest |got - want| where n_contrib agrees, relative to the largest
    |want|; reports the first bad tile past `tol`."""
    scale = float(want.abs().max().clamp(min=1e-30)) if want.numel() else 1.0
    diff = (got - want).abs() * agree[..., None]
    err = float(diff.max()) / scale if diff.numel() else 0.0
    if err > tol:
        _report_tile(log, label, diff, diff > tol * scale, tiles, counts)
    return err


def _k1_tiles(out, width, height, C):
    """The training forward's images as (tiles, 256, C + 4): colour,
    inverse depth, depth, log T, n_contrib; and which entries lie in the
    image."""
    img = torch.cat([out.color, out.invdepth[..., None],
                     out.depth[..., None], out.log_t[..., None],
                     out.n_contrib[..., None].to(torch.float32)], -1)
    inside = torch.ones((height, width, 1), device=img.device)
    tile = probes.TILE
    return (raster._tile(img, width, height, tile, tile),
            raster._tile(inside, width, height, tile, tile)[..., 0] > 0)


def bisect(proj, ba, width: int, height: int, tol: float = BLEND_TOL,
           flip_fraction: float = 0.0,
           log: Callable[[str], None] = print) -> dict:
    """D1, D1 with the walk, D2 and K1 against their plain versions on one
    binned frame. n_contrib may differ at `flip_fraction` of the compared
    pixels (a log T within rounding of ln 1e-4); the other values are
    compared where it agrees. Returns the errors and counts, and "ok"."""
    args = pair_args(proj, ba)
    means2d, depths, conics, colors, opacities, ids, starts, counts = args
    geo = (means2d, conics, opacities, ids, starts, counts, width, height)
    every = torch.arange(counts.shape[0], device=counts.device)
    res = {}

    alpha = probes.tile_alpha(*geo)
    walked = probes.tile_alpha(*geo, walk_all=True)
    ref = probes.tile_alpha_torch(*geo)
    diff = (alpha - ref).abs()
    res["tile_alpha"] = float(diff.max())
    res["tile_alpha_walk_equal"] = bool(torch.equal(alpha, walked))
    log(f"D1 alpha: worst diff {res['tile_alpha']:.4g} (bar {ALPHA_TOL:g}); "
        f"with the walk over every batch bitwise equal: "
        f"{res['tile_alpha_walk_equal']}")
    if res["tile_alpha"] > ALPHA_TOL:
        _report_tile(log, "D1", diff, diff > ALPHA_TOL, every, counts)
    if not res["tile_alpha_walk_equal"]:
        d = (alpha - walked).abs()
        _report_tile(log, "D1 walk", d, d != 0, every, counts)
    del alpha, walked, ref, diff

    n_pix = ba.tile_counts.shape[0] * probes.PIX
    blend = probes.tile_blend(*args, width, height)
    want = probes.tile_blend_torch(*args, width, height)
    agree = blend[..., 9] == want[..., 9]
    res["tile_blend_flips"] = int((~agree).sum())
    res["tile_blend_stops"] = int((want[..., 9] < probes.CHUNK).sum())
    res["tile_blend"] = _relative(blend[..., :9], want[..., :9], agree,
                                  every, counts, log, "D2", tol)
    res["tile_blend_rest_zero"] = bool(
        (blend[..., probes.BLEND_COLS:] == 0).all())
    log(f"D2 blend: worst diff {res['tile_blend']:.4g} of the largest value "
        f"(bar {tol:g}); n_contrib differs at {res['tile_blend_flips']} of "
        f"{n_pix} pixels ({res['tile_blend_stops']} stop within the batch); "
        f"columns past 9 zero: {res['tile_blend_rest_zero']}")
    del blend, want, agree

    C = colors.shape[1]
    out = raster.rasterize_forward(
        *args, torch.zeros(C, device=means2d.device), width, height,
        probes.TILE, probes.TILE, True)
    got, inside = _k1_tiles(out, width, height, C)
    want = probes.tile_blend_torch(*args, width, height, lanes=K1_LANES)
    sel = counts <= K1_LANES
    nc_want = torch.minimum(want[..., 9],
                            counts.to(torch.float32)[:, None])
    want = torch.cat([want[..., :C + 2], want[..., 8:9], nc_want[..., None]],
                     -1)
    got, want, inside = got[sel] * inside[sel][..., None], \
        want[sel] * inside[sel][..., None], inside[sel]
    agree = (got[..., -1] == want[..., -1]) | ~inside
    # K1 contracts multiply-adds, the expectation does not: a pair within
    # rounding of a skip test may be skipped by one and kept by the other
    scale = float(want[..., :-1].abs().max()) if want.numel() else 1.0
    off = ((got[..., :-1] - want[..., :-1]).abs().amax(-1) > tol * scale) \
        & agree
    at_test = torch.zeros_like(off)
    for i, p in torch.nonzero(off)[:MAX_REPLAYS].tolist():
        at_test[i, p] = _at_skip_test(args, int(every[sel][i]), p,
                                      int(got[i, p, -1]), width)
    agree &= ~at_test
    res["raster_fwd_tiles"] = int(sel.sum())
    res["raster_fwd_flips"] = int((got[..., -1] != want[..., -1]).sum())
    res["raster_fwd_skip_flips"] = int(at_test.sum())
    res["raster_fwd"] = _relative(got[..., :-1], want[..., :-1], agree,
                                  every[sel], counts, log, "K1", tol)
    n_cmp = int(inside.sum())
    log(f"K1 forward (training, zero background) vs the two-batch D2 "
        f"expectation on {res['raster_fwd_tiles']} of "
        f"{counts.shape[0]} tiles (<= {K1_LANES} pairs): worst diff "
        f"{res['raster_fwd']:.4g} of the largest value (bar {tol:g}); "
        f"n_contrib differs at {res['raster_fwd_flips']} of {n_cmp} pixels; "
        f"{res['raster_fwd_skip_flips']} pixels differ by a pair within "
        f"rounding of a skip test (float64 replay)")

    allowed_blend = flip_fraction * n_pix
    allowed_k1 = flip_fraction * n_cmp
    res["ok"] = (res["tile_alpha"] <= ALPHA_TOL
                 and res["tile_alpha_walk_equal"]
                 and res["tile_blend"] <= tol
                 and res["tile_blend_flips"] <= allowed_blend
                 and res["tile_blend_rest_zero"]
                 and res["raster_fwd"] <= tol
                 and res["raster_fwd_flips"] + res["raster_fwd_skip_flips"]
                 <= allowed_k1)
    return res


def _at_skip_test(args, tile: int, p: int, n_contrib: int,
                  width: int) -> bool:
    """Whether one of pixel `p`'s pairs up to its stop sits within f32
    rounding of the forward's skip tests (alpha >= 1/255, power <= 0),
    replayed in float64."""
    means2d, _, conics, _, opacities, ids, starts, counts = args
    grid_x = (width + probes.TILE - 1) // probes.TILE
    s = int(starts[tile])
    g = ids[s:s + min(int(counts[tile]), n_contrib + 1)].to(torch.int64)
    m, con = means2d[g].double(), conics[g].double()
    dx = (tile % grid_x) * probes.TILE + p % probes.TILE - m[:, 0]
    dy = (tile // grid_x) * probes.TILE + p // probes.TILE - m[:, 1]
    power = -0.5 * (con[:, 0] * dx * dx + con[:, 2] * dy * dy) \
        - con[:, 1] * dx * dy
    alpha = opacities[g].double() * torch.exp(torch.clamp(power, max=0.0))
    near = ((alpha / ALPHA_EPS - 1.0).abs() <= SKIP_TEST_REL) \
        | (power.abs() <= SKIP_TEST_REL)
    return bool(near.any())


def main(argv=None) -> int:
    parser = ArgumentParser(description="bisect the forward rasterizer")
    parser.add_argument("--width", type=int, default=64)
    parser.add_argument("--height", type=int, default=48)
    parser.add_argument("--points", type=int, default=300)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels) or cpu (their plain PyTorch "
                             "versions); never falls back")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    proj, ba = build_scene(args.width, args.height, args.points, device,
                           args.seed)
    print(f"{args.width}x{args.height}, {args.points} Gaussians: "
          f"{ba.total_pairs} pairs in {ba.tile_counts.shape[0]} tiles, "
          f"at most {int(ba.tile_counts.max())} per tile", flush=True)
    res = bisect(proj, ba, args.width, args.height,
                 log=lambda s: print(s, flush=True))
    print("all probes OK" if res["ok"] else "FAILED", flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
