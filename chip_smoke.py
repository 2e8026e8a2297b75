#!/usr/bin/env python3
"""Smoke run of the PyTorch port's training and render paths on one CUDA
card.

    python3 chip_smoke.py

Phases, one line each or more, any failure exits non-zero:
  1 device     the card's name and power limit (nvidia-smi)
  2 build      nvcc-compiles csrc/raster_fwd.cu, csrc/raster_bwd.cu and
               csrc/probes.cu for sm_90a, all at once, into build/kernels/;
               ptxas registers and spills
  3 kernel     the forward kernel against its plain PyTorch version at 64x48
               on the rasterizer test scenes, both instantiations (n_contrib
               and log T_final too), both tile shapes; and on the frame
               built to stress the warp cull (16x8 too), with both
               versions' log T_final against float64 sums
  4 bwd        the backward kernel (K3) and the per-Gaussian segment sum
               against their plain versions on the same scenes at 16x16 and
               32x16, per pair and per Gaussian; then one 800x800 training
               render of the 100k-Gaussian training model; two kernel runs
               on the same inputs bitwise equal, the segment sum in the
               binning's order bitwise equal to a stable sort's; at 800p
               K3's (warp, pair) work: replayed, with a contributing lane,
               culled (none of them contributing); and the forward's:
               walked, with a lane that blends or stops, culled (none of
               them with such a lane)
  5 train      the `bench.py:126-155` configuration (800x800, 100k Gaussians
               from create_from_pcd, SH 3, lgdwt losses, patch 128) through
               `train_step`: 3 warm-up and 20 timed steps on a fixed view
               (CUDA events), peak memory, the loss finite and decreasing;
               then a torch.profiler run of 3 more steps: device busy share,
               K3's time, and host and device time per stage of the port's
               own record_function ranges
  resume       the phase-5 state saved as a checkpoint and restored into a
               fresh Trainer: every array bitwise equal; one more step on
               the same view from both, losses and parameters bitwise equal
  6 train_cli  `python -m sparse_view_3dgs_pack_tpu_torch.train --method
               lgdwt` on a 400x400 Blender scene rendered from a known cloud,
               densify and opacity reset within the run, then the port's
               render and metrics CLIs: test PSNR at least 5 dB above the
               starting model's, and the point count changed; the same run
               again with the debug snapshot armed (--debug_from 0) and a
               checkpoint halfway, resumed from it (--start_checkpoint) to
               the same end
  probes       `probes.prims` and `probes.fwd_bisect` through their main();
               each of the six probe kernels against its plain version;
               D1 (both instantiations), D2 and the forward kernel against
               the two-batch blend expectation on the 800x800 training
               scene and on fwd_bisect's own 800x800 scene, whose pixels
               reach the ln 1e-4 stop; times and bounds
  7 render     a 200k-Gaussian SH-degree-3 model (saved and re-loaded as PLY)
               rendered from 20 orbit cameras at 1920x1080 through
               renderer.render; frame 0 against the plain version, the
               forward's (warp, pair) work as in phase 4; timings
  8 cli        render + metrics CLIs on an 800x800 Blender-layout scene whose
               ground truth is the plain version's render
Each path (train, probes, render) is driven with the kernels' launch
counts set to 0 just before it and read just after; launches made to
compare a kernel with its plain version are not counted. The line before
the last is a JSON summary of the kernels, one entry per (kernel, path);
the last line is {"ok": true, "device": {"platform": "gpu", ...}}.
Imports no jax and nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time
from argparse import Namespace
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CSRC = "sparse_view_3dgs_pack_tpu_torch/csrc"
KERNELS = {   # name → (source, the TPU kernel or JAX reduction it replaces)
    "raster_fwd": (f"{CSRC}/raster_fwd.cu",
                   "sparse_view_3dgs_pack_tpu/ops/pallas/raster.py:151"),
    "raster_bwd": (f"{CSRC}/raster_bwd.cu",
                   "sparse_view_3dgs_pack_tpu/ops/pallas/raster_bwd.py:83"),
    "segment_sum": (f"{CSRC}/raster_bwd.cu",
                    "sparse_view_3dgs_pack_tpu/ops/pallas/raster_vjp.py:131"),
    "probe_tile_coords": (f"{CSRC}/probes.cu", "scripts/tpu_prims.py:18"),
    "probe_row_cumsum": (f"{CSRC}/probes.cu", "scripts/tpu_prims.py:44"),
    "probe_offset_copy": (f"{CSRC}/probes.cu", "scripts/tpu_prims.py:68"),
    "probe_pair_alpha": (f"{CSRC}/probes.cu", "scripts/tpu_prims.py:93"),
    "probe_tile_alpha": (f"{CSRC}/probes.cu", "scripts/tpu_dbg.py:54"),
    "probe_tile_blend": (f"{CSRC}/probes.cu", "scripts/tpu_dbg.py:141"),
}
TRAIN_KERNELS = ("raster_fwd", "raster_bwd", "segment_sum")
PROBE_KERNELS = tuple(k for k in KERNELS if k.startswith("probe_"))
SMALL_TOL = 1e-5     # phases 3-4 at 64x48: abs (depth, gradients: relative
FULL_TOL = 1e-4      # to the largest); 1080p / 800p: sums in another order
# at 800p a pixel whose log T lands within rounding of ln 1e-4 may stop one
# pair earlier or later in the plain version's chunked sums: allow 1e-4 of
# the pixels to differ in n_contrib (log T compared where it agrees)
FLIP_FRACTION = 1e-4
N_FRAMES = 20
RENDER_W, RENDER_H, N_GAUSSIANS = 1920, 1080, 200_000
TRAIN_W = TRAIN_H = 800
TRAIN_N = 100_000
WARMUP_STEPS, TIMED_STEPS = 3, 20
CLI_W, CLI_ITERS, CLI_INIT_POINTS = 400, 600, 1000
# H100 SXM published peaks: float32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# the port's `record_function` ranges (renderer.render_core, train/step.py)
STAGE_PREFIXES = ("render/", "step/")


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of `fn()` over `reps` runs, timed with CUDA events
    after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of `fn` over `reps` calls: the
    summed durations of the CUDA kernels (and copies) it runs, from a
    torch.profiler trace. For a call so short that the host cannot launch
    it as fast as the card runs it, CUDA events around a run of calls time
    the host instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise AssertionError("the profiler recorded no device activity")
    return sum(e.time_range.end - e.time_range.start
               for e in dev) / 1e3 / reps


def bound(n_bytes: float, n_ops: float):
    """(least ms, what sets it): bytes at the HBM rate or f32 operations at
    the f32 peak, whichever takes longer."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / PEAK_F32_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# f32 operations per (pair, pixel) evaluation. A skipped one (power > 0 or
# alpha < 1/255) costs the same in both kernels: offsets 2, quadratic form
# 9, clamp/exp/opacity/clamp 4, the two skip tests 2.
SKIP_OPS = 17


def fwd_ops_per_contrib(C: int) -> int:
    """The forward kernel per contributing (pair, pixel): offsets 2,
    quadratic form 9, clamp/exp/opacity/clamp 4, log1p and its add 2, the
    weight α·T and the transmittance's update 2, payload FMAs 2(C+2). The
    pair that stops a pixel costs SKIP_OPS + 3 (log1p, its add, the stop
    test)."""
    return 2 + 9 + 4 + 2 + 2 + 2 * (C + 2)


def blend_ops(C: int, contrib: int, stops: int, skipped: int = 0) -> int:
    """The operations a forward blend needs: each contributing (pair,
    pixel) and each pixel's stop. A skipped evaluation (power > 0 or α <
    1/255) adds nothing to the result, so the bound counts none; `skipped`
    adds SKIP_OPS for each, the looser figure logged beside it."""
    return (contrib * fwd_ops_per_contrib(C) + stops * (SKIP_OPS + 3)
            + skipped * SKIP_OPS)


def bwd_ops_per_contrib(C: int) -> int:
    """The backward kernel per contributing (pair, pixel): the forward's
    alpha 15, log1p/sum 2, T 2, weight 1, <g, payload> 2(C+2), dL/dalpha 6,
    suffix 2, payload gradients C+2, geometry gradients 19, and one add per
    value of the reduction over pixels, C+8."""
    return 15 + 2 + 2 + 1 + 2 * (C + 2) + 6 + 2 + (C + 2) + 19 + (C + 8)


def max_errs(out, ref) -> dict:
    errs = {f: float((getattr(out, f) - getattr(ref, f)).abs().max())
            for f in ("color", "invdepth", "alpha")}
    scale = float(ref.depth.abs().max().clamp(min=1.0))
    errs["depth_rel"] = float((out.depth - ref.depth).abs().max()) / scale
    if out.log_t is not None:
        errs["log_t"] = float((out.log_t - ref.log_t).abs().max())
    return errs


def _counters():
    from sparse_view_3dgs_pack_tpu_torch.ops import probes, raster
    return {"raster_fwd": raster.rasterize_forward,
            "raster_bwd": raster.rasterize_backward,
            "segment_sum": raster.pairs_to_gaussians,
            "probe_tile_coords": probes.tile_coords,
            "probe_row_cumsum": probes.row_cumsum,
            "probe_offset_copy": probes.offset_copy,
            "probe_pair_alpha": probes.pair_alpha,
            "probe_tile_alpha": probes.tile_alpha,
            "probe_tile_blend": probes.tile_blend}


def reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in _counters().items()}


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this script needs one CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    log("device", f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}"
                  f" cuda {torch.version.cuda}; count "
                  f"{torch.cuda.device_count()}")
    return card


def _ptxas(out: str) -> list:
    """ptxas -v output → [(kernel, registers, spill bytes)], a template
    kernel named with its integer and bool arguments, e.g.
    raster_fwd_kernel<3,1>."""
    res = []
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(?<=\d)([a-z_]+_kernel)(?:I((?:L[ib]\d+E)+)E)?",
                          m.group(1))
            args = re.findall(r"L[ib](\d+)E", k.group(2) or "") if k else []
            name = k.group(1) if k else m.group(1)
            res.append([name + (f"<{','.join(args)}>" if args else ""), 0,
                        0])
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and res:
            res[-1][2] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and res:
            res[-1][1] = int(m.group(1))
    return res


def phase_build() -> None:
    """Every source through nvcc at once, one process each; ptxas'
    registers and spill bytes of each kernel."""
    from sparse_view_3dgs_pack_tpu_torch.ops import _build
    t0 = time.perf_counter()
    names = ("raster_fwd", "raster_bwd", "probes")
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(_build.build, names)))
    secs = time.perf_counter() - t0
    for name, (path, out) in built.items():
        _build.load(name)
        usage = _ptxas(out)
        log("build", f"{os.path.relpath(path, REPO)}"
                     + ("; ptxas (kernel: registers, spill bytes): "
                        + ", ".join(f"{k}: {r}, {b}" for k, r, b in usage)
                        if usage else " (already built)"))
    log("build", f"{len(names)} sources in {secs:.1f} s")


def _model(cloud):
    from sparse_view_3dgs_pack_tpu_torch.models.gaussians import \
        GaussianModel
    f = cloud["features"]
    return GaussianModel(cloud["xyz"], f[:, :1], f[:, 1:], cloud["scales"],
                         cloud["quats"], cloud["opacity"])


def _raster_args(proj, ba, bg):
    return (proj.means2d.contiguous(), proj.depths.contiguous(),
            proj.conics.contiguous(), proj.colors.contiguous(),
            proj.opacities.contiguous(), ba.ids, ba.tile_starts,
            ba.tile_counts, bg)


def _project_model(model, cam, sh_degree=None):
    from sparse_view_3dgs_pack_tpu_torch.ops.projection import \
        project_gaussians
    p = cam.params()
    dev = model.xyz.device
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    with torch.no_grad():
        return project_gaussians(
            means3d=model.xyz, scales=torch.exp(model.scaling),
            quats=model.rotation,
            opacities=torch.sigmoid(model.opacity[:, 0]),
            viewmat=t(p.viewmat), full_proj=t(p.full_proj),
            cam_center=t(p.cam_center), tan_fovx=float(p.tan_fovx),
            tan_fovy=float(p.tan_fovy), width=cam.width, height=cam.height,
            sh=torch.cat([model.features_dc, model.features_rest], 1),
            sh_degree=(model.max_sh_degree if sh_degree is None
                       else sh_degree))


def phase_kernels(device) -> float:
    """Forward kernel vs plain version on the small scenes and on the
    frame built to stress the warp cull, where both versions' log T_final
    are also read against float64 sums (`testing.log_t_f64`); returns the
    largest error seen."""
    from sparse_view_3dgs_pack_tpu_torch import testing
    from sparse_view_3dgs_pack_tpu_torch.ops.binning import bin_gaussians
    from sparse_view_3dgs_pack_tpu_torch.ops.raster import (
        rasterize_forward, rasterize_forward_torch)
    W, H = testing.RASTER_W, testing.RASTER_H
    bg = torch.tensor([0.1, 0.2, 0.3], device=device)
    frames = {}
    for name in testing.RASTER_SCENES:
        cloud, cam = testing.raster_scene(name)
        frames[name] = _project_model(_model(cloud).to(device), cam)
    m2, dep, con, col, op, radii = testing.cull_stress_frame(device=device)
    frames["cull_stress"] = Namespace(means2d=m2, depths=dep, conics=con,
                                      colors=col, opacities=op, radii=radii)
    worst = 0.0
    for name, proj in frames.items():
        stress = name == "cull_stress"
        for tx, ty in ((16, 16), (32, 16)) + (((16, 8),) if stress else ()):
            ba = bin_gaussians(proj.means2d, proj.depths, proj.radii, W, H,
                               tx, ty)
            args = _raster_args(proj, ba, bg)
            for n_contrib in (False, True):
                out = rasterize_forward(*args, W, H, tx, ty, n_contrib)
                ref = rasterize_forward_torch(*args, W, H, tx, ty, n_contrib)
                torch.cuda.synchronize()
                errs = max_errs(out, ref)
                if n_contrib and stress:
                    exact = [testing.log_t_f64(
                        proj.means2d, proj.conics, proj.opacities, ba.ids,
                        ba.tile_starts, ba.tile_counts, out.n_contrib, W, H,
                        tx, ty, f32) for f32 in (False, True)]
                    e = lambda a, b: float((a.double() - b).abs().max())
                    log("kernel", f"{name} {tx}x{ty} log T_final against "
                                  f"its float64 sum: kernel "
                                  f"{e(out.log_t, exact[0]):.3g}, plain "
                                  f"{e(ref.log_t, exact[0]):.3g}; against "
                                  f"the float64 sum of the plain version's "
                                  f"float32 terms: kernel "
                                  f"{e(out.log_t, exact[1]):.3g}, plain "
                                  f"{e(ref.log_t, exact[1]):.3g}")
                msg = " ".join(f"{k}={v:.3g}" for k, v in errs.items())
                if n_contrib:
                    diff = int((out.n_contrib != ref.n_contrib).sum())
                    msg += f" n_contrib_diff={diff}"
                    if diff:
                        raise AssertionError(f"{name}: n_contrib differs "
                                             f"at {diff} pixels")
                log("kernel", f"{name} {tx}x{ty} "
                              f"{'train' if n_contrib else 'infer'} "
                              f"pairs={ba.total_pairs} max_tile="
                              f"{int(ba.tile_counts.max())} {msg}")
                bad = {k: v for k, v in errs.items() if not v <= SMALL_TOL}
                if bad:
                    raise AssertionError(f"{name} {tx}x{ty}: {bad} > "
                                         f"{SMALL_TOL}")
                worst = max(worst, *errs.values())
    return worst


def _sort_order(ids, P: int):
    """(slots, offsets) of a stable sort of the pair ids: the order that
    `Binning.gaussian_slots` / `gaussian_offsets` give without a sort."""
    slots = torch.sort(ids, stable=True).indices.to(torch.int32)
    offsets = torch.zeros(P + 1, dtype=torch.int32, device=ids.device)
    offsets[1:] = torch.cumsum(torch.bincount(ids, minlength=P), 0)
    return slots, offsets


def _bwd_case(args, ba, tol: float, label: str):
    """K3 and the segment sum against their plain versions on one set of
    backward inputs (`rasterize_backward` argument tuple, binning `ba`):
    per-pair and per-Gaussian errors relative to the largest plain value,
    two kernel runs bitwise equal, and the segment sum in the binning's
    order bitwise equal to the same rows summed in a stable sort's order.
    Returns (pair error, Gaussian error)."""
    from sparse_view_3dgs_pack_tpu_torch.ops import raster
    ids, P = args[5], args[0].shape[0]
    order = (ba.gaussian_slots, ba.gaussian_offsets)
    out = raster.rasterize_backward(*args)
    again = raster.rasterize_backward(*args)
    ref = raster.rasterize_backward_torch(*args)
    per = raster.pairs_to_gaussians(out, ids, *order)
    per_again = raster.pairs_to_gaussians(again, ids, *order)
    per_sorted = raster.pairs_to_gaussians(out, ids, *_sort_order(ids, P))
    per_ref = raster.pairs_to_gaussians_torch(ref, ids, P)
    torch.cuda.synchronize()
    if not (torch.equal(out, again) and torch.equal(per, per_again)):
        raise AssertionError(f"{label}: two backward runs differ")
    if not torch.equal(per, per_sorted):
        raise AssertionError(f"{label}: the segment sum in the binning's "
                             f"order differs from the stable sort's")
    pair_err = float((out - ref).abs().max() / ref.abs().max())
    g_err = float((per - per_ref).abs().max() / per_ref.abs().max())
    log("bwd", f"{label} pairs={ids.shape[0]} per-pair err {pair_err:.3g}, "
               f"per-Gaussian err {g_err:.3g} (relative to the largest); "
               f"two runs bitwise equal; segment sum in the binning's order "
               f"bitwise equal to the stable sort's")
    if not (pair_err <= tol and g_err <= tol):
        raise AssertionError(f"{label}: backward vs plain {pair_err:.3g}, "
                             f"{g_err:.3g} > {tol}")
    return pair_err, g_err


def _bwd_args(proj, ba, bg, W, H, tx, ty, seed=0):
    """Backward inputs: the kernel forward's saved log T / n_contrib and
    seeded normal image cotangents."""
    from sparse_view_3dgs_pack_tpu_torch.ops.raster import rasterize_forward
    args = _raster_args(proj, ba, bg)
    fwd = rasterize_forward(*args, W, H, tx, ty, True)
    gen = torch.Generator(device=bg.device).manual_seed(seed)
    g = [torch.randn(s, generator=gen, device=bg.device)
         for s in ((H, W, 3), (H, W), (H, W), (H, W))]
    return args + (fwd.log_t, fwd.n_contrib, *g, W, H, tx, ty), fwd


def phase_bwd_small(device) -> float:
    from sparse_view_3dgs_pack_tpu_torch import testing
    from sparse_view_3dgs_pack_tpu_torch.ops.binning import bin_gaussians
    W, H = testing.RASTER_W, testing.RASTER_H
    bg = torch.tensor([0.05, 0.1, 0.15], device=device)
    worst = 0.0
    for name in testing.RASTER_SCENES:
        cloud, cam = testing.raster_scene(name)
        proj = _project_model(_model(cloud).to(device), cam)
        for tx, ty in ((16, 16), (32, 16)):
            ba = bin_gaussians(proj.means2d, proj.depths, proj.radii, W, H,
                               tx, ty)
            args, _ = _bwd_args(proj, ba, bg, W, H, tx, ty)
            worst = max(worst, *_bwd_case(args, ba, SMALL_TOL,
                                          f"{name} {tx}x{ty}"))
    return worst


def _train_setup(device):
    """The `bench.py:126-155` training configuration."""
    from sparse_view_3dgs_pack_tpu_torch import testing
    from sparse_view_3dgs_pack_tpu_torch.models import gaussians as gm
    from sparse_view_3dgs_pack_tpu_torch.train import step
    rng = np.random.default_rng(0)
    pts = rng.uniform(-2, 2, (TRAIN_N, 3)).astype(np.float32)
    cols = rng.random((TRAIN_N, 3)).astype(np.float32)
    t0 = time.perf_counter()
    model = gm.create_from_pcd(pts, cols, n_images=4, sh_degree=3,
                               device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cams = testing.make_orbit_cameras(4, radius=6.0, width=TRAIN_W,
                                      height_px=TRAIN_H)
    for c in cams:
        c.image = rng.random((TRAIN_H, TRAIN_W, 3)).astype(np.float32)
        c.alpha_mask = np.ones((TRAIN_H, TRAIN_W), np.float32)
    bank = step.CameraBank.from_cameras(cams, 3, device)
    cfg = step.StepConfig(width=TRAIN_W, height=TRAIN_H, sh_degree=3,
                          dwt_enable=True, patch_dwt_enable=True,
                          patch_size=128)
    return model, cams, bank, cfg, init_s


class Work(NamedTuple):
    """What this run's data asks of the rasterizer kernels, in (pair, pixel)
    evaluations: both replay each pixel's pairs before its stop (n_contrib
    of them), the forward also evaluates the pair that stops it. Both work
    per (warp, pair), counted here for one layout of the warps
    (`raster.warp_pixels`), and skip a pair whose cull box misses the warp's
    pixel rectangle. K3 (2 pixels per thread) replays the pairs
    below the warp's largest n_contrib and reduces a pair's gradients over
    its lanes where one contributes; the forward walks the pairs up to the
    last one that stops a pixel of the warp (the tile's count if one does
    not stop), and a lane is live at a pair that it blends or that stops
    it."""
    before_stop: int   # sum of n_contrib
    skipped: int       # of those, skipped: power > 0 or alpha < 1/255
    stops: int         # pixels that stop before their tile's last pair
    warp_pairs: int    # K3: (warp, pair) below the warp's largest n_contrib
    warp_contrib: int  # of those, with a contributing lane
    warp_culled: int   # of those, outside the warp's cull box
    culled_contrib: int  # culled yet with a contributing lane: must be 0
    fwd_pairs: int     # forward: (warp, pair) up to the warp's last stop
    fwd_walked: int    # of those, inside the warp's cull box: walked
    fwd_live: int      # of those, with a live lane
    fwd_culled_live: int  # culled yet with a live lane: must be 0

    def fwd_line(self) -> str:
        return (f"forward per (warp, pair): {self.fwd_pairs} up to the "
                f"warp's last stop, {self.fwd_walked} walked "
                f"({100 * self.fwd_walked / max(self.fwd_pairs, 1):.1f}%; "
                f"{self.fwd_pairs - self.fwd_walked} culled), "
                f"{self.fwd_live} with a lane that blends or stops "
                f"({100 * self.fwd_live / max(self.fwd_walked, 1):.1f}% of "
                f"the walked), {self.fwd_culled_live} culled with such a "
                f"lane")

    def fwd_ops(self, C: int, with_skips: bool = False) -> int:
        return blend_ops(C, self.before_stop - self.skipped, self.stops,
                         self.skipped if with_skips else 0)

    def bwd_ops(self, C: int, with_skips: bool = False) -> int:
        """K3 needs each contributing (pair, pixel); `with_skips` also
        charges SKIP_OPS for each skipped one before the stops."""
        return ((self.before_stop - self.skipped) * bwd_ops_per_contrib(C)
                + (self.skipped * SKIP_OPS if with_skips else 0))


def _work(proj, ba, n_contrib, W, H, tx, ty, pixels: int) -> Work:
    """Counts each pixel's evaluations before its stop and, with the
    kernels' own expression and test, the skipped ones among them; per
    (warp, pair) of warps whose threads cover `pixels` rows, K3's replayed,
    contributing and culled ones and the forward's walked, live and culled
    ones (the cull box of `raster.cull_box_torch`). Tiles in batches, pairs
    in chunks, on the card."""
    from sparse_view_3dgs_pack_tpu_torch.ops import raster
    from sparse_view_3dgs_pack_tpu_torch.ops.binning import tile_grid
    from sparse_view_3dgs_pack_tpu_torch.ops.blending import (ALPHA_EPS,
                                                              ALPHA_MAX)
    dev = n_contrib.device
    gx, gy = tile_grid(W, H, tx, ty)
    pix = tx * ty
    warp_pix = raster.warp_pixels(tx, ty, pixels).to(dev)   # (nw, 32 px)
    nw = warp_pix.shape[0]
    nc = n_contrib.to(torch.int64)
    counts = ba.tile_counts.to(torch.int64)
    ys = torch.arange(H, device=dev) // ty
    xs = torch.arange(W, device=dev) // tx
    per_pix = counts[ys[:, None] * gx + xs[None, :]]
    stops = int((nc < per_pix).sum())
    nc_t = torch.nn.functional.pad(nc, (0, gx * tx - W, 0, gy * ty - H))
    nc_t = nc_t.reshape(gy, ty, gx, tx).permute(0, 2, 1, 3).reshape(-1, pix)
    warp_max = nc_t[:, warp_pix].max(2).values               # (tiles, nw)
    # the forward's walk: through the pair that stops the warp's last pixel
    fwd_end = torch.minimum(warp_max + 1, counts[:, None])   # (tiles, nw)
    boxes = raster.cull_box_torch(proj.means2d, proj.conics, proj.opacities)
    rects = raster.warp_rects(tx, ty, pixels).to(dev)
    lin = torch.arange(pix, device=dev)
    lx, ly = (lin % tx).to(torch.float32), (lin // tx).to(torch.float32)
    deepest = fwd_end.max(1).values
    order = torch.argsort(deepest, descending=True)
    depth_sorted = deepest[order].tolist()
    chunk = 256
    tb = max(1, (1 << 24) // (pix * chunk))
    skipped = warp_contrib = warp_culled = culled_contrib = 0
    fwd_walked = fwd_live = fwd_culled_live = 0
    for b0 in range(0, order.shape[0], tb):
        kmax = depth_sorted[b0]
        if kmax == 0:
            break
        tsel = order[b0:b0 + tb]
        px = ((tsel % gx) * tx).to(torch.float32)[:, None] + lx
        py = ((tsel // gx) * ty).to(torch.float32)[:, None] + ly
        origin = torch.stack([tsel % gx * tx, tsel % gx * tx,
                              tsel // gx * ty, tsel // gx * ty], 1)
        rect_b = (origin[:, None, None, :] + rects[None, :, None, :])
        wmax_b, fend_b = warp_max[tsel], fwd_end[tsel]
        nc_b, st = nc_t[tsel], ba.tile_starts.to(torch.int64)[tsel]
        cnt_b = counts[tsel]
        for k0 in range(0, kmax, chunk):
            k = torch.arange(k0, min(k0 + chunk, kmax), device=dev)
            slot = torch.clamp(st[:, None] + k[None, :],
                               max=ba.ids.shape[0] - 1)
            g = ba.ids[slot].to(torch.int64)
            m, con = proj.means2d[g], proj.conics[g]
            dx = px[:, :, None] - m[:, None, :, 0]
            dy = py[:, :, None] - m[:, None, :, 1]
            power = -0.5 * (con[:, None, :, 0] * dx * dx
                            + con[:, None, :, 2] * dy * dy) \
                - con[:, None, :, 1] * dx * dy
            alpha = torch.clamp(proj.opacities[g][:, None, :] * torch.exp(
                torch.clamp(power, max=0.0)), max=ALPHA_MAX)
            before = k[None, None, :] < nc_b[:, :, None]
            skip = (power > 0.0) | (alpha < ALPHA_EPS)
            skipped += int((before & skip).sum())
            contrib = (before & ~skip)[:, warp_pix].any(2)     # (B, nw, K)
            below = k[None, None, :] < wmax_b[:, :, None]      # (B, nw, K)
            outside = raster.rect_outside(boxes[g][:, None], rect_b)
            warp_contrib += int(contrib.sum())
            warp_culled += int((below & outside).sum())
            culled_contrib += int((contrib & outside).sum())
            live = ((k[None, None, :] <= nc_b[:, :, None])
                    & (k[None, :] < cnt_b[:, None])[:, None, :]
                    & ~skip)[:, warp_pix].any(2)               # (B, nw, K)
            walk = k[None, None, :] < fend_b[:, :, None]
            fwd_walked += int((walk & ~outside).sum())
            fwd_live += int(live.sum())
            fwd_culled_live += int((live & outside).sum())
    return Work(int(nc.sum()), skipped, stops, int(warp_max.sum()),
                warp_contrib, warp_culled, culled_contrib,
                int(fwd_end.sum()), fwd_walked, fwd_live, fwd_culled_live)


def _stop_f64(proj, ba, pixels, W, tx, ty) -> list:
    """n_contrib of each (y, x) in `pixels` with its tile's pairs replayed
    in float64: the same expression, skips and sticky stop."""
    from sparse_view_3dgs_pack_tpu_torch.ops.blending import (
        ALPHA_EPS, ALPHA_MAX, LOG_T_EPS)
    gx = (W + tx - 1) // tx
    out = []
    for y, x in pixels.tolist():
        t = (y // ty) * gx + x // tx
        s, c = int(ba.tile_starts[t]), int(ba.tile_counts[t])
        g = ba.ids[s:s + c].to(torch.int64)
        m = proj.means2d[g].double()
        a, b, cc = proj.conics[g].double().unbind(1)
        dx, dy = x - m[:, 0], y - m[:, 1]
        power = -0.5 * (a * dx * dx + cc * dy * dy) - b * dx * dy
        alpha = torch.clamp(proj.opacities[g].double() * torch.exp(
            torch.clamp(power, max=0.0)), max=ALPHA_MAX)
        alpha = torch.where((power > 0.0) | (alpha < ALPHA_EPS),
                            torch.zeros_like(alpha), alpha)
        crossed = torch.nonzero(torch.cumsum(torch.log1p(-alpha), 0)
                                < LOG_T_EPS)
        out.append(int(crossed[0]) if crossed.numel() else c)
    return out


def _fwd_bound(P, C, n_pairs, num_tiles, W, H, work: Work, training: bool,
               with_skips: bool = False):
    n_bytes = (P * (2 + 1 + 3 + C + 1) + n_pairs + 2 * num_tiles + C) * 4 \
        + W * H * (C + 3 + (2 if training else 0)) * 4
    return bound(n_bytes, work.fwd_ops(C, with_skips))


def _bwd_bound(P, C, n_pairs, num_tiles, W, H, work: Work,
               with_skips: bool = False):
    n_bytes = ((P * (2 + 1 + 3 + C + 1) + n_pairs + 2 * num_tiles + C) * 4
               + W * H * (C + 5) * 4 + n_pairs * (C + 8) * 4)
    return bound(n_bytes, work.bwd_ops(C, with_skips))


def _segsum_bound(P, K, n_pairs):
    n_bytes = n_pairs * (K + 1) * 4 + (P + 1) * 4 + P * K * 4
    return bound(n_bytes, n_pairs * K)


def phase_bwd_full(model, cams, device) -> dict:
    """The 800x800 training render of the training model, kernels against
    plain versions; also their times and bounds at that shape."""
    from sparse_view_3dgs_pack_tpu_torch.ops import raster
    from sparse_view_3dgs_pack_tpu_torch.ops.binning import bin_gaussians
    from sparse_view_3dgs_pack_tpu_torch.renderer import (TRAIN_TILE_X,
                                                          TRAIN_TILE_Y)
    W, H, tx, ty = TRAIN_W, TRAIN_H, TRAIN_TILE_X, TRAIN_TILE_Y
    proj = _project_model(model, cams[0], sh_degree=3)
    ba = bin_gaussians(proj.means2d, proj.depths, proj.rect_radii, W, H,
                       tx, ty)
    bg = torch.zeros(3, device=device)
    args, fwd = _bwd_args(proj, ba, bg, W, H, tx, ty, seed=1)
    fargs = _raster_args(proj, ba, bg) + (W, H, tx, ty, True)
    ref = raster.rasterize_forward_torch(*fargs)
    torch.cuda.synchronize()
    same = fwd.n_contrib == ref.n_contrib
    nc_diff = int((~same).sum())
    errs = max_errs(fwd, ref._replace(log_t=torch.where(same, ref.log_t,
                                                        fwd.log_t)))
    log("bwd", f"{W}x{H} training forward, {ba.total_pairs} pairs: kernel vs "
               f"plain " + " ".join(f"{k}={v:.3g}" for k, v in errs.items())
        + f" (log_t where n_contrib agrees) n_contrib_diff={nc_diff} of "
          f"{W * H} pixels")
    if nc_diff > FLIP_FRACTION * W * H or not all(
            v <= FULL_TOL for v in errs.values()):
        raise AssertionError(f"800p training forward: {errs}, n_contrib "
                             f"differs at {nc_diff} pixels")
    if nc_diff:
        # which side stops where exact arithmetic would: float64 replay
        flips = torch.nonzero(~same)
        n64 = torch.tensor(_stop_f64(proj, ba, flips, W, tx, ty),
                           device=device)
        at = (flips[:, 0], flips[:, 1])
        log("bwd", f"at the {nc_diff} pixels where n_contrib differs, a "
                   f"float64 replay stops with the kernel at "
                   f"{int((fwd.n_contrib[at] == n64).sum())}, with the plain "
                   f"version at {int((ref.n_contrib[at] == n64).sum())}")
    pair_err, g_err = _bwd_case(args, ba, FULL_TOL,
                                f"{W}x{H} training render")

    P, C, n_pairs = proj.means2d.shape[0], 3, ba.total_pairs
    num_tiles = ba.tile_counts.shape[0]
    K = C + 8
    ids = ba.ids
    pairs = raster.rasterize_backward(*args)
    t_fwd = cuda_ms(lambda: raster.rasterize_forward(*fargs), 20)
    t_fwd_plain = cuda_ms(lambda: raster.rasterize_forward_torch(*fargs), 2)
    t_bwd = cuda_ms(lambda: raster.rasterize_backward(*args), 20)
    t_bwd_plain = cuda_ms(lambda: raster.rasterize_backward_torch(*args), 2)
    order = (ba.gaussian_slots, ba.gaussian_offsets)
    t_seg = cuda_ms(lambda: raster.pairs_to_gaussians(pairs, ids, *order),
                    20)
    t_seg_plain = cuda_ms(lambda: raster.pairs_to_gaussians_torch(
        pairs, ids, P), 5)
    ids64 = ids.to(torch.int64)
    t_seg_lib = cuda_ms(lambda: torch.zeros((P, K), device=device)
                        .index_add_(0, ids64, pairs), 20)
    t_sort = cuda_ms(lambda: _sort_order(ids, P), 20)
    # one count serves both kernels: the training forward has K3's layout
    if raster.fwd_pixels(True) != raster.BWD_PIXELS:
        raise AssertionError("the training forward and K3 differ in layout")
    work = _work(proj, ba, fwd.n_contrib, W, H, tx, ty, raster.BWD_PIXELS)
    fb = _fwd_bound(P, C, n_pairs, num_tiles, W, H, work, True)
    bb = _bwd_bound(P, C, n_pairs, num_tiles, W, H, work)
    fb_skips = _fwd_bound(P, C, n_pairs, num_tiles, W, H, work, True, True)
    bb_skips = _bwd_bound(P, C, n_pairs, num_tiles, W, H, work, True)
    sb = _segsum_bound(P, K, n_pairs)
    log("bwd", f"{W}x{H} work: {work.before_stop} (pair, pixel) evaluations "
               f"before the stops, {work.skipped} of them skipped "
               f"({100 * work.skipped / work.before_stop:.1f}%), "
               f"{work.stops} pixels stop early")
    log("bwd", f"{W}x{H} K3 per (warp, pair): {work.warp_pairs} replayed "
               f"(below the warp's largest n_contrib), {work.warp_contrib} "
               f"with a contributing lane "
               f"({100 * work.warp_contrib / work.warp_pairs:.1f}%), "
               f"{work.warp_culled} outside the warp's cull box "
               f"({100 * work.warp_culled / work.warp_pairs:.1f}%), "
               f"{work.culled_contrib} culled with a contributing lane")
    log("bwd", f"{W}x{H} {work.fwd_line()}")
    if work.culled_contrib or work.fwd_culled_live:
        raise AssertionError(f"the cull box drops {work.culled_contrib} "
                             f"(warp, pair) with a contributing lane (K3), "
                             f"{work.fwd_culled_live} with a live one "
                             f"(forward)")
    log("bwd", f"{W}x{H} training shape: raster_fwd {t_fwd:.3f} ms (plain "
               f"{t_fwd_plain:.1f}, bound {fb[0]:.4f} by {fb[1]}; "
               f"{fb_skips[0]:.4f} with the skipped evaluations); "
               f"raster_bwd {t_bwd:.3f} ms through its wrapper, the pair "
               f"buffer allocated empty (no zero fill of "
               f"{n_pairs * K * 4 / 1e6:.1f} MB) (plain "
               f"{t_bwd_plain:.1f}, bound {bb[0]:.4f} by {bb[1]}; "
               f"{bb_skips[0]:.4f} with the skipped evaluations); "
               f"segment_sum {t_seg:.3f} ms in the binning's order (plain "
               f"{t_seg_plain:.3f}, index_add_ {t_seg_lib:.3f}, bound "
               f"{sb[0]:.4f} by {sb[1]}; a stable sort of the ids with "
               f"its bincount and cumsum, which that order saves, takes "
               f"{t_sort:.3f})")
    return {
        "raster_fwd": dict(max_abs_err=max(errs["color"], errs["alpha"],
                                           errs["invdepth"]),
                           ms=t_fwd, plain_ms=t_fwd_plain, bound_ms=fb[0],
                           bound_by=fb[1], library_ms=None),
        "raster_bwd": dict(max_abs_err=pair_err, ms=t_bwd,
                           plain_ms=t_bwd_plain, bound_ms=bb[0],
                           bound_by=bb[1], library_ms=None),
        "segment_sum": dict(max_abs_err=g_err, ms=t_seg,
                            plain_ms=t_seg_plain, bound_ms=sb[0],
                            bound_by=sb[1], library_ms=t_seg_lib)}


def _stages(events, dev, n: int) -> dict:
    """stage → [host ms, device ms] per call. A stage is a
    `record_function` range of the port (`STAGE_PREFIXES`); each kernel's
    device time goes to the innermost range around the host call that
    launched it (the CUDA runtime call of the same correlation id).
    Kernels launched outside every range go to "other"."""
    from torch.autograd import DeviceType
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    ranges = [(e.time_range.start, e.time_range.end, e.name) for e in cpu
              if e.name.startswith(STAGE_PREFIXES)]
    runtime = {e.id: e.time_range.start for e in cpu
               if e.name.startswith("cu")}
    out = {name: [0.0, 0.0] for _, _, name in sorted(ranges)}
    out["other"] = [0.0, 0.0]
    for s, e, name in ranges:
        out[name][0] += (e - s) / 1e3 / n
    for k in dev:
        t = runtime.get(k.id)
        inner = max(((s, name) for s, e, name in ranges
                     if t is not None and s <= t <= e), default=None)
        out[inner[1] if inner else "other"][1] += (
            k.time_range.end - k.time_range.start) / 1e3 / n
    return out


def _profile(fn, n: int) -> dict:
    """Device busy time, ops, top kernels and the stage breakdown per call
    of `fn` over `n` calls, from torch.profiler's CUDA activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    events = list(prof.events())
    # the ranges' own device-side spans are not work
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.name.startswith(STAGE_PREFIXES)]
    if not dev:
        return {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy = (busy + cur_e - cur_s) / 1e3 / n
    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3 / n
    return {"busy_ms": busy, "wall_ms": wall, "ops": len(dev) / n,
            "by_name": by_name, "stages": _stages(events, dev, n)}


def _profile_line(prof: dict, what: str) -> str:
    if not prof:
        return "profile: no device activity recorded (not measured)"
    top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1])[:4]
    return (f"profile over {what}: device busy {prof['busy_ms']:.3f} ms of "
            f"{prof['wall_ms']:.3f} ms per call "
            f"({100 * (1 - prof['busy_ms'] / prof['wall_ms']):.1f}% idle), "
            f"{prof['ops']:.0f} device ops per call; top: "
            + "; ".join(f"{n[:40]} {t:.3f} ms" for n, t in top)
            + "\n  stages (host ms / device ms per call): "
            + ", ".join(f"{k} {h:.3f} / {d:.3f}"
                        for k, (h, d) in prof["stages"].items()))


class Trained(NamedTuple):
    """Phase 5's training state after its steps, for the resume phase."""
    model: object
    adam: object
    exp_adam: object
    running: torch.Tensor
    cams: list
    bank: object
    cfg: object
    lrs: dict
    bg: torch.Tensor
    iteration: int


def phase_train(device):
    """The main path of the training slice: `train_step` at full width.
    Returns the path's kernel entries and the state it left."""
    from sparse_view_3dgs_pack_tpu_torch.train import optim, step
    model, cams, bank, cfg, init_s = _train_setup(device)
    log("train", f"create_from_pcd of {TRAIN_N} points on the card (exact "
                 f"3-NN) in {init_s:.2f} s")
    kernels = phase_bwd_full(model, cams, device)
    adam = optim.init_adam(model.params())
    eadam = optim.init_exposure_adam(model.exposure)
    running = torch.ones((), device=device)
    lrs = {k: 1e-3 for k in model.params()}
    bg = torch.zeros(3, device=device)

    def one():
        nonlocal running
        metrics, running = step.train_step(model, adam, eadam, running, bank,
                                           0, lrs, 0.0, 0.0, 3, bg, cfg)
        return metrics

    for _ in range(WARMUP_STEPS):
        one()
    torch.cuda.synchronize()

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    ev_ms, host_ms, losses, pairs = [], [], [], []
    for _ in range(TIMED_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        metrics = one()
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        ev_ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
        pairs.append(metrics["n_pairs"])
    counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    med = float(np.median(ev_ms))
    log("train", f"{TIMED_STEPS} steps {TRAIN_W}x{TRAIN_H}, {TRAIN_N} "
                 f"Gaussians SH3, lgdwt: median {med:.3f} ms per step "
                 f"({1e3 / med:.2f} it/s; host clock median "
                 f"{float(np.median(host_ms)):.3f} ms; min {min(ev_ms):.3f}, "
                 f"max {max(ev_ms):.3f}); pairs median "
                 f"{int(np.median(pairs))}; peak {peak_gib:.3f} GiB; "
                 f"launches {counts}")
    for name in TRAIN_KERNELS:
        if counts[name] != TIMED_STEPS:
            raise AssertionError(f"{name} launched {counts[name]} times in "
                                 f"{TIMED_STEPS} train steps")
    log("train", "loss over the timed steps (fixed view): "
                 + " ".join(f"{v:.5f}" for v in losses))
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"loss not finite and decreasing: {losses}")

    prof = _profile(one, 3)
    log("train", _profile_line(prof, "3 train steps"))
    if prof:
        k3 = sum(t for n, t in prof["by_name"].items() if "raster_bwd" in n)
        seg = sum(t for n, t in prof["by_name"].items()
                  if "segment_sum" in n)
        log("train", f"of step/backward's device time, raster_bwd_kernel "
                     f"{k3:.3f} ms and segment_sum_kernel {seg:.3f} ms per "
                     f"step; K3 = {100 * k3 / prof['busy_ms']:.1f}% of device "
                     f"busy time")
    for name in kernels:
        kernels[name]["launches"] = counts[name]
    return kernels, Trained(model, adam, eadam, running, cams, bank, cfg, lrs,
                            bg, adam.step)


def phase_train_cli(work: str, device):
    """The training CLI on a Blender scene rendered from a known cloud, then
    the render and metrics CLIs on its output. Returns the scene directory
    and the training run's it/s."""
    from sparse_view_3dgs_pack_tpu_torch import testing
    from sparse_view_3dgs_pack_tpu_torch.data import readers
    from sparse_view_3dgs_pack_tpu_torch.data.camera_utils import \
        camera_list_from_cam_infos
    from sparse_view_3dgs_pack_tpu_torch.data.ply import (fetch_point_cloud,
                                                          read_ply)
    from sparse_view_3dgs_pack_tpu_torch.models import gaussians as gm
    from sparse_view_3dgs_pack_tpu_torch.train.loop import evaluate_cameras
    t0 = time.perf_counter()
    cloud = testing.make_gaussian_cloud(11, 2000, extent=1.2,
                                        scale_range=(0.04, 0.15))
    scene = testing.write_blender_scene(
        os.path.join(work, "train_scene"), n_train=8, n_test=2, width=CLI_W,
        cloud=cloud, device=device, init_points=CLI_INIT_POINTS)
    # test PSNR of the model the trainer starts from (iteration 0)
    info = readers.read_nerf_synthetic_scene(scene, False, "", True)
    test_cams = camera_list_from_cam_infos(
        info.test_cameras, 1.0, Namespace(resolution=-1), True, True)
    pcd = fetch_point_cloud(os.path.join(scene, "points3d.ply"))
    start = gm.create_from_pcd(pcd.points, pcd.colors, n_images=8,
                               sh_degree=3, device=device)
    psnr0 = evaluate_cameras(start, test_cams, [0.0, 0.0, 0.0], 0)["psnr"]
    log("train_cli", f"scene {CLI_W}x{CLI_W}, 8 train + 2 test views of a "
                     f"2000-Gaussian cloud, {CLI_INIT_POINTS} start points, "
                     f"in {time.perf_counter() - t0:.1f} s; test PSNR at "
                     f"iteration 0: {psnr0:.3f} dB")
    out = os.path.join(work, "train_out")
    cmd = [sys.executable, "-m", "sparse_view_3dgs_pack_tpu_torch.train",
           "-s", scene, "-m", out, "--method", "lgdwt", "--disable_viewer",
           "--eval", "--iterations", str(CLI_ITERS),
           "--densify_from_iter", "100", "--densification_interval", "50",
           "--densify_until_iter", "450", "--opacity_reset_interval", "250",
           "--test_iterations", "250", str(CLI_ITERS)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True)
    if proc.returncode != 0:
        raise AssertionError(f"train CLI failed (rc={proc.returncode}):\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    for line in proc.stdout.splitlines():
        if "Evaluating" in line or "Training took" in line:
            log("train_cli", line.strip())
    ips = _its_per_s(proc.stdout)
    log("train_cli", f"python -m sparse_view_3dgs_pack_tpu_torch.train ok "
                     f"in {time.perf_counter() - t0:.1f} s")
    for mod, extra in (("render", ["--skip_train"]), ("metrics", [])):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"sparse_view_3dgs_pack_tpu_torch.{mod}",
             "-m", out, *extra], cwd=REPO, capture_output=True, text=True)
        if proc.returncode != 0:
            raise AssertionError(f"{mod} CLI failed (rc={proc.returncode}):"
                                 f"\n{proc.stdout}\n{proc.stderr}")
        log("train_cli", f"{mod} CLI ok in {time.perf_counter() - t0:.1f} s")
    with open(os.path.join(out, "results.json")) as f:
        res = json.load(f)[f"ours_{CLI_ITERS}"]
    n_end = len(read_ply(os.path.join(out, "point_cloud",
                                      f"iteration_{CLI_ITERS}",
                                      "point_cloud.ply"))["x"])
    log("train_cli", f"test PSNR {psnr0:.3f} dB at iteration 0 -> "
                     f"{res['PSNR']:.3f} dB at {CLI_ITERS} (SSIM "
                     f"{res['SSIM']:.4f}); Gaussians {CLI_INIT_POINTS} -> "
                     f"{n_end}")
    if not res["PSNR"] >= psnr0 + 5.0:
        raise AssertionError(f"test PSNR rose by {res['PSNR'] - psnr0:.3f} "
                             f"dB, less than 5")
    if n_end == CLI_INIT_POINTS:
        raise AssertionError("the point count did not change")
    return scene, ips


def _its_per_s(stdout: str) -> float:
    m = re.search(r"Training took [0-9.]+s for \d+ iterations \(([0-9.]+) "
                  r"it/s\)", stdout)
    if m is None:
        raise AssertionError(f"no 'Training took' line:\n{stdout[-2000:]}")
    return float(m.group(1))


class _Scene:
    """What `Trainer` reads of a `Scene`: the model, the training cameras
    and their extent, and the model directory."""

    def __init__(self, gaussians, cams, model_path: str):
        self.gaussians, self.cams = gaussians, cams
        self.model_path = model_path
        self.cameras_extent = 6.0     # the orbit radius of the cameras

    def getTrainCameras(self):
        return self.cams

    def getTestCameras(self):
        return []


def _fresh_trainer(cams, work: str, device):
    """A `Trainer` with the CLI's default lgdwt options over the training
    cameras, its model a 1000-point stand-in for a restore to replace."""
    from argparse import ArgumentParser
    from sparse_view_3dgs_pack_tpu_torch.config import (ModelParams,
                                                        OptimizationParams,
                                                        PipelineParams)
    from sparse_view_3dgs_pack_tpu_torch.models import gaussians as gm
    from sparse_view_3dgs_pack_tpu_torch.train.loop import Trainer
    parser = ArgumentParser()
    lp = ModelParams(parser)
    op = OptimizationParams(parser, method="lgdwt")
    pp = PipelineParams(parser)
    args = parser.parse_args(["-m", work])
    rng = np.random.default_rng(1)
    stand_in = gm.create_from_pcd(rng.uniform(-2, 2, (1000, 3)),
                                  rng.random((1000, 3)), n_images=len(cams),
                                  sh_degree=3, device=device)
    return Trainer(_Scene(stand_in, cams, work), op.extract(args),
                   pp.extract(args), lp.extract(args))


def _state_arrays(model, adam, exp_adam, running) -> dict:
    from sparse_view_3dgs_pack_tpu_torch.models.gaussians import (PARAM_NAMES,
                                                                  STAT_NAMES)
    out = {k: getattr(model, k) for k in PARAM_NAMES + STAT_NAMES
           + ("exposure",)}
    for m in ("m", "v"):
        out.update({f"adam.{m}.{k}": getattr(adam, m)[k]
                    for k in PARAM_NAMES})
        out[f"exp_adam.{m}"] = getattr(exp_adam, m)
    out["dwt_running_mean"] = running
    return out


def _unequal(a: dict, b: dict) -> dict:
    """name → largest |a - b| where the two arrays are not bitwise equal."""
    return {k: (float((a[k].detach().double() - b[k].detach().double())
                      .abs().max()) if a[k].shape == b[k].shape
                else float("inf"))
            for k in a if not torch.equal(a[k], b[k])}


def phase_resume(tr: Trained, work: str, device) -> None:
    """Phase 5's state through a checkpoint into a fresh `Trainer`: bitwise
    the same arrays, and one more step from each bitwise the same."""
    from sparse_view_3dgs_pack_tpu_torch.train import checkpoint, step
    path = os.path.join(work, f"chkpnt{tr.iteration}.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save_checkpoint(path, tr.model, tr.adam, tr.exp_adam,
                               tr.running, tr.iteration)
    save_s = time.perf_counter() - t0
    trainer = _fresh_trainer(tr.cams, work, device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.restore_checkpoint(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    saved = _state_arrays(tr.model, tr.adam, tr.exp_adam, tr.running)
    bad = _unequal(_state_arrays(trainer.model, trainer.adam,
                                 trainer.exp_adam, trainer.dwt_running_mean),
                   saved)
    steps = (trainer.iteration, trainer.adam.step, trainer.exp_adam.step)
    log("resume", f"checkpoint of {tr.model.num_points} Gaussians at "
                  f"iteration {tr.iteration}: saved in {save_s:.3f} s, "
                  f"{os.path.getsize(path) / 2 ** 20:.1f} MiB; restored "
                  f"into a fresh Trainer in {load_s:.3f} s; {len(saved)} "
                  f"arrays bitwise equal: {not bad}; steps {steps}")
    if bad or steps != (tr.iteration, tr.adam.step, tr.exp_adam.step):
        raise AssertionError(f"restored state differs: {bad}, steps {steps}")

    # one more step on view 0 from each; cuDNN may otherwise pick a
    # convolution backward that adds with atomics
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        losses = []
        for model, adam, exp_adam, running, bank in (
                (tr.model, tr.adam, tr.exp_adam, tr.running, tr.bank),
                (trainer.model, trainer.adam, trainer.exp_adam,
                 trainer.dwt_running_mean, trainer.bank)):
            metrics, new_running = step.train_step(
                model, adam, exp_adam, running, bank, 0, tr.lrs, 0.0, 0.0, 3,
                tr.bg, tr.cfg)
            losses.append((metrics["loss"], new_running))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    bad = _unequal(_state_arrays(trainer.model, trainer.adam,
                                 trainer.exp_adam, losses[1][1]),
                   _state_arrays(tr.model, tr.adam, tr.exp_adam,
                                 losses[0][1]))
    same_loss = torch.equal(losses[0][0], losses[1][0])
    log("resume", f"one more step on view 0 from both: loss "
                  f"{float(losses[0][0]):.7f} / {float(losses[1][0]):.7f}, "
                  f"bitwise equal: {same_loss}; updated state bitwise "
                  f"equal: {not bad}")
    if bad or not same_loss:
        raise AssertionError(f"the restored trainer's step differs: {bad}")


def phase_resume_cli(work: str, scene: str, plain_ips: float) -> None:
    """Phase 6's training run again with the debug snapshot armed and a
    checkpoint halfway, then resumed from that checkpoint to the end."""
    out = os.path.join(work, "resume_out")
    half = CLI_ITERS // 2
    ckpt = os.path.join(out, f"chkpnt{half}.npz")
    base = [sys.executable, "-m", "sparse_view_3dgs_pack_tpu_torch.train",
            "-s", scene, "-m", out, "--method", "lgdwt", "--disable_viewer",
            "--eval", "--iterations", str(CLI_ITERS),
            "--densify_from_iter", "100", "--densification_interval", "50",
            "--densify_until_iter", "450", "--opacity_reset_interval", "250",
            "--test_iterations", str(CLI_ITERS)]
    ips = {}
    for label, extra in (
            ("debug armed", ["--debug_from", "0", "--checkpoint_iterations",
                             str(half)]),
            ("resumed", ["--start_checkpoint", ckpt])):
        t0 = time.perf_counter()
        proc = subprocess.run(base + extra, cwd=REPO, capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise AssertionError(f"train CLI ({label}) failed (rc="
                                 f"{proc.returncode}):\n{proc.stdout[-3000:]}"
                                 f"\n{proc.stderr[-3000:]}")
        ips[label] = _its_per_s(proc.stdout)
        for line in proc.stdout.splitlines():
            if "Evaluating" in line or "Resumed" in line \
                    or "Training took" in line:
                log("resume", f"{label}: {line.strip()}")
        log("resume", f"{label}: train CLI ok in "
                      f"{time.perf_counter() - t0:.1f} s")
        if label == "resumed" and f"(iteration {half})" not in proc.stdout:
            raise AssertionError("the resumed run did not start from the "
                                 "checkpoint")
    if os.path.exists(os.path.join(out, "snapshot_fw.npz")):
        raise AssertionError("the debug snapshot fired on a finite run")
    if not os.path.exists(os.path.join(out, "point_cloud",
                                       f"iteration_{CLI_ITERS}",
                                       "point_cloud.ply")):
        raise AssertionError("the resumed run wrote no final point cloud")
    log("resume", f"train CLI it/s at {CLI_W}x{CLI_W}: plain "
                  f"{plain_ips:.2f} (phase 6), debug armed "
                  f"{ips['debug armed']:.2f} (one host sync per step), "
                  f"resumed from {half} {ips['resumed']:.2f}")


def _probe_small(device) -> dict:
    """P1-P4 against their plain versions on the inputs of
    `scripts/tpu_prims.py`, with device times (profiler: a call of a few
    microseconds on the card takes longer to launch from Python), the
    wall time per call, and bounds."""
    from sparse_view_3dgs_pack_tpu_torch.ops import probes
    from sparse_view_3dgs_pack_tpu_torch.probes import prims
    out = {}

    def entry(name, kernel, plain, err, bar, n_bytes, n_ops, lib=None,
              shape=""):
        if not err <= bar:
            raise AssertionError(f"{name}: {err:.3g} from its plain version "
                                 f"(bar {bar:g})")
        ms = device_ms(kernel, 50)
        plain_ms = device_ms(plain, 20)
        library_ms = None if lib is None else device_ms(lib, 50)
        call_ms = cuda_ms(kernel, 200)
        b = bound(n_bytes, n_ops)
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b[0], bound_by=b[1], library_ms=library_ms,
                         call_ms=call_ms, shape=shape)
        log("probes", f"{name} ({shape}): vs plain {err:.3g} (bar {bar:g}); "
                      f"device {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} "
                      f"us" + ("" if lib is None else
                               f", torch.cumsum {library_ms * 1e3:.2f} us")
                      + f", bound {b[0] * 1e3:.4f} us by {b[1]}; "
                        f"{call_ms * 1e3:.2f} us per call from Python")

    tiles = (8, 4, device)
    got, want = probes.tile_coords(*tiles), probes.tile_coords_torch(*tiles)
    entry("probe_tile_coords", lambda: probes.tile_coords(*tiles),
          lambda: probes.tile_coords_torch(*tiles),
          0.0 if torch.equal(got, want) else float("inf"), 0.0,
          got.numel() * 4, 0, shape="8 tiles, 4 across")

    x = torch.as_tensor(prims.scan_input(), device=device)
    err = float((probes.row_cumsum(x) - probes.row_cumsum_torch(x))
                .abs().max())
    entry("probe_row_cumsum", lambda: probes.row_cumsum(x),
          lambda: probes.row_cumsum_torch(x), err, 1e-4, 2 * x.numel() * 4,
          x.shape[0] * (x.shape[1] - 1), lib=lambda: torch.cumsum(x, 1),
          shape="256 x 256")

    data, starts = (torch.as_tensor(a, device=device)
                    for a in prims.copy_input())
    got = probes.offset_copy(data, starts)
    want = probes.offset_copy_torch(data, starts)
    src = torch.zeros(data.shape[1], dtype=torch.bool)
    for s0 in prims.COPY_STARTS:
        src[s0:s0 + probes.CHUNK] = True
    entry("probe_offset_copy", lambda: probes.offset_copy(data, starts),
          lambda: probes.offset_copy_torch(data, starts),
          0.0 if torch.equal(got, want) else float("inf"), 0.0,
          (data.shape[0] * int(src.sum()) + starts.numel() + got.numel()) * 4,
          0, shape="8 slices of (16, 8192)")

    d = torch.as_tensor(prims.alpha_input(), device=device)
    err = float((probes.pair_alpha(d) - probes.pair_alpha_torch(d))
                .abs().max())
    n = d.shape[1]
    entry("probe_pair_alpha", lambda: probes.pair_alpha(d),
          lambda: probes.pair_alpha_torch(d), err, 1e-6,
          (6 * n + probes.PIX * n) * 4, probes.PIX * n * (SKIP_OPS - 2),
          shape="256 pixels x 256 pairs")
    return out


def _probe_full(device) -> dict:
    """D1 (both instantiations), D2 and the forward kernel against plain
    versions on the 800x800 training scene, then D1's and D2's times and
    bounds there."""
    from sparse_view_3dgs_pack_tpu_torch.ops import probes
    from sparse_view_3dgs_pack_tpu_torch.ops.binning import bin_gaussians
    from sparse_view_3dgs_pack_tpu_torch.probes import fwd_bisect
    W, H, T = TRAIN_W, TRAIN_H, probes.TILE
    model, cams = _train_setup(device)[:2]
    proj = _project_model(model, cams[0], sh_degree=3)
    ba = bin_gaussians(proj.means2d, proj.depths, proj.rect_radii, W, H, T, T)
    counts = ba.tile_counts
    log("probes", f"{W}x{H} training scene: {ba.total_pairs} pairs in "
                  f"{counts.shape[0]} tiles, at most {int(counts.max())} per "
                  f"tile; {int((counts > probes.CHUNK).sum())} tiles hold "
                  f"more than one batch, {int((counts <= 512).sum())} at "
                  f"most two")
    res = fwd_bisect.bisect(proj, ba, W, H, tol=FULL_TOL,
                            flip_fraction=FLIP_FRACTION,
                            log=lambda m: log("probes", m))
    if not res["ok"]:
        raise AssertionError(f"{W}x{H} probes against plain versions: {res}")

    args = fwd_bisect.pair_args(proj, ba)
    m2, _, con, col, op, ids, st, cn = args
    geo = (m2, con, op, ids, st, cn, W, H)
    t_d1 = cuda_ms(lambda: probes.tile_alpha(*geo), 10)
    t_walk = cuda_ms(lambda: probes.tile_alpha(*geo, walk_all=True), 10)
    t_d1_plain = cuda_ms(lambda: probes.tile_alpha_torch(*geo), 2)
    t_d2 = cuda_ms(lambda: probes.tile_blend(*args, W, H), 10)
    t_d2_plain = cuda_ms(lambda: probes.tile_blend_torch(*args, W, H), 2)

    # what this run's data asks of D1 and D2: each tile's first
    # m = min(count, 256) lanes; D2 evaluates a pixel's lanes up to its
    # stop (the first m if it does not stop) and the lane that stops it
    P, C, NT = m2.shape[0], col.shape[1], cn.shape[0]
    lanes_t = cn.to(torch.int64).clamp(max=probes.CHUNK)
    n_lanes = int(lanes_t.sum())
    out_bytes = NT * probes.PIX * probes.CHUNK * 4
    pair_bytes = n_lanes * 4 + 2 * NT * 4
    b1 = bound(P * 6 * 4 + pair_bytes + out_bytes,
               n_lanes * probes.PIX * SKIP_OPS)
    alpha = probes.tile_alpha(*geo)
    nc = probes.tile_blend(*args, W, H)[..., 9].to(torch.int64)
    evals = torch.minimum(nc, lanes_t[:, None])
    before = (torch.arange(probes.CHUNK, device=device)[None, None, :]
              < evals[..., None])
    skipped = int(((alpha == 0) & before).sum())
    del alpha, before
    n_eval = int(evals.sum())
    stops = int((nc < probes.CHUNK).sum())
    b2 = bound(P * (6 + C + 1) * 4 + pair_bytes + out_bytes,
               blend_ops(C, n_eval - skipped, stops))
    log("probes", f"{W}x{H} D1: {t_d1:.3f} ms, with the walk {t_walk:.3f} ms"
                  f", plain {t_d1_plain:.1f} ms, bound {b1[0]:.4f} ms by "
                  f"{b1[1]} ({n_lanes} lanes x 256 pixels)")
    log("probes", f"{W}x{H} D2: {t_d2:.3f} ms, plain {t_d2_plain:.1f} ms, "
                  f"bound {b2[0]:.4f} ms by {b2[1]} ({n_eval} evaluations "
                  f"before the stops, {skipped} skipped, {stops} pixels "
                  f"stop)")
    shape = f"{W}x{H}, {NT} tiles, {ba.total_pairs} pairs"
    del model, proj, ba, args, geo
    torch.cuda.empty_cache()

    # the probes' own scene at the same size: opaque enough that pixels
    # reach the ln 1e-4 stop inside the first batch
    proj, ba = fwd_bisect.build_scene(W, H, TRAIN_N, device)
    log("probes", f"{W}x{H} fwd_bisect scene, {TRAIN_N} Gaussians: "
                  f"{ba.total_pairs} pairs, at most "
                  f"{int(ba.tile_counts.max())} per tile")
    res_stop = fwd_bisect.bisect(proj, ba, W, H, tol=FULL_TOL,
                                 flip_fraction=FLIP_FRACTION,
                                 log=lambda m: log("probes", m))
    if not res_stop["ok"] or not res_stop["tile_blend_stops"]:
        raise AssertionError(f"{W}x{H} fwd_bisect scene: {res_stop}")
    del proj, ba
    torch.cuda.empty_cache()
    return {
        "probe_tile_alpha": dict(
            max_abs_err=res["tile_alpha"], ms=t_d1, walk_ms=t_walk,
            plain_ms=t_d1_plain, bound_ms=b1[0], bound_by=b1[1],
            library_ms=None, shape=shape),
        "probe_tile_blend": dict(
            max_abs_err=res["tile_blend"], ms=t_d2, plain_ms=t_d2_plain,
            bound_ms=b2[0], bound_by=b2[1], library_ms=None, shape=shape)}


def phase_probes(device, train_fwd: dict) -> dict:
    """The probe path: its two entry points as a user runs them, then each
    kernel against its plain version, timed. Returns the path's kernel
    entries (the forward kernel's numbers are phase 4's at 800p)."""
    from sparse_view_3dgs_pack_tpu_torch.probes import fwd_bisect, prims
    reset_counts()
    rc = (prims.main([]), fwd_bisect.main([]))
    torch.cuda.synchronize()
    counts = read_counts()
    used = {k: counts[k] for k in PROBE_KERNELS + ("raster_fwd",)}
    log("probes", f"prims.main() -> {rc[0]}, fwd_bisect.main() -> {rc[1]}; "
                  f"launches {used}")
    if rc != (0, 0):
        raise AssertionError(f"the probe entry points exited {rc}")
    if not all(used.values()):
        raise AssertionError(f"a kernel of the probe path never ran: {used}")
    entries = _probe_small(device)
    entries.update(_probe_full(device))
    entries["raster_fwd"] = dict(train_fwd)
    for name, entry in entries.items():
        entry["launches"] = used[name]
    return entries


def phase_render(device, work: str):
    """The render path at full size. Returns the PLY path and the render
    path's kernel entries."""
    from sparse_view_3dgs_pack_tpu_torch import testing
    from sparse_view_3dgs_pack_tpu_torch.models import gaussians as gm
    from sparse_view_3dgs_pack_tpu_torch.ops.binning import bin_gaussians
    from sparse_view_3dgs_pack_tpu_torch.ops.raster import (
        fwd_pixels, rasterize_forward, rasterize_forward_torch)
    from sparse_view_3dgs_pack_tpu_torch.renderer import (INFER_TILE_X,
                                                          INFER_TILE_Y, render)
    W, H = RENDER_W, RENDER_H
    cloud = testing.make_sh3_cloud(0, N_GAUSSIANS)
    ply = os.path.join(work, "point_cloud.ply")
    gm.save_ply(_model(cloud), ply)
    model = gm.load_ply(ply, sh_degree=3, device=device)
    if not np.array_equal(model.features_rest.detach().cpu().numpy(),
                          cloud["features"][:, 1:]):
        raise AssertionError("PLY round trip changed the SH coefficients")
    cams = testing.make_orbit_cameras(N_FRAMES, radius=6.0, width=W,
                                      height_px=H)
    bg = [0.0, 0.0, 0.0]
    render(model, cams[0], bg)            # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    ev_ms, host_ms, pairs, first = [], [], [], None
    for cam in cams:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        res = render(model, cam, bg)
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        ev_ms.append(start.elapsed_time(end))
        pairs.append(res.n_pairs)
        if first is None:
            first = res
        if not (res.render.shape == (H, W, 3)
                and bool(torch.isfinite(res.render).all())
                and bool(torch.isfinite(res.alpha).all())):
            raise AssertionError("non-finite or misshapen frame")
    counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if counts["raster_fwd"] != N_FRAMES:
        raise AssertionError(f"raster_fwd launched {counts['raster_fwd']} "
                             f"times for {N_FRAMES} frames")
    med = float(np.median(ev_ms))
    log("render", f"{N_FRAMES} frames {W}x{H}, {N_GAUSSIANS} Gaussians SH3: "
                  f"median {med:.3f} ms ({1e3 / med:.2f} fps; host clock "
                  f"median {float(np.median(host_ms)):.3f} ms); pairs frame0="
                  f"{pairs[0]} median={int(np.median(pairs))}; peak "
                  f"{peak_gib:.3f} GiB; launches {counts}")
    log("render", _profile_line(
        _profile(lambda: render(model, cams[1], bg), 3), "3 frames"))

    # frame 0 again, stage by stage: the kernel against the plain version
    # on the same inputs, and where the frame time goes
    proj = _project_model(model, cams[0])
    ba = bin_gaussians(proj.means2d, proj.depths, proj.rect_radii, W, H,
                       INFER_TILE_X, INFER_TILE_Y)
    bgt = torch.zeros(3, device=device)
    args = _raster_args(proj, ba, bgt) + (W, H, INFER_TILE_X, INFER_TILE_Y)
    out = rasterize_forward(*args)
    ref = rasterize_forward_torch(*args)
    torch.cuda.synchronize()
    if not torch.equal(out.alpha, first.alpha):
        raise AssertionError("render() frame 0 differs from the kernel on "
                             "the same inputs")
    errs = max_errs(out, ref)
    log("render", "frame0 kernel vs plain: "
                  + " ".join(f"{k}={v:.3g}" for k, v in errs.items()))
    if not (errs["color"] <= FULL_TOL and errs["alpha"] <= FULL_TOL):
        raise AssertionError(f"frame 0: kernel vs plain {errs} > {FULL_TOL}")
    t_proj = cuda_ms(lambda: _project_model(model, cams[0]), 10)
    t_bin = cuda_ms(lambda: bin_gaussians(
        proj.means2d, proj.depths, proj.rect_radii, W, H, INFER_TILE_X,
        INFER_TILE_Y), 10)
    t_kernel = cuda_ms(lambda: rasterize_forward(*args), 20)
    t_plain = cuda_ms(lambda: rasterize_forward_torch(*args), 3)
    nc = rasterize_forward(*args[:-4], W, H, INFER_TILE_X, INFER_TILE_Y,
                           True).n_contrib
    work = _work(proj, ba, nc, W, H, INFER_TILE_X, INFER_TILE_Y,
                 fwd_pixels(False))
    fb, fb_skips = (_fwd_bound(proj.means2d.shape[0], 3, ba.total_pairs,
                               ba.tile_counts.shape[0], W, H, work, False,
                               with_skips) for with_skips in (False, True))
    log("render", f"frame0 work: {work.before_stop} (pair, pixel) "
                  f"evaluations before the stops, {work.skipped} skipped "
                  f"({100 * work.skipped / work.before_stop:.1f}%), "
                  f"{work.stops} pixels stop early")
    log("render", f"frame0 {work.fwd_line()}")
    if work.fwd_culled_live:
        raise AssertionError(f"the cull box drops {work.fwd_culled_live} "
                             f"(warp, pair) with a live lane at 1080p")
    log("render", f"frame0 stages: projection {t_proj:.3f} ms, binning "
                  f"{t_bin:.3f} ms (one host sync for the pair count), "
                  f"raster kernel {t_kernel:.3f} ms (bound {fb[0]:.4f} ms by "
                  f"{fb[1]}; {fb_skips[0]:.4f} with the skipped "
                  f"evaluations); plain raster {t_plain:.3f} ms "
                  f"({t_plain / t_kernel:.1f}x the kernel)")
    return ply, {"raster_fwd": dict(
        launches=counts["raster_fwd"],
        max_abs_err=max(errs["color"], errs["alpha"], errs["invdepth"]),
        ms=t_kernel, plain_ms=t_plain, bound_ms=fb[0], bound_by=fb[1],
        library_ms=None)}


def phase_cli(ply: str, work: str) -> None:
    """The port's render and metrics CLIs, as subprocesses, on a Blender
    scene whose ground truth is the plain version's render (the model on
    the CPU); the CLI renders through the kernel."""
    from sparse_view_3dgs_pack_tpu_torch import testing
    from sparse_view_3dgs_pack_tpu_torch.data.camera_utils import \
        camera_list_from_cam_infos
    from sparse_view_3dgs_pack_tpu_torch.data.readers import \
        read_nerf_synthetic_scene
    from sparse_view_3dgs_pack_tpu_torch.models import gaussians as gm
    from sparse_view_3dgs_pack_tpu_torch.render import to_u8
    from sparse_view_3dgs_pack_tpu_torch.renderer import render
    from sparse_view_3dgs_pack_tpu_torch.utils import image_io

    scene = testing.write_blender_scene(os.path.join(work, "scene"),
                                        n_train=4, n_test=2, width=800)
    model_dir = os.path.join(work, "model")
    it_dir = os.path.join(model_dir, "point_cloud", "iteration_30000")
    os.makedirs(it_dir, exist_ok=True)
    shutil.copyfile(ply, os.path.join(it_dir, "point_cloud.ply"))
    args = Namespace(sh_degree=3, source_path=scene, model_path=model_dir,
                     images="images", depths="", resolution=-1,
                     white_background=False, train_test_exp=False,
                     data_device="cuda", eval=True, n_views=0,
                     point_cloud_type="dense")
    with open(os.path.join(model_dir, "cfg_args"), "w") as f:
        f.write(str(args))          # what training writes (config.py)

    info = read_nerf_synthetic_scene(scene, False, "", True)
    cpu_model = gm.load_ply(ply, sh_degree=3, device="cpu")
    t0 = time.perf_counter()
    for infos, is_test in ((info.train_cameras, False),
                           (info.test_cameras, True)):
        for info_i, cam in zip(infos, camera_list_from_cam_infos(
                infos, 1.0, args, True, is_test)):
            gt = to_u8(render(cpu_model, cam, [0.0, 0.0, 0.0]).render)
            image_io.write_png(info_i.image_path, gt)
    log("cli", f"ground truth: 6 plain-version renders at 800x800 on the "
               f"CPU in {time.perf_counter() - t0:.1f} s")

    for mod in ("render", "metrics"):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"sparse_view_3dgs_pack_tpu_torch.{mod}",
             "-m", model_dir], cwd=REPO, capture_output=True, text=True)
        if proc.returncode != 0:
            raise AssertionError(f"{mod} CLI failed (rc={proc.returncode}):"
                                 f"\n{proc.stdout}\n{proc.stderr}")
        log("cli", f"python -m sparse_view_3dgs_pack_tpu_torch.{mod} ok in "
                   f"{time.perf_counter() - t0:.1f} s")
    with open(os.path.join(model_dir, "results.json")) as f:
        res = json.load(f)["ours_30000"]
    log("cli", f"test PSNR {res['PSNR']:.4f} dB, SSIM {res['SSIM']:.6f}")
    if not (res["PSNR"] >= 50.0 and res["SSIM"] >= 0.999):
        raise AssertionError(f"CLI render vs plain version: {res}")


def main() -> None:
    t_start = time.perf_counter()
    card = phase_device()
    device = torch.device("cuda")
    phase_build()
    worst = phase_kernels(device)
    log("kernel", f"all small scenes within {SMALL_TOL} (worst {worst:.3g})")
    worst = phase_bwd_small(device)
    log("bwd", f"all small scenes within {SMALL_TOL} of the largest "
               f"gradient (worst {worst:.3g})")
    work = os.path.join(REPO, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    paths = {}
    paths["train"], trained = phase_train(device)
    phase_resume(trained, work, device)
    del trained
    scene, ips = phase_train_cli(work, device)
    phase_resume_cli(work, scene, ips)
    paths["probes"] = phase_probes(device, paths["train"]["raster_fwd"])
    ply, paths["render"] = phase_render(device, work)
    phase_cli(ply, work)
    if "jax" in sys.modules or any(
            k.split(".")[0] == "sparse_view_3dgs_pack_tpu"
            for k in sys.modules):
        raise AssertionError("jax or the JAX package was imported")
    log("done", f"all phases in {time.perf_counter() - t_start:.1f} s")
    print(card)
    # one entry per (kernel, path): launches, times and bound at that
    # path's own shape (train 800x800 16x16 tiles, render 1080p 32x16,
    # probes: the shape each entry names)
    print(json.dumps({"kernels": [
        {"name": name, "path": path, "route": "cuda",
         "source": KERNELS[name][0], "replaces": KERNELS[name][1], **entry}
        for path, kernels in paths.items()
        for name, entry in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
