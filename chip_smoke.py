#!/usr/bin/env python3
"""Smoke run of the PyTorch port's render path on one CUDA card.

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero:
  1 device   the card's name and power limit (nvidia-smi)
  2 build    nvcc-compiles csrc/raster_fwd.cu for sm_90a into build/kernels/
  3 kernel   the kernel against its plain PyTorch version at 64x48 on the
             rasterizer test scenes, both instantiations, both tile shapes
  4 render   a 200k-Gaussian SH-degree-3 model (saved and re-loaded as PLY)
             rendered from 20 orbit cameras at 1920x1080 through
             renderer.render; frame 0 against the plain version; timings
  5 cli      render + metrics CLIs on an 800x800 Blender-layout scene whose
             ground truth is the plain version's render
The line before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}. Imports no jax.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from argparse import Namespace

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "sparse_view_3dgs_pack_tpu_torch/csrc/raster_fwd.cu"
KERNEL_REPLACES = "sparse_view_3dgs_pack_tpu/ops/pallas/raster.py:151"
SMALL_TOL = 1e-5     # phase 3: color/invdepth/alpha abs, depth relative
FULL_TOL = 1e-4      # phase 4: ~1e3-pair sums taken in another order
N_FRAMES = 20
RENDER_W, RENDER_H, N_GAUSSIANS = 1920, 1080, 200_000


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


def max_errs(out, ref) -> dict:
    errs = {f: float((getattr(out, f) - getattr(ref, f)).abs().max())
            for f in ("color", "invdepth", "alpha")}
    scale = float(ref.depth.abs().max().clamp(min=1.0))
    errs["depth_rel"] = float((out.depth - ref.depth).abs().max()) / scale
    return errs


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


def phase_build() -> None:
    from sparse_view_3dgs_pack_tpu_torch.ops import _build
    t0 = time.perf_counter()
    path, out = _build.build("raster_fwd")
    _build.load("raster_fwd")
    secs = time.perf_counter() - t0
    regs = [int(w) for line in out.splitlines() if "registers" in line
            for prev, w in zip(line.split(), line.split()[1:])
            if prev == "Used"]
    spills = sum(int(w) for line in out.splitlines()
                 for w, b, sp in zip(line.split(), line.split()[1:],
                                     line.split()[2:])
                 if (b, sp) == ("bytes", "spill"))
    log("build", f"{os.path.relpath(path, REPO)} in {secs:.1f} s"
                 + (f"; ptxas: {len(regs)} instantiations, <= {max(regs)} "
                    f"registers, {spills} spill bytes" if regs
                    else " (already built)"))


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


def phase_kernels(device) -> float:
    """Kernel vs plain version on the small scenes; returns the largest
    error seen."""
    from sparse_view_3dgs_pack_tpu_torch import testing
    from sparse_view_3dgs_pack_tpu_torch.ops.binning import bin_gaussians
    from sparse_view_3dgs_pack_tpu_torch.ops.raster import (
        rasterize_forward, rasterize_forward_torch)
    W, H = testing.RASTER_W, testing.RASTER_H
    bg = torch.tensor([0.1, 0.2, 0.3], device=device)
    worst = 0.0
    for name in testing.RASTER_SCENES:
        cloud, cam = testing.raster_scene(name)
        proj = _project_model(_model(cloud).to(device), cam)
        for tx, ty in ((16, 16), (32, 16)):
            ba = bin_gaussians(proj.means2d, proj.depths, proj.radii, W, H,
                               tx, ty)
            args = _raster_args(proj, ba, bg)
            for n_contrib in (False, True):
                out = rasterize_forward(*args, W, H, tx, ty, n_contrib)
                ref = rasterize_forward_torch(*args, W, H, tx, ty, n_contrib)
                if device.type == "cuda":
                    torch.cuda.synchronize()
                errs = max_errs(out, ref)
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


def phase_render(device, work: str):
    """The main path at full size. Returns (ply path, kernel summary)."""
    from sparse_view_3dgs_pack_tpu_torch import testing
    from sparse_view_3dgs_pack_tpu_torch.models import gaussians as gm
    from sparse_view_3dgs_pack_tpu_torch.ops.binning import bin_gaussians
    from sparse_view_3dgs_pack_tpu_torch.ops.raster import (
        rasterize_forward, rasterize_forward_torch)
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

    rasterize_forward.launches = 0
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
    launches = rasterize_forward.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if launches != N_FRAMES:
        raise AssertionError(f"raster_fwd launched {launches} times for "
                             f"{N_FRAMES} frames")
    med = float(np.median(ev_ms))
    log("render", f"{N_FRAMES} frames {W}x{H}, {N_GAUSSIANS} Gaussians SH3: "
                  f"median "
                  f"{med:.3f} ms ({1e3 / med:.2f} fps; host clock median "
                  f"{float(np.median(host_ms)):.3f} ms); pairs frame0="
                  f"{pairs[0]} median={int(np.median(pairs))}; peak "
                  f"{peak_gib:.3f} GiB; raster_fwd launches={launches}")

    log("render", _profile_frames(model, cams[1:4], bg))

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
    log("render", f"frame0 stages: projection {t_proj:.3f} ms, binning "
                  f"{t_bin:.3f} ms (one host sync for the pair count), "
                  f"raster kernel {t_kernel:.3f} ms; plain raster "
                  f"{t_plain:.3f} ms ({t_plain / t_kernel:.1f}x the kernel)")
    return ply, {"name": "raster_fwd", "route": "cuda",
                 "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
                 "launches": launches,
                 "max_abs_err": max(errs["color"], errs["alpha"],
                                    errs["invdepth"]),
                 "ms": t_kernel, "plain_ms": t_plain}


def _profile_frames(model, cams, bg) -> str:
    """Device busy share and kernel launches per frame over a few frames,
    from torch.profiler's CUDA activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sparse_view_3dgs_pack_tpu_torch.renderer import render
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for cam in cams:
            render(model, cam, bg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / len(cams)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        return "profile: no device activity recorded (not measured)"
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy = (busy + cur_e - cur_s) / 1e3 / len(cams)
    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3 / len(cams)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return (f"profile over {len(cams)} frames: device busy {busy:.3f} ms "
            f"of {wall_ms:.3f} ms per frame ({100 * (1 - busy / wall_ms):.1f}"
            f"% idle), {len(dev) / len(cams):.0f} device ops per frame; top: "
            + "; ".join(f"{n[:48]} {t:.3f} ms" for n, t in top))


def _project_model(model, cam):
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
            sh_degree=model.max_sh_degree)


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
    card = phase_device()
    device = torch.device("cuda")
    phase_build()
    worst_small = phase_kernels(device)
    log("kernel", f"all small scenes within {SMALL_TOL} "
                  f"(worst {worst_small:.3g})")
    work = os.path.join(REPO, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ply, kernel = phase_render(device, work)
    phase_cli(ply, work)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(card)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
