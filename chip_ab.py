#!/usr/bin/env python3
"""Forward-kernel, training-step and frame times of two checkouts of the
PyTorch port, measured in turns on one CUDA card.

    python3 chip_ab.py BASE CHANGE [--rounds 3]

BASE and CHANGE are roots of checkouts (for example the parent commit
unpacked with `git archive` into `bench_runs/`, and this one). Each round
runs BASE, CHANGE, CHANGE, BASE, each in a fresh process that imports the
port and `chip_smoke.py` from its own checkout (its kernels built there),
and times:
  kernel  the checkout's forward kernel (`rasterize_forward`), 50 launches
          timed with CUDA events after a warm-up, at the shapes of its two
          paths: the training instantiation on view 0 of phase 5's model at
          800x800 (16x16 tiles, n_contrib and log T_final) and the inference
          instantiation on frame 0 of phase 7's model at 1920x1080 (32x16);
          each held once against the plain version (largest absolute
          difference of colour and alpha, pixels whose n_contrib differs);
  train   phase 5's configuration (800x800, 100k Gaussians from
          create_from_pcd, SH 3, lgdwt, patch 128): 3 warm-up and 20 timed
          `train_step` calls on one view, CUDA events around each;
  render  phase 7's model (200k Gaussians, SH 3) from 20 orbit cameras at
          1920x1080 through `renderer.render`, after one warm-up frame.
Prints the card's name and power limit, one line
per run, per checkout the median of its runs' values with their range, and
as the last line one JSON object with every run's numbers.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

TAG = "chip_ab "
KERNEL_REPS = 50
KEYS = ("fwd_train_ms", "fwd_infer_ms", "step_median", "frame_median")


def worker(root: str) -> None:
    """One run in checkout `root`: prints one JSON line after TAG."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    import sparse_view_3dgs_pack_tpu_torch as port
    for mod in (cs, port):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise AssertionError(f"{mod.__name__} imported from "
                                 f"{mod.__file__}, not from {root}")
    from sparse_view_3dgs_pack_tpu_torch import testing
    from sparse_view_3dgs_pack_tpu_torch.ops import raster
    from sparse_view_3dgs_pack_tpu_torch.ops.binning import bin_gaussians
    from sparse_view_3dgs_pack_tpu_torch.renderer import render
    from sparse_view_3dgs_pack_tpu_torch.train import optim, step

    device = torch.device("cuda")
    res = {}
    cs.phase_build()

    def timed(fn, n):
        ev, host = [], []
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            ev.append(start.elapsed_time(end))
        return ev, host

    def kernel(label, proj, W, H, tx, ty, training):
        ba = bin_gaussians(proj.means2d, proj.depths, proj.rect_radii, W, H,
                           tx, ty)
        args = cs._raster_args(proj, ba, torch.zeros(3, device=device)) + (
            W, H, tx, ty, training)
        res[f"fwd_{label}_ms"] = cs.cuda_ms(
            lambda: raster.rasterize_forward(*args), KERNEL_REPS)
        out = raster.rasterize_forward(*args)
        ref = raster.rasterize_forward_torch(*args)
        res[f"fwd_{label}_err"] = max(
            float((out.color - ref.color).abs().max()),
            float((out.alpha - ref.alpha).abs().max()))
        if training:
            res[f"fwd_{label}_nc_diff"] = int(
                (out.n_contrib != ref.n_contrib).sum())

    model, cams, bank, cfg, _ = cs._train_setup(device)
    kernel("train", cs._project_model(model, cams[0], sh_degree=3),
           cs.TRAIN_W, cs.TRAIN_H, 16, 16, True)
    adam = optim.init_adam(model.params())
    eadam = optim.init_exposure_adam(model.exposure)
    lrs = {k: 1e-3 for k in model.params()}
    bg = torch.zeros(3, device=device)
    running = torch.ones((), device=device)

    def one_step():
        nonlocal running
        _, running = step.train_step(model, adam, eadam, running, bank, 0,
                                     lrs, 0.0, 0.0, 3, bg, cfg)

    for _ in range(cs.WARMUP_STEPS):
        one_step()
    torch.cuda.synchronize()
    step_ms, step_host = timed(one_step, cs.TIMED_STEPS)
    res.update(step_median=float(np.median(step_ms)),
               step_min=min(step_ms), step_max=max(step_ms),
               step_host_median=float(np.median(step_host)))
    del adam, eadam, model, bank

    cloud = testing.make_sh3_cloud(0, cs.N_GAUSSIANS)
    rmodel = cs._model(cloud).to(device)
    cams = testing.make_orbit_cameras(cs.N_FRAMES, radius=6.0,
                                      width=cs.RENDER_W, height_px=cs.RENDER_H)
    kernel("infer", cs._project_model(rmodel, cams[0]), cs.RENDER_W,
           cs.RENDER_H, 32, 16, False)
    render(rmodel, cams[0], [0.0, 0.0, 0.0])
    torch.cuda.synchronize()
    it = iter(cams)
    frame_ms, frame_host = timed(
        lambda: render(rmodel, next(it), [0.0, 0.0, 0.0]), cs.N_FRAMES)
    res.update(frame_median=float(np.median(frame_ms)),
               frame_min=min(frame_ms), frame_max=max(frame_ms),
               frame_host_median=float(np.median(frame_host)))
    print(TAG + json.dumps(res), flush=True)


def main() -> None:
    args = sys.argv[1:]
    if args[:1] == ["--worker"] and len(args) == 2:
        worker(args[1])
        return
    rounds = 3
    if "--rounds" in args:
        i = args.index("--rounds")
        rounds = int(args[i + 1])
        del args[i:i + 2]
    if len(args) != 2:
        raise SystemExit(f"usage: {sys.argv[0]} BASE CHANGE [--rounds N]")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_ab: torch.cuda.is_available() is False — "
                         "this script needs one CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    runs = {side: [] for side in args}
    for r in range(rounds):
        for side in args + args[::-1]:
            root = os.path.abspath(side)
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", root],
                cwd=root, capture_output=True, text=True)
            lines = [ln for ln in proc.stdout.splitlines()
                     if ln.startswith(TAG)]
            if proc.returncode != 0 or len(lines) != 1:
                raise SystemExit(f"{side} run failed (rc={proc.returncode})"
                                 f":\n{proc.stdout[-4000:]}\n"
                                 f"{proc.stderr[-4000:]}")
            res = json.loads(lines[0][len(TAG):])
            runs[side].append(res)
            print(f"round {r} {side}: " + ", ".join(
                f"{k} {res[k]:.4f}" for k in KEYS)
                + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    import numpy as np
    summary = {}
    for side, rs in runs.items():
        print(f"{side}: errors against plain: train "
              f"{max(x['fwd_train_err'] for x in rs):.3g} (n_contrib differs "
              f"at {max(x['fwd_train_nc_diff'] for x in rs)} pixels), infer "
              f"{max(x['fwd_infer_err'] for x in rs):.3g}", flush=True)
        summary[side] = {}
        for key in KEYS:
            v = [x[key] for x in rs]
            summary[side][key] = dict(median=float(np.median(v)),
                                      min=min(v), max=max(v))
            print(f"{side} {key} over {len(v)} runs: median "
                  f"{np.median(v):.4f}, range {min(v):.4f}–{max(v):.4f}",
                  flush=True)
    print(json.dumps({"summary": summary, "runs": runs}))


if __name__ == "__main__":
    main()
