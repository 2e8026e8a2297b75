#!/usr/bin/env python3
"""Forward-kernel, training-step and frame times of two checkouts of the
PyTorch port, or their `knn3` times and work, measured in turns on one
CUDA card.

    python3 chip_ab.py BASE CHANGE [--rounds 3] [--knn]
    python3 chip_ab.py --knn-worker ROOT [BUDGET ...]

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
With --knn each run times instead the checkout's `knn3` on four clouds:
the fsgs phase's 30k `fused.ply` with its 30 strays, 300k uniform points,
100k `knn_stress_cloud` points and the nir phase's 2000-point SfM init
(built once, into build/knn_clouds.npz): the kernel against its plain
version (bitwise), 20 calls timed with CUDA events, a torch.profiler
trace of 5 calls (device ms per kernel name, device ops per call), and
its work per query warp (box tests, boxes or leaves scanned, distance
evaluations summed over the lanes) through the checkout's
`knn.knn3_work`, or, for a checkout without it (the earlier design: a
linear sweep over boxes of 256 sorted points), by building that
checkout's `csrc/knn.cu` with counters added.
`--knn-worker ROOT` makes one such run alone; given BUDGETs, it then
times the four clouds again with each as `knn.BUDGET` (the leaves a query
may need before it is listed), bitwise checked.
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

import numpy as np

TAG = "chip_ab "
KERNEL_REPS = 50
KEYS = ("fwd_train_ms", "fwd_infer_ms", "step_median", "frame_median")
KNN_CLOUDS = ("fused", "uniform", "stress", "sfm")
KNN_REPS, KNN_PROFILED = 20, 5
CLOUDS_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "knn_clouds.npz")


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


def _knn_clouds(cs, device) -> dict:
    """The four clouds of `knn3`'s row in PERF.md, as chip_smoke.py builds
    them (fsgs and nir fixtures, phase knn's seeds)."""
    if os.path.exists(CLOUDS_NPZ):
        with np.load(CLOUDS_NPZ) as z:
            return {k: z[k] for k in KNN_CLOUDS}
    from sparse_view_3dgs_pack_tpu_torch import testing
    from sparse_view_3dgs_pack_tpu_torch.data import readers
    from sparse_view_3dgs_pack_tpu_torch.data.ply import fetch_point_cloud
    work = os.path.join(os.path.dirname(CLOUDS_NPZ), "knn_ab")
    fsgs = testing.write_llff_colmap_scene(
        os.path.join(work, "fsgs_scene"), size=cs.FSGS_W,
        n_gauss=cs.FSGS_GAUSS, n_dense=cs.FSGS_DENSE,
        n_outliers=cs.FSGS_OUTLIERS, device=device)
    nir = testing.write_llff_colmap_scene(
        os.path.join(work, "nir_scene"), size=cs.NIR_W, n_gauss=cs.NIR_GAUSS,
        n_dense=1000, n_sparse=cs.NIR_SPARSE, nir=True, device=device)
    clouds = {
        "fused": fetch_point_cloud(
            os.path.join(fsgs, "3_views", "dense", "fused.ply")).points,
        "uniform": np.random.default_rng(5).uniform(
            -2, 2, (cs.KNN_UNIFORM, 3)),
        "stress": testing.knn_stress_cloud(6, cs.KNN_STRESS),
        "sfm": readers.read_colmap_scene(nir, eval=True).point_cloud.points}
    clouds = {k: np.asarray(v, np.float32) for k, v in clouds.items()}
    os.makedirs(os.path.dirname(CLOUDS_NPZ), exist_ok=True)
    tmp = CLOUDS_NPZ + f".{os.getpid()}.npz"
    np.savez(tmp, **clouds)
    os.replace(tmp, CLOUDS_NPZ)
    return clouds


# counters added to the linear-sweep `csrc/knn.cu` (every query warp
# tests every box of 256 sorted points): per query warp, box tests, boxes
# scanned and distance evaluations summed over its 32 lanes
_SWEEP_PATCH = (
    ("int* __restrict__ idx, int n, int n_boxes) {",
     "int* __restrict__ idx, int n, int n_boxes, int* stats) {"),
    ("  const int self = __float_as_int(q.w);\n",
     "  const int self = __float_as_int(q.w);\n"
     "  int* ws = stats + 3 * (s >> 5);\n"),
    ("    offer(seed, sqdist(q, p), __float_as_int(p.w));\n  }",
     "    offer(seed, sqdist(q, p), __float_as_int(p.w));\n"
     "    atomicAdd(ws + 2, 1);\n  }"),
    ("    const int end = min(b * kBox + kBox, n);",
     "    const int end = min(b * kBox + kBox, n);\n"
     "    if ((threadIdx.x & 31) == 0) {\n"
     "      atomicAdd(ws + 1, 1);\n"
     "      atomicAdd(ws + 2, 32 * (end - b * kBox));\n    }"),
    ("  if (!live) return;",
     "  if ((threadIdx.x & 31) == 0) ws[0] = n_boxes;\n  if (!live) return;"),
    ("void* boxes, void* mean_d2, void* idx, int n,\n"
     "                           void* stream) {",
     "void* boxes, void* mean_d2, void* idx, int n,\n"
     "                           void* stream, void* stats) {"),
    ("static_cast<int*>(idx), n, n_boxes);",
     "static_cast<int*>(idx), n, n_boxes,\n"
     "                           static_cast<int*>(stats));"),
)


def _sweep_work(root: str, pts):
    """Per query warp (box tests, boxes scanned, distance evaluations) of
    the linear-sweep kernel in checkout `root`, built with counters
    added; the wrapper's chain as that checkout's `_knn3_cuda` runs it."""
    import ctypes
    import hashlib

    import torch

    from sparse_view_3dgs_pack_tpu_torch.ops import _build
    src = open(os.path.join(root, "sparse_view_3dgs_pack_tpu_torch", "csrc",
                            "knn.cu")).read()
    for old, new in _SWEEP_PATCH:
        if src.count(old) != 1:
            raise SystemExit(f"chip_ab: {root}'s knn.cu is not the "
                             f"linear sweep (no unique {old!r})")
        src = src.replace(old, new)
    tag = hashlib.sha256(src.encode()).hexdigest()[:12]
    out = os.path.join(root, "build", f"knn_sweep_stats-{tag}.so")
    if not os.path.exists(out):
        cu = out[:-3] + ".cu"
        with open(cu, "w") as f:
            f.write(src)
        subprocess.run([_build._nvcc(), *_build._flags("knn"), "-o", out,
                        cu], check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.knn_morton.argtypes = [vp] * 3 + [ci, vp]
    lib.knn3_search.argtypes = [vp] * 6 + [ci, vp, vp]
    n, dev = pts.shape[0], pts.device
    bbox = torch.cat([pts.amin(0), pts.amax(0)]).contiguous()
    codes = torch.empty(n, dtype=torch.int64, device=dev)
    sorted_pts = torch.empty((n, 4), dtype=torch.float32, device=dev)
    boxes = torch.empty((-(-n // 256), 2, 4), dtype=torch.float32,
                        device=dev)
    mean = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty((n, 3), dtype=torch.int32, device=dev)
    # a row for every warp of the launch's 128-thread blocks
    stats = torch.zeros((-(-n // 128) * 4, 3), dtype=torch.int32,
                        device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    assert lib.knn_morton(pts.data_ptr(), bbox.data_ptr(), codes.data_ptr(),
                          n, stream) == 0
    order = torch.sort(codes, stable=True).indices.to(torch.int32)
    assert lib.knn3_search(pts.data_ptr(), order.data_ptr(),
                           sorted_pts.data_ptr(), boxes.data_ptr(),
                           mean.data_ptr(), idx.data_ptr(), n, stream,
                           stats.data_ptr()) == 0
    torch.cuda.synchronize()
    return {"warp": stats[:-(-n // 32)].cpu().numpy(),
            "listed": np.zeros((0, 2), int)}


def _spread(a) -> dict:
    a = np.asarray(a, np.float64)
    return dict(mean=float(a.mean()) if a.size else 0.0,
                max=float(a.max()) if a.size else 0.0)


def _work_counts(w) -> dict:
    """Per-warp counts by the layout of their width: the sweep's three (box
    tests, boxes scanned, distance evaluations) or `knn3_work`'s six."""
    if w.shape[1] == 3:
        return dict(scanned=_spread(w[:, 1]), dist_evals=_spread(w[:, 2]))
    if w.shape[1] != 6:
        return {}
    return dict(passed=_spread(w[:, 1]), scanned=_spread(w[:, 2]),
                dist_evals=_spread(w[:, 3]), lanes_listed=_spread(w[:, 4]),
                kcycles=_spread(w[:, 5]))


def knn_worker(root: str, budgets=()) -> None:
    """One knn run in checkout `root`: prints one JSON line after TAG.
    With `budgets`, each is then set as `knn.BUDGET` in turn and the four
    clouds are timed again, bitwise checked, with their listed queries
    (one more line after TAG)."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    import sparse_view_3dgs_pack_tpu_torch as port
    for mod in (cs, port):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise AssertionError(f"{mod.__name__} imported from "
                                 f"{mod.__file__}, not from {root}")
    from sparse_view_3dgs_pack_tpu_torch.ops import knn
    device = torch.device("cuda")
    cs.phase_device()
    cs.phase_build()
    res = {}
    for name, arr in _knn_clouds(cs, device).items():
        pts = torch.as_tensor(arr, device=device)
        d, i = knn.knn3(pts)
        rd, ri = knn.knn3_torch(pts)
        torch.cuda.synchronize()
        if not (torch.equal(d, rd) and torch.equal(i, ri)):
            raise AssertionError(f"knn3 {name}: kernel and plain differ")
        ms = cs.cuda_ms(lambda: knn.knn3(pts), KNN_REPS)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(KNN_PROFILED):
                knn.knn3(pts)
            torch.cuda.synchronize()
        per = {}
        ops = 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                ops += 1
                short = e.name.replace("(anonymous namespace)::", "")
                short = short.split("(")[0].split("<")[0][-48:]
                per[short] = per.get(short, 0.0) + (
                    e.time_range.end - e.time_range.start) / 1e3
        work = (knn.knn3_work(pts) if hasattr(knn, "knn3_work")
                else _sweep_work(root, pts))
        w, h = (torch.as_tensor(work[k]).cpu().numpy()
                for k in ("warp", "listed"))
        res[name] = dict(
            n=int(arr.shape[0]), ms=ms, device_ops=ops / KNN_PROFILED,
            device_ms={k: v / KNN_PROFILED for k, v in sorted(
                per.items(), key=lambda kv: -kv[1])},
            box_tests=_spread(w[:, 0]), **_work_counts(w),
            listed=int(h.shape[0]),
            listed_leaf_tests=_spread(h[:, 0]),
            listed_dist_evals=_spread(h[:, 1]),
            **({} if h.shape[1] < 3 else dict(
                listed_kcycles=_spread(h[:, 2]))))
    print(TAG + json.dumps(res), flush=True)
    sweep = {}
    for b in budgets:
        knn.BUDGET = b
        for name, arr in _knn_clouds(cs, device).items():
            pts = torch.as_tensor(arr, device=device)
            d, i = knn.knn3(pts)
            listed = int(knn.knn3.listed)
            rd, ri = knn.knn3_torch(pts)
            if not (torch.equal(d, rd) and torch.equal(i, ri)):
                raise AssertionError(f"knn3 {name} at budget {b}: kernel "
                                     f"and plain differ")
            sweep[f"{b} {name}"] = dict(
                ms=cs.cuda_ms(lambda: knn.knn3(pts), KNN_REPS),
                listed=listed)
    if sweep:
        print(TAG + json.dumps({"budgets": sweep}), flush=True)


def main() -> None:
    args = sys.argv[1:]
    if args[:1] == ["--worker"] and len(args) == 2:
        worker(args[1])
        return
    if args[:1] == ["--knn-worker"] and len(args) >= 2:
        knn_worker(args[1], [int(b) for b in args[2:]])
        return
    rounds = 3
    if "--rounds" in args:
        i = args.index("--rounds")
        rounds = int(args[i + 1])
        del args[i:i + 2]
    knn_mode = "--knn" in args
    if knn_mode:
        args.remove("--knn")
    if len(args) != 2:
        raise SystemExit(f"usage: {sys.argv[0]} BASE CHANGE [--rounds N] "
                         f"[--knn]")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_ab: torch.cuda.is_available() is False — "
                         "this script needs one CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    runs = {side: [] for side in args}
    flag, keys = ("--knn-worker", KNN_CLOUDS) if knn_mode else ("--worker",
                                                                KEYS)
    value = (lambda res, k: res[k]["ms"]) if knn_mode else (
        lambda res, k: res[k])
    for r in range(rounds):
        for side in args + args[::-1]:
            root = os.path.abspath(side)
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), flag, root],
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
                f"{k} {value(res, k):.4f}" for k in keys)
                + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    summary = {}
    for side, rs in runs.items():
        if knn_mode:
            for k in keys:
                x = {f: rs[0][k][f] for f in rs[0][k] if f != "ms"}
                print(f"{side} {k}: {json.dumps(x)}", flush=True)
        else:
            print(f"{side}: errors against plain: train "
                  f"{max(x['fwd_train_err'] for x in rs):.3g} (n_contrib "
                  f"differs at {max(x['fwd_train_nc_diff'] for x in rs)} "
                  f"pixels), infer {max(x['fwd_infer_err'] for x in rs):.3g}",
                  flush=True)
        summary[side] = {}
        for key in keys:
            v = [value(x, key) for x in rs]
            summary[side][key] = dict(median=float(np.median(v)),
                                      min=min(v), max=max(v))
            print(f"{side} {key} over {len(v)} runs: median "
                  f"{np.median(v):.4f}, range {min(v):.4f}–{max(v):.4f}",
                  flush=True)
    print(json.dumps({"summary": summary, "runs": runs}))


if __name__ == "__main__":
    main()
