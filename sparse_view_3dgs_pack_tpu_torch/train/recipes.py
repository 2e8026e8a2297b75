"""Method recipes: a method name → its training procedure.

Counterpart of `sparse_view_3dgs_pack_tpu/train/recipes.py`. Vanilla 3DGS
is LGDWT with the DWT terms off; both run `simple_train`. FSGS runs
`fsgs_loop.train_fsgs`, DNGaussian `dng_loop.train_dngaussian`, mult-dwtgs
`nir_loop.train_nir` (whose scene `train_method` returns, as JAX's does);
each of those three steps its method's trainer (`FSGSTrainer`,
`DNGTrainer`, `NIRTrainer`) through `loop.drive`.
For `3dgs` / `lgdwt` the SIBR remote viewer listens on `--ip` / `--port`
unless `--disable_viewer` is given (`Trainer.serve_viewer`); `fsgs`,
`dngaussian` and `mult-dwtgs` train without it, as in JAX (its FSGS loop
imports `network_gui` but never serves it; its DNG and NIR loops never
touch it). `3dgs` / `lgdwt` also train data-parallel: `train_rank` is one
rank of a run the train CLI spawns (`parallel/dp.py::launch`); rank 0
alone listens for the viewer, evaluates, prints and writes.
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from ..scene import Scene
from ..utils.general import safe_state
from ..viewer import network_gui
from .loop import simple_train, timing_line


def _progress_printer(total):
    state = {"last": time.time(), "ema": 0.0}

    def cb(it, metrics):
        if it % 100:
            return
        loss = float(metrics["loss"])
        state["ema"] = 0.4 * loss + 0.6 * state["ema"] if state["ema"] else loss
        now = time.time()
        ips = 100 / max(now - state["last"], 1e-9)
        state["last"] = now
        print(f"[{it}/{total}] loss={state['ema']:.5f} ({ips:.1f} it/s)",
              flush=True)

    return cb


def train_method(method: str, dataset, opt, pipe, args, device, group=None):
    """Train `method`; `group` (`parallel/dp.py::DPGroup`, 3dgs / lgdwt
    only) makes this process one rank of a data-parallel run."""
    if method not in ("3dgs", "lgdwt", "fsgs", "dngaussian", "mult-dwtgs"):
        raise ValueError(method)
    if group is not None and method not in ("3dgs", "lgdwt"):
        raise ValueError(f"{method} does not train data-parallel")
    # arm the debug snapshot from --debug_from (`train/debug.py`)
    pipe.debug_from = getattr(args, "debug_from", -1)
    if method == "fsgs":
        from .fsgs_loop import train_fsgs
        pipe.use_confidence = getattr(args, "use_confidence", False)
        train_fsgs(dataset, opt, pipe, args, device)
        return
    if method == "mult-dwtgs":
        from .nir_loop import train_nir
        return train_nir(dataset, opt, pipe, args, device)
    if method == "dngaussian":
        from .dng_loop import train_dngaussian
        train_dngaussian(dataset, opt, pipe, args, device,
                         near_range=getattr(args, "near_range", 0.0),
                         dataset_type=getattr(args, "dataset_type", "llff"))
        return
    main = group is None or group.rank == 0
    scene = _scene(dataset, device, group)
    if main and not getattr(args, "disable_viewer", False):
        network_gui.init(args.ip, args.port)

    trainer, elapsed = simple_train(
        scene, opt, pipe, dataset,
        testing_iterations=set(args.test_iterations),
        saving_iterations=set(args.save_iterations),
        checkpoint_iterations=set(args.checkpoint_iterations or []),
        start_checkpoint=getattr(args, "start_checkpoint", None),
        progress=_progress_printer(opt.iterations), group=group)
    if not main:
        return

    stats = trainer.evaluate(scene.getTestCameras() or
                             scene.getTrainCameras()[:8])
    if stats:
        print(f"\n[ITER {opt.iterations}] Evaluating test: "
              f"L1 {stats['l1']:.4f} PSNR {stats['psnr']:.2f}")
    timing_line("Training", elapsed, opt.iterations - trainer.start_iteration)


def _scene(dataset, device, group):
    """The training Scene; under data parallelism rank 0 builds its own
    first (it writes `input.ply` and `cameras.json`), then the others."""
    if group is None:
        return Scene(dataset, sh_degree=dataset.sh_degree, device=device)
    scene = None
    if group.rank == 0:
        scene = Scene(dataset, sh_degree=dataset.sh_degree, device=device)
    dist.barrier(group=group.pg)
    if group.rank != 0:
        scene = Scene(dataset, sh_degree=dataset.sh_degree, device=device)
    return scene


def train_rank(group, method: str, dataset, opt, pipe, args) -> None:
    """One rank of a data-parallel CLI run (`parallel/dp.py::launch`
    calls it in each spawned process): the host RNGs seeded as in the
    parent, stdout silent except on rank 0, the profile (`--profile`) on
    rank 0 only."""
    safe_state(args.quiet or group.rank != 0, args.seed)
    torch.autograd.set_detect_anomaly(args.detect_anomaly)
    profile_dir = args.profile if group.rank == 0 else ""
    run_profiled(profile_dir, group.device, train_method, method, dataset,
                 opt, pipe, args, group.device, group)


def run_profiled(profile_dir: str, device, fn, *fn_args):
    """fn(*fn_args), under `torch.profiler` (CPU, and CUDA activity on a
    card) when `profile_dir` is given: a Chrome trace
    `<profile_dir>/train.pt.trace.json` of the whole call, whose spans
    (`utils/tracing.py`) name the stages (`render/…`, `step/…`, `dp/…`)
    and the work inside them (`grad/…`, `sync/…`, `host/…`). A profiler that cannot
    start prints `[profiler] disabled (…)` and the call runs on, as the
    JAX CLI does."""
    if not profile_dir:
        return fn(*fn_args)
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        os.makedirs(profile_dir, exist_ok=True)
        prof.start()
    except (OSError, RuntimeError) as e:
        print(f"[profiler] disabled ({e})")
        return fn(*fn_args)
    try:
        result = fn(*fn_args)
    finally:
        prof.stop()
    path = os.path.join(profile_dir, "train.pt.trace.json")
    prof.export_chrome_trace(path)
    print(f"[profiler] trace written to {path}")
    return result
