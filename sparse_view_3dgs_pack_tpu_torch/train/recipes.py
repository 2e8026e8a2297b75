"""Method recipes: a method name → its training procedure.

Counterpart of `sparse_view_3dgs_pack_tpu/train/recipes.py`. Vanilla 3DGS
is LGDWT with the DWT terms off; both run `simple_train`. FSGS runs
`fsgs_loop.train_fsgs`, DNGaussian `dng_loop.train_dngaussian`, mult-dwtgs
`nir_loop.train_nir` (whose scene `train_method` returns, as JAX's does).
For `3dgs` / `lgdwt` the SIBR remote viewer listens on `--ip` / `--port`
unless `--disable_viewer` is given (`Trainer.serve_viewer`); `fsgs`,
`dngaussian` and `mult-dwtgs` train without it, as in JAX (its FSGS loop
imports `network_gui` but never serves it; its DNG and NIR loops never
touch it).
"""

from __future__ import annotations

import time

from ..scene import Scene
from ..viewer import network_gui
from .loop import simple_train


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


def train_method(method: str, dataset, opt, pipe, args, device):
    if method not in ("3dgs", "lgdwt", "fsgs", "dngaussian", "mult-dwtgs"):
        raise ValueError(method)
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
    scene = Scene(dataset, sh_degree=dataset.sh_degree, device=device)
    if not getattr(args, "disable_viewer", False):
        network_gui.init(args.ip, args.port)

    trainer, elapsed = simple_train(
        scene, opt, pipe, dataset,
        testing_iterations=set(args.test_iterations),
        saving_iterations=set(args.save_iterations),
        checkpoint_iterations=set(args.checkpoint_iterations or []),
        start_checkpoint=getattr(args, "start_checkpoint", None),
        progress=_progress_printer(opt.iterations))

    stats = trainer.evaluate(scene.getTestCameras() or
                             scene.getTrainCameras()[:8])
    if stats:
        print(f"\n[ITER {opt.iterations}] Evaluating test: "
              f"L1 {stats['l1']:.4f} PSNR {stats['psnr']:.2f}")
    ran = opt.iterations - trainer.start_iteration
    print(f"Training took {elapsed:.1f}s for {ran} iterations "
          f"({ran / max(elapsed, 1e-9):.2f} it/s)")
